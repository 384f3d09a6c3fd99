// f32 sampling evaluator: per shot row, the sum over graphs of the complex
// product of four term families times a prefolded prefactor.
//
// Replaces the TPU kernels of tsim_tpu/compile/pallas_sample.py:
//   _kernel_sample (K1, wide layout) and _kernel_sample_t (K2, transposed
//   small-G layout), whose body is _product_body_sample_packed;
//   _kernel_sample_unpacked (K3a) and _kernel_sample_t_unpacked (K3b), the
//   same function with one parity dot per term (_product_body_sample);
// and the family/stage ablation of dev/kernel_ablate.py::_body_ablate (K8).
// On the TPU every parity is a bf16 matrix-unit dot of the shot's 0/1
// parameters against a term's parameter mask. Here a shot's parameters are
// packed into 32-bit words and every parity is the popcount parity of
// (x & w) over the words, so no parity matrix is formed at all.
//
// The configurations differ in where a shot's packed words live:
//   "wide" / "small" (K1 / K2): in W <= 4 registers, W a template parameter;
//   "per_term_wide" / "per_term_small" (K3a / K3b): staged in shared memory
//   and read in a loop over all W words for each term, so P has no word cap
//   (only the block's shared memory bounds it: 32 W bytes a block in the
//   wide and 4 W bytes a shot in the small configuration).
// "wide" spreads graphs over the threads of a block and gives each thread
// NS shots, so each table entry it loads is reused NS times; a block
// reduction (warp shuffles, then shared memory) sums over graphs, and no sum
// is carried across blocks. "small" gives each thread one shot and loops over
// all graphs; every thread of a warp reads the same table entry, which L1
// broadcasts. The ragged edge of the batch is masked in all of them.
//
// What bounds it on an H100: the integer pipe. Per (shot, graph) pair it does
// one popcount per parity row (T1 + T2 + 2 T3 + 2 T4 of them) and about ten
// f32 operations per term; it reads P bytes and writes 8 bytes per shot, and
// the tables of one rung are a few tens of KB that stay in L1/L2. Popcount
// issues at a quarter of the f32 rate, so the popcounts and the table loads
// are the limit.
//
// The wide kernel takes a family/stage mask M as a template parameter (bits
// kP1..kT4: form family k's parities, apply family k's factors). K1 and K3a
// run with every stage on; the ablation (tsim_sample_eval_ablate) launches
// the same template with stages off, so its "full" variant is K1's own code.
// A family whose parities are formed without its factors XORs them into a
// word that is added to the real part, so the compiler cannot drop them.
//
// Build with -O3 and without --use_fast_math or -ftz, so that denormals
// survive (the host still folds the common power of two out of the
// prefactor, see compile/sample_tables.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kSqrtHalf = 0.70710678118654752f;
constexpr int kWideThreads = 128;  // upper bound of the wide block
constexpr int kWideShots = 8;      // shots per wide block (NS)
constexpr int kSmallThreads = 128;
constexpr int kDefaultSharedBytes = 48 * 1024;

// Family/stage mask bits.
constexpr unsigned kP1 = 1, kT1 = 2, kP2 = 4, kT2 = 8, kP3 = 16, kT3 = 32, kP4 = 64, kT4 = 128;
constexpr unsigned kAllStages = 255;

// Configuration codes of tsim_sample_eval (kernels/sample_eval.py::CONFIGURATIONS).
enum Config { kSmall = 0, kWide = 1, kPerTermSmall = 2, kPerTermWide = 3 };

// Pointers into the flat table buffer; the segment order matches
// tsim_tpu_torch/compile/sample_tables.py::table_layout.
struct Tables {
  const float* np_cos;
  const float* np_sin;
  const uint32_t* np_w;
  const int32_t* hp_c;
  const uint32_t* hp_w;
  const int32_t* psi_c;
  const int32_t* phi_c;
  const uint32_t* psi_w;
  const uint32_t* phi_w;
  const float* ca;
  const float* sa;
  const float* cb;
  const float* sb;
  const float* cg;
  const float* sg;
  const uint32_t* a_w;
  const uint32_t* b_w;
  const float* pre_re;
  const float* pre_im;
  int G, T1, T2, T3, T4, W;
};

Tables make_tables(const int32_t* flat, int G, int T1, int T2, int T3, int T4, int W) {
  const int32_t* p = flat;
  auto take = [&p](long long n) {
    const int32_t* q = p;
    p += n;
    return q;
  };
  const long long g1 = (long long)T1 * G, g2 = (long long)T2 * G;
  const long long g3 = (long long)T3 * G, g4 = (long long)T4 * G;
  Tables t;
  t.np_cos = reinterpret_cast<const float*>(take(g1));
  t.np_sin = reinterpret_cast<const float*>(take(g1));
  t.np_w = reinterpret_cast<const uint32_t*>(take(g1 * W));
  t.hp_c = take(g2);
  t.hp_w = reinterpret_cast<const uint32_t*>(take(g2 * W));
  t.psi_c = take(g3);
  t.phi_c = take(g3);
  t.psi_w = reinterpret_cast<const uint32_t*>(take(g3 * W));
  t.phi_w = reinterpret_cast<const uint32_t*>(take(g3 * W));
  t.ca = reinterpret_cast<const float*>(take(g4));
  t.sa = reinterpret_cast<const float*>(take(g4));
  t.cb = reinterpret_cast<const float*>(take(g4));
  t.sb = reinterpret_cast<const float*>(take(g4));
  t.cg = reinterpret_cast<const float*>(take(g4));
  t.sg = reinterpret_cast<const float*>(take(g4));
  t.a_w = reinterpret_cast<const uint32_t*>(take(g4 * W));
  t.b_w = reinterpret_cast<const uint32_t*>(take(g4 * W));
  t.pre_re = reinterpret_cast<const float*>(take(G));
  t.pre_im = reinterpret_cast<const float*>(take(G));
  t.G = G;
  t.T1 = T1;
  t.T2 = T2;
  t.T3 = T3;
  t.T4 = T4;
  t.W = W;
  return t;
}

// Word i (bits 32i .. 32i + 31) of a row of P parameter bytes (bit 0 of each).
__device__ __forceinline__ uint32_t pack_word(const uint8_t* __restrict__ row, int P, int i) {
  uint32_t word = 0;
  const int lo = 32 * i, hi = min(P, lo + 32);
  for (int p = lo; p < hi; ++p) word |= (uint32_t)(row[p] & 1) << (p - lo);
  return word;
}

// NS shots' rows in W registers each (K1, K2).
template <int W, int NS>
struct RegisterRows {
  uint32_t x[NS][W];

  __device__ __forceinline__ int words() const { return W; }

  // p[k] = parity of popcount(x[k] & w) over the W words at w_src.
  __device__ __forceinline__ void parities(const uint32_t* w_src, int (&p)[NS]) const {
    uint32_t w[W];
#pragma unroll
    for (int i = 0; i < W; ++i) w[i] = __ldg(w_src + i);
#pragma unroll
    for (int k = 0; k < NS; ++k) {
      uint32_t acc = 0;
#pragma unroll
      for (int i = 0; i < W; ++i) acc ^= x[k][i] & w[i];
      p[k] = __popc(acc) & 1;
    }
  }
};

// NS shots' rows staged in shared memory, any number of words (K3a, K3b):
// word i of shot k is xs[i * stride + k].
template <int NS>
struct SharedRows {
  const uint32_t* xs;
  int W, stride;

  __device__ __forceinline__ int words() const { return W; }

  __device__ __forceinline__ void parities(const uint32_t* w_src, int (&p)[NS]) const {
    uint32_t acc[NS];
#pragma unroll
    for (int k = 0; k < NS; ++k) acc[k] = 0;
    for (int i = 0; i < W; ++i) {
      const uint32_t w = __ldg(w_src + i);
#pragma unroll
      for (int k = 0; k < NS; ++k) acc[k] ^= xs[i * stride + k] & w;
    }
#pragma unroll
    for (int k = 0; k < NS; ++k) p[k] = __popc(acc[k]) & 1;
  }
};

__device__ __forceinline__ void cmul(float& re, float& im, float fr, float fi) {
  const float nre = re * fr - im * fi;
  const float nim = re * fi + im * fr;
  re = nre;
  im = nim;
}

// (re, im) * w^k for k in [0, 8), staged on k's bits.
__device__ __forceinline__ void rot_staged(float& re, float& im, int k) {
  if (k & 1) {
    const float nre = (re - im) * kSqrtHalf;
    const float nim = (re + im) * kSqrtHalf;
    re = nre;
    im = nim;
  }
  if (k & 2) {
    const float t = re;
    re = -im;
    im = t;
  }
  if (k & 4) {
    re = -re;
    im = -im;
  }
}

// Adds graph g's product, for each of NS shots, into (acc_re, acc_im), with
// the stages of mask M.
template <unsigned M, int NS, class Rows>
__device__ __forceinline__ void accumulate_graph(const Tables& tb, int g, const Rows& rows,
                                                 float (&acc_re)[NS], float (&acc_im)[NS]) {
  constexpr bool kBare = ((M & kP1) && !(M & kT1)) || ((M & kP2) && !(M & kT2)) ||
                         ((M & kP3) && !(M & kT3)) || ((M & kP4) && !(M & kT4));
  const int G = tb.G;
  const long long W = rows.words();
  float re[NS], im[NS];
  int bare[NS], p[NS], q[NS];
#pragma unroll
  for (int k = 0; k < NS; ++k) {
    re[k] = 1.0f;
    im[k] = 0.0f;
    bare[k] = 0;
  }

  // Node phases: (1 + c) - 2c p, s - 2s p; dead slots have c = s = 0.
  if (M & kP1) {
    for (int t = 0; t < tb.T1; ++t) {
      const int i = t * G + g;
      rows.parities(tb.np_w + i * W, p);
      if (M & kT1) {
        const float c = __ldg(tb.np_cos + i), s = __ldg(tb.np_sin + i);
#pragma unroll
        for (int k = 0; k < NS; ++k) {
          const float pf = (float)p[k];
          cmul(re[k], im[k], (1.0f + c) - (2.0f * c) * pf, s - (2.0f * s) * pf);
        }
      } else {
#pragma unroll
        for (int k = 0; k < NS; ++k) bare[k] ^= p[k];
      }
    }
  }

  // Half-pi phases: one rotation by w^(sum coeff * parity mod 8).
  if ((M & kP2) && tb.T2) {
    int tot[NS];
#pragma unroll
    for (int k = 0; k < NS; ++k) tot[k] = 0;
    for (int t = 0; t < tb.T2; ++t) {
      const int i = t * G + g;
      rows.parities(tb.hp_w + i * W, p);
      if (M & kT2) {
        const int coeff = __ldg(tb.hp_c + i);
#pragma unroll
        for (int k = 0; k < NS; ++k) tot[k] += coeff * p[k];
      } else {
#pragma unroll
        for (int k = 0; k < NS; ++k) bare[k] ^= p[k];
      }
    }
    if (M & kT2) {
#pragma unroll
      for (int k = 0; k < NS; ++k) rot_staged(re[k], im[k], tot[k] & 7);
    }
  }

  // Pi products: sign (-1)^(XOR over terms of psi & phi).
  if ((M & kP3) && tb.T3) {
    int sgn[NS];
#pragma unroll
    for (int k = 0; k < NS; ++k) sgn[k] = 0;
    for (int t = 0; t < tb.T3; ++t) {
      const int i = t * G + g;
      rows.parities(tb.psi_w + i * W, p);
      rows.parities(tb.phi_w + i * W, q);
      if (M & kT3) {
        const int pc = __ldg(tb.psi_c + i) & 1, qc = __ldg(tb.phi_c + i) & 1;
#pragma unroll
        for (int k = 0; k < NS; ++k) sgn[k] ^= (pc ^ p[k]) & (qc ^ q[k]);
      } else {
#pragma unroll
        for (int k = 0; k < NS; ++k) bare[k] ^= p[k] ^ q[k];
      }
    }
    if (M & kT3) {
#pragma unroll
      for (int k = 0; k < NS; ++k) {
        if (sgn[k]) {
          re[k] = -re[k];
          im[k] = -im[k];
        }
      }
    }
  }

  // Phase pairs: 1 + s_a w^alpha + s_b w^beta - s_a s_b w^(alpha+beta).
  if (M & kP4) {
    for (int t = 0; t < tb.T4; ++t) {
      const int i = t * G + g;
      rows.parities(tb.a_w + i * W, p);
      rows.parities(tb.b_w + i * W, q);
      if (M & kT4) {
        const float ca = __ldg(tb.ca + i), sa = __ldg(tb.sa + i);
        const float cb = __ldg(tb.cb + i), sb = __ldg(tb.sb + i);
        const float cg = __ldg(tb.cg + i), sg = __ldg(tb.sg + i);
#pragma unroll
        for (int k = 0; k < NS; ++k) {
          const float s_a = 1.0f - 2.0f * (float)p[k];
          const float s_b = 1.0f - 2.0f * (float)q[k];
          const float s_g = s_a * s_b;
          cmul(re[k], im[k], 1.0f + s_a * ca + s_b * cb - s_g * cg,
               s_a * sa + s_b * sb - s_g * sg);
        }
      } else {
#pragma unroll
        for (int k = 0; k < NS; ++k) bare[k] ^= p[k] ^ q[k];
      }
    }
  }

  if (kBare) {
#pragma unroll
    for (int k = 0; k < NS; ++k) re[k] += (float)bare[k];
  }

  const float pr = __ldg(tb.pre_re + g), pi = __ldg(tb.pre_im + g);
#pragma unroll
  for (int k = 0; k < NS; ++k) {
    acc_re[k] += re[k] * pr - im[k] * pi;
    acc_im[k] += re[k] * pi + im[k] * pr;
  }
}

// Sums NS shots' (acc_re, acc_im) over the block's threads and writes the
// shots b0 .. b0 + NS - 1 that lie inside the batch.
template <int NS>
__device__ __forceinline__ void block_sum_store(const float (&acc_re)[NS], const float (&acc_im)[NS],
                                                long long b0, long long B, float* __restrict__ out) {
  __shared__ float red[kWideThreads / 32][NS][2];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int k = 0; k < NS; ++k) {
    float r = acc_re[k], m = acc_im[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      r += __shfl_down_sync(0xffffffffu, r, off);
      m += __shfl_down_sync(0xffffffffu, m, off);
    }
    if (lane == 0) {
      red[warp][k][0] = r;
      red[warp][k][1] = m;
    }
  }
  __syncthreads();
  if (tid < 2 * NS) {
    const int k = tid >> 1, c = tid & 1;
    float s = 0.0f;
    for (int wi = 0; wi < (int)(blockDim.x >> 5); ++wi) s += red[wi][k][c];
    if (b0 + k < B) out[(b0 + k) * 2 + c] = s;
  }
}

// Wide configuration (K1; K8 with M below kAllStages): block = NS shots x up
// to kWideThreads graph lanes, rows in registers.
template <int W, unsigned M>
__global__ void __launch_bounds__(kWideThreads)
    sample_eval_wide(const uint8_t* __restrict__ x, long long B, int P, Tables tb,
                     float* __restrict__ out) {
  constexpr int NS = kWideShots;
  __shared__ uint32_t xs[NS][W];
  const long long b0 = (long long)blockIdx.x * NS;
  const int tid = threadIdx.x;
  if (tid < NS) {
#pragma unroll
    for (int i = 0; i < W; ++i) xs[tid][i] = b0 + tid < B ? pack_word(x + (b0 + tid) * P, P, i) : 0u;
  }
  __syncthreads();

  RegisterRows<W, NS> rows;
#pragma unroll
  for (int k = 0; k < NS; ++k)
#pragma unroll
    for (int i = 0; i < W; ++i) rows.x[k][i] = xs[k][i];

  float acc_re[NS], acc_im[NS];
#pragma unroll
  for (int k = 0; k < NS; ++k) {
    acc_re[k] = 0.0f;
    acc_im[k] = 0.0f;
  }
  for (int g = tid; g < tb.G; g += blockDim.x) accumulate_graph<M>(tb, g, rows, acc_re, acc_im);
  block_sum_store(acc_re, acc_im, b0, B, out);
}

// Per-term wide configuration (K3a): as the wide one, with the block's NS
// rows staged in dynamic shared memory, word i of shot k at xs[i * NS + k].
__global__ void __launch_bounds__(kWideThreads)
    sample_eval_per_term_wide(const uint8_t* __restrict__ x, long long B, int P, Tables tb,
                              float* __restrict__ out) {
  constexpr int NS = kWideShots;
  extern __shared__ uint32_t xs_dyn[];
  const long long b0 = (long long)blockIdx.x * NS;
  const int tid = threadIdx.x;
  for (int j = tid; j < NS * tb.W; j += blockDim.x) {
    const int k = j % NS, i = j / NS;
    xs_dyn[j] = b0 + k < B ? pack_word(x + (b0 + k) * P, P, i) : 0u;
  }
  __syncthreads();

  const SharedRows<NS> rows{xs_dyn, tb.W, NS};
  float acc_re[NS], acc_im[NS];
#pragma unroll
  for (int k = 0; k < NS; ++k) {
    acc_re[k] = 0.0f;
    acc_im[k] = 0.0f;
  }
  for (int g = tid; g < tb.G; g += blockDim.x) accumulate_graph<kAllStages>(tb, g, rows, acc_re, acc_im);
  block_sum_store(acc_re, acc_im, b0, B, out);
}

// Small configuration (K2): one thread per shot, looping over all graphs.
template <int W>
__global__ void __launch_bounds__(kSmallThreads)
    sample_eval_small(const uint8_t* __restrict__ x, long long B, int P, Tables tb,
                      float* __restrict__ out) {
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  RegisterRows<W, 1> rows;
#pragma unroll
  for (int i = 0; i < W; ++i) rows.x[0][i] = pack_word(x + b * P, P, i);
  float acc_re[1] = {0.0f}, acc_im[1] = {0.0f};
  for (int g = 0; g < tb.G; ++g) accumulate_graph<kAllStages>(tb, g, rows, acc_re, acc_im);
  out[b * 2] = acc_re[0];
  out[b * 2 + 1] = acc_im[0];
}

// Per-term small configuration (K3b): one thread per shot, its row staged in
// dynamic shared memory, word i of thread t at xs[i * blockDim.x + t] (so a
// warp's reads of one word fall on 32 banks).
__global__ void __launch_bounds__(kSmallThreads)
    sample_eval_per_term_small(const uint8_t* __restrict__ x, long long B, int P, Tables tb,
                               float* __restrict__ out) {
  extern __shared__ uint32_t xs_dyn[];
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  uint32_t* mine = xs_dyn + threadIdx.x;
  for (int i = 0; i < tb.W; ++i) mine[i * blockDim.x] = pack_word(x + b * P, P, i);
  const SharedRows<1> rows{mine, tb.W, (int)blockDim.x};
  float acc_re[1] = {0.0f}, acc_im[1] = {0.0f};
  for (int g = 0; g < tb.G; ++g) accumulate_graph<kAllStages>(tb, g, rows, acc_re, acc_im);
  out[b * 2] = acc_re[0];
  out[b * 2 + 1] = acc_im[0];
}

int wide_threads(int G) {
  const int lanes = 32 * ((G + 31) / 32);
  return lanes < kWideThreads ? lanes : kWideThreads;
}

template <int W, unsigned M>
void launch_wide(const uint8_t* x, long long B, int P, const Tables& tb, float* out,
                 cudaStream_t stream) {
  const long long blocks = (B + kWideShots - 1) / kWideShots;
  sample_eval_wide<W, M><<<(unsigned)blocks, wide_threads(tb.G), 0, stream>>>(x, B, P, tb, out);
}

template <int W>
void launch_packed(const uint8_t* x, long long B, int P, const Tables& tb, int config, float* out,
                   cudaStream_t stream) {
  if (config == kWide) {
    launch_wide<W, kAllStages>(x, B, P, tb, out, stream);
  } else {
    const long long blocks = (B + kSmallThreads - 1) / kSmallThreads;
    sample_eval_small<W><<<(unsigned)blocks, kSmallThreads, 0, stream>>>(x, B, P, tb, out);
  }
}

// Dynamic shared memory above the default 48 KB needs the kernel's consent.
template <class Kernel>
cudaError_t allow_shared(Kernel kernel, size_t bytes) {
  if (bytes <= (size_t)kDefaultSharedBytes) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

cudaError_t launch_per_term(const uint8_t* x, long long B, int P, const Tables& tb, int config,
                            float* out, cudaStream_t stream) {
  if (config == kPerTermWide) {
    const size_t bytes = sizeof(uint32_t) * kWideShots * tb.W;
    const cudaError_t err = allow_shared(sample_eval_per_term_wide, bytes);
    if (err != cudaSuccess) return err;
    const long long blocks = (B + kWideShots - 1) / kWideShots;
    sample_eval_per_term_wide<<<(unsigned)blocks, wide_threads(tb.G), bytes, stream>>>(x, B, P, tb,
                                                                                      out);
  } else {
    // Fewer shots a block where a row is long, down to one warp.
    int threads = kSmallThreads;
    while (threads > 32 && sizeof(uint32_t) * threads * tb.W > (size_t)kDefaultSharedBytes) threads /= 2;
    const size_t bytes = sizeof(uint32_t) * threads * tb.W;
    const cudaError_t err = allow_shared(sample_eval_per_term_small, bytes);
    if (err != cudaSuccess) return err;
    const long long blocks = (B + threads - 1) / threads;
    sample_eval_per_term_small<<<(unsigned)blocks, threads, bytes, stream>>>(x, B, P, tb, out);
  }
  return cudaSuccess;
}

// Stage masks of the ablation variants, in the order of
// kernels/sample_eval.py::ABLATION_VARIANTS (names of dev/kernel_ablate.py).
template <int W>
int launch_ablate(const uint8_t* x, long long B, int P, const Tables& tb, int variant, float* out,
                  cudaStream_t stream) {
  switch (variant) {
    case 0: launch_wide<W, 0>(x, B, P, tb, out, stream); break;                            // empty
    case 1: launch_wide<W, kP1>(x, B, P, tb, out, stream); break;                          // par1
    case 2: launch_wide<W, kP1 | kP2 | kP3 | kP4>(x, B, P, tb, out, stream); break;        // par-all
    case 3: launch_wide<W, kP1 | kT1>(x, B, P, tb, out, stream); break;                    // par1+T1
    case 4: launch_wide<W, kP1 | kT1 | kP2 | kT2 | kP3 | kT3>(x, B, P, tb, out, stream); break;  // par+T1..T3
    case 5: launch_wide<W, kAllStages>(x, B, P, tb, out, stream); break;                   // full
    default: return (int)cudaErrorInvalidValue;
  }
  return 0;
}

}  // namespace

// x: (B, P) uint8 rows; flat: the rung's table buffer; out: (B, 2) float32.
// config: 0 small, 1 wide (W <= 4), 2 per-term small, 3 per-term wide (any
// W). Returns cudaGetLastError() after the launch (0 on success); the caller
// raises on anything else.
extern "C" int tsim_sample_eval(const void* x, long long B, int P, const void* flat, int G,
                                int T1, int T2, int T3, int T4, int W, int config, void* out,
                                void* stream) {
  if (B <= 0 || G <= 0 || W <= 0) return (int)cudaErrorInvalidValue;
  const Tables tb = make_tables(static_cast<const int32_t*>(flat), G, T1, T2, T3, T4, W);
  const uint8_t* xp = static_cast<const uint8_t*>(x);
  float* op = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (config == kPerTermSmall || config == kPerTermWide) {
    const cudaError_t err = launch_per_term(xp, B, P, tb, config, op, s);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
  }
  if (config != kSmall && config != kWide) return (int)cudaErrorInvalidValue;
  switch (W) {
    case 1: launch_packed<1>(xp, B, P, tb, config, op, s); break;
    case 2: launch_packed<2>(xp, B, P, tb, config, op, s); break;
    case 3: launch_packed<3>(xp, B, P, tb, config, op, s); break;
    case 4: launch_packed<4>(xp, B, P, tb, config, op, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// The wide kernel with the stages of ablation variant `variant` (0 empty,
// 1 par1, 2 par-all, 3 par1+T1, 4 par+T1..T3, 5 full); W <= 4.
extern "C" int tsim_sample_eval_ablate(const void* x, long long B, int P, const void* flat, int G,
                                       int T1, int T2, int T3, int T4, int W, int variant,
                                       void* out, void* stream) {
  if (B <= 0 || G <= 0) return (int)cudaErrorInvalidValue;
  const Tables tb = make_tables(static_cast<const int32_t*>(flat), G, T1, T2, T3, T4, W);
  const uint8_t* xp = static_cast<const uint8_t*>(x);
  float* op = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err = 0;
  switch (W) {
    case 1: err = launch_ablate<1>(xp, B, P, tb, variant, op, s); break;
    case 2: err = launch_ablate<2>(xp, B, P, tb, variant, op, s); break;
    case 3: err = launch_ablate<3>(xp, B, P, tb, variant, op, s); break;
    case 4: err = launch_ablate<4>(xp, B, P, tb, variant, op, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != 0) return err;
  return (int)cudaGetLastError();
}

extern "C" const char* tsim_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
