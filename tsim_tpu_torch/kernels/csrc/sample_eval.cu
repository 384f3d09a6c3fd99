// f32 sampling evaluator: per shot row, the sum over graphs of the complex
// product of four term families times a prefolded prefactor.
//
// Replaces the TPU kernels tsim_tpu/compile/pallas_sample.py::_kernel_sample
// (wide layout) and ::_kernel_sample_t (transposed small-G layout), whose
// shared body is _product_body_sample_packed. On the TPU every parity is a
// bf16 matrix-unit dot of the shot's 0/1 parameters against the term's
// parameter mask. Here a shot's parameters are packed into W <= 4 32-bit
// words and every parity is __popc(x & w) & 1, so no parity matrix is
// formed at all.
//
// What bounds it on an H100: arithmetic. Per (shot, graph) pair it does one
// popcount per parity row (T1 + T2 + 2 T3 + 2 T4 of them) and about ten f32
// operations per term, and it reads only P bytes of input and writes 8
// bytes of output per shot; the tables of one rung are a few tens of KB and
// stay in L1/L2. Integer popcount has a lower issue rate than f32 FMA, so
// the popcounts and the table loads are the limit.
//
// What the design does about it: the "wide" configuration (G >= 24) spreads
// graphs over the threads of a block and gives each thread NS shots, so each
// table entry it loads is reused NS times and the packed shot words sit in
// registers; a block reduction (warp shuffles, then shared memory) sums
// over graphs, and no sum is carried across blocks. The "small"
// configuration (G < 24) gives each thread one shot and loops over all
// graphs; every thread of a warp reads the same table entry, which L1
// broadcasts. The ragged edge of the batch is masked in both.
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
  int G, T1, T2, T3, T4;
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
  return t;
}

template <int W>
__device__ __forceinline__ void load_words(const uint32_t* src, uint32_t (&w)[W]) {
#pragma unroll
  for (int i = 0; i < W; ++i) w[i] = __ldg(src + i);
}

// Parity of popcount(x & w) over W words.
template <int W>
__device__ __forceinline__ int parity(const uint32_t (&x)[W], const uint32_t (&w)[W]) {
  uint32_t acc = 0;
#pragma unroll
  for (int i = 0; i < W; ++i) acc ^= x[i] & w[i];
  return __popc(acc) & 1;
}

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

// Adds graph g's product, for each of NS shots, into (acc_re, acc_im).
template <int W, int NS>
__device__ __forceinline__ void accumulate_graph(const Tables& tb, int g,
                                                 const uint32_t (&x)[NS][W],
                                                 float (&acc_re)[NS],
                                                 float (&acc_im)[NS]) {
  const int G = tb.G;
  float re[NS], im[NS];
#pragma unroll
  for (int k = 0; k < NS; ++k) {
    re[k] = 1.0f;
    im[k] = 0.0f;
  }
  uint32_t w[W], w2[W];

  // Node phases: (1 + c) - 2c p, s - 2s p; dead slots have c = s = 0.
  for (int t = 0; t < tb.T1; ++t) {
    const int i = t * G + g;
    const float c = __ldg(tb.np_cos + i), s = __ldg(tb.np_sin + i);
    load_words<W>(tb.np_w + (long long)i * W, w);
#pragma unroll
    for (int k = 0; k < NS; ++k) {
      const float p = (float)parity<W>(x[k], w);
      cmul(re[k], im[k], (1.0f + c) - (2.0f * c) * p, s - (2.0f * s) * p);
    }
  }

  // Half-pi phases: one rotation by w^(sum coeff * parity mod 8).
  if (tb.T2) {
    int tot[NS];
#pragma unroll
    for (int k = 0; k < NS; ++k) tot[k] = 0;
    for (int t = 0; t < tb.T2; ++t) {
      const int i = t * G + g;
      const int coeff = __ldg(tb.hp_c + i);
      load_words<W>(tb.hp_w + (long long)i * W, w);
#pragma unroll
      for (int k = 0; k < NS; ++k) tot[k] += coeff * parity<W>(x[k], w);
    }
#pragma unroll
    for (int k = 0; k < NS; ++k) rot_staged(re[k], im[k], tot[k] & 7);
  }

  // Pi products: sign (-1)^(XOR over terms of psi & phi).
  if (tb.T3) {
    int sgn[NS];
#pragma unroll
    for (int k = 0; k < NS; ++k) sgn[k] = 0;
    for (int t = 0; t < tb.T3; ++t) {
      const int i = t * G + g;
      const int pc = __ldg(tb.psi_c + i) & 1, qc = __ldg(tb.phi_c + i) & 1;
      load_words<W>(tb.psi_w + (long long)i * W, w);
      load_words<W>(tb.phi_w + (long long)i * W, w2);
#pragma unroll
      for (int k = 0; k < NS; ++k)
        sgn[k] ^= (pc ^ parity<W>(x[k], w)) & (qc ^ parity<W>(x[k], w2));
    }
#pragma unroll
    for (int k = 0; k < NS; ++k) {
      if (sgn[k]) {
        re[k] = -re[k];
        im[k] = -im[k];
      }
    }
  }

  // Phase pairs: 1 + s_a w^alpha + s_b w^beta - s_a s_b w^(alpha+beta).
  for (int t = 0; t < tb.T4; ++t) {
    const int i = t * G + g;
    const float ca = __ldg(tb.ca + i), sa = __ldg(tb.sa + i);
    const float cb = __ldg(tb.cb + i), sb = __ldg(tb.sb + i);
    const float cg = __ldg(tb.cg + i), sg = __ldg(tb.sg + i);
    load_words<W>(tb.a_w + (long long)i * W, w);
    load_words<W>(tb.b_w + (long long)i * W, w2);
#pragma unroll
    for (int k = 0; k < NS; ++k) {
      const float s_a = 1.0f - 2.0f * (float)parity<W>(x[k], w);
      const float s_b = 1.0f - 2.0f * (float)parity<W>(x[k], w2);
      const float s_g = s_a * s_b;
      cmul(re[k], im[k], 1.0f + s_a * ca + s_b * cb - s_g * cg,
           s_a * sa + s_b * sb - s_g * sg);
    }
  }

  const float pr = __ldg(tb.pre_re + g), pi = __ldg(tb.pre_im + g);
#pragma unroll
  for (int k = 0; k < NS; ++k) {
    acc_re[k] += re[k] * pr - im[k] * pi;
    acc_im[k] += re[k] * pi + im[k] * pr;
  }
}

// Packs row b's P parameter bytes (bit 0 of each) into W words.
template <int W>
__device__ __forceinline__ void pack_row(const uint8_t* __restrict__ x, long long b, int P,
                                         uint32_t (&out)[W]) {
  const uint8_t* row = x + b * P;
#pragma unroll
  for (int i = 0; i < W; ++i) {
    uint32_t word = 0;
    const int lo = 32 * i, hi = min(P, lo + 32);
    for (int p = lo; p < hi; ++p) word |= (uint32_t)(row[p] & 1) << (p - lo);
    out[i] = word;
  }
}

// Wide configuration: block = NS shots x up to kWideThreads graph lanes.
template <int W>
__global__ void __launch_bounds__(kWideThreads)
    sample_eval_wide(const uint8_t* __restrict__ x, long long B, int P, Tables tb,
                     float* __restrict__ out) {
  constexpr int NS = kWideShots;
  __shared__ uint32_t xs[NS][W];
  __shared__ float red[kWideThreads / 32][NS][2];
  const long long b0 = (long long)blockIdx.x * NS;
  const int tid = threadIdx.x;
  if (tid < NS) {
    uint32_t words[W];
    if (b0 + tid < B) {
      pack_row<W>(x, b0 + tid, P, words);
    } else {
#pragma unroll
      for (int i = 0; i < W; ++i) words[i] = 0;
    }
#pragma unroll
    for (int i = 0; i < W; ++i) xs[tid][i] = words[i];
  }
  __syncthreads();

  uint32_t xr[NS][W];
#pragma unroll
  for (int k = 0; k < NS; ++k)
#pragma unroll
    for (int i = 0; i < W; ++i) xr[k][i] = xs[k][i];

  float acc_re[NS], acc_im[NS];
#pragma unroll
  for (int k = 0; k < NS; ++k) {
    acc_re[k] = 0.0f;
    acc_im[k] = 0.0f;
  }
  for (int g = tid; g < tb.G; g += blockDim.x) accumulate_graph<W, NS>(tb, g, xr, acc_re, acc_im);

  const int lane = tid & 31, warp = tid >> 5;
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

// Small configuration: one thread per shot, looping over all graphs.
template <int W>
__global__ void __launch_bounds__(kSmallThreads)
    sample_eval_small(const uint8_t* __restrict__ x, long long B, int P, Tables tb,
                      float* __restrict__ out) {
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  uint32_t xr[1][W];
  pack_row<W>(x, b, P, xr[0]);
  float acc_re[1] = {0.0f}, acc_im[1] = {0.0f};
  for (int g = 0; g < tb.G; ++g) accumulate_graph<W, 1>(tb, g, xr, acc_re, acc_im);
  out[b * 2] = acc_re[0];
  out[b * 2 + 1] = acc_im[0];
}

template <int W>
void launch(const uint8_t* x, long long B, int P, const Tables& tb, int wide, float* out,
            cudaStream_t stream) {
  if (wide) {
    const int lanes = 32 * ((tb.G + 31) / 32);
    const int threads = lanes < kWideThreads ? lanes : kWideThreads;
    const long long blocks = (B + kWideShots - 1) / kWideShots;
    sample_eval_wide<W><<<(unsigned)blocks, threads, 0, stream>>>(x, B, P, tb, out);
  } else {
    const long long blocks = (B + kSmallThreads - 1) / kSmallThreads;
    sample_eval_small<W><<<(unsigned)blocks, kSmallThreads, 0, stream>>>(x, B, P, tb, out);
  }
}

}  // namespace

// x: (B, P) uint8 rows; flat: the rung's table buffer; out: (B, 2) float32.
// wide selects the launch configuration. Returns cudaGetLastError() after
// the launch (0 on success); the caller raises on anything else.
extern "C" int tsim_sample_eval(const void* x, long long B, int P, const void* flat, int G,
                                int T1, int T2, int T3, int T4, int W, int wide, void* out,
                                void* stream) {
  if (B <= 0 || G <= 0) return (int)cudaErrorInvalidValue;
  const Tables tb = make_tables(static_cast<const int32_t*>(flat), G, T1, T2, T3, T4, W);
  const uint8_t* xp = static_cast<const uint8_t*>(x);
  float* op = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (W) {
    case 1: launch<1>(xp, B, P, tb, wide, op, s); break;
    case 2: launch<2>(xp, B, P, tb, wide, op, s); break;
    case 3: launch<3>(xp, B, P, tb, wide, op, s); break;
    case 4: launch<4>(xp, B, P, tb, wide, op, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* tsim_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
