// Exact evaluator: per shot row and per graph, the exact Z[w] * 2^p product
// of the four term families and the static prefactor, then a sum over
// graphs, either exact (integer coefficients and a power, K5/K7a) or in
// float32 after an approximate complex factor per graph (K6/K7b).
//
// Replaces the TPU kernels of tsim_tpu/compile/pallas_evaluate.py:
//   _kernel_exact    (K5, wide layout)       -> exact_wide
//   _kernel_approx   (K6, wide layout)       -> approx_wide
//   _kernel_exact_t  (K7a, small-G layout)   -> exact_small
//   _kernel_approx_t (K7b, small-G layout)   -> approx_small
// Their shared body is _product_body / _product_body_t. On the TPU every
// parity is a matrix-unit dot of the shot's 0/1 parameters against the
// term's mask; here a shot's parameters are packed into W <= 4 32-bit words
// and every parity is __popc(x & w) & 1.
//
// The product follows _product_body step for step, so that the int32
// coefficients grow as they do in tsim_tpu: per node-phase term
// acc += rot(acc, phase + 4 parity) under the graph's count, then a reduce
// step (no all-zero guard, even on dead slots); the half-pi rotation by the
// summed phase; the pi-product sign; per phase-pair term
// acc + rot_a + rot_b - rot_(a+b) under the count, then a reduce step; the
// prefactor rotation; the floatfactor product and a reduce step; + power2.
// Trailing dead rows of the half-pi and pi-product families (hp_len,
// pp_len) are skipped: they contribute nothing.
//
// Exact sums shift to the smaller power (the shift clipped at 30) and then
// take a reduce step, as the TPU kernel does; an exactly zero summand is
// skipped, so its drifted power never enters the alignment. The kernels
// write integers only: the float conversion is the plain version's own
// torch code (compile/evaluate.py), so magnitudes agree bit for bit.
//
// What bounds it on an H100: integer arithmetic. Per (shot, graph) pair it
// does one popcount per parity row and a few dozen integer operations per
// term (rotations are selects and adds), and it reads P bytes per shot.
// The tables of one rung are a few hundred KB at most and stay in L1/L2.
//
// What the design does about it: "wide" (G >= 24) gives each thread one
// graph of a tile of up to 128 graphs and NS shots, so every table entry
// it loads serves NS shots; the tile's products are summed in shared
// memory (a tree for the exact sum, warp shuffles for the float sum) and
// each block writes one partial per shot and graph tile, combined in torch.
// "small" (G < 24) gives each thread one shot and loops over the graphs;
// the threads of a warp read the same table entry, which L1 broadcasts.
//
// Build with -O3 and without --use_fast_math or -ftz.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kInvSqrt2 = 0.7071067811865476f;
constexpr int kMaxTile = 128;  // graphs per wide block (its threads)
constexpr int kWideShots = 8;  // shots per wide block (NS)
constexpr int kSmallThreads = 128;

// Pointers into the flat table buffer; the segment order matches
// tsim_tpu_torch/compile/exact_tables.py::exact_table_layout.
struct Tables {
  const int32_t* np_phase;
  const uint32_t* np_w;
  const int32_t* np_cnt;
  const int32_t* hp_c;
  const uint32_t* hp_w;
  const int32_t* hp_len;
  const int32_t* psi_c;
  const int32_t* phi_c;
  const uint32_t* psi_w;
  const uint32_t* phi_w;
  const int32_t* pp_len;
  const int32_t* qa;
  const int32_t* qb;
  const uint32_t* qa_w;
  const uint32_t* qb_w;
  const int32_t* qp_cnt;
  const int32_t* pf_phase;
  const int32_t* pf_ff;
  const int32_t* pf_pow;
  const float* approx;  // (2, G), re then im; null for the exact finisher
  int G, T1, T2, T3, T4;
};

Tables make_tables(const int32_t* flat, const float* approx, int G, int T1, int T2, int T3,
                   int T4, int W) {
  const int32_t* p = flat;
  auto take = [&p](long long n) {
    const int32_t* q = p;
    p += n;
    return q;
  };
  auto words = [&take](long long n) { return reinterpret_cast<const uint32_t*>(take(n)); };
  const long long g1 = (long long)T1 * G, g2 = (long long)T2 * G;
  const long long g3 = (long long)T3 * G, g4 = (long long)T4 * G;
  Tables t;
  t.np_phase = take(g1);
  t.np_w = words(g1 * W);
  t.np_cnt = take(G);
  t.hp_c = take(g2);
  t.hp_w = words(g2 * W);
  t.hp_len = take(G);
  t.psi_c = take(g3);
  t.phi_c = take(g3);
  t.psi_w = words(g3 * W);
  t.phi_w = words(g3 * W);
  t.pp_len = take(G);
  t.qa = take(g4);
  t.qb = take(g4);
  t.qa_w = words(g4 * W);
  t.qb_w = words(g4 * W);
  t.qp_cnt = take(G);
  t.pf_phase = take(G);
  t.pf_ff = take(4LL * G);
  t.pf_pow = take(G);
  t.approx = approx;
  t.G = G;
  t.T1 = T1;
  t.T2 = T2;
  t.T3 = T3;
  t.T4 = T4;
  return t;
}

// An exact value (c0 + c1 w + c2 w^2 + c3 w^3) * 2^p.
struct Zw {
  int c[4];
  int p;
};

__device__ __forceinline__ bool is_zero(const Zw& v) {
  return (v.c[0] | v.c[1] | v.c[2] | v.c[3]) == 0;
}

// _k_reduce_step: halve when all four coefficients are even (no zero guard).
__device__ __forceinline__ void reduce_step(Zw& v) {
  if (((v.c[0] | v.c[1] | v.c[2] | v.c[3]) & 1) == 0) {
#pragma unroll
    for (int j = 0; j < 4; ++j) v.c[j] >>= 1;
    v.p += 1;
  }
}

// _k_rot: the coefficients of w^k * a, staged on the bits of k.
__device__ __forceinline__ void rot(const int (&a)[4], int k, int (&r)[4]) {
  int a0 = a[0], a1 = a[1], a2 = a[2], a3 = a[3];
  if (k & 1) {
    const int t = a3;
    a3 = a2;
    a2 = a1;
    a1 = a0;
    a0 = -t;
  }
  if (k & 2) {
    const int t0 = a0, t1 = a1;
    a0 = -a2;
    a1 = -a3;
    a2 = t0;
    a3 = t1;
  }
  if (k & 4) {
    a0 = -a0;
    a1 = -a1;
    a2 = -a2;
    a3 = -a3;
  }
  r[0] = a0;
  r[1] = a1;
  r[2] = a2;
  r[3] = a3;
}

// Aligned exact add, b into a: shift to the smaller power (clipped at 30),
// then a reduce step. Exact zeros are skipped.
__device__ __forceinline__ void add_exact(Zw& a, const Zw& b) {
  if (is_zero(b)) return;
  if (is_zero(a)) {
    a = b;
    return;
  }
  const int s1 = 1 << min(max(a.p - b.p, 0), 30);
  const int s2 = 1 << min(max(b.p - a.p, 0), 30);
#pragma unroll
  for (int j = 0; j < 4; ++j) a.c[j] = a.c[j] * s1 + b.c[j] * s2;
  a.p = min(a.p, b.p);
  reduce_step(a);
}

template <int W>
__device__ __forceinline__ void load_words(const uint32_t* src, uint32_t (&w)[W]) {
#pragma unroll
  for (int i = 0; i < W; ++i) w[i] = __ldg(src + i);
}

template <int W>
__device__ __forceinline__ int parity(const uint32_t (&x)[W], const uint32_t (&w)[W]) {
  uint32_t acc = 0;
#pragma unroll
  for (int i = 0; i < W; ++i) acc ^= x[i] & w[i];
  return __popc(acc) & 1;
}

// _product_body for graph g and NS shots: v[k] = the exact product of shot k.
template <int W, int NS>
__device__ __forceinline__ void product(const Tables& tb, int g, const uint32_t (&x)[NS][W],
                                        Zw (&v)[NS]) {
  const int G = tb.G;
#pragma unroll
  for (int k = 0; k < NS; ++k) {
    v[k].c[0] = 1;
    v[k].c[1] = v[k].c[2] = v[k].c[3] = 0;
    v[k].p = 0;
  }
  uint32_t w[W], w2[W];
  int r[4], ra[4], rb[4];

  // Node phases: acc *= 1 + w^(phase + 4 parity), i.e. acc + rot(acc).
  const int cnt1 = __ldg(tb.np_cnt + g);
  for (int t = 0; t < tb.T1; ++t) {
    const int i = t * G + g;
    if (t < cnt1) {
      const int ph = __ldg(tb.np_phase + i);
      load_words<W>(tb.np_w + (long long)i * W, w);
#pragma unroll
      for (int k = 0; k < NS; ++k) {
        rot(v[k].c, (ph + 4 * parity<W>(x[k], w)) & 7, r);
#pragma unroll
        for (int j = 0; j < 4; ++j) v[k].c[j] += r[j];
      }
    }
#pragma unroll
    for (int k = 0; k < NS; ++k) reduce_step(v[k]);
  }

  // Half-pi phases: one rotation by the summed phase mod 8.
  if (tb.T2) {
    int tot[NS];
#pragma unroll
    for (int k = 0; k < NS; ++k) tot[k] = 0;
    const int len = __ldg(tb.hp_len + g);
    for (int t = 0; t < len; ++t) {
      const int i = t * G + g;
      const int coeff = __ldg(tb.hp_c + i);
      load_words<W>(tb.hp_w + (long long)i * W, w);
#pragma unroll
      for (int k = 0; k < NS; ++k) tot[k] += coeff * parity<W>(x[k], w);
    }
#pragma unroll
    for (int k = 0; k < NS; ++k) {
      rot(v[k].c, tot[k] & 7, r);
#pragma unroll
      for (int j = 0; j < 4; ++j) v[k].c[j] = r[j];
    }
  }

  // Pi products: sign (-1)^(XOR over terms of psi & phi).
  if (tb.T3) {
    int e[NS];
#pragma unroll
    for (int k = 0; k < NS; ++k) e[k] = 0;
    const int len = __ldg(tb.pp_len + g);
    for (int t = 0; t < len; ++t) {
      const int i = t * G + g;
      const int pc = __ldg(tb.psi_c + i), qc = __ldg(tb.phi_c + i);
      load_words<W>(tb.psi_w + (long long)i * W, w);
      load_words<W>(tb.phi_w + (long long)i * W, w2);
#pragma unroll
      for (int k = 0; k < NS; ++k) e[k] ^= (pc ^ parity<W>(x[k], w)) & (qc ^ parity<W>(x[k], w2));
    }
#pragma unroll
    for (int k = 0; k < NS; ++k) {
      const int sign = 1 - 2 * e[k];
#pragma unroll
      for (int j = 0; j < 4; ++j) v[k].c[j] *= sign;
    }
  }

  // Phase pairs: acc * (1 + w^a + w^b - w^(a+b)), three rotations of acc.
  const int cnt4 = __ldg(tb.qp_cnt + g);
  for (int t = 0; t < tb.T4; ++t) {
    const int i = t * G + g;
    if (t < cnt4) {
      const int al = __ldg(tb.qa + i), be = __ldg(tb.qb + i);
      load_words<W>(tb.qa_w + (long long)i * W, w);
      load_words<W>(tb.qb_w + (long long)i * W, w2);
#pragma unroll
      for (int k = 0; k < NS; ++k) {
        const int a = (al + 4 * parity<W>(x[k], w)) & 7;
        const int b = (be + 4 * parity<W>(x[k], w2)) & 7;
        rot(v[k].c, a, ra);
        rot(v[k].c, b, rb);
        rot(v[k].c, (a + b) & 7, r);
#pragma unroll
        for (int j = 0; j < 4; ++j) v[k].c[j] += ra[j] + rb[j] - r[j];
      }
    }
#pragma unroll
    for (int k = 0; k < NS; ++k) reduce_step(v[k]);
  }

  // Static prefactor: w^phase, the exact floatfactor, 2^power2.
  const int ph = __ldg(tb.pf_phase + g) & 7;
  const int f0 = __ldg(tb.pf_ff + g), f1 = __ldg(tb.pf_ff + G + g);
  const int f2 = __ldg(tb.pf_ff + 2 * G + g), f3 = __ldg(tb.pf_ff + 3 * G + g);
  const int pw = __ldg(tb.pf_pow + g);
#pragma unroll
  for (int k = 0; k < NS; ++k) {
    rot(v[k].c, ph, r);
    v[k].c[0] = r[0] * f0 - r[1] * f3 - r[2] * f2 - r[3] * f1;
    v[k].c[1] = r[0] * f1 + r[1] * f0 - r[2] * f3 - r[3] * f2;
    v[k].c[2] = r[0] * f2 + r[1] * f1 + r[2] * f0 - r[3] * f3;
    v[k].c[3] = r[0] * f3 + r[1] * f2 + r[2] * f1 + r[3] * f0;
    reduce_step(v[k]);
    v[k].p += pw;
  }
}

// _kernel_approx's per-graph float32 term: (re, im) * 2^p times the graph's
// approximate complex factor; _zero_power pins an exact zero's power to 0.
__device__ __forceinline__ void approx_term(const Tables& tb, int g, const Zw& v, float& re,
                                            float& im) {
  const float c0 = (float)v.c[0], c1 = (float)v.c[1];
  const float c2 = (float)v.c[2], c3 = (float)v.c[3];
  const float r = c0 + (c1 - c3) * kInvSqrt2;
  const float i = c2 + (c1 + c3) * kInvSqrt2;
  const float scale = ldexpf(1.0f, is_zero(v) ? 0 : v.p);
  const float fre = __ldg(tb.approx + g) * scale;
  const float fim = __ldg(tb.approx + tb.G + g) * scale;
  re = r * fre - i * fim;
  im = r * fim + i * fre;
}

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

// Loads the block's NS shots into registers (zeros past the batch's end).
template <int W, int NS>
__device__ __forceinline__ void load_shots(const uint8_t* __restrict__ x, long long B, int P,
                                           long long b0, uint32_t (&xr)[NS][W]) {
  __shared__ uint32_t xs[NS][W];
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
#pragma unroll
  for (int k = 0; k < NS; ++k)
#pragma unroll
    for (int i = 0; i < W; ++i) xr[k][i] = xs[k][i];
}

// K5: block = NS shots x one tile of blockDim.x (a power of two) graphs.
// Writes out_c[tile][b][0..3] and out_p[tile][b].
template <int W>
__global__ void __launch_bounds__(kMaxTile)
    exact_wide(const uint8_t* __restrict__ x, long long B, int P, Tables tb,
               int32_t* __restrict__ out_c, int32_t* __restrict__ out_p) {
  constexpr int NS = kWideShots;
  __shared__ Zw red[NS][kMaxTile];
  const long long b0 = (long long)blockIdx.x * NS;
  const int tid = threadIdx.x, tile = blockIdx.y;
  const int g = tile * blockDim.x + tid;
  uint32_t xr[NS][W];
  load_shots<W, NS>(x, B, P, b0, xr);

  Zw v[NS];
  if (g < tb.G) {
    product<W, NS>(tb, g, xr, v);
  } else {
#pragma unroll
    for (int k = 0; k < NS; ++k) v[k] = Zw{{0, 0, 0, 0}, 0};
  }
#pragma unroll
  for (int k = 0; k < NS; ++k) red[k][tid] = v[k];
  __syncthreads();
  for (int s = blockDim.x >> 1; s > 0; s >>= 1) {
    if (tid < s) {
#pragma unroll
      for (int k = 0; k < NS; ++k) add_exact(red[k][tid], red[k][tid + s]);
    }
    __syncthreads();
  }
  if (tid < NS && b0 + tid < B) {
    const Zw& s = red[tid][0];
    const long long o = (long long)tile * B + b0 + tid;
#pragma unroll
    for (int j = 0; j < 4; ++j) out_c[o * 4 + j] = s.c[j];
    out_p[o] = is_zero(s) ? 0 : s.p;
  }
}

// K6: as K5, with the float32 finisher; writes out[tile][b][re, im].
template <int W>
__global__ void __launch_bounds__(kMaxTile)
    approx_wide(const uint8_t* __restrict__ x, long long B, int P, Tables tb,
                float* __restrict__ out) {
  constexpr int NS = kWideShots;
  __shared__ float red[kMaxTile / 32][NS][2];
  const long long b0 = (long long)blockIdx.x * NS;
  const int tid = threadIdx.x, tile = blockIdx.y;
  const int g = tile * blockDim.x + tid;
  uint32_t xr[NS][W];
  load_shots<W, NS>(x, B, P, b0, xr);

  float re[NS], im[NS];
  if (g < tb.G) {
    Zw v[NS];
    product<W, NS>(tb, g, xr, v);
#pragma unroll
    for (int k = 0; k < NS; ++k) approx_term(tb, g, v[k], re[k], im[k]);
  } else {
#pragma unroll
    for (int k = 0; k < NS; ++k) re[k] = im[k] = 0.0f;
  }
  const int lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int k = 0; k < NS; ++k) {
    float r = re[k], m = im[k];
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
    if (b0 + k < B) out[((long long)tile * B + b0 + k) * 2 + c] = s;
  }
}

// K7a: one thread per shot, looping over all graphs; out_c[b][4], out_p[b].
template <int W>
__global__ void __launch_bounds__(kSmallThreads)
    exact_small(const uint8_t* __restrict__ x, long long B, int P, Tables tb,
                int32_t* __restrict__ out_c, int32_t* __restrict__ out_p) {
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  uint32_t xr[1][W];
  pack_row<W>(x, b, P, xr[0]);
  Zw acc{{0, 0, 0, 0}, 0};
  for (int g = 0; g < tb.G; ++g) {
    Zw v[1];
    product<W, 1>(tb, g, xr, v);
    add_exact(acc, v[0]);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) out_c[b * 4 + j] = acc.c[j];
  out_p[b] = is_zero(acc) ? 0 : acc.p;
}

// K7b: one thread per shot, float32 sum over all graphs; out[b][re, im].
template <int W>
__global__ void __launch_bounds__(kSmallThreads)
    approx_small(const uint8_t* __restrict__ x, long long B, int P, Tables tb,
                 float* __restrict__ out) {
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  uint32_t xr[1][W];
  pack_row<W>(x, b, P, xr[0]);
  float sre = 0.0f, sim = 0.0f;
  for (int g = 0; g < tb.G; ++g) {
    Zw v[1];
    product<W, 1>(tb, g, xr, v);
    float re, im;
    approx_term(tb, g, v[0], re, im);
    sre += re;
    sim += im;
  }
  out[b * 2] = sre;
  out[b * 2 + 1] = sim;
}

template <int W>
void launch(const uint8_t* x, long long B, int P, const Tables& tb, int wide, int tile,
            int32_t* out_c, int32_t* out_p, float* out_f, cudaStream_t stream) {
  if (wide) {
    const dim3 grid((unsigned)((B + kWideShots - 1) / kWideShots),
                    (unsigned)((tb.G + tile - 1) / tile));
    if (out_f)
      approx_wide<W><<<grid, tile, 0, stream>>>(x, B, P, tb, out_f);
    else
      exact_wide<W><<<grid, tile, 0, stream>>>(x, B, P, tb, out_c, out_p);
  } else {
    const unsigned blocks = (unsigned)((B + kSmallThreads - 1) / kSmallThreads);
    if (out_f)
      approx_small<W><<<blocks, kSmallThreads, 0, stream>>>(x, B, P, tb, out_f);
    else
      exact_small<W><<<blocks, kSmallThreads, 0, stream>>>(x, B, P, tb, out_c, out_p);
  }
}

int dispatch(const void* x, long long B, int P, const void* flat, const void* approx, int G,
             int T1, int T2, int T3, int T4, int W, int wide, int tile, void* out_c,
             void* out_p, void* out_f, void* stream) {
  if (B <= 0 || G <= 0) return (int)cudaErrorInvalidValue;
  if (wide && (tile < 32 || tile > kMaxTile || (tile & (tile - 1)) != 0))
    return (int)cudaErrorInvalidValue;
  const Tables tb = make_tables(static_cast<const int32_t*>(flat),
                                static_cast<const float*>(approx), G, T1, T2, T3, T4, W);
  const uint8_t* xp = static_cast<const uint8_t*>(x);
  int32_t* oc = static_cast<int32_t*>(out_c);
  int32_t* op = static_cast<int32_t*>(out_p);
  float* of = static_cast<float*>(out_f);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (W) {
    case 1: launch<1>(xp, B, P, tb, wide, tile, oc, op, of, s); break;
    case 2: launch<2>(xp, B, P, tb, wide, tile, oc, op, of, s); break;
    case 3: launch<3>(xp, B, P, tb, wide, tile, oc, op, of, s); break;
    case 4: launch<4>(xp, B, P, tb, wide, tile, oc, op, of, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Exact finisher (K5 wide, K7a small). x: (B, P) uint8 rows; flat: the
// rung's int32 table buffer; out_c: (n_tiles, B, 4) int32; out_p:
// (n_tiles, B) int32, n_tiles = ceil(G / tile) when wide, else 1. Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int tsim_exact_eval(const void* x, long long B, int P, const void* flat, int G,
                               int T1, int T2, int T3, int T4, int W, int wide, int tile,
                               void* out_c, void* out_p, void* stream) {
  return dispatch(x, B, P, flat, nullptr, G, T1, T2, T3, T4, W, wide, tile, out_c, out_p,
                  nullptr, stream);
}

// Approximate finisher (K6 wide, K7b small). approx: (2, G) float32;
// out: (n_tiles, B, 2) float32.
extern "C" int tsim_approx_eval(const void* x, long long B, int P, const void* flat,
                                const void* approx, int G, int T1, int T2, int T3, int T4,
                                int W, int wide, int tile, void* out, void* stream) {
  if (approx == nullptr) return (int)cudaErrorInvalidValue;
  return dispatch(x, B, P, flat, approx, G, T1, T2, T3, T4, W, wide, tile, nullptr, nullptr,
                  out, stream);
}
