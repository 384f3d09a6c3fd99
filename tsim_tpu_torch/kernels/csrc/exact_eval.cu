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
// term's mask. Here the wide kernels form parities bit-sliced over the 128
// shots of a block (bitsliced.cuh: bit planes in shared memory, an XOR per
// listed mask bit per 32 shots, any number of parameters), and the small ones
// as __popc(x & w) & 1 over the row's packed words, held in registers up to
// four words and in shared memory beyond (word i of thread t at
// xs[i * blockDim.x + t], the block shrunk for long rows).
//
// The product follows _product_body step for step, so that the int32
// coefficients grow as they do in tsim_tpu: per node-phase term
// acc += rot(acc, phase + 4 parity) under the graph's count, then a reduce
// step (no all-zero guard, even on dead slots); the half-pi rotation by the
// summed phase; the pi-product sign; per phase-pair term
// acc + rot_a + rot_b - rot_(a+b) under the count, then a reduce step; the
// prefactor rotation; the floatfactor product and a reduce step; + power2.
// Dead rows of the half-pi and pi-product families are skipped: they
// contribute nothing.
//
// Exact sums shift to the smaller power (the shift clipped at 30) and then
// take a reduce step, as the TPU kernel does; an exactly zero summand is
// skipped, so its drifted power never enters the alignment. The kernels
// write integers only: the float conversion is the plain version's own
// torch code (compile/evaluate.py), so magnitudes agree bit for bit.
//
// What bounds the wide kernels on an H100: int32 instruction throughput in the
// per-shot stage (about three quarters of exact_wide on 2-check
// cultivation's 307-graph rung; the integer stage, which forms the parities
// of a graph for 128 shots at once, is most of the rest). Per shot, graph
// and term the product takes a few dozen integer operations: rotations are
// selects and adds, the reduce step a test and four shifts. It reads P bytes
// per shot; the tables of one rung are a few hundred KB at most and stay in
// L1/L2.
//
// What the design does about it. "wide" (G >= 24): a block takes 128 shots
// and a tile of up to 128 graphs. In the integer stage a thread is a graph
// and leaves the graph's parities for all 128 shots in its column of shared
// memory. In the per-shot stage the block turns round: a lane is one shot of
// each 32-shot group, and warp w takes the tile's graphs w, w + warps, ...,
// so a graph's table entries are the same for all 32 lanes and are loaded
// once for 128 shots, a thread carries four shots' products and running
// sums, and no sum over graphs crosses lanes: each thread adds its graphs'
// products one after the other (exact: the aligned add; float: in f32), the
// warps' sums are added in order through shared memory, and each block writes
// one partial per shot and graph tile, combined in torch. An exact sum has
// the same value in any order as long as no alignment shift is clipped; the
// kernels are held to the plain version bit for bit on every exact rung.
// "small" (G < 24) gives each thread one shot and loops over the graphs; the
// threads of a warp read the same table entry, which L1 broadcasts.
//
// Build with -O3 and without --use_fast_math or -ftz.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bitsliced.cuh"

namespace {

constexpr float kInvSqrt2 = 0.7071067811865476f;
constexpr int kMaxTile = 128;  // graphs per wide block (its threads)
constexpr int kSmallThreads = 128;
constexpr int kDefaultSharedBytes = 48 * 1024;

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
  bitsliced::Lists lists;  // the set parameters of every mask, for the wide kernels
  int G, T1, T2, T3, T4, W;
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
  t.lists = bitsliced::make_lists(p, G, T1, T2, T3, T4);
  t.G = G;
  t.T1 = T1;
  t.T2 = T2;
  t.T3 = T3;
  t.T4 = T4;
  t.W = W;
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

// Word i (bits 32i .. 32i + 31) of a row of P parameter bytes (bit 0 of each).
__device__ __forceinline__ uint32_t pack_word(const uint8_t* __restrict__ row, int P, int i) {
  uint32_t word = 0;
  const int lo = 32 * i, hi = min(P, lo + 32);
  for (int p = lo; p < hi; ++p) word |= (uint32_t)(row[p] & 1) << (p - lo);
  return word;
}

// One shot's packed row in W <= 4 registers.
template <int W>
struct Row {
  uint32_t x[W];

  __device__ __forceinline__ void load(const uint8_t* __restrict__ row, int P, int) {
#pragma unroll
    for (int i = 0; i < W; ++i) x[i] = pack_word(row, P, i);
  }
  __device__ __forceinline__ int words() const { return W; }
  __device__ __forceinline__ int parity(const uint32_t* w_src) const {
    uint32_t acc = 0;
#pragma unroll
    for (int i = 0; i < W; ++i) acc ^= x[i] & __ldg(w_src + i);
    return __popc(acc) & 1;
  }
};

// One shot's packed row of any number of words, in dynamic shared memory:
// word i of thread t at xs[i * blockDim.x + t] (one bank a thread).
template <>
struct Row<0> {
  uint32_t* mine;
  int W;

  __device__ __forceinline__ void load(const uint8_t* __restrict__ row, int P, int n_words) {
    extern __shared__ uint32_t xs_dyn[];
    mine = xs_dyn + threadIdx.x;
    W = n_words;
    for (int i = 0; i < W; ++i) mine[i * blockDim.x] = pack_word(row, P, i);
  }
  __device__ __forceinline__ int words() const { return W; }
  __device__ __forceinline__ int parity(const uint32_t* w_src) const {
    uint32_t acc = 0;
    for (int i = 0; i < W; ++i) acc ^= mine[i * blockDim.x] & __ldg(w_src + i);
    return __popc(acc) & 1;
  }
};

// Parities of one shot by popcount over its packed row (K7a, K7b).
template <class RowT>
struct PopcountParities {
  const Tables& tb;
  const RowT& row;
  int g;

  __device__ __forceinline__ const uint32_t* mask(const uint32_t* words, int t) const {
    return words + (long long)(t * tb.G + g) * row.words();
  }
  __device__ __forceinline__ void node(int t, int (&p)[1]) const {
    p[0] = row.parity(mask(tb.np_w, t));
  }
  // Sum over the live half-pi rows of coeff * parity.
  __device__ __forceinline__ void halfpi(int (&tot)[1]) const {
    tot[0] = 0;
    const int len = __ldg(tb.hp_len + g);
    for (int t = 0; t < len; ++t)
      tot[0] += __ldg(tb.hp_c + t * tb.G + g) * row.parity(mask(tb.hp_w, t));
  }
  // XOR over the live pi-product terms of psi & phi.
  __device__ __forceinline__ void sign(int (&e)[1]) const {
    e[0] = 0;
    const int len = __ldg(tb.pp_len + g);
    for (int t = 0; t < len; ++t) {
      const int i = t * tb.G + g;
      e[0] ^= (__ldg(tb.psi_c + i) ^ row.parity(mask(tb.psi_w, t))) &
              (__ldg(tb.phi_c + i) ^ row.parity(mask(tb.phi_w, t)));
    }
  }
  __device__ __forceinline__ void pair(int t, int (&p)[1], int (&q)[1]) const {
    p[0] = row.parity(mask(tb.qa_w, t));
    q[0] = row.parity(mask(tb.qb_w, t));
  }
};

// _product_body for graph g and NS shots: v[k] = the exact product of shot k;
// `par` gives the shots' parities (PopcountParities, or bitsliced::Column
// after the integer stage).
template <int NS, class Parities>
__device__ __forceinline__ void product(const Tables& tb, int g, const Parities& par,
                                        Zw (&v)[NS]) {
  const int G = tb.G;
#pragma unroll
  for (int k = 0; k < NS; ++k) {
    v[k].c[0] = 1;
    v[k].c[1] = v[k].c[2] = v[k].c[3] = 0;
    v[k].p = 0;
  }
  int p[NS], q[NS];
  int r[4], ra[4], rb[4];

  // Node phases: acc *= 1 + w^(phase + 4 parity), i.e. acc + rot(acc).
  const int cnt1 = __ldg(tb.np_cnt + g);
  for (int t = 0; t < tb.T1; ++t) {
    if (t < cnt1) {
      const int ph = __ldg(tb.np_phase + t * G + g);
      par.node(t, p);
#pragma unroll
      for (int k = 0; k < NS; ++k) {
        rot(v[k].c, (ph + 4 * p[k]) & 7, r);
#pragma unroll
        for (int j = 0; j < 4; ++j) v[k].c[j] += r[j];
      }
    }
#pragma unroll
    for (int k = 0; k < NS; ++k) reduce_step(v[k]);
  }

  // Half-pi phases: one rotation by the summed phase mod 8.
  if (tb.T2) {
    par.halfpi(p);
#pragma unroll
    for (int k = 0; k < NS; ++k) {
      rot(v[k].c, p[k] & 7, r);
#pragma unroll
      for (int j = 0; j < 4; ++j) v[k].c[j] = r[j];
    }
  }

  // Pi products: sign (-1)^(XOR over terms of psi & phi).
  if (tb.T3) {
    par.sign(p);
#pragma unroll
    for (int k = 0; k < NS; ++k) {
      const int sign = 1 - 2 * p[k];
#pragma unroll
      for (int j = 0; j < 4; ++j) v[k].c[j] *= sign;
    }
  }

  // Phase pairs: acc * (1 + w^a + w^b - w^(a+b)), three rotations of acc.
  const int cnt4 = __ldg(tb.qp_cnt + g);
  for (int t = 0; t < tb.T4; ++t) {
    if (t < cnt4) {
      const int i = t * G + g;
      const int al = __ldg(tb.qa + i), be = __ldg(tb.qb + i);
      par.pair(t, p, q);
#pragma unroll
      for (int k = 0; k < NS; ++k) {
        const int a = (al + 4 * p[k]) & 7;
        const int b = (be + 4 * q[k]) & 7;
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

// K5: block = 128 shots (four groups of 32) x one tile of blockDim.x (a
// power of two) graphs, IB bytes an index of the lists. Dynamic shared memory
// (bitsliced.cuh): the bit planes, the lists' row table, then one column per
// thread. In the integer stage a thread is a graph of the tile and fills its
// column for all 128 shots. In the per-shot stage a lane is one shot of each
// group and warp w takes the tile's graphs w, w + warps, ...: each thread forms
// its four shots' products of one graph after the other and adds them to its
// running exact sums; then the warps' sums are added in order. Writes
// out_c[tile][b][0..3] and out_p[tile][b].
template <int IB>
__global__ void __launch_bounds__(kMaxTile)
    exact_wide(const uint8_t* __restrict__ x, long long B, int P, Tables tb,
               int32_t* __restrict__ out_c, int32_t* __restrict__ out_p) {
  constexpr int NG = bitsliced::kGroups, NS = bitsliced::kShots;
  __shared__ Zw red[kMaxTile / 32][NS];
  extern __shared__ bitsliced::Entry bs_dyn[];
  const long long b0 = (long long)blockIdx.x * NS;
  const int tid = threadIdx.x, stride = blockDim.x, tile = blockIdx.y;
  const int lane = tid & 31, warp = tid >> 5, warps = stride >> 5;
  const int g0 = tile * stride;
  const int32_t* base = reinterpret_cast<const int32_t*>(bs_dyn + P + 1);
  bitsliced::Entry* columns = bs_dyn + bitsliced::column_offset(P, tb.T1, tb.T2, tb.T3, tb.T4);
  bitsliced::build_planes(x, B, P, b0, tb.lists, bs_dyn);
  __syncthreads();
  if (g0 + tid < tb.G)
    bitsliced::integer_stage<bitsliced::kAllStages, IB>(tb.lists, g0 + tid, bs_dyn, base,
                                                        columns + tid, stride);
  __syncthreads();

  Zw acc[NG];
#pragma unroll
  for (int k = 0; k < NG; ++k) acc[k] = Zw{{0, 0, 0, 0}, 0};
  const int n = min(stride, tb.G - g0);
  for (int j = warp; j < n; j += warps) {
    Zw v[NG];
    const bitsliced::Column par{columns + j, stride, tb.T1, tb.T4, lane};
    product<NG>(tb, g0 + j, par, v);
#pragma unroll
    for (int k = 0; k < NG; ++k) add_exact(acc[k], v[k]);
  }
#pragma unroll
  for (int k = 0; k < NG; ++k) red[warp][32 * k + lane] = acc[k];
  __syncthreads();
  for (int k = tid; k < NS; k += stride) {
    if (b0 + k >= B) break;
    Zw sum = red[0][k];
    for (int wi = 1; wi < warps; ++wi) add_exact(sum, red[wi][k]);
    const long long o = (long long)tile * B + b0 + k;
#pragma unroll
    for (int j = 0; j < 4; ++j) out_c[o * 4 + j] = sum.c[j];
    out_p[o] = is_zero(sum) ? 0 : sum.p;
  }
}

// K6: as K5, with the float32 finisher; writes out[tile][b][re, im].
template <int IB>
__global__ void __launch_bounds__(kMaxTile)
    approx_wide(const uint8_t* __restrict__ x, long long B, int P, Tables tb,
                float* __restrict__ out) {
  constexpr int NG = bitsliced::kGroups, NS = bitsliced::kShots;
  __shared__ float red[kMaxTile / 32][NS][2];
  extern __shared__ bitsliced::Entry bs_dyn[];
  const long long b0 = (long long)blockIdx.x * NS;
  const int tid = threadIdx.x, stride = blockDim.x, tile = blockIdx.y;
  const int lane = tid & 31, warp = tid >> 5, warps = stride >> 5;
  const int g0 = tile * stride;
  const int32_t* base = reinterpret_cast<const int32_t*>(bs_dyn + P + 1);
  bitsliced::Entry* columns = bs_dyn + bitsliced::column_offset(P, tb.T1, tb.T2, tb.T3, tb.T4);
  bitsliced::build_planes(x, B, P, b0, tb.lists, bs_dyn);
  __syncthreads();
  if (g0 + tid < tb.G)
    bitsliced::integer_stage<bitsliced::kAllStages, IB>(tb.lists, g0 + tid, bs_dyn, base,
                                                        columns + tid, stride);
  __syncthreads();

  float sre[NG], sim[NG];
#pragma unroll
  for (int k = 0; k < NG; ++k) sre[k] = sim[k] = 0.0f;
  const int n = min(stride, tb.G - g0);
  for (int j = warp; j < n; j += warps) {
    Zw v[NG];
    const bitsliced::Column par{columns + j, stride, tb.T1, tb.T4, lane};
    product<NG>(tb, g0 + j, par, v);
#pragma unroll
    for (int k = 0; k < NG; ++k) {
      float re, im;
      approx_term(tb, g0 + j, v[k], re, im);
      sre[k] += re;
      sim[k] += im;
    }
  }
#pragma unroll
  for (int k = 0; k < NG; ++k) {
    red[warp][32 * k + lane][0] = sre[k];
    red[warp][32 * k + lane][1] = sim[k];
  }
  __syncthreads();
  for (int j = tid; j < 2 * NS; j += stride) {
    const int k = j >> 1, c = j & 1;
    if (b0 + k < B) {
      float sum = 0.0f;
      for (int wi = 0; wi < warps; ++wi) sum += red[wi][k][c];
      out[((long long)tile * B + b0 + k) * 2 + c] = sum;
    }
  }
}

// K7a: one thread per shot, looping over all graphs; out_c[b][4], out_p[b].
// W = 0: the row's words live in dynamic shared memory (any number).
template <int W>
__global__ void __launch_bounds__(kSmallThreads)
    exact_small(const uint8_t* __restrict__ x, long long B, int P, Tables tb,
                int32_t* __restrict__ out_c, int32_t* __restrict__ out_p) {
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  Row<W> row;
  row.load(x + b * P, P, tb.W);
  Zw acc{{0, 0, 0, 0}, 0};
  for (int g = 0; g < tb.G; ++g) {
    Zw v[1];
    const PopcountParities<Row<W>> par{tb, row, g};
    product<1>(tb, g, par, v);
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
  Row<W> row;
  row.load(x + b * P, P, tb.W);
  float sre = 0.0f, sim = 0.0f;
  for (int g = 0; g < tb.G; ++g) {
    Zw v[1];
    const PopcountParities<Row<W>> par{tb, row, g};
    product<1>(tb, g, par, v);
    float re, im;
    approx_term(tb, g, v[0], re, im);
    sre += re;
    sim += im;
  }
  out[b * 2] = sre;
  out[b * 2 + 1] = sim;
}

// A block's static and dynamic shared memory together may exceed the
// default 48 KB only with the kernel's consent; beyond what the card has,
// the attribute is refused and the launch is not made.
template <class Kernel>
cudaError_t allow_shared(Kernel kernel, size_t bytes) {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  if (attr.sharedSizeBytes + bytes <= (size_t)kDefaultSharedBytes) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int IB>
cudaError_t launch_wide(const uint8_t* x, long long B, int P, const Tables& tb, int tile,
                        int32_t* out_c, int32_t* out_p, float* out_f, cudaStream_t stream) {
  const dim3 grid((unsigned)((B + bitsliced::kShots - 1) / bitsliced::kShots),
                  (unsigned)((tb.G + tile - 1) / tile));
  const size_t bytes = bitsliced::shared_bytes(P, tb.T1, tb.T2, tb.T3, tb.T4, tile);
  const cudaError_t err =
      out_f ? allow_shared(approx_wide<IB>, bytes) : allow_shared(exact_wide<IB>, bytes);
  if (err != cudaSuccess) return err;
  if (out_f)
    approx_wide<IB><<<grid, tile, bytes, stream>>>(x, B, P, tb, out_f);
  else
    exact_wide<IB><<<grid, tile, bytes, stream>>>(x, B, P, tb, out_c, out_p);
  return cudaSuccess;
}

// W in 1..4: rows in registers; W = 0: rows of tb.W words in shared memory,
// fewer shots a block where a row is long, down to one warp.
template <int W>
cudaError_t launch_small(const uint8_t* x, long long B, int P, const Tables& tb, int32_t* out_c,
                         int32_t* out_p, float* out_f, cudaStream_t stream) {
  int threads = kSmallThreads;
  size_t bytes = 0;
  if (W == 0) {
    while (threads > 32 && sizeof(uint32_t) * threads * tb.W > (size_t)kDefaultSharedBytes) threads /= 2;
    bytes = sizeof(uint32_t) * threads * tb.W;
    const cudaError_t err =
        out_f ? allow_shared(approx_small<W>, bytes) : allow_shared(exact_small<W>, bytes);
    if (err != cudaSuccess) return err;
  }
  const unsigned blocks = (unsigned)((B + threads - 1) / threads);
  if (out_f)
    approx_small<W><<<blocks, threads, bytes, stream>>>(x, B, P, tb, out_f);
  else
    exact_small<W><<<blocks, threads, bytes, stream>>>(x, B, P, tb, out_c, out_p);
  return cudaSuccess;
}

int dispatch(const void* x, long long B, int P, const void* flat, const void* approx, int G,
             int T1, int T2, int T3, int T4, int W, int wide, int tile, void* out_c,
             void* out_p, void* out_f, void* stream) {
  if (B <= 0 || G <= 0 || W <= 0) return (int)cudaErrorInvalidValue;
  if (wide && (tile < 32 || tile > kMaxTile || (tile & (tile - 1)) != 0))
    return (int)cudaErrorInvalidValue;
  const Tables tb = make_tables(static_cast<const int32_t*>(flat),
                                static_cast<const float*>(approx), G, T1, T2, T3, T4, W);
  const uint8_t* xp = static_cast<const uint8_t*>(x);
  int32_t* oc = static_cast<int32_t*>(out_c);
  int32_t* op = static_cast<int32_t*>(out_p);
  float* of = static_cast<float*>(out_f);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (wide) {
    err = bitsliced::index_bytes(P) == 1 ? launch_wide<1>(xp, B, P, tb, tile, oc, op, of, s)
                                         : launch_wide<2>(xp, B, P, tb, tile, oc, op, of, s);
  } else {
    switch (W) {
      case 1: err = launch_small<1>(xp, B, P, tb, oc, op, of, s); break;
      case 2: err = launch_small<2>(xp, B, P, tb, oc, op, of, s); break;
      case 3: err = launch_small<3>(xp, B, P, tb, oc, op, of, s); break;
      case 4: err = launch_small<4>(xp, B, P, tb, oc, op, of, s); break;
      default: err = launch_small<0>(xp, B, P, tb, oc, op, of, s); break;
    }
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// Exact finisher (K5 wide, K7a small). x: (B, P) uint8 rows; flat: the
// rung's int32 table buffer; out_c: (n_tiles, B, 4) int32; out_p:
// (n_tiles, B) int32, n_tiles = ceil(G / tile) when wide, else 1. Any number
// W of packed words per row. Returns the first CUDA error of the launch (0
// on success).
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
