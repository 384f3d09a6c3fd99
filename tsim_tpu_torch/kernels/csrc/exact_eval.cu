// Exact evaluator: per shot row and per graph, the exact Z[w] * 2^p product
// of the four term families and the static prefactor, then a sum over
// graphs, either exact (integer coefficients and a power, K5/K7a) or in
// float32 after an approximate complex factor per graph (K6/K7b), where the
// product is formed in closed form and not as integers.
//
// Replaces the TPU kernels of tsim_tpu/compile/pallas_evaluate.py:
//   _kernel_exact    (K5, wide layout)       -> exact_wide
//   _kernel_approx   (K6, wide layout)       -> approx_wide
//   _kernel_exact_t  (K7a, small-G layout)   -> exact_small
//   _kernel_approx_t (K7b, small-G layout)   -> approx_small
// Their shared body is _product_body / _product_body_t. On the TPU every
// parity is a matrix-unit dot of the shot's 0/1 parameters against the
// term's mask. Here every kernel forms parities bit-sliced over the 128 shots
// of a block (bitsliced.cuh: bit planes in shared memory, an XOR per listed
// mask bit per 32 shots, any number of parameters; the small kernels through
// the small front end they share with sample_eval.cu's small f32 kernel).
//
// The exact finisher's product follows _product_body step for step, so that
// the int32 coefficients grow as they do in tsim_tpu: per node-phase term
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
// skipped, so its drifted power never enters the alignment. The exact kernels
// write integers only: the float conversion is the plain version's own
// torch code (compile/evaluate.py), so magnitudes agree bit for bit.
//
// The approximate finisher owes no integer to anyone: its result is a float32
// sum of per-graph values, held to the plain version within a relative
// tolerance. It does not carry the product as Z[w] coefficients at all. A
// node-phase factor 1 + w^k is 0 or a sixteenth root of unity times sqrt 2
// and c = 2 cos(pi / 8) to small powers, so the family (2761 of the 3631
// live terms of the 172-graph state-probability rung) is four counts in one
// packed word per shot and graph (closed_form_add, tables from
// compile/closed_form.py): an add of a host-made delta where the term's
// parity is 1. The half-pi rotation, the pi-product sign and the prefactor's
// w^phase go into the word's phase field. Only the phase pairs, whose factor
// is not a monomial, stay an exact Z[w] product from 1; then one conversion
// per graph, through two small tables in shared memory.
//
// What bounds the wide kernels on an H100: int32 instruction throughput in the
// per-shot stage (about three quarters of exact_wide on 2-check
// cultivation's 307-graph rung, two thirds of approx_wide on the 172-graph
// state-probability rung; the integer stage, which forms the parities of a
// graph for 128 shots at once, is most of the rest). For the exact finisher
// that is a few dozen integer operations per shot, graph and term: rotations
// are selects and adds, the reduce step a test and four shifts. For the
// approximate one it is a bit extract and a multiply-add per shot, graph and
// live slot, the phase pairs' rotations where a graph has any, and per graph
// the conversion: a few dozen float operations and two table reads. The
// kernels read P bytes per shot; the tables of one rung are a few hundred KB
// at most and stay in L1/L2.
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
// The approximate finisher walks only as many node-phase slots as the rung's
// fullest graph has live (dead slots of other graphs add a zero delta), does
// no work that depends on the data, and so takes the same time on rows
// whose products mostly vanish as on rows where few do.
// "small" (G < 24) gives each thread one shot and loops over the graphs; the
// threads of a warp read the same table entry, which L1 broadcasts. Both small
// kernels (K7a, K7b) first form the parities of their block's 128 shots
// bit-sliced, a thread a (row, graph) mask and then a thread a (graph, 32-shot
// group) word for the half-pi total and the pi-product sign
// (bitsliced::small_front_end), so that the per-shot stage reads one bit a
// term and no lane repeats a parity's table loads. What is left per shot is
// the product itself: a few dozen int32 operations per graph and live term
// (K7a, as in the wide kernel), or an add per live node-phase term, the phase
// pairs and one conversion per graph (K7b, as in approx_wide).
//
// Build with -O3 and without --use_fast_math or -ftz.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bitsliced.cuh"

namespace {

constexpr float kInvSqrt2 = 0.7071067811865476f;
constexpr int kMaxTile = 128;  // graphs per wide block (its threads)
constexpr int kDefaultSharedBytes = 48 * 1024;

// Fields of a closed-form word (compile/closed_form.py): the zero count from
// bit 0, the biased count of c from bit 9, the half powers of two from bit 19,
// the phase in sixteenths of a turn in the top four bits.
constexpr int kCountShift = 9, kHalfShift = 19, kPhiShift = 28;
constexpr uint32_t kZeroMask = 0x1ffu, kCountMask = 0x3ffu, kHalfMask = 0x1ffu;
constexpr int kMaxBias = 160;  // c^145 already leaves the float32 range; the host refuses such a rung
constexpr int kMagWords = 2 * (2 * kMaxBias + 1);

// Pointers into the flat table buffer; the segment order matches
// tsim_tpu_torch/compile/exact_tables.py::exact_table_layout. The kernels read
// every parity's mask from the bit lists; the packed mask words and the half-pi
// and pi-product tables are the plain reader's, and make_tables steps over them.
struct Tables {
  const int32_t* np_phase;
  const int32_t* np_cnt;
  const int32_t* qa;
  const int32_t* qb;
  const int32_t* qp_cnt;
  const int32_t* pf_phase;
  const int32_t* pf_ff;
  const int32_t* pf_pow;
  // The closed-form tables of an approximate rung (compile/closed_form.py);
  // an exact rung has none.
  const uint32_t* cf_delta;  // (TC, G): the term's word for parity 1 less that for parity 0
  const uint32_t* cf_base;   // (G): the parity-0 words summed, the bias, the prefactor's phase
  const float* cf_pre;       // (2, G): exact floatfactor times approximate factor, re then im
  const float* cf_unit;      // (16, 2): cos, sin of k pi / 8
  const float* cf_mag;       // (2 EB + 1, 2): c^(j - EB), and that times sqrt 2
  bitsliced::Lists lists;  // the set parameters of every mask
  int G, T1, T2, T3, T4;
  int TC, EB;  // most live node-phase terms of a graph; the bias of the count of c
};

// closed: the rung is approximate and its buffer holds the closed-form segments.
Tables make_tables(const int32_t* flat, bool closed, int G, int T1, int T2, int T3, int T4,
                   int W, int TC, int EB) {
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
  take(g1 * W);                // np_words
  t.np_cnt = take(G);
  take(g2 * (1 + W) + G);      // hp_coeffs, hp_words, hp_len
  take(g3 * 2 * (1 + W) + G);  // pp_psi_c, pp_phi_c, pp_psi_words, pp_phi_words, pp_len
  t.qa = take(g4);
  t.qb = take(g4);
  take(g4 * 2 * W);            // qp_alpha_words, qp_beta_words
  t.qp_cnt = take(G);
  t.pf_phase = take(G);
  t.pf_ff = take(4LL * G);
  t.pf_pow = take(G);
  t.cf_delta = words(closed ? (long long)TC * G : 0);
  t.cf_base = words(closed ? G : 0);
  t.cf_pre = reinterpret_cast<const float*>(take(closed ? 2LL * G : 0));
  t.cf_unit = reinterpret_cast<const float*>(take(closed ? 32 : 0));
  t.cf_mag = reinterpret_cast<const float*>(take(closed ? 2LL * (2 * EB + 1) : 0));
  t.lists = bitsliced::make_lists(p, G, T1, T2, T3, T4);
  t.G = G;
  t.T1 = T1;
  t.T2 = T2;
  t.T3 = T3;
  t.T4 = T4;
  t.TC = TC;
  t.EB = EB;
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

// The phase-pair family of _product_body: v[k] * (1 + w^a + w^b - w^(a+b)) per
// live term, three rotations of v[k], then a reduce step per slot.
template <int NS, class Parities>
__device__ __forceinline__ void pair_terms(const Tables& tb, int g, const Parities& par,
                                           Zw (&v)[NS]) {
  const int G = tb.G;
  int p[NS], q[NS];
  int r[4], ra[4], rb[4];
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
}

// _product_body for graph g and NS shots: v[k] = the exact product of shot k;
// `par` gives the shots' parities (bitsliced::Column after the wide integer
// stage, bitsliced::ShotRows after the small front end).
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
  int p[NS];
  int r[4];

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

  pair_terms<NS>(tb, g, par, v);

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

// m * 2^n as two exact power-of-two factors built from exponent bits, each a
// normal float32 for n in [-252, 254] (the plain version's exp2_int does the
// same), so the product rounds only where it leaves the float32 range.
__device__ __forceinline__ float scale_by_power(float m, int n) {
  n = max(-252, min(254, n));
  const int h = n >> 1;
  return m * __int_as_float((h + 127) << 23) * __int_as_float((n - h + 127) << 23);
}

// The approximate finisher's per-graph term in closed form, for graph g and NS
// shots, added to sre[k] and sim[k] (compile/closed_form.py has the algebra
// and the fields of a word). A node-phase factor 1 + w^k is 0 or a sixteenth
// root of unity times a product of sqrt 2 and c = 2 cos(pi / 8), so the family
// is four counts in one word: the graph's base word plus, per live term, the
// term's delta where the shot's parity is 1. The half-pi rotation and the
// pi-product sign are added to the word's phase field. The phase pairs stay an
// exact Z[w] product from 1 (pair_terms). One conversion per graph: the pairs'
// (re, im) as float32, turned by unit[phi], times mag[e, h odd] * 2^(h / 2 +
// power) * pre; a graph with a zero factor contributes exactly 0
// (_zero_power's case). `unit` and `mag` are the tables cf_unit and cf_mag, in
// shared or global memory. M below kAllStages (the stage split of
// tsim_approx_eval_ablate) leaves the factors out: the prefactor alone, plus
// the parities formed without factors so that the compiler keeps them.
template <unsigned M, int NS, class Parities>
__device__ __forceinline__ void closed_form_add(const Tables& tb, int g, const Parities& par,
                                                const float* unit, const float* mag,
                                                float (&sre)[NS], float (&sim)[NS]) {
  const int G = tb.G;
  const float pre_re = __ldg(tb.cf_pre + g), pre_im = __ldg(tb.cf_pre + G + g);
  const int pw = __ldg(tb.pf_pow + g);
  if constexpr (M != bitsliced::kAllStages) {
    const float scale = scale_by_power(1.0f, pw);
#pragma unroll
    for (int k = 0; k < NS; ++k) {
      sre[k] += pre_re * scale + (float)par.bare(k);
      sim[k] += pre_im * scale;
    }
    return;
  }
  uint32_t acc[NS];
  int p[NS];
  const uint32_t base = __ldg(tb.cf_base + g);
#pragma unroll
  for (int k = 0; k < NS; ++k) acc[k] = base;
  for (int t = 0; t < tb.TC; ++t) {
    const uint32_t delta = __ldg(tb.cf_delta + t * G + g);
    par.node(t, p);
#pragma unroll
    for (int k = 0; k < NS; ++k) acc[k] += (uint32_t)p[k] * delta;
  }
  if (tb.T2) {
    par.halfpi(p);
#pragma unroll
    for (int k = 0; k < NS; ++k) acc[k] += (uint32_t)(p[k] & 7) << (kPhiShift + 1);
  }
  if (tb.T3) {
    par.sign(p);
#pragma unroll
    for (int k = 0; k < NS; ++k) acc[k] += (uint32_t)p[k] << (kPhiShift + 3);
  }

  Zw v[NS];
#pragma unroll
  for (int k = 0; k < NS; ++k) v[k] = Zw{{1, 0, 0, 0}, 0};
  pair_terms<NS>(tb, g, par, v);

#pragma unroll
  for (int k = 0; k < NS; ++k) {
    const uint32_t a = acc[k];
    const bool vanishes = (a & kZeroMask) != 0 || is_zero(v[k]);
    const float c0 = (float)v[k].c[0], c1 = (float)v[k].c[1];
    const float c2 = (float)v[k].c[2], c3 = (float)v[k].c[3];
    const float r = c0 + (c1 - c3) * kInvSqrt2;
    const float i = c2 + (c1 + c3) * kInvSqrt2;
    const int h = (int)((a >> kHalfShift) & kHalfMask);
    const float m = mag[((a >> (kCountShift - 1)) & (kCountMask << 1)) | (uint32_t)(h & 1)];
    const float scale = scale_by_power(m, vanishes ? 0 : (h >> 1) + v[k].p + pw);
    const uint32_t phi = a >> kPhiShift;
    const float ur = unit[2 * phi], ui = unit[2 * phi + 1];
    const float ar = r * ur - i * ui, ai = r * ui + i * ur;
    const float fre = pre_re * scale, fim = pre_im * scale;
    sre[k] += vanishes ? 0.0f : ar * fre - ai * fim;
    sim[k] += vanishes ? 0.0f : ar * fim + ai * fre;
  }
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
  bitsliced::Entry<NG>* bs_dyn = bitsliced::dynamic_entries<NG>();
  const long long b0 = (long long)blockIdx.x * NS;
  const int tid = threadIdx.x, stride = blockDim.x, tile = blockIdx.y;
  const int lane = tid & 31, warp = tid >> 5, warps = stride >> 5;
  const int g0 = tile * stride;
  const int32_t* base = reinterpret_cast<const int32_t*>(bs_dyn + P + 1);
  bitsliced::Entry<NG>* columns = bs_dyn + bitsliced::column_offset<NG>(P, tb.T1, tb.T2, tb.T3, tb.T4);
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
    const bitsliced::Column<NG> par{columns + j, stride, tb.T1, tb.T4, lane};
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

// K6: K5's block shape and integer stage with the closed-form float32
// finisher; the tables cf_unit and cf_mag are copied to shared memory first.
// Writes out[tile][b][re, im]. M below kAllStages: the stage split.
template <unsigned M, int IB>
__global__ void __launch_bounds__(kMaxTile)
    approx_wide(const uint8_t* __restrict__ x, long long B, int P, Tables tb,
                float* __restrict__ out) {
  constexpr int NG = bitsliced::kGroups, NS = bitsliced::kShots;
  __shared__ float red[kMaxTile / 32][NS][2];
  __shared__ float unit[32], mag[kMagWords];
  bitsliced::Entry<NG>* bs_dyn = bitsliced::dynamic_entries<NG>();
  const long long b0 = (long long)blockIdx.x * NS;
  const int tid = threadIdx.x, stride = blockDim.x, tile = blockIdx.y;
  const int lane = tid & 31, warp = tid >> 5, warps = stride >> 5;
  const int g0 = tile * stride;
  const int32_t* base = reinterpret_cast<const int32_t*>(bs_dyn + P + 1);
  bitsliced::Entry<NG>* columns = bs_dyn + bitsliced::column_offset<NG>(P, tb.T1, tb.T2, tb.T3, tb.T4);
  bitsliced::build_planes(x, B, P, b0, tb.lists, bs_dyn);
  for (int i = tid; i < 32; i += stride) unit[i] = __ldg(tb.cf_unit + i);
  for (int i = tid; i < 2 * (2 * tb.EB + 1); i += stride) mag[i] = __ldg(tb.cf_mag + i);
  __syncthreads();
  if (g0 + tid < tb.G)
    bitsliced::integer_stage<M, IB>(tb.lists, g0 + tid, bs_dyn, base, columns + tid, stride);
  __syncthreads();

  float sre[NG], sim[NG];
#pragma unroll
  for (int k = 0; k < NG; ++k) sre[k] = sim[k] = 0.0f;
  const int n = min(stride, tb.G - g0);
  for (int j = warp; j < n; j += warps) {
    const bitsliced::Column<NG> par{columns + j, stride, tb.T1, tb.T4, lane};
    closed_form_add<M, NG>(tb, g0 + j, par, unit, mag, sre, sim);
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

// K7a: block = 128 shots = 128 threads, IB bytes an index of the lists. The
// small front end (bitsliced.cuh, shared with sample_eval.cu's small f32
// kernel) forms the block's parities bit-sliced; then a thread is a shot and
// walks all graphs in order: _product_body's steps (product<1>) on bits read
// from the front end's rows, then the aligned add. Dynamic shared memory:
// bitsliced::small_shared_bytes. out_c[b][4], out_p[b].
template <int IB>
__global__ void __launch_bounds__(bitsliced::kShots)
    exact_small(const uint8_t* __restrict__ x, long long B, int P, Tables tb,
                int32_t* __restrict__ out_c, int32_t* __restrict__ out_p) {
  const long long b0 = (long long)blockIdx.x * bitsliced::kShots;
  const bitsliced::Entry<bitsliced::kGroups>* rows = bitsliced::small_front_end<IB>(
      x, B, P, b0, tb.lists, bitsliced::dynamic_entries<bitsliced::kGroups>());
  const int tid = threadIdx.x;
  const long long b = b0 + tid;
  if (b >= B) return;
  Zw acc{{0, 0, 0, 0}, 0};
  for (int g = 0; g < tb.G; ++g) {
    Zw v[1];
    const bitsliced::ShotRows par(rows, tb.lists, g, tid);
    product<1>(tb, g, par, v);
    add_exact(acc, v[0]);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) out_c[b * 4 + j] = acc.c[j];
  out_p[b] = is_zero(acc) ? 0 : acc.p;
}

// K7b: K7a's block and front end with the closed-form float32 finisher of
// approx_wide. The tables cf_unit and cf_mag are copied to shared memory
// first (a barrier of its own: a term-free rung's front end has none); then a
// thread is a shot and adds the closed-form term of every graph in order, on
// bits read from the front end's rows. out[b][re, im]. At least 8 blocks an
// SM: left free, ptxas gave the one-byte-index instance 40 registers and a
// 4-byte spill; asked for 8 blocks, it takes 56 and spills nothing.
template <int IB>
__global__ void __launch_bounds__(bitsliced::kShots, 8)
    approx_small(const uint8_t* __restrict__ x, long long B, int P, Tables tb,
                 float* __restrict__ out) {
  __shared__ float unit[32], mag[kMagWords];
  const int tid = threadIdx.x;
  for (int i = tid; i < 32; i += blockDim.x) unit[i] = __ldg(tb.cf_unit + i);
  for (int i = tid; i < 2 * (2 * tb.EB + 1); i += blockDim.x) mag[i] = __ldg(tb.cf_mag + i);
  __syncthreads();
  const long long b0 = (long long)blockIdx.x * bitsliced::kShots;
  const bitsliced::Entry<bitsliced::kGroups>* rows = bitsliced::small_front_end<IB>(
      x, B, P, b0, tb.lists, bitsliced::dynamic_entries<bitsliced::kGroups>());
  const long long b = b0 + tid;
  if (b >= B) return;
  float sre[1] = {0.0f}, sim[1] = {0.0f};
  for (int g = 0; g < tb.G; ++g) {
    const bitsliced::ShotRows par(rows, tb.lists, g, tid);
    closed_form_add<bitsliced::kAllStages, 1>(tb, g, par, unit, mag, sre, sim);
  }
  out[b * 2] = sre[0];
  out[b * 2 + 1] = sim[0];
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
cudaError_t launch_exact_wide(const uint8_t* x, long long B, int P, const Tables& tb, int tile,
                              int32_t* out_c, int32_t* out_p, cudaStream_t stream) {
  const dim3 grid((unsigned)((B + bitsliced::kShots - 1) / bitsliced::kShots),
                  (unsigned)((tb.G + tile - 1) / tile));
  const size_t bytes = bitsliced::shared_bytes<bitsliced::kGroups>(P, tb.T1, tb.T2, tb.T3, tb.T4, tile);
  const cudaError_t err = allow_shared(exact_wide<IB>, bytes);
  if (err != cudaSuccess) return err;
  exact_wide<IB><<<grid, tile, bytes, stream>>>(x, B, P, tb, out_c, out_p);
  return cudaSuccess;
}

template <unsigned M, int IB>
cudaError_t launch_approx_wide_as(const uint8_t* x, long long B, int P, const Tables& tb, int tile,
                                  float* out, cudaStream_t stream) {
  const dim3 grid((unsigned)((B + bitsliced::kShots - 1) / bitsliced::kShots),
                  (unsigned)((tb.G + tile - 1) / tile));
  const size_t bytes = bitsliced::shared_bytes<bitsliced::kGroups>(P, tb.T1, tb.T2, tb.T3, tb.T4, tile);
  const cudaError_t err = allow_shared(approx_wide<M, IB>, bytes);
  if (err != cudaSuccess) return err;
  approx_wide<M, IB><<<grid, tile, bytes, stream>>>(x, B, P, tb, out);
  return cudaSuccess;
}

template <unsigned M>
cudaError_t launch_approx_wide(const uint8_t* x, long long B, int P, const Tables& tb, int tile,
                               float* out, cudaStream_t stream) {
  return bitsliced::index_bytes(P) == 1 ? launch_approx_wide_as<M, 1>(x, B, P, tb, tile, out, stream)
                                        : launch_approx_wide_as<M, 2>(x, B, P, tb, tile, out, stream);
}

// A small kernel (K7a, K7b): 128 shots a block, the front end's dynamic shared
// memory, IB from the parameter count.
template <class Kernel, class... Out>
cudaError_t launch_small(Kernel kernel, const uint8_t* x, long long B, int P, const Tables& tb,
                         cudaStream_t stream, Out... out) {
  const size_t bytes = bitsliced::small_shared_bytes(P, tb.G, tb.T1, tb.T2, tb.T3, tb.T4);
  const cudaError_t err = allow_shared(kernel, bytes);
  if (err != cudaSuccess) return err;
  const long long blocks = (B + bitsliced::kShots - 1) / bitsliced::kShots;
  kernel<<<(unsigned)blocks, bitsliced::kShots, bytes, stream>>>(x, B, P, tb, out...);
  return cudaSuccess;
}

bool valid_shape(long long B, int G, int W, int wide, int tile) {
  if (B <= 0 || G <= 0 || W <= 0) return false;
  return !wide || (tile >= 32 && tile <= kMaxTile && (tile & (tile - 1)) == 0);
}

int finish(cudaError_t err) { return err != cudaSuccess ? (int)err : (int)cudaGetLastError(); }

}  // namespace

// Exact finisher (K5 wide, K7a small). x: (B, P) uint8 rows; flat: the
// rung's int32 table buffer; out_c: (n_tiles, B, 4) int32; out_p:
// (n_tiles, B) int32, n_tiles = ceil(G / tile) when wide, else 1. Any number
// W of packed words per row. Returns the first CUDA error of the launch (0
// on success).
extern "C" int tsim_exact_eval(const void* x, long long B, int P, const void* flat, int G,
                               int T1, int T2, int T3, int T4, int W, int wide, int tile,
                               void* out_c, void* out_p, void* stream) {
  if (!valid_shape(B, G, W, wide, tile)) return (int)cudaErrorInvalidValue;
  const Tables tb = make_tables(static_cast<const int32_t*>(flat), false, G, T1, T2, T3, T4, W, 0, 0);
  const uint8_t* xp = static_cast<const uint8_t*>(x);
  int32_t* oc = static_cast<int32_t*>(out_c);
  int32_t* op = static_cast<int32_t*>(out_p);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool one = bitsliced::index_bytes(P) == 1;
  if (wide)
    return finish(one ? launch_exact_wide<1>(xp, B, P, tb, tile, oc, op, s)
                      : launch_exact_wide<2>(xp, B, P, tb, tile, oc, op, s));
  return finish(launch_small(one ? &exact_small<1> : &exact_small<2>, xp, B, P, tb, s, oc, op));
}

// Approximate finisher (K6 wide, K7b small) of a rung whose buffer holds the
// closed-form segments with TC term slots and bias EB; out: (n_tiles, B, 2)
// float32.
extern "C" int tsim_approx_eval(const void* x, long long B, int P, const void* flat, int G,
                                int T1, int T2, int T3, int T4, int W, int TC, int EB, int wide,
                                int tile, void* out, void* stream) {
  if (!valid_shape(B, G, W, wide, tile) || TC < 0 || EB < 0 || EB > kMaxBias)
    return (int)cudaErrorInvalidValue;
  const Tables tb = make_tables(static_cast<const int32_t*>(flat), true, G, T1, T2, T3, T4, W, TC, EB);
  const uint8_t* xp = static_cast<const uint8_t*>(x);
  float* of = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (wide) return finish(launch_approx_wide<bitsliced::kAllStages>(xp, B, P, tb, tile, of, s));
  const bool one = bitsliced::index_bytes(P) == 1;
  return finish(launch_small(one ? &approx_small<1> : &approx_small<2>, xp, B, P, tb, s, of));
}

// K6 with the stages of variant `variant` (0 empty: the prefactor and the
// graph sum; 1 par-all: the integer stage as well, its parities consumed
// without factors; 2 full: K6's own code), to split its time by stage.
extern "C" int tsim_approx_eval_ablate(const void* x, long long B, int P, const void* flat, int G,
                                       int T1, int T2, int T3, int T4, int W, int TC, int EB,
                                       int tile, int variant, void* out, void* stream) {
  using namespace bitsliced;
  if (!valid_shape(B, G, W, 1, tile) || TC < 0 || EB < 0 || EB > kMaxBias)
    return (int)cudaErrorInvalidValue;
  const Tables tb = make_tables(static_cast<const int32_t*>(flat), true, G, T1, T2, T3, T4, W, TC, EB);
  const uint8_t* xp = static_cast<const uint8_t*>(x);
  float* of = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case 0: return finish(launch_approx_wide<0>(xp, B, P, tb, tile, of, s));
    case 1: return finish(launch_approx_wide<kP1 | kP2 | kP3 | kP4>(xp, B, P, tb, tile, of, s));
    case 2: return finish(launch_approx_wide<kAllStages>(xp, B, P, tb, tile, of, s));
    default: return (int)cudaErrorInvalidValue;
  }
}
