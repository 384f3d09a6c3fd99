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
// parameters against a term's parameter mask. No parity matrix is formed
// here. The configurations differ in how they form a parity:
//   "wide" (K1, K8): bit-sliced over the shots of a block (bitsliced.cuh):
//   the block's rows become bit planes in shared memory and a graph's thread
//   XORs the planes of each mask's set parameters, walking a host-built
//   stream of their indices; any number of parameters; 128 shots a block, or
//   32 for launches of few rows (see below);
//   "small" (K2): bit-sliced as well, with the same planes and lists, but a
//   thread a mask (bitsliced.cuh::small_front_end, shared with the small
//   exact kernel): below 24 graphs a thread a graph would leave most of the
//   block idle; any number of parameters;
//   "per_term_wide" / "per_term_small" (K3a / K3b): a popcount per term and
//   shot, nothing of bitsliced.cuh, so that they stay the oracles of the
//   bit-sliced ones. Up to 128 parameters (two 64-bit words) a thread holds
//   its shots' packed rows in registers, templated on the word count, and
//   the block stages a chunk of graphs' term masks in shared memory, which
//   a warp then reads as broadcasts: a parity is an AND per word, an XOR
//   fold to 32 bits and one __popc. K3a takes 128 shots a block (4 a
//   thread) or, for launches below kernels/sample_eval.py::WIDE_SMALL_ROWS
//   rows, 32 (K4's 128-row probe then fills four SMs, not one); K3b a
//   thread a shot and 256 shots a block. Longer rows keep the first design:
//   the packed words staged in shared memory and read in a loop over all W
//   words for each term (1024 W bytes a 256-shot block in the wide and 4 W
//   bytes a shot in the small configuration).
// In every configuration a thread applies the f32 factors of a graph to its
// own shots (accumulate_graph) and adds the graphs' products one after the
// other, so whatever belongs to the graph (its table entries) is the same for
// the 32 lanes of a warp, which L1 broadcasts, and no sum over graphs crosses
// lanes. The small configurations give each thread one shot and all graphs,
// in the same order, so they agree bit for bit. The wide ones give each
// thread one shot of every 32-shot group of the block and each warp a share
// of the graphs (warp w the graphs w, w + warps, ... of every chunk of
// blockDim graphs); the warps' sums are added in order through shared
// memory, and no sum is carried across blocks. "wide" and "per_term_wide"
// share that order, so they agree bit for bit. The ragged edge of the batch
// is masked in all of them.
//
// "wide" runs in two stages per chunk of blockDim graphs. In the integer
// stage a thread is a graph: it forms every parity of the graph for all the
// block's shots at once, keeps the half-pi total and the pi-product sign
// bit-sliced, and leaves the result in its column of shared memory. In the
// per-shot stage the block turns round as described above, and a thread
// reads bit `lane` of the columns' words.
//
// "wide" has two instances, NG = 4 and NG = 1 groups of 32 shots a block.
// With 128 shots a block, a launch of fewer than about 16,000 rows leaves
// most of the card's 132 SMs without a block, and each thread carries four shots
// through every graph of its warp in turn (K4's probe, 128 rows, is one
// block). The 32-shot instance gives such a launch four times the blocks, a
// quarter of the per-shot work each, at the price of walking the lists once
// per 32 shots instead of once per 128; kernels/sample_eval.py chooses it by
// row count. Such a launch is latency-bound in the integer stage (one thread
// walks a graph's lists, with too few warps on the SM to hide the loads), so
// the 32-shot block also takes up to kWideSmallThreads threads and walks that
// many graphs' lists at once, where the 128-shot block walks 128 after 128;
// only the first four warps work in the per-shot stage. A shot's graphs are
// added in the same order in both (a thread holds shot 32 k + lane of its
// block, warp w the graphs w, w + warps, ... of each span of 128), so the two
// are equal bit for bit.
//
// What bounds "wide" on an H100: instruction throughput in the per-shot stage. The
// stage ablation (dev/torch_kernel_ablate.py, 2^20 rows, 2-check
// cultivation's 307-graph rung) puts the integer stage at a third of the
// kernel and the per-shot stage at three fifths: per shot, graph and
// node-phase term two selects and a complex product, per phase-pair term
// about twenty f32 operations, plus the rotation, sign and prefactor per
// graph. The integer stage is one 16-byte shared-memory load and four XORs
// per listed parameter per 128 shots; the stream is padded to the same shape
// for every graph of the rung, which costs about 2.7 listed parameters per
// set mask bit on that rung. The kernel reads P bytes and writes 8 bytes per
// shot, and the tables of one rung are a few hundred KB that stay in L1/L2.
// The per-term configurations pay a popcount (a quarter of the f32 rate) and
// an AND and XOR per word for every term and shot, on top of "wide"'s
// per-shot stage; their row-in-register instances read no row word and no
// mask from device memory per term. "small" walked popcounts too, a thread a shot, every
// lane of a warp repeating the same table loads and address arithmetic; its
// parities now cost one 16-byte shared-memory load and four XORs per listed
// parameter per 128 shots, and what is left is the row load, three block
// barriers and the f32 factors per shot.
//
// The wide kernel takes a family/stage mask M as a template parameter (bits
// kP1..kT4: form family k's parities, apply family k's factors). K1 runs
// with every stage on; the ablation (tsim_sample_eval_ablate) launches the
// same template with stages off, so its "full" variant is K1's own code. A
// family whose parities are formed without its factors XORs them into a
// word that is added to the real part, so the compiler cannot drop them.
//
// Registers (nvcc 12.8, -O3, sm_90a): "wide" 126 with four blocks an SM asked
// for, its 32-shot instance 63, "small" 40, no spill; the build keeps the
// compiler's report beside the library (kernels/build.py).
//
// Build with -O3 and without --use_fast_math or -ftz, so that denormals
// survive (the host still folds the common power of two out of the
// prefactor, see compile/sample_tables.py). Every complex product whose
// rounding matters is written with explicit intrinsics (cmul and the graph
// sum in accumulate_graph: one __fmul_rn and one __fmaf_rn a component):
// nvcc contracts a * b + c * d into a fused multiply-add in whichever way it
// likes, and did so differently in the one-shot and the four-shot instances
// of "wide", which then differed in the last bit. With the products pinned
// every configuration and instance rounds the same way.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bitsliced.cuh"

namespace {

using bitsliced::kAllStages;
using bitsliced::kP1;
using bitsliced::kP2;
using bitsliced::kP3;
using bitsliced::kP4;
using bitsliced::kT1;
using bitsliced::kT2;
using bitsliced::kT3;
using bitsliced::kT4;

constexpr float kSqrtHalf = 0.70710678118654752f;
constexpr int kWideThreads = 128;  // upper bound of the wide block, and of its per-shot stage
constexpr int kWideSmallThreads = 512;  // upper bound of the 32-shot wide block
constexpr int kPerTermGroups = 8;  // 32-shot groups per per-term wide block of long rows
constexpr int kSmallThreads = 128;  // upper bound of the per-term small block of long rows
constexpr int kPerTermSmallShots = 256;  // per-term small block of rows in registers
constexpr int kRegisterWords = 2;  // 64-bit row words held in registers, at most
constexpr int kStageBytes = 40 * 1024;  // staged term masks of one chunk of graphs, at most
constexpr int kDefaultSharedBytes = 48 * 1024;

// Threads of a wide block: one a graph up to `most`, a whole number of warps.
__host__ __device__ inline int wide_threads(int G, int most = kWideThreads) {
  const int lanes = 32 * ((G + 31) / 32);
  return lanes < most ? lanes : most;
}

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
  bitsliced::Lists lists;  // the set parameters of every mask, for "wide"
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
  t.lists = bitsliced::make_lists(p, G, T1, T2, T3, T4);
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

// NS shots' rows staged in shared memory, any number of words (K3a, K3b):
// word i of shot k is xs[i * stride + k * step].
template <int NS>
struct SharedRows {
  const uint32_t* xs;
  int W, stride, step;

  __device__ __forceinline__ int words() const { return W; }

  __device__ __forceinline__ void parities(const uint32_t* w_src, int (&p)[NS]) const {
    uint32_t acc[NS];
#pragma unroll
    for (int k = 0; k < NS; ++k) acc[k] = 0;
    for (int i = 0; i < W; ++i) {
      const uint32_t w = __ldg(w_src + i);
#pragma unroll
      for (int k = 0; k < NS; ++k) acc[k] ^= xs[i * stride + k * step] & w;
    }
#pragma unroll
    for (int k = 0; k < NS; ++k) p[k] = __popc(acc[k]) & 1;
  }
};

__device__ __forceinline__ void cmul(float& re, float& im, float fr, float fi) {
  const float nre = __fmaf_rn(re, fr, -__fmul_rn(im, fi));
  const float nim = __fmaf_rn(re, fi, __fmul_rn(im, fr));
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

// Parities by popcount over packed rows (K2, K3a, K3b): graph g's, for the
// NS shots of `rows`.
template <int NS, class Rows>
struct PopcountParities {
  const Tables& tb;
  const Rows& rows;
  int g;

  __device__ __forceinline__ const uint32_t* mask(const uint32_t* words, int t) const {
    return words + (long long)(t * tb.G + g) * rows.words();
  }
  __device__ __forceinline__ void node(int t, int (&p)[NS]) const {
    rows.parities(mask(tb.np_w, t), p);
  }
  // Sum over the half-pi rows of coeff * parity.
  __device__ __forceinline__ void halfpi(int (&tot)[NS]) const {
    int p[NS];
#pragma unroll
    for (int k = 0; k < NS; ++k) tot[k] = 0;
    for (int t = 0; t < tb.T2; ++t) {
      rows.parities(mask(tb.hp_w, t), p);
      const int coeff = __ldg(tb.hp_c + t * tb.G + g);
#pragma unroll
      for (int k = 0; k < NS; ++k) tot[k] += coeff * p[k];
    }
  }
  // XOR over the pi-product terms of psi & phi.
  __device__ __forceinline__ void sign(int (&sgn)[NS]) const {
    int p[NS], q[NS];
#pragma unroll
    for (int k = 0; k < NS; ++k) sgn[k] = 0;
    for (int t = 0; t < tb.T3; ++t) {
      rows.parities(mask(tb.psi_w, t), p);
      rows.parities(mask(tb.phi_w, t), q);
      const int i = t * tb.G + g;
      const int pc = __ldg(tb.psi_c + i) & 1, qc = __ldg(tb.phi_c + i) & 1;
#pragma unroll
      for (int k = 0; k < NS; ++k) sgn[k] ^= (pc ^ p[k]) & (qc ^ q[k]);
    }
  }
  __device__ __forceinline__ void pair(int t, int (&p)[NS], int (&q)[NS]) const {
    rows.parities(mask(tb.a_w, t), p);
    rows.parities(mask(tb.b_w, t), q);
  }
  __device__ __forceinline__ int bare(int) const { return 0; }
};

// Adds graph g's product, for each of NS shots, into acc_re[k] and
// acc_im[k], with the factor stages of mask M; `par` gives the shots'
// parities (PopcountParities, or bitsliced::Column after the integer
// stage). Every configuration applies the f32 factors through this one
// function, in the same order.
template <unsigned M, int NS, class Parities>
__device__ __forceinline__ void accumulate_graph(const Tables& tb, int g, const Parities& par,
                                                 float (&acc_re)[NS], float (&acc_im)[NS]) {
  constexpr bool kBare = ((M & kP1) && !(M & kT1)) || ((M & kP2) && !(M & kT2)) ||
                         ((M & kP3) && !(M & kT3)) || ((M & kP4) && !(M & kT4));
  const int G = tb.G;
  float re[NS], im[NS];
  int p[NS], q[NS];
#pragma unroll
  for (int k = 0; k < NS; ++k) {
    re[k] = 1.0f;
    im[k] = 0.0f;
  }

  // Node phases: (1 + c) - 2c p, s - 2s p; dead slots have c = s = 0.
  if (M & kT1) {
    for (int t = 0; t < tb.T1; ++t) {
      const int i = t * G + g;
      par.node(t, p);
      const float c = __ldg(tb.np_cos + i), s = __ldg(tb.np_sin + i);
      // The factor for parity 0 and for parity 1, formed once for all shots.
      const float fr0 = 1.0f + c, fr1 = (1.0f + c) - 2.0f * c, fi1 = s - 2.0f * s;
#pragma unroll
      for (int k = 0; k < NS; ++k) cmul(re[k], im[k], p[k] ? fr1 : fr0, p[k] ? fi1 : s);
    }
  }

  // Half-pi phases: one rotation by w^(sum coeff * parity mod 8).
  if ((M & kT2) && tb.T2) {
    par.halfpi(p);
#pragma unroll
    for (int k = 0; k < NS; ++k) rot_staged(re[k], im[k], p[k] & 7);
  }

  // Pi products: sign (-1)^(XOR over terms of psi & phi).
  if ((M & kT3) && tb.T3) {
    par.sign(p);
#pragma unroll
    for (int k = 0; k < NS; ++k) {
      if (p[k]) {
        re[k] = -re[k];
        im[k] = -im[k];
      }
    }
  }

  // Phase pairs: 1 + s_a w^alpha + s_b w^beta - s_a s_b w^(alpha+beta).
  if (M & kT4) {
    for (int t = 0; t < tb.T4; ++t) {
      const int i = t * G + g;
      par.pair(t, p, q);
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
    }
  }

  if (kBare) {
#pragma unroll
    for (int k = 0; k < NS; ++k) re[k] += (float)par.bare(k);
  }

  const float pr = __ldg(tb.pre_re + g), pi = __ldg(tb.pre_im + g);
#pragma unroll
  for (int k = 0; k < NS; ++k) {
    acc_re[k] += __fmaf_rn(re[k], pr, -__fmul_rn(im[k], pi));
    acc_im[k] += __fmaf_rn(re[k], pi, __fmul_rn(im[k], pr));
  }
}

// The end of the wide configurations: every thread of the first `warps`
// warps holds the sums of its NG shots (shot 32 k + lane of the block) over
// its warp's graphs; adds the warps' sums in order and writes the shots that
// lie inside the batch.
template <int NG>
__device__ __forceinline__ void warps_sum_store(const float (&acc_re)[NG], const float (&acc_im)[NG],
                                                int warps, long long b0, long long B,
                                                float* __restrict__ out) {
  __shared__ float red[kWideThreads / 32][32 * NG][2];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (warp < warps) {
#pragma unroll
    for (int k = 0; k < NG; ++k) {
      red[warp][32 * k + lane][0] = acc_re[k];
      red[warp][32 * k + lane][1] = acc_im[k];
    }
  }
  __syncthreads();
  for (int j = tid; j < 64 * NG; j += blockDim.x) {
    const int k = j >> 1, c = j & 1;
    float s = 0.0f;
    for (int wi = 0; wi < warps; ++wi) s += red[wi][k][c];
    if (b0 + k < B) out[(b0 + k) * 2 + c] = s;
  }
}

// Wide configuration (K1; K8 with M below kAllStages): block = 32 NG shots
// (NG groups of 32) x wide_threads(G) threads (NG = 4) or up to
// kWideSmallThreads (NG = 1), IB bytes an index of the lists. Dynamic shared
// memory (bitsliced.cuh): the bit planes, the lists' row table, then one
// column per thread. The block takes the graphs in chunks of blockDim. In the
// integer stage a thread is a graph and fills its column for all the block's
// shots. The per-shot stage takes each chunk in spans of wide_threads(G)
// graphs, in order, and only the first wide_threads(G) / 32 warps work in it:
// a lane is one shot of each group and warp w takes the span's graphs w,
// w + warps, ...: each thread adds its NG shots' products of one graph after
// the other. At the end the warps' sums are added in order. With NG = 4 a
// chunk is one span; with NG = 1 a chunk may hold several (see the top of the
// file), and the spans, so the order of every sum, are those of NG = 4.
template <unsigned M, int IB, int NG>
__global__ void __launch_bounds__(NG == 1 ? kWideSmallThreads : kWideThreads, NG == 1 ? 1 : 4)
    sample_eval_wide(const uint8_t* __restrict__ x, long long B, int P, Tables tb,
                     float* __restrict__ out) {
  bitsliced::Entry<NG>* bs_dyn = bitsliced::dynamic_entries<NG>();
  const long long b0 = (long long)blockIdx.x * 32 * NG;
  const int tid = threadIdx.x, stride = blockDim.x, span = wide_threads(tb.G);
  const int lane = tid & 31, warp = tid >> 5, warps = span >> 5;
  const int32_t* base = reinterpret_cast<const int32_t*>(bs_dyn + P + 1);
  bitsliced::Entry<NG>* columns = bs_dyn + bitsliced::column_offset<NG>(P, tb.T1, tb.T2, tb.T3, tb.T4);
  bitsliced::build_planes(x, B, P, b0, tb.lists, bs_dyn);
  __syncthreads();

  float acc_re[NG], acc_im[NG];
#pragma unroll
  for (int k = 0; k < NG; ++k) {
    acc_re[k] = 0.0f;
    acc_im[k] = 0.0f;
  }
  for (int c0 = 0; c0 < tb.G; c0 += stride) {
    if (c0 + tid < tb.G)
      bitsliced::integer_stage<M, IB>(tb.lists, c0 + tid, bs_dyn, base, columns + tid, stride);
    __syncthreads();
    if (warp < warps) {
      for (int g0 = c0; g0 < min(c0 + stride, tb.G); g0 += span) {
        const int n = min(span, tb.G - g0);
        for (int j = warp; j < n; j += warps) {
          const bitsliced::Column<NG> par{columns + (g0 - c0) + j, stride, tb.T1, tb.T4, lane};
          accumulate_graph<M, NG>(tb, g0 + j, par, acc_re, acc_im);
        }
      }
    }
    __syncthreads();  // the columns are filled again by the next chunk
  }
  warps_sum_store(acc_re, acc_im, warps, b0, B, out);
}

// Per-term wide configuration (K3a): the wide configuration's per-shot stage
// with popcount parities. Block = 256 shots x up to kWideThreads threads, the
// shots' packed rows staged in dynamic shared memory, word i of shot s at
// xs[i * 256 + s]; a lane is one shot of each group of 32, warp w takes the
// graphs w, w + warps, ... of each chunk of blockDim graphs, as "wide" does,
// so the two add the same f32 values in the same order.
__global__ void __launch_bounds__(kWideThreads)
    sample_eval_per_term_wide(const uint8_t* __restrict__ x, long long B, int P, Tables tb,
                              float* __restrict__ out) {
  constexpr int NG = kPerTermGroups, NS = 32 * NG;
  extern __shared__ uint32_t xs_dyn[];
  const long long b0 = (long long)blockIdx.x * NS;
  const int tid = threadIdx.x, stride = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, warps = stride >> 5;
  for (int j = tid; j < NS * tb.W; j += stride) {
    const int k = j % NS, i = j / NS;
    xs_dyn[j] = b0 + k < B ? pack_word(x + (b0 + k) * P, P, i) : 0u;
  }
  __syncthreads();

  const SharedRows<NG> rows{xs_dyn + lane, tb.W, NS, 32};
  float acc_re[NG], acc_im[NG];
#pragma unroll
  for (int k = 0; k < NG; ++k) {
    acc_re[k] = 0.0f;
    acc_im[k] = 0.0f;
  }
  for (int g0 = 0; g0 < tb.G; g0 += stride) {
    const int n = min(stride, tb.G - g0);
    for (int j = warp; j < n; j += warps) {
      const PopcountParities<NG, SharedRows<NG>> par{tb, rows, g0 + j};
      accumulate_graph<kAllStages, NG>(tb, g0 + j, par, acc_re, acc_im);
    }
  }
  warps_sum_store(acc_re, acc_im, warps, b0, B, out);
}

// Small configuration (K2): block = 128 shots = 128 threads, IB bytes an index
// of the lists. The small front end (bitsliced.cuh::small_front_end, shared
// with exact_eval.cu `exact_small`) forms every parity of the block's 128
// shots, a thread a mask, then the half-pi totals and pi-product signs, a
// thread a word. In the per-shot stage a thread is a shot and walks all
// graphs in order through accumulate_graph, as the per-term small
// configuration does with its popcount parities, so the two agree bit for bit.
template <int IB>
__global__ void __launch_bounds__(bitsliced::kShots)
    sample_eval_small(const uint8_t* __restrict__ x, long long B, int P, Tables tb,
                      float* __restrict__ out) {
  const long long b0 = (long long)blockIdx.x * bitsliced::kShots;
  const bitsliced::Entry<bitsliced::kGroups>* rows = bitsliced::small_front_end<IB>(
      x, B, P, b0, tb.lists, bitsliced::dynamic_entries<bitsliced::kGroups>());
  const int tid = threadIdx.x;
  const long long b = b0 + tid;
  if (b >= B) return;
  float acc_re[1] = {0.0f}, acc_im[1] = {0.0f};
  for (int g = 0; g < tb.G; ++g) {
    const bitsliced::ShotRows par(rows, tb.lists, g, tid);
    accumulate_graph<kAllStages, 1>(tb, g, par, acc_re, acc_im);
  }
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
  const SharedRows<1> rows{mine, tb.W, (int)blockDim.x, 0};
  float acc_re[1] = {0.0f}, acc_im[1] = {0.0f};
  for (int g = 0; g < tb.G; ++g) {
    const PopcountParities<1, SharedRows<1>> par{tb, rows, g};
    accumulate_graph<kAllStages, 1>(tb, g, par, acc_re, acc_im);
  }
  out[b * 2] = acc_re[0];
  out[b * 2 + 1] = acc_im[0];
}

// The per-term kernels of rows of at most kRegisterWords 64-bit words (K3a,
// K3b): each thread holds its NS shots' packed rows in registers, and the
// block stages the term masks of a chunk of n graphs in shared memory as
// 64-bit words: mask m of chunk graph j, word w at stage[(m * n + j) * W64 +
// w], masks in the order node terms, half-pi terms, psi, phi, alpha, beta.

__device__ __forceinline__ int mask_count(const Tables& tb) {
  return tb.T1 + tb.T2 + 2 * tb.T3 + 2 * tb.T4;
}

// The 32-bit words of mask m of graph g in the table buffer.
__device__ __forceinline__ const uint32_t* mask_words(const Tables& tb, int m, int g) {
  const uint32_t* seg;
  int t = m;
  if (t < tb.T1) {
    seg = tb.np_w;
  } else if ((t -= tb.T1) < tb.T2) {
    seg = tb.hp_w;
  } else if ((t -= tb.T2) < tb.T3) {
    seg = tb.psi_w;
  } else if ((t -= tb.T3) < tb.T3) {
    seg = tb.phi_w;
  } else if ((t -= tb.T3) < tb.T4) {
    seg = tb.a_w;
  } else {
    t -= tb.T4;
    seg = tb.b_w;
  }
  return seg + (long long)(t * tb.G + g) * tb.W;
}

// Copies the masks of graphs c0 .. c0 + n - 1 into `stage`, the whole block.
template <int W64>
__device__ __forceinline__ void stage_masks(const Tables& tb, int c0, int n, uint64_t* stage) {
  const int total = mask_count(tb) * n * W64;
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int w = i % W64, j = (i / W64) % n, m = i / (W64 * n);
    const uint32_t* src = mask_words(tb, m, c0 + j);
    const uint32_t lo = __ldg(src + 2 * w);
    const uint32_t hi = 2 * w + 1 < tb.W ? __ldg(src + 2 * w + 1) : 0u;
    stage[i] = (uint64_t)hi << 32 | lo;
  }
}

// A shot's row of P parameter bytes as W64 packed 64-bit words (zero for a
// shot past the batch).
template <int W64>
__device__ __forceinline__ void load_row(const uint8_t* __restrict__ x, long long b, long long B, int P,
                                         uint64_t (&row)[W64]) {
#pragma unroll
  for (int i = 0; i < W64; ++i) {
    uint64_t word = 0;
    if (b < B) {
      const uint8_t* r = x + b * P;
      const int hi = min(P, 64 * i + 64);
      for (int p = 64 * i; p < hi; ++p) word |= (uint64_t)(r[p] & 1) << (p - 64 * i);
    }
    row[i] = word;
  }
}

// Parities of one graph from its staged masks and NS rows held in registers.
template <int NS, int W64>
struct StagedParities {
  const Tables& tb;
  const uint64_t (&rows)[NS][W64];
  const uint64_t* masks;  // mask 0 of this graph in the stage
  int step;               // from one mask of the graph to the next: n * W64
  int g;

  __device__ __forceinline__ void parities(int m, int (&p)[NS]) const {
    uint64_t w[W64];
#pragma unroll
    for (int i = 0; i < W64; ++i) w[i] = masks[m * step + i];
#pragma unroll
    for (int k = 0; k < NS; ++k) {
      uint64_t a = rows[k][0] & w[0];
#pragma unroll
      for (int i = 1; i < W64; ++i) a ^= rows[k][i] & w[i];
      p[k] = __popc((uint32_t)a ^ (uint32_t)(a >> 32)) & 1;
    }
  }
  __device__ __forceinline__ void node(int t, int (&p)[NS]) const { parities(t, p); }
  __device__ __forceinline__ void halfpi(int (&tot)[NS]) const {
    int p[NS];
#pragma unroll
    for (int k = 0; k < NS; ++k) tot[k] = 0;
    for (int t = 0; t < tb.T2; ++t) {
      parities(tb.T1 + t, p);
      const int coeff = __ldg(tb.hp_c + t * tb.G + g);
#pragma unroll
      for (int k = 0; k < NS; ++k) tot[k] += coeff * p[k];
    }
  }
  __device__ __forceinline__ void sign(int (&sgn)[NS]) const {
    int p[NS], q[NS];
#pragma unroll
    for (int k = 0; k < NS; ++k) sgn[k] = 0;
    const int psi = tb.T1 + tb.T2, phi = psi + tb.T3;
    for (int t = 0; t < tb.T3; ++t) {
      parities(psi + t, p);
      parities(phi + t, q);
      const int i = t * tb.G + g;
      const int pc = __ldg(tb.psi_c + i) & 1, qc = __ldg(tb.phi_c + i) & 1;
#pragma unroll
      for (int k = 0; k < NS; ++k) sgn[k] ^= (pc ^ p[k]) & (qc ^ q[k]);
    }
  }
  __device__ __forceinline__ void pair(int t, int (&p)[NS], int (&q)[NS]) const {
    const int alpha = tb.T1 + tb.T2 + 2 * tb.T3;
    parities(alpha + t, p);
    parities(alpha + tb.T4 + t, q);
  }
  __device__ __forceinline__ int bare(int) const { return 0; }
};

// Per-term wide configuration of short rows (K3a): block = 32 NG shots x
// wide_threads(G) threads, a lane one shot of each group of 32, as in
// "wide"'s per-shot stage. Warp w adds the graphs w, w + warps, w + 2 warps,
// ... in order, which is the order "wide" gives each warp (its chunks and
// spans start at multiples of the warp count), then the warps' sums are
// added in order: the two agree bit for bit. The chunks of n staged graphs
// only split that sequence.
template <int NG, int W64>
__global__ void __launch_bounds__(kWideThreads)
    sample_eval_per_term_wide_regs(const uint8_t* __restrict__ x, long long B, int P, Tables tb, int n,
                                   float* __restrict__ out) {
  extern __shared__ uint64_t stage_dyn[];
  const long long b0 = (long long)blockIdx.x * 32 * NG;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  uint64_t rows[NG][W64];
#pragma unroll
  for (int k = 0; k < NG; ++k) load_row<W64>(x, b0 + 32 * k + lane, B, P, rows[k]);
  float acc_re[NG], acc_im[NG];
#pragma unroll
  for (int k = 0; k < NG; ++k) {
    acc_re[k] = 0.0f;
    acc_im[k] = 0.0f;
  }
  for (int c0 = 0; c0 < tb.G; c0 += n) {
    const int m = min(n, tb.G - c0);
    __syncthreads();  // the previous chunk's masks are read
    stage_masks<W64>(tb, c0, m, stage_dyn);
    __syncthreads();
    for (int g = c0 + (warp - c0 % warps + warps) % warps; g < c0 + m; g += warps) {
      const StagedParities<NG, W64> par{tb, rows, stage_dyn + (g - c0) * W64, m * W64, g};
      accumulate_graph<kAllStages, NG>(tb, g, par, acc_re, acc_im);
    }
  }
  warps_sum_store(acc_re, acc_im, warps, b0, B, out);
}

// Per-term small configuration of short rows (K3b): a thread a shot,
// kPerTermSmallShots shots a block, every graph in order, as "small" adds
// them: the two agree bit for bit.
template <int W64>
__global__ void __launch_bounds__(kPerTermSmallShots)
    sample_eval_per_term_small_regs(const uint8_t* __restrict__ x, long long B, int P, Tables tb, int n,
                                    float* __restrict__ out) {
  extern __shared__ uint64_t stage_dyn[];
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  uint64_t rows[1][W64];
  load_row<W64>(x, b, B, P, rows[0]);
  float acc_re[1] = {0.0f}, acc_im[1] = {0.0f};
  for (int c0 = 0; c0 < tb.G; c0 += n) {
    const int m = min(n, tb.G - c0);
    __syncthreads();
    stage_masks<W64>(tb, c0, m, stage_dyn);
    __syncthreads();
    for (int g = c0; g < c0 + m; ++g) {
      const StagedParities<1, W64> par{tb, rows, stage_dyn + (g - c0) * W64, m * W64, g};
      accumulate_graph<kAllStages, 1>(tb, g, par, acc_re, acc_im);
    }
  }
  if (b < B) {
    out[b * 2] = acc_re[0];
    out[b * 2 + 1] = acc_im[0];
  }
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

template <unsigned M, int IB, int NG>
cudaError_t launch_wide_as(const uint8_t* x, long long B, int P, const Tables& tb, float* out,
                           cudaStream_t stream) {
  const int threads = wide_threads(tb.G, NG == 1 ? kWideSmallThreads : kWideThreads);
  const size_t bytes = bitsliced::shared_bytes<NG>(P, tb.T1, tb.T2, tb.T3, tb.T4, threads);
  const cudaError_t err = allow_shared(sample_eval_wide<M, IB, NG>, bytes);
  if (err != cudaSuccess) return err;
  const long long blocks = (B + 32 * NG - 1) / (32 * NG);
  sample_eval_wide<M, IB, NG><<<(unsigned)blocks, threads, bytes, stream>>>(x, B, P, tb, out);
  return cudaSuccess;
}

// The wide kernel with stage mask M and NG groups of 32 shots a block (1 or
// 4; anything else is refused).
template <unsigned M>
cudaError_t launch_wide(const uint8_t* x, long long B, int P, const Tables& tb, int groups,
                        float* out, cudaStream_t stream) {
  const bool one = bitsliced::index_bytes(P) == 1;
  switch (groups) {
    case 1: return one ? launch_wide_as<M, 1, 1>(x, B, P, tb, out, stream)
                       : launch_wide_as<M, 2, 1>(x, B, P, tb, out, stream);
    case 4: return one ? launch_wide_as<M, 1, 4>(x, B, P, tb, out, stream)
                       : launch_wide_as<M, 2, 4>(x, B, P, tb, out, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <int IB>
cudaError_t launch_small_as(const uint8_t* x, long long B, int P, const Tables& tb, float* out,
                            cudaStream_t stream) {
  const size_t bytes = bitsliced::small_shared_bytes(P, tb.G, tb.T1, tb.T2, tb.T3, tb.T4);
  const cudaError_t err = allow_shared(sample_eval_small<IB>, bytes);
  if (err != cudaSuccess) return err;
  const long long blocks = (B + bitsliced::kShots - 1) / bitsliced::kShots;
  sample_eval_small<IB><<<(unsigned)blocks, bitsliced::kShots, bytes, stream>>>(x, B, P, tb, out);
  return cudaSuccess;
}

// Graphs a chunk of staged masks holds: as many as kStageBytes take.
inline int stage_graphs(const Tables& tb, int W64) {
  const long long per_graph = 8LL * W64 * (tb.T1 + tb.T2 + 2 * tb.T3 + 2 * tb.T4);
  const long long n = per_graph ? kStageBytes / per_graph : tb.G;
  return (int)(n < 1 ? 1 : n < tb.G ? n : tb.G);
}

template <int W64>
cudaError_t launch_per_term_regs(const uint8_t* x, long long B, int P, const Tables& tb, int config,
                                 int groups, float* out, cudaStream_t stream) {
  const int n = stage_graphs(tb, W64);
  const size_t bytes = 8ull * W64 * n * (tb.T1 + tb.T2 + 2 * tb.T3 + 2 * tb.T4);
  if (config == kPerTermWide) {
    const int threads = wide_threads(tb.G);
    if (groups == 1) {
      const cudaError_t err = allow_shared(sample_eval_per_term_wide_regs<1, W64>, bytes);
      if (err != cudaSuccess) return err;
      sample_eval_per_term_wide_regs<1, W64><<<(unsigned)((B + 31) / 32), threads, bytes, stream>>>(
          x, B, P, tb, n, out);
    } else {
      const cudaError_t err = allow_shared(sample_eval_per_term_wide_regs<4, W64>, bytes);
      if (err != cudaSuccess) return err;
      sample_eval_per_term_wide_regs<4, W64><<<(unsigned)((B + 127) / 128), threads, bytes, stream>>>(
          x, B, P, tb, n, out);
    }
  } else {
    const cudaError_t err = allow_shared(sample_eval_per_term_small_regs<W64>, bytes);
    if (err != cudaSuccess) return err;
    const long long blocks = (B + kPerTermSmallShots - 1) / kPerTermSmallShots;
    sample_eval_per_term_small_regs<W64><<<(unsigned)blocks, kPerTermSmallShots, bytes, stream>>>(
        x, B, P, tb, n, out);
  }
  return cudaSuccess;
}

// The per-term configurations: rows of up to kRegisterWords 64-bit words in
// registers (the wide one with `groups` 32-shot groups a block, 1 or 4),
// longer rows through shared memory.
cudaError_t launch_per_term(const uint8_t* x, long long B, int P, const Tables& tb, int config,
                            int groups, float* out, cudaStream_t stream) {
  const int W64 = (tb.W + 1) / 2;
  if (config == kPerTermWide && groups != 1 && groups != 4) return cudaErrorInvalidValue;
  if (W64 == 1) return launch_per_term_regs<1>(x, B, P, tb, config, groups, out, stream);
  if (W64 == kRegisterWords) return launch_per_term_regs<2>(x, B, P, tb, config, groups, out, stream);
  if (config == kPerTermWide) {
    const size_t bytes = sizeof(uint32_t) * 32 * kPerTermGroups * tb.W;
    const cudaError_t err = allow_shared(sample_eval_per_term_wide, bytes);
    if (err != cudaSuccess) return err;
    const long long blocks = (B + 32 * kPerTermGroups - 1) / (32 * kPerTermGroups);
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
// kernels/sample_eval.py::ABLATION_VARIANTS (names of dev/kernel_ablate.py),
// on the 128-shot block of K1 at the sizes the ablation times.
cudaError_t launch_ablate(const uint8_t* x, long long B, int P, const Tables& tb, int variant,
                          float* out, cudaStream_t stream) {
  constexpr int NG = bitsliced::kGroups;
  switch (variant) {
    case 0: return launch_wide<0>(x, B, P, tb, NG, out, stream);                          // empty
    case 1: return launch_wide<kP1>(x, B, P, tb, NG, out, stream);                        // par1
    case 2: return launch_wide<kP1 | kP2 | kP3 | kP4>(x, B, P, tb, NG, out, stream);      // par-all
    case 3: return launch_wide<kP1 | kT1>(x, B, P, tb, NG, out, stream);                  // par1+T1
    case 4: return launch_wide<kP1 | kT1 | kP2 | kT2 | kP3 | kT3>(x, B, P, tb, NG, out, stream);  // par+T1..T3
    case 5: return launch_wide<kAllStages>(x, B, P, tb, NG, out, stream);                 // full
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x: (B, P) uint8 rows; flat: the rung's table buffer; out: (B, 2) float32.
// config: 0 small, 1 wide, 2 per-term small, 3 per-term wide, each for any
// number W of packed words a row; groups: 32-shot groups a block of "wide"
// and of "per_term_wide" on rows of up to 128 parameters, 1 or 4 (the
// others take 1). Returns the first CUDA error of the launch (0
// on success); the caller raises on anything else.
extern "C" int tsim_sample_eval(const void* x, long long B, int P, const void* flat, int G,
                                int T1, int T2, int T3, int T4, int W, int config, int groups,
                                void* out, void* stream) {
  if (B <= 0 || G <= 0 || W <= 0 || (config != kWide && config != kPerTermWide && groups != 1))
    return (int)cudaErrorInvalidValue;
  const Tables tb = make_tables(static_cast<const int32_t*>(flat), G, T1, T2, T3, T4, W);
  const uint8_t* xp = static_cast<const uint8_t*>(x);
  float* op = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaSuccess;
  switch (config) {
    case kWide: err = launch_wide<kAllStages>(xp, B, P, tb, groups, op, s); break;
    case kPerTermSmall:
    case kPerTermWide: err = launch_per_term(xp, B, P, tb, config, groups, op, s); break;
    case kSmall:
      err = bitsliced::index_bytes(P) == 1 ? launch_small_as<1>(xp, B, P, tb, op, s)
                                           : launch_small_as<2>(xp, B, P, tb, op, s);
      break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The wide kernel (128 shots a block) with the stages of ablation variant
// `variant` (0 empty, 1 par1, 2 par-all, 3 par1+T1, 4 par+T1..T3, 5 full).
extern "C" int tsim_sample_eval_ablate(const void* x, long long B, int P, const void* flat, int G,
                                       int T1, int T2, int T3, int T4, int W, int variant,
                                       void* out, void* stream) {
  if (B <= 0 || G <= 0 || W <= 0) return (int)cudaErrorInvalidValue;
  const Tables tb = make_tables(static_cast<const int32_t*>(flat), G, T1, T2, T3, T4, W);
  const cudaError_t err =
      launch_ablate(static_cast<const uint8_t*>(x), B, P, tb, variant, static_cast<float*>(out),
                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

extern "C" const char* tsim_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
