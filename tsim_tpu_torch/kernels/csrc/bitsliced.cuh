// Bit-sliced parity front end of the wide kernels (sample_eval.cu `wide`,
// exact_eval.cu `exact_wide` and `approx_wide`), and of the small ones
// (sample_eval.cu `small`, exact_eval.cu `exact_small` and `approx_small`),
// which use its planes and lists with a thread a mask (small_front_end, at
// the end).
//
// A parity is x . mask mod 2 for a shot's 0/1 parameter row x and a term's
// parameter mask. The TPU kernels form it as a matrix-unit dot; the first
// Hopper kernels formed it per shot as the popcount parity of (x & mask)
// over packed words, and were bound by the popcount unit, which runs at a
// quarter of the int32 rate. Here a block takes NG groups of 32 shots (NG = 4,
// 128 shots; `wide` also has an instance of NG = 1 for launches of few rows,
// see sample_eval.cu) and first turns their rows into bit planes in shared
// memory: plane p holds parameter p of the block's shots, one shot a bit, one
// word a group. The parity of a mask for all the block's shots at once is
// then the XOR of the planes of the mask's set parameters: one shared memory
// load of NG words and NG XORs per set parameter per block, no popcount, and
// nothing at all for the all-zero masks that pad the tables.
//
// A thread owns one graph. It walks a host-built stream of the set
// parameters of the graph's masks (compile/bit_lists.py). The stream has the
// same shape for every graph of the rung: row r takes the words
// base[r] .. base[r + 1] - 1, a word holds 4 parameter indices of one byte
// (2 of two bytes where the rung has 256 parameters or more), word w of graph
// g lies at words[w * G + g], and a list shorter than its row's slot is
// padded with the index P of an all-zero plane. So the walk has no
// data-dependent branch and no load whose address depends on loaded data
// except the plane reads: trip counts are uniform, the compiler unrolls the
// loop and keeps several loads in flight, and the lanes of a warp, which hold
// neighbouring graphs, load neighbouring words. (A first version walked
// per-graph counts: its chain of dependent loads left the kernel slower than
// the popcount it replaced.) Rows are ordered: T1 node-phase rows; T2
// half-pi rows; T3 pi-product terms of two rows (psi, phi); T4 phase-pair
// terms of two rows (alpha, beta). The half-pi rows and pi-product terms of
// each graph are sorted by falling weight on the host, dead ones last: both
// families only accumulate (a sum mod 8, an XOR), so their order is free,
// sorted rows of like rank have like weight across the graphs, which keeps
// the padding small, and the rung's dead tail (base[R + 1] live half-pi rows,
// base[R + 2] live pi-product terms at most) is never walked. A half-pi
// row's coefficient and a pi-product side's constant are the aux of
// meta[r][g] = count | aux << 16.
//
// The half-pi total stays bit-sliced (three bit planes, a ripple-carry add of
// coeff * parity word) and so does the pi-product sign (one word); only the
// node-phase and phase-pair parity words are kept per row. All of it goes to
// the graph's column of shared memory, because the per-shot stage that
// follows turns the block round: there a lane is a shot of each group (bit
// `lane` of every word) and a warp takes one graph at a time, so whatever
// belongs to the graph (table entries, rotation indices, the entries of its
// column) is the same for all 32 lanes and is loaded once for the block's
// shots, a thread carries NG shots' running values, and no reduction over
// graphs crosses lanes.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace bitsliced {

constexpr int kGroups = 4;                // 32-shot groups per block of the 128-shot instances
constexpr int kShots = 32 * kGroups;      // their shots per block
constexpr int kAhead = 4;                 // words of the list stream loaded ahead of their use
constexpr int kSliced = 5;                // entries a column holds beside its parity entries

// Family/stage mask bits: kPk forms family k's parities, kTk applies its
// factors. Only the stage ablation of sample_eval.cu switches any off.
constexpr unsigned kP1 = 1, kT1 = 2, kP2 = 4, kT2 = 8, kP3 = 16, kT3 = 32, kP4 = 64, kT4 = 128;
constexpr unsigned kAllStages = 255;

// The list segments of a table buffer, in the order of
// tsim_tpu_torch/compile/bit_lists.py::bit_list_layout.
struct Lists {
  const int32_t* base;    // (R + 3): first word of each row's slot; S; live T2; live T3
  const int32_t* meta;    // (R, G): count | aux << 16
  const uint32_t* words;  // (S + kAhead, G): parameter indices, 4 or 2 a word
  int G, T1, T2, T3, T4;
};

// Bytes of a parameter index: one while P and the zero plane's index P fit a
// byte (compile/bit_lists.py::index_bytes is the same rule).
inline int index_bytes(int P) { return P < 256 ? 1 : 2; }

inline Lists make_lists(const int32_t* p, int G, int T1, int T2, int T3, int T4) {
  const long long R = (long long)T1 + T2 + 2LL * T3 + 2LL * T4;
  Lists bl;
  bl.base = p;
  bl.meta = bl.base + R + 3;
  bl.words = reinterpret_cast<const uint32_t*>(bl.meta + R * G);
  bl.G = G;
  bl.T1 = T1;
  bl.T2 = T2;
  bl.T3 = T3;
  bl.T4 = T4;
  return bl;
}

// An entry is NG words, one per 32-shot group of the block, aligned to its
// size (16 bytes for NG = 4), read and written with one vector access.
template <int NG>
struct alignas(4 * NG) Entry {
  static_assert(NG == 1 || NG == 4, "a block takes 32 or 128 shots");
  uint32_t w[NG];
};

// The kernel's dynamic shared memory as entries of NG words. One byte array
// serves every instance: an extern __shared__ array may not change its type
// between the kernels of a file.
template <int NG>
__device__ __forceinline__ Entry<NG>* dynamic_entries() {
  extern __shared__ __align__(16) unsigned char bs_dyn_bytes[];
  return reinterpret_cast<Entry<NG>*>(bs_dyn_bytes);
}

// The front end's dynamic shared memory, in entries: P planes and the zero
// plane; the R + 3 words of `base`, padded to whole entries; then one column
// of T1 + 2 T4 + kSliced entries per thread (entry j of thread t's column at
// columns[j * threads + t]).
__host__ __device__ inline int base_words(int T1, int T2, int T3, int T4) {
  return T1 + T2 + 2 * T3 + 2 * T4 + 3;
}
template <int NG>
__host__ __device__ inline size_t column_offset(int P, int T1, int T2, int T3, int T4) {
  return (size_t)P + 1 + (base_words(T1, T2, T3, T4) + NG - 1) / NG;
}
template <int NG>
inline size_t shared_bytes(int P, int T1, int T2, int T3, int T4, int threads) {
  return sizeof(Entry<NG>) *
         (column_offset<NG>(P, T1, T2, T3, T4) + (size_t)(T1 + 2 * T4 + kSliced) * threads);
}

// planes[p], p < P: bit s of word k = parameter p of shot b0 + 32 k + s, 0
// past the batch's end; planes[P] = 0; then the copy of `base`. Lane s reads
// byte p of its group's row and one ballot gathers the 32 bits; the block's
// warps share the P parameters. The caller synchronises.
template <int NG>
__device__ __forceinline__ void build_planes(const uint8_t* __restrict__ x, long long B, int P,
                                             long long b0, const Lists& bl, Entry<NG>* planes) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  for (int p = warp; p < P; p += warps) {
    Entry<NG> e;
#pragma unroll
    for (int k = 0; k < NG; ++k) {
      const long long b = b0 + 32 * k + lane;
      e.w[k] = __ballot_sync(0xffffffffu, b < B && (x[b * P + p] & 1));
    }
    if (lane == 0) planes[p] = e;
  }
  if (threadIdx.x < NG) planes[P].w[threadIdx.x] = 0u;
  uint32_t* base = planes[P + 1].w;
  const int n = base_words(bl.T1, bl.T2, bl.T3, bl.T4);
  for (int i = threadIdx.x; i < n; i += blockDim.x) base[i] = (uint32_t)__ldg(bl.base + i);
}

template <int NG>
__device__ __forceinline__ void entry_xor(Entry<NG>& a, const Entry<NG>& b) {
#pragma unroll
  for (int k = 0; k < NG; ++k) a.w[k] ^= b.w[k];
}

// acc ^= the planes that one word of a list names: 4 indices of one byte, or 2
// of two bytes (IB).
template <int IB, int NG>
__device__ __forceinline__ void xor_listed(Entry<NG>& acc, const Entry<NG>* planes, uint32_t e) {
  if (IB == 1) {
    entry_xor(acc, planes[e & 255u]);
    entry_xor(acc, planes[(e >> 8) & 255u]);
    entry_xor(acc, planes[(e >> 16) & 255u]);
    entry_xor(acc, planes[e >> 24]);
  } else {
    entry_xor(acc, planes[e & 0xffffu]);
    entry_xor(acc, planes[e >> 16]);
  }
}

// Walks graph g's stream row by row, in order. The next kAhead words are
// always in registers, loaded kAhead words before their use, whatever rows
// they belong to: rows are a few words long, so a load started at its row's
// start would be waited for in full. The stream ends in kAhead padding words.
template <int IB, int NG>
struct Walker {
  const Lists& bl;
  const Entry<NG>* planes;
  const int32_t* base;    // the block's copy of bl.base in shared memory
  const int32_t* end;     // the entry of `base` for the row after the next
  const int32_t* meta;    // the next row's meta entry for graph g
  const uint32_t* ahead;  // word pos + kAhead of graph g's stream
  uint32_t queue[kAhead];
  int g, pos, hi;  // the next row's first word and the row after's

  __device__ __forceinline__ Walker(const Lists& lists, int graph, const Entry<NG>* shared_planes,
                                    const int32_t* shared_base)
      : bl(lists), planes(shared_planes), base(shared_base), end(shared_base + 1),
        meta(lists.meta + graph), g(graph), pos(0), hi(shared_base[1]) {
    fill();
  }
  __device__ __forceinline__ void fill() {
    ahead = bl.words + (long long)pos * bl.G + g;
#pragma unroll
    for (int i = 0; i < kAhead; ++i, ahead += bl.G) queue[i] = __ldg(ahead);
  }
  // Skips to row r; free where only empty rows are skipped.
  __device__ __forceinline__ void seek(int r) {
    const int lo = base[r];
    end = base + r + 1;
    meta = bl.meta + (long long)r * bl.G + g;
    hi = *end;
    if (lo != pos) {
      pos = lo;
      fill();
    }
  }
  // The aux of the next row.
  __device__ __forceinline__ int aux() const { return __ldg(meta) >> 16; }
  // Parity entry of the next row (bit s of word k = shot 32 k + s); moves on
  // to the row after.
  __device__ __forceinline__ Entry<NG> word() {
    Entry<NG> acc{};
    for (; pos < hi; ++pos, ahead += bl.G) {
      const uint32_t e = queue[0];
#pragma unroll
      for (int i = 0; i + 1 < kAhead; ++i) queue[i] = queue[i + 1];
      queue[kAhead - 1] = __ldg(ahead);
      xor_listed<IB>(acc, planes, e);
    }
    meta += bl.G;
    hi = *++end;
    return acc;
  }
};

// (t0, t1, t2) += c * w mod 8 for each of a word's 32 shots: three bit planes
// of the total, c in [0, 8).
__device__ __forceinline__ void ripple_add_word(uint32_t& t0, uint32_t& t1, uint32_t& t2, uint32_t w,
                                                int c) {
  const uint32_t a0 = (c & 1) ? w : 0u, a1 = (c & 2) ? w : 0u, a2 = (c & 4) ? w : 0u;
  const uint32_t c0 = t0 & a0;
  const uint32_t c1 = (t1 & a1) | (c0 & (t1 ^ a1));
  t0 ^= a0;
  t1 ^= a1 ^ c0;
  t2 ^= a2 ^ c1;
}

// tot += c * w mod 8 for every shot of the block.
template <int NG>
__device__ __forceinline__ void ripple_add(Entry<NG> (&tot)[3], const Entry<NG>& w, int c) {
#pragma unroll
  for (int k = 0; k < NG; ++k) ripple_add_word(tot[0].w[k], tot[1].w[k], tot[2].w[k], w.w[k], c);
}

// The integer stage of graph g under stage mask M, IB bytes an index, with
// the planes and the copy `base` of bl.base in shared memory: walks the rows
// of the families whose parities M forms and fills the graph's column `col`
// (entries `stride` apart): the node-phase parities at entries t < T1, the
// phase-pair parities at T1 + 2t (alpha) and T1 + 2t + 1 (beta), then kSliced
// entries: the three bit planes of the half-pi total mod 8, the pi-product
// sign, and the XOR of the parities formed without their factors.
template <unsigned M, int IB, int NG>
__device__ __forceinline__ void integer_stage(const Lists& bl, int g, const Entry<NG>* planes,
                                              const int32_t* base, Entry<NG>* col, int stride) {
  using E = Entry<NG>;
  E tot[3] = {}, sgn{}, bare{};
  const int R = bl.T1 + bl.T2 + 2 * bl.T3 + 2 * bl.T4;
  Walker<IB, NG> walk(bl, g, planes, base);
  if (M & kP1) {
    for (int t = 0; t < bl.T1; ++t) {
      const E w = walk.word();
      if (M & kT1) col[t * stride] = w; else entry_xor(bare, w);
    }
  }
  if (M & kP2) {
    const int n = base[R + 1];
    walk.seek(bl.T1);
    for (int r = 0; r < n; ++r) {
      const int coeff = walk.aux();
      const E w = walk.word();
      if (M & kT2) ripple_add(tot, w, coeff); else entry_xor(bare, w);
    }
  }
  if (M & kP3) {
    const int n = base[R + 2];
    walk.seek(bl.T1 + bl.T2);
    for (int r = 0; r < n; ++r) {
      const uint32_t pc = 0u - (uint32_t)(walk.aux() & 1);
      const E p = walk.word();
      const uint32_t qc = 0u - (uint32_t)(walk.aux() & 1);
      const E q = walk.word();
#pragma unroll
      for (int k = 0; k < NG; ++k) {
        if (M & kT3) sgn.w[k] ^= (p.w[k] ^ pc) & (q.w[k] ^ qc);
        else bare.w[k] ^= p.w[k] ^ q.w[k];
      }
    }
  }
  if (M & kP4) {
    walk.seek(bl.T1 + bl.T2 + 2 * bl.T3);
    for (int t = 0; t < bl.T4; ++t) {
      const E a = walk.word();
      const E b = walk.word();
      if (M & kT4) {
        col[(bl.T1 + 2 * t) * stride] = a;
        col[(bl.T1 + 2 * t + 1) * stride] = b;
      } else {
        entry_xor(bare, a);
        entry_xor(bare, b);
      }
    }
  }
  E* sliced = col + (bl.T1 + 2 * bl.T4) * stride;
  sliced[0] = tot[0];
  sliced[stride] = tot[1];
  sliced[2 * stride] = tot[2];
  sliced[3 * stride] = sgn;
  sliced[4 * stride] = bare;
}

// exact_wide's vanish entry (compile/node_fold.py): the OR over the rows of
// `bl`, graph g's node-phase terms of phase 0 or 4 (T1 rows and no other
// family), of each row's parity XOR its aux (1 for phase 4), so that bit s
// of word k is set where shot 32 k + s has a factor 1 + w^4 = 0. `base` is
// bl.base, read where it lies.
template <int IB, int NG>
__device__ __forceinline__ Entry<NG> vanish_stage(const Lists& bl, int g, const Entry<NG>* planes,
                                                  const int32_t* base) {
  Entry<NG> van{};
  Walker<IB, NG> walk(bl, g, planes, base);
  for (int t = 0; t < bl.T1; ++t) {
    const uint32_t c = 0u - (uint32_t)(walk.aux() & 1);
    const Entry<NG> w = walk.word();
#pragma unroll
    for (int k = 0; k < NG; ++k) van.w[k] |= w.w[k] ^ c;
  }
  return van;
}

// The values of one graph for a thread's NG shots (shot 32 k + lane of the
// block for k < NG), read from the graph's column: bit `lane` of word k of
// every entry. The parity source of the per-shot stage.
template <int NG>
struct Column {
  const Entry<NG>* col;  // the graph's column, entries `stride` apart
  int stride, T1, T4, lane;

  __device__ __forceinline__ void bits(int entry, int (&p)[NG]) const {
    const Entry<NG> e = col[entry * stride];
#pragma unroll
    for (int k = 0; k < NG; ++k) p[k] = (e.w[k] >> lane) & 1;
  }
  __device__ __forceinline__ void node(int t, int (&p)[NG]) const { bits(t, p); }
  __device__ __forceinline__ void halfpi(int (&tot)[NG]) const {
    int hi[NG];
    bits(T1 + 2 * T4, tot);
#pragma unroll
    for (int j = 1; j < 3; ++j) {
      bits(T1 + 2 * T4 + j, hi);
#pragma unroll
      for (int k = 0; k < NG; ++k) tot[k] |= hi[k] << j;
    }
  }
  __device__ __forceinline__ void sign(int (&sgn)[NG]) const { bits(T1 + 2 * T4 + 3, sgn); }
  __device__ __forceinline__ void pair(int t, int (&p)[NG], int (&q)[NG]) const {
    bits(T1 + 2 * t, p);
    bits(T1 + 2 * t + 1, q);
  }
  __device__ __forceinline__ int bare(int k) const {
    return (col[(T1 + 2 * T4 + 4) * stride].w[k] >> lane) & 1;
  }
  // exact_wide's vanish entry (vanish_stage), whole, after the kSliced ones.
  __device__ __forceinline__ Entry<NG> vanish() const { return col[(T1 + 2 * T4 + kSliced) * stride]; }
};

// ---------------------------------------------------------- the small kernels
//
// With fewer than 24 graphs a thread a graph would leave most of the block
// idle in the integer stage. The small kernels (sample_eval.cu `small`, K2;
// exact_eval.cu `exact_small`, K7a, and `approx_small`, K7b) take kShots shots
// a block, a thread a shot, and share this front end. It builds the planes; then a thread is a
// mask: the R * G list rows of the rung are dealt out over the block, and
// each thread XORs the planes its row lists for all 128 shots and leaves the
// parity entry in shared memory (row r of graph g at rows[r * G + g]). Then a
// thread is one word of one graph: it folds the graph's half-pi rows into the
// three bit planes of the total mod 8 (rows[(R + j) * G + g], j < 3; mod 8 is
// all that either product reads) and its pi-product rows into the sign
// (rows[(R + 3) * G + g]). A rung without terms (R = 0) builds nothing. After
// it a thread is a shot and walks all graphs in order, reading its bits
// through ShotRows.

// Dynamic shared memory of a small kernel's block, in bytes: the planes and
// the lists' row table, then R + 4 entries a graph; none without terms.
inline size_t small_shared_bytes(int P, int G, int T1, int T2, int T3, int T4) {
  const int R = T1 + T2 + 2 * T3 + 2 * T4;
  if (R == 0) return 0;
  return sizeof(Entry<kGroups>) * (column_offset<kGroups>(P, T1, T2, T3, T4) + (size_t)(R + 4) * G);
}

// The small front end of the block whose first shot is b0, IB bytes an index
// of the lists, in the dynamic shared memory `smem`; returns its rows. Every
// thread of the block calls it: it synchronises the block.
template <int IB>
__device__ __forceinline__ const Entry<kGroups>* small_front_end(const uint8_t* __restrict__ x,
                                                                 long long B, int P, long long b0,
                                                                 const Lists& bl,
                                                                 Entry<kGroups>* smem) {
  using E = Entry<kGroups>;
  const int tid = threadIdx.x, G = bl.G;
  const int R = bl.T1 + bl.T2 + 2 * bl.T3 + 2 * bl.T4;
  const int32_t* base = reinterpret_cast<const int32_t*>(smem + P + 1);
  E* rows = smem + column_offset<kGroups>(P, bl.T1, bl.T2, bl.T3, bl.T4);
  if (R == 0) return rows;
  build_planes(x, B, P, b0, bl, smem);
  __syncthreads();
  for (int i = tid; i < R * G; i += blockDim.x) {
    const int r = i / G, g = i - r * G;
    const int lo = base[r], hi = base[r + 1];
    const uint32_t* word = bl.words + (long long)lo * G + g;
    E acc{};
    for (int j = lo; j < hi; ++j, word += G) xor_listed<IB>(acc, smem, __ldg(word));
    rows[i] = acc;
  }
  __syncthreads();
  const int live2 = base[R + 1], live3 = base[R + 2];
  for (int i = tid; i < G * kGroups; i += blockDim.x) {
    const int g = i / kGroups, k = i - g * kGroups;
    uint32_t t0 = 0u, t1 = 0u, t2 = 0u, sgn = 0u;
    for (int r = bl.T1; r < bl.T1 + live2; ++r)
      ripple_add_word(t0, t1, t2, rows[r * G + g].w[k], __ldg(bl.meta + r * G + g) >> 16);
    for (int r = bl.T1 + bl.T2; r < bl.T1 + bl.T2 + 2 * live3; r += 2) {
      const uint32_t pc = 0u - (uint32_t)((__ldg(bl.meta + r * G + g) >> 16) & 1);
      const uint32_t qc = 0u - (uint32_t)((__ldg(bl.meta + (r + 1) * G + g) >> 16) & 1);
      sgn ^= (rows[r * G + g].w[k] ^ pc) & (rows[(r + 1) * G + g].w[k] ^ qc);
    }
    rows[R * G + g].w[k] = t0;
    rows[(R + 1) * G + g].w[k] = t1;
    rows[(R + 2) * G + g].w[k] = t2;
    rows[(R + 3) * G + g].w[k] = sgn;
  }
  __syncthreads();
  return rows;
}

// One shot's parities of graph g, read from the rows that small_front_end
// left in shared memory: bit `lane` of word `group` of row r's entry; the
// graph's half-pi total (three bit planes) and pi-product sign follow the R
// list rows. The parity source of the small kernels' per-shot stage.
struct ShotRows {
  const Entry<kGroups>* rows;
  int G, g, T1, R, pairs, group, lane;  // pairs: the first phase-pair row

  // The source of graph g for thread `tid` of the block.
  __device__ __forceinline__ ShotRows(const Entry<kGroups>* shared_rows, const Lists& bl, int graph,
                                      int tid)
      : rows(shared_rows), G(bl.G), g(graph), T1(bl.T1),
        R(bl.T1 + bl.T2 + 2 * bl.T3 + 2 * bl.T4), pairs(bl.T1 + bl.T2 + 2 * bl.T3),
        group(tid >> 5), lane(tid & 31) {}

  __device__ __forceinline__ int bit(int row) const {
    return (int)((rows[row * G + g].w[group] >> lane) & 1u);
  }
  __device__ __forceinline__ void node(int t, int (&p)[1]) const { p[0] = bit(t); }
  __device__ __forceinline__ void halfpi(int (&tot)[1]) const {
    tot[0] = bit(R) | bit(R + 1) << 1 | bit(R + 2) << 2;
  }
  __device__ __forceinline__ void sign(int (&sgn)[1]) const { sgn[0] = bit(R + 3); }
  __device__ __forceinline__ void pair(int t, int (&p)[1], int (&q)[1]) const {
    p[0] = bit(pairs + 2 * t);
    q[0] = bit(pairs + 2 * t + 1);
  }
  __device__ __forceinline__ int bare(int) const { return 0; }
};

}  // namespace bitsliced
