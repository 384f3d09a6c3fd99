// Bit-packed Pauli-frame batch sampler.
//
// Native-runtime counterpart of the Python FrameSampler in
// ../../stim_core/frame.py (the role Stim's C++ frame simulator plays for
// the reference, SURVEY.md section 2.1): frames are packed 64 shots/word,
// Clifford gates are word-wide XORs, and noise uses geometric-skip
// sampling so cost scales with the number of *fired* errors rather than
// shots x channels.
//
// The op stream is compiled on the Python side (native_frame.py); this
// file only executes it. C ABI for ctypes.

#include <cstdint>
#include <cstring>
#include <cmath>
#include <vector>

namespace {

// ----------------------------------------------------------------- RNG
// xoshiro256++ (public domain construction), seeded via splitmix64.
struct Rng {
  uint64_t s[4];
  explicit Rng(uint64_t seed) {
    uint64_t x = seed;
    for (int i = 0; i < 4; i++) {
      x += 0x9e3779b97f4a7c15ULL;
      uint64_t z = x;
      z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ULL;
      z = (z ^ (z >> 27)) * 0x94d049bb133111ebULL;
      s[i] = z ^ (z >> 31);
    }
  }
  static inline uint64_t rotl(uint64_t v, int k) {
    return (v << k) | (v >> (64 - k));
  }
  inline uint64_t next() {
    uint64_t r = rotl(s[0] + s[3], 23) + s[0];
    uint64_t t = s[1] << 17;
    s[2] ^= s[0];
    s[3] ^= s[1];
    s[1] ^= s[2];
    s[0] ^= s[3];
    s[2] ^= t;
    s[3] = rotl(s[3], 45);
    return r;
  }
  inline double uniform() {  // in [0, 1)
    return (next() >> 11) * 0x1.0p-53;
  }
  // Geometric skip: number of Bernoulli(p) failures before the next
  // success. Advancing a shot cursor by 1 + skip visits exactly the
  // fired shots.
  inline int64_t skip(double p) {
    if (p >= 1.0) return 0;
    double u = uniform();
    if (u <= 0.0) u = 0x1.0p-53;
    return (int64_t)std::floor(std::log(u) / std::log1p(-p));
  }
};

struct Frame {
  int64_t W;           // words per row
  uint64_t* fx;        // (n_qubits, W)
  uint64_t* fz;
  inline uint64_t* x(int64_t q) { return fx + q * W; }
  inline uint64_t* z(int64_t q) { return fz + q * W; }
};

inline void xor_row(uint64_t* dst, const uint64_t* src, int64_t W) {
  for (int64_t w = 0; w < W; w++) dst[w] ^= src[w];
}

inline void flip_bit(uint64_t* row, int64_t s) { row[s >> 6] ^= 1ULL << (s & 63); }

// Apply a single-qubit frame transform given 4 packed bits:
// nfx = b0*fx ^ b1*fz ; nfz = b2*fx ^ b3*fz.
inline void gate1(Frame& f, int64_t q, int bits) {
  uint64_t *x = f.x(q), *z = f.z(q);
  for (int64_t w = 0; w < f.W; w++) {
    uint64_t ox = x[w], oz = z[w];
    uint64_t nx = 0, nz = 0;
    if (bits & 1) nx ^= ox;
    if (bits & 2) nx ^= oz;
    if (bits & 4) nz ^= ox;
    if (bits & 8) nz ^= oz;
    x[w] = nx;
    z[w] = nz;
  }
}

// 4x4 binary transform on (x1, z1, x2, z2); bits row-major (16 bits).
inline void gate2(Frame& f, int64_t q1, int64_t q2, int bits) {
  uint64_t *x1 = f.x(q1), *z1 = f.z(q1), *x2 = f.x(q2), *z2 = f.z(q2);
  for (int64_t w = 0; w < f.W; w++) {
    uint64_t in[4] = {x1[w], z1[w], x2[w], z2[w]};
    uint64_t out[4] = {0, 0, 0, 0};
    for (int r = 0; r < 4; r++)
      for (int c = 0; c < 4; c++)
        if ((bits >> (r * 4 + c)) & 1) out[r] ^= in[c];
    x1[w] = out[0];
    z1[w] = out[1];
    x2[w] = out[2];
    z2[w] = out[3];
  }
}

// Geometric-skip Bernoulli(p) XOR of a fresh error into selected rows.
template <typename Fn>
inline void for_fired(Rng& rng, double p, int64_t shots, Fn&& fn) {
  if (p <= 0.0) return;
  int64_t s = rng.skip(p);
  while (s < shots) {
    fn(s);
    s += 1 + rng.skip(p);
  }
}

}  // namespace

namespace {

// In-place 64x64 bit-matrix transpose (LSB-first convention: output word s
// bit r = input word r bit s). Recursive block-swap, 6 rounds.
inline void transpose64(uint64_t a[64]) {
  uint64_t m = 0x00000000FFFFFFFFULL;
  for (int j = 32; j; j >>= 1, m ^= m << j) {
    for (int k = 0; k < 64; k = (k + j + 1) & ~j) {
      uint64_t t = ((a[k] >> j) ^ a[k + j]) & m;
      a[k] ^= t << j;
      a[k + j] ^= t;
    }
  }
}

}  // namespace

// Repack row-major bit rows (rows, W words) into shot-major packed rows
// (W*64, stride words): out[s] bit r = in[r] bit s.
extern "C" void tsim_bit_transpose(const uint64_t* in, int64_t rows,
                                   int64_t W, uint64_t* out,
                                   int64_t out_stride_words) {
  const int64_t row_blocks = (rows + 63) >> 6;
  uint64_t block[64];
  for (int64_t rb = 0; rb < row_blocks; rb++) {
    const int64_t r0 = rb << 6;
    const int64_t nr = rows - r0 < 64 ? rows - r0 : 64;
    for (int64_t w = 0; w < W; w++) {
      for (int64_t r = 0; r < nr; r++) block[r] = in[(r0 + r) * W + w];
      for (int64_t r = nr; r < 64; r++) block[r] = 0;
      transpose64(block);
      uint64_t* dst = out + (w << 6) * out_stride_words + rb;
      for (int64_t s = 0; s < 64; s++)
        dst[s * out_stride_words] = block[s];
    }
  }
}

// Transpose + expand in one pass: row-major bit rows (rows, W words) into
// shot-major uint8 0/1 rows out[s * rows + r] for s < shots. Replaces the
// numpy transpose + unpackbits epilogue, which dominated end-to-end
// Clifford sampling (np.unpackbits ran at ~150 MB/s; a spread-LUT write
// runs at memory bandwidth).
// ``out_stride``: bytes between consecutive shots' rows (= ``rows`` for a
// dense (shots, rows) array; larger when writing into a column slice of a
// wider joined output).
extern "C" void tsim_unpack_rows(const uint64_t* in, int64_t rows, int64_t W,
                                 int64_t shots, uint8_t* out,
                                 int64_t out_stride) {
  static uint64_t lut[256];
  static bool lut_init = false;
  if (!lut_init) {
    for (int b = 0; b < 256; b++) {
      uint64_t v = 0;
      for (int j = 0; j < 8; j++) v |= (uint64_t)((b >> j) & 1) << (8 * j);
      lut[b] = v;
    }
    lut_init = true;
  }
  const int64_t row_blocks = (rows + 63) >> 6;
  // Word-major order: transpose ALL row blocks of one shot-word first,
  // then emit each shot's full output row contiguously. Every output
  // cache line is touched exactly once with sequential writes (the
  // earlier row-block-major order swept the multi-GB output once per row
  // block, i.e. rows/64 read-allocate passes; measured ~6x more DRAM
  // traffic and 64 MB/s effective on the d=7 surface-code workload).
  std::vector<uint64_t> tb((size_t)row_blocks << 6);
  for (int64_t w = 0; w < W; w++) {
    for (int64_t rb = 0; rb < row_blocks; rb++) {
      const int64_t r0 = rb << 6;
      const int64_t nr = rows - r0 < 64 ? rows - r0 : 64;
      uint64_t* block = tb.data() + (rb << 6);
      for (int64_t r = 0; r < nr; r++) block[r] = in[(r0 + r) * W + w];
      for (int64_t r = nr; r < 64; r++) block[r] = 0;
      transpose64(block);
    }
    const int64_t s0 = w << 6;
    const int64_t ns = shots - s0 < 64 ? shots - s0 : 64;
    for (int64_t s = 0; s < ns; s++) {
      uint8_t* dst = out + (s0 + s) * out_stride;
      for (int64_t rb = 0; rb < row_blocks; rb++) {
        const int64_t r0 = rb << 6;
        const int64_t nr = rows - r0 < 64 ? rows - r0 : 64;
        const uint64_t bits = tb[(rb << 6) + s];
        const int64_t full = nr >> 3;  // whole 8-byte chunks
        for (int64_t chunk = 0; chunk < full; chunk++) {
          uint64_t v = lut[(bits >> (8 * chunk)) & 0xff];
          std::memcpy(dst + r0 + 8 * chunk, &v, 8);
        }
        // Trailing partial chunk: write singly so a column-slice
        // destination's neighbours are never clobbered.
        const int64_t rem = nr - 8 * full;
        if (rem) {
          uint64_t v = lut[(bits >> (8 * full)) & 0xff];
          for (int64_t j = 0; j < rem; j++)
            dst[r0 + 8 * full + j] = (uint8_t)(v >> (8 * j));
        }
      }
    }
  }
}

// Opcodes (must match native_frame.py).
enum : int32_t {
  OP_GATE1 = 0,
  OP_GATE2 = 1,
  OP_MEAS = 2,       // a=rec_idx, b=ref_bit, darg=[p_flip], aux=(q,mask)*
  OP_GAUGE_SET = 3,  // a=q, b=mode
  OP_GAUGE_PROD = 4, // aux=(q,mask)*  shared random word
  OP_ERR1 = 5,       // a=q, b=mask, darg=[p]
  OP_DEP1 = 6,       // a=q, darg=[p]
  OP_DEP2 = 7,       // a=q0, b=q1, darg=[p]
  OP_PC1 = 8,        // a=q, darg=[px,py,pz]
  OP_PC2 = 9,        // a=q0, b=q1, darg=[15 probs]
  OP_HERALD = 10,    // a=rec_idx, b=q, darg=[pI,pX,pY,pZ]
  OP_CORR = 11,      // c=reset, darg=[p], aux=(q,mask)*
  OP_DET = 12,       // a=det_idx, b=ref_parity, aux=rec_idx*
  OP_OBS = 13,       // a=obs_idx, aux=rec_idx*
  OP_RC_PAULI = 14,  // a=q, b=rec_idx, c=mask|ref<<2
};

extern "C" void tsim_frame_run(
    const int32_t* ops, int64_t n_ops, const int32_t* aux, const double* dargs,
    uint64_t seed, int64_t shots, int64_t n_qubits, int64_t num_meas,
    int64_t num_det, int64_t num_obs, uint64_t* rec, uint64_t* dets,
    uint64_t* obs) {
  const int64_t W = (shots + 63) >> 6;
  Rng rng(seed);
  std::vector<uint64_t> fx_buf(n_qubits * W, 0);
  std::vector<uint64_t> fz_buf(n_qubits * W);
  std::vector<uint64_t> rword(W);
  std::vector<uint64_t> prev_corr(W, 0);
  Frame f{W, fx_buf.data(), fz_buf.data()};
  // Initial resets leave the Z-stabilizer gauge direction random; this is
  // what becomes genuine measurement randomness downstream.
  for (auto& w : fz_buf) w = rng.next();

  std::memset(rec, 0, (size_t)(num_meas * W) * 8);
  std::memset(dets, 0, (size_t)(num_det * W) * 8);
  std::memset(obs, 0, (size_t)(num_obs * W) * 8);

  for (int64_t i = 0; i < n_ops; i++) {
    const int32_t* o = ops + i * 7;
    const int32_t op = o[0], a = o[1], b = o[2], c = o[3];
    const int32_t aux_off = o[4], aux_n = o[5];
    const double* dp = dargs + o[6];
    switch (op) {
      case OP_GATE1:
        gate1(f, a, b);
        break;
      case OP_GATE2:
        gate2(f, a, b, c);
        break;
      case OP_MEAS: {
        uint64_t* row = rec + (int64_t)a * W;
        std::memset(row, b ? 0xff : 0x00, (size_t)W * 8);
        for (int32_t t = 0; t < aux_n; t++) {
          int64_t q = aux[aux_off + 2 * t];
          int32_t m = aux[aux_off + 2 * t + 1];
          if (m & 1) xor_row(row, f.x(q), W);
          if (m & 2) xor_row(row, f.z(q), W);
        }
        for_fired(rng, dp[0], shots, [&](int64_t s) { flip_bit(row, s); });
        break;
      }
      case OP_GAUGE_SET: {
        uint64_t *x = f.x(a), *z = f.z(a);
        switch (b) {
          case 0:  // R/RZ, MRZ: fx=0, fz=rand
            for (int64_t w = 0; w < W; w++) { x[w] = 0; z[w] = rng.next(); }
            break;
          case 1:  // RX, MRX: fz=0, fx=rand
            for (int64_t w = 0; w < W; w++) { z[w] = 0; x[w] = rng.next(); }
            break;
          case 2:  // RY, MRY: fx=fz=r
            for (int64_t w = 0; w < W; w++) { uint64_t r = rng.next(); x[w] = r; z[w] = r; }
            break;
          case 3:  // MZ: fz=rand
            for (int64_t w = 0; w < W; w++) z[w] = rng.next();
            break;
          case 4:  // MX: fx=rand
            for (int64_t w = 0; w < W; w++) x[w] = rng.next();
            break;
          case 5:  // MY: fx^=r, fz^=r
            for (int64_t w = 0; w < W; w++) { uint64_t r = rng.next(); x[w] ^= r; z[w] ^= r; }
            break;
        }
        break;
      }
      case OP_GAUGE_PROD: {
        for (int64_t w = 0; w < W; w++) rword[w] = rng.next();
        for (int32_t t = 0; t < aux_n; t++) {
          int64_t q = aux[aux_off + 2 * t];
          int32_t m = aux[aux_off + 2 * t + 1];
          if (m & 1) xor_row(f.x(q), rword.data(), W);
          if (m & 2) xor_row(f.z(q), rword.data(), W);
        }
        break;
      }
      case OP_ERR1:
        for_fired(rng, dp[0], shots, [&](int64_t s) {
          if (b & 1) flip_bit(f.x(a), s);
          if (b & 2) flip_bit(f.z(a), s);
        });
        break;
      case OP_DEP1:
        for_fired(rng, dp[0], shots, [&](int64_t s) {
          // uniform over X(1), Y(3), Z(2)
          static const int masks[3] = {1, 3, 2};
          int m = masks[(int)(rng.uniform() * 3.0) % 3];
          if (m & 1) flip_bit(f.x(a), s);
          if (m & 2) flip_bit(f.z(a), s);
        });
        break;
      case OP_DEP2:
        for_fired(rng, dp[0], shots, [&](int64_t s) {
          int which = 1 + (int)(rng.uniform() * 15.0) % 15;
          if (which & 1) flip_bit(f.z(a), s);
          if (which & 2) flip_bit(f.x(a), s);
          if (which & 4) flip_bit(f.z(b), s);
          if (which & 8) flip_bit(f.x(b), s);
        });
        break;
      case OP_PC1: {
        double px = dp[0], py = dp[1], pz = dp[2];
        double tot = px + py + pz;
        for_fired(rng, tot, shots, [&](int64_t s) {
          double u = rng.uniform() * tot;
          int m = u < px ? 1 : (u < px + py ? 3 : 2);
          if (m & 1) flip_bit(f.x(a), s);
          if (m & 2) flip_bit(f.z(a), s);
        });
        break;
      }
      case OP_PC2: {
        // 15 probs in Stim order: IX IY IZ XI XX XY XZ YI YX YY YZ ZI ZX ZY ZZ
        double tot = 0;
        for (int k = 0; k < 15; k++) tot += dp[k];
        static const int mz[4] = {0, 0, 1, 1};  // I X Y Z -> z component
        static const int mx[4] = {0, 1, 1, 0};  //            x component
        for_fired(rng, tot, shots, [&](int64_t s) {
          double u = rng.uniform() * tot, acc = 0;
          int k = 14;
          for (int j = 0; j < 15; j++) {
            acc += dp[j];
            if (u < acc) { k = j; break; }
          }
          int pa = (k + 1) / 4, pb = (k + 1) % 4;  // indices into IXYZ
          if (mx[pa]) flip_bit(f.x(a), s);
          if (mz[pa]) flip_bit(f.z(a), s);
          if (mx[pb]) flip_bit(f.x(b), s);
          if (mz[pb]) flip_bit(f.z(b), s);
        });
        break;
      }
      case OP_HERALD: {
        uint64_t* row = rec + (int64_t)a * W;
        std::memset(row, 0, (size_t)W * 8);
        double tot = dp[0] + dp[1] + dp[2] + dp[3];
        static const int masks[4] = {0, 1, 3, 2};  // I X Y Z
        for_fired(rng, tot, shots, [&](int64_t s) {
          flip_bit(row, s);
          double u = rng.uniform() * tot;
          int k = u < dp[0] ? 0 : (u < dp[0] + dp[1] ? 1 : (u < dp[0] + dp[1] + dp[2] ? 2 : 3));
          int m = masks[k];
          if (m & 1) flip_bit(f.x(b), s);
          if (m & 2) flip_bit(f.z(b), s);
        });
        break;
      }
      case OP_CORR: {
        if (c) std::memset(prev_corr.data(), 0, (size_t)W * 8);
        for_fired(rng, dp[0], shots, [&](int64_t s) {
          uint64_t& pw = prev_corr[s >> 6];
          uint64_t bit = 1ULL << (s & 63);
          if (pw & bit) return;  // an earlier E/ELSE in the chain fired
          pw |= bit;
          for (int32_t t = 0; t < aux_n; t++) {
            int64_t q = aux[aux_off + 2 * t];
            int32_t m = aux[aux_off + 2 * t + 1];
            if (m & 1) flip_bit(f.x(q), s);
            if (m & 2) flip_bit(f.z(q), s);
          }
        });
        break;
      }
      case OP_DET: {
        uint64_t* row = dets + (int64_t)a * W;
        std::memset(row, b ? 0xff : 0x00, (size_t)W * 8);
        for (int32_t t = 0; t < aux_n; t++)
          xor_row(row, rec + (int64_t)aux[aux_off + t] * W, W);
        break;
      }
      case OP_OBS: {
        uint64_t* row = obs + (int64_t)a * W;
        for (int32_t t = 0; t < aux_n; t++)
          xor_row(row, rec + (int64_t)aux[aux_off + t] * W, W);
        break;
      }
      case OP_RC_PAULI: {
        const uint64_t* ctrl = rec + (int64_t)b * W;
        int m = c & 3;
        bool ref = (c >> 2) & 1;
        for (int64_t w = 0; w < W; w++) {
          uint64_t cw = ref ? ~ctrl[w] : ctrl[w];
          if (m & 1) f.x(a)[w] ^= cw;
          if (m & 2) f.z(a)[w] ^= cw;
        }
        break;
      }
    }
  }
}
