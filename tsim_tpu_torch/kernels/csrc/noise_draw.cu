// The noise-configuration draw of a batch: (B, C) float32 uniforms -> (B, F)
// uint8 f bits, a thread a shot.
//
// Replaces what XLA fuses inside tsim_tpu's one-jit batch step
// (tsim_tpu/sampler.py::_batch_step_fn): the draw of
// tsim_tpu/noise/device_channels.py:124-176, which has no pl.pallas_call of
// its own. The port's torch transcription of it
// (noise/device_channels.py::sample_from_uniforms, the plain version here)
// runs in stages: a compare and a sum a bucket, a gather and an XOR fold or a
// bitplane matmul, with (B, C, O) and (B, k, C) intermediates in device
// memory.
//
// Per shot and live channel c, the outcome k is the number of the channel's
// float32 CDF entries <= u (the same float32 compare as the plain version),
// and the shot's f bits are the XOR over channels of pattern k of channel c
// (W = ceil(F / 32) words; k = O, past the last entry, selects the pattern
// the plain version gives there). The table, one int32 buffer built on the
// host (DeviceChannelSampler): offsets[C + 1] (CDF entries before channel c),
// cdf[N] (float32 bits), patterns[(N + C) * W] (channel c's O_c + 1 patterns
// start at row offsets[c] + c).
//
// Bound: the bytes, (4C + F) a row (uniforms read once, bits written once)
// over 3.35 TB/s; the compares (N a row) are far below the card's integer
// rate. What the design does about it:
// * the uniforms are read coalesced: a block stages a tile of 128 rows by 32
//   channels in shared memory (a warp reads 128 contiguous bytes of one row),
//   padded to 33 columns so that the thread-a-shot reads hit 32 banks;
// * the table sits in shared memory where it fits beside the tile (d3 5.5 KB,
//   d5 18.5 KB), staged once by each persistent block, and is read through
//   L1/L2 where it does not (the d7 surface code's 590 KB); every thread of a
//   warp reads the same CDF entry (a broadcast);
// * the pattern words are XORed in registers, WC words a pass (WC = 1, 2, 4,
//   8 or 16; W > 16 takes more passes over the staged uniforms), and the
//   block's F bits a row are written from shared memory as contiguous bytes.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kShots = 128;                 // threads (shots) a block
constexpr int kChunk = 32;                  // channels a staged tile of uniforms holds
constexpr int kTileStride = kChunk + 1;     // padded row of the tile
constexpr int kDefaultSharedBytes = 48 * 1024;
constexpr int kBlocksPerSM = 16;            // persistent blocks a multiprocessor, at most

__host__ __device__ inline size_t table_words(int C, int N, int W) {
  return (size_t)(C + 1) + N + (size_t)(N + C) * W;
}

__host__ __device__ inline size_t base_shared_words(int W) {
  return (size_t)kShots * kTileStride + (size_t)kShots * W;
}

template <int WC, bool kSharedTable>
__global__ void __launch_bounds__(kShots) noise_draw(const float* __restrict__ u, long long B, int C,
                                                     const int32_t* __restrict__ table, int N, int W,
                                                     int F, uint8_t* __restrict__ out) {
  extern __shared__ int32_t smem[];
  float* tile = reinterpret_cast<float*>(smem);
  uint32_t* bits = reinterpret_cast<uint32_t*>(smem + kShots * kTileStride);
  const int t = threadIdx.x;
  const int32_t* tb = table;
  if (kSharedTable) {
    int32_t* staged = smem + base_shared_words(W);
    const int total = (int)table_words(C, N, W);
    for (int i = t; i < total; i += kShots) staged[i] = table[i];
    tb = staged;  // made visible by the first barrier below
  }
  const int32_t* offsets = tb;
  const float* cdf = reinterpret_cast<const float*>(tb + C + 1);
  const uint32_t* patterns = reinterpret_cast<const uint32_t*>(tb + C + 1 + N);
  const long long tiles = (B + kShots - 1) / kShots;

  for (long long tile_index = blockIdx.x; tile_index < tiles; tile_index += gridDim.x) {
    const long long row0 = tile_index * kShots;
    const int rows = (int)(B - row0 < kShots ? B - row0 : kShots);
    for (int w0 = 0; w0 < W; w0 += WC) {
      uint32_t acc[WC];
#pragma unroll
      for (int q = 0; q < WC; ++q) acc[q] = 0u;
      for (int c0 = 0; c0 < C; c0 += kChunk) {
        const int cc = C - c0 < kChunk ? C - c0 : kChunk;
        __syncthreads();  // the previous tile (and bits) are read
        for (int i = t; i < rows * kChunk; i += kShots) {
          const int r = i / kChunk, j = i % kChunk;
          if (j < cc) tile[r * kTileStride + j] = u[(row0 + r) * C + c0 + j];
        }
        __syncthreads();
        if (t < rows) {
          for (int j = 0; j < cc; ++j) {
            const float x = tile[t * kTileStride + j];
            const int c = c0 + j;
            const int lo = offsets[c], hi = offsets[c + 1];
            int k = 0;
            for (int e = lo; e < hi; ++e) k += x >= cdf[e];
            const uint32_t* p = patterns + (size_t)(lo + c + k) * W + w0;
#pragma unroll
            for (int q = 0; q < WC; ++q)
              if (w0 + q < W) acc[q] ^= p[q];
          }
        }
      }
      if (t < rows) {
#pragma unroll
        for (int q = 0; q < WC; ++q)
          if (w0 + q < W) bits[t * W + w0 + q] = acc[q];
      }
    }
    __syncthreads();
    uint8_t* o = out + row0 * F;
    for (int i = t; i < rows * F; i += kShots) {
      const int r = i / F, f = i - r * F;
      o[i] = (uint8_t)((bits[r * W + (f >> 5)] >> (f & 31)) & 1u);
    }
  }
}

template <int WC>
cudaError_t launch_as(const float* u, long long B, int C, const int32_t* table, int N, int W, int F,
                      uint8_t* out, cudaStream_t stream) {
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const long long tiles = (B + kShots - 1) / kShots;
  const long long cap = (long long)sms * kBlocksPerSM;
  const unsigned blocks = (unsigned)(tiles < cap ? tiles : cap);
  const size_t base = 4 * base_shared_words(W);
  const size_t with_table = base + 4 * table_words(C, N, W);
  // The table in shared memory only below the default 48 KB a block, so no
  // launch changes a kernel attribute (nothing to set before a capture).
  if (with_table <= (size_t)kDefaultSharedBytes) {
    noise_draw<WC, true><<<blocks, kShots, with_table, stream>>>(u, B, C, table, N, W, F, out);
  } else {
    if (base > (size_t)kDefaultSharedBytes) return cudaErrorInvalidValue;
    noise_draw<WC, false><<<blocks, kShots, base, stream>>>(u, B, C, table, N, W, F, out);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch the draw on ``stream``: ``u`` (B, C) float32 row-major, ``table``
// as above (C + 1 + N + (N + C) * W int32), ``out`` (B, F) uint8. W words a
// pattern, F <= 32 W; W above 63 (F over 2016) is refused: the tile and the
// block's bits would pass 48 KB of shared memory. Returns the launch's
// cudaError_t (0 on success).
int tsim_noise_draw(const float* u, long long B, int C, const int32_t* table, int N, int W, int F,
                    uint8_t* out, void* stream) {
  if (B <= 0 || C <= 0 || W <= 0 || F <= 0 || F > 32 * W) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (W == 1) return (int)launch_as<1>(u, B, C, table, N, W, F, out, s);
  if (W == 2) return (int)launch_as<2>(u, B, C, table, N, W, F, out, s);
  if (W <= 4) return (int)launch_as<4>(u, B, C, table, N, W, F, out, s);
  if (W <= 8) return (int)launch_as<8>(u, B, C, table, N, W, F, out, s);
  return (int)launch_as<16>(u, B, C, table, N, W, F, out, s);
}

}  // extern "C"
