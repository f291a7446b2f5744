// STC-007 trial-grid binarize for NVIDIA Hopper (sm_90a).
//
// Replaces sdvpcmdecoder_tpu/ops/pallas_binarize.py::stc007_fused_decode_frames
// (the Pallas TPU kernel K1) and, through the entry point
// stc007_binarize_group, ::stc007_fused_decode (K2). Plain torch version:
// sdvpcmdecoder_tpu_torch/ops/binarize.py::stc007_frame_decode; wrappers:
// sdvpcmdecoder_tpu_torch/ops/fused_binarize.py::stc007_fused_decode_frames
// and ::stc007_fused_decode.
//
// What it computes, per video line: for hysteresis depth h in [0, n_h) and
// pixel-shift stage s in [0, n_s), in that (lexicographic) order, read the
// 128 STC-007 data bits with a Schmitt trigger
//     bit = prev ? px >= min(ref + h, 254) : px > max(ref - h, 1)
// (prev starts at 0) at the stage's bit-centre pixels, and take the CRC-16
// syndrome of the read. A trial is valid when its syndrome matches and both
// trigger levels lie strictly inside (black, white). The first valid trial
// wins -- the reference's break-on-first-valid loops (readPCMdata,
// binarizer.cpp:7695-8090) -- and a line with none falls back to the bits of
// trial (0, 0). Output: eight 14-bit words, the 16-bit read CRC, valid, and
// the chosen hysteresis depth and shift stage.
//
// What bounds it on this card: the pixel bytes. A PAL batch of 128 frames x
// 588 lines x 1152 px is 86.7 MB read once, ~26 us at 3.35 TB/s, while one
// trial is 128 dependent Schmitt steps (~1k instructions) per line and a
// clean line needs only one trial. The TPU kernel sampled pixels with a
// one-hot bf16 matmul and took syndromes and word packing as matmuls (the
// TPU has no fast gather); here those are byte loads, XORs and shifts.
//
// Design: one block per (frame, tile of `tile` lines); blockDim is at least
// 128 threads so the tile's rows -- one contiguous span of global memory --
// are staged into shared memory by many threads with coalesced 4-byte
// loads. Each row is padded to an odd number of 32-bit words, so the 32
// lines of a warp reading the same bit-centre column hit 32 different
// banks. Then one thread per line runs the trials serially with early exit;
// the frame's bit-centre coordinates [n_s, 128] and the packed syndrome rows
// sit in shared memory and are read as warp-wide broadcasts. The ragged last
// tile of a frame is masked here, not padded by the caller. Later work:
// overlap the staging with compute (cp.async / TMA ring), and split the
// trials of a line across threads.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBits = 128;       // STC-007 data bits per line
constexpr int kWordBits = 14;    // bits per data word
constexpr int kWords = 8;        // data words per line
constexpr int kCrcPos = kWords * kWordBits;  // 112: read CRC, 16 bits
constexpr int kMaxShifts = 5;    // PIX_SH_BG/ED stages (pcmline.h:63-71)
constexpr int kMinThreads = 128;

// MSB-first bit field [p, p + n) of the 128-bit read held as hi (bits 0..63)
// and lo (bits 64..127), bit 0 in the top bit of hi.
__device__ __forceinline__ int32_t field(uint64_t hi, uint64_t lo, int p,
                                         int n) {
  const uint64_t mask = (1ull << n) - 1;
  if (p + n <= 64) return (int32_t)((hi >> (64 - p - n)) & mask);
  if (p >= 64) return (int32_t)((lo >> (128 - p - n)) & mask);
  const int nl = p + n - 64;  // bits taken from lo, 1..n-1
  return (int32_t)((((hi << nl) | (lo >> (64 - nl)))) & mask);
}

// One Schmitt read of a line: 128 bits at `pos` (bit-centre pixel columns
// of one shift stage), packed into hi/lo, and the packed CRC syndrome (XOR
// of the syndrome rows of the set bits).
__device__ __forceinline__ void read_trial(const uint8_t* row,
                                           const int32_t* pos,
                                           const uint32_t* synd_rows, int rl,
                                           int rh, uint64_t& hi, uint64_t& lo,
                                           uint32_t& synd) {
  bool prev = false;
  uint64_t h = 0, l = 0;
  uint32_t s = 0;
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const int v = row[pos[i]];
    const bool b = prev ? (v >= rh) : (v > rl);
    prev = b;
    h = (h << 1) | (uint64_t)b;
    s ^= b ? synd_rows[i] : 0u;
  }
#pragma unroll
  for (int i = 64; i < kBits; ++i) {
    const int v = row[pos[i]];
    const bool b = prev ? (v >= rh) : (v > rl);
    prev = b;
    l = (l << 1) | (uint64_t)b;
    s ^= b ? synd_rows[i] : 0u;
  }
  hi = h;
  lo = l;
  synd = s;
}

__global__ void stc007_binarize_frames_kernel(
    const uint8_t* __restrict__ pixels,     // [F, L, W]
    const int32_t* __restrict__ pos_g,      // [F, n_s, 128]
    const int32_t* __restrict__ ref,        // [F, L]
    const int32_t* __restrict__ black,      // [F, L]
    const int32_t* __restrict__ white,      // [F, L]
    const int32_t* __restrict__ synd_table, // [128, 16] 0/1
    uint32_t synd_const, int L, int W, int n_h, int n_s, int tile,
    int row_words, int32_t* __restrict__ words, int32_t* __restrict__ crc_read,
    uint8_t* __restrict__ valid, int32_t* __restrict__ hyst,
    int32_t* __restrict__ shift) {
  extern __shared__ uint32_t smem[];
  uint32_t* synd_rows = smem;                               // [128]
  int32_t* pos = reinterpret_cast<int32_t*>(smem + kBits);  // [n_s, 128]
  uint32_t* rows = smem + kBits + n_s * kBits;              // [tile, row_words]

  const int f = blockIdx.y;
  const int l0 = blockIdx.x * tile;
  const int n_lines = min(tile, L - l0);

  for (int i = threadIdx.x; i < kBits; i += blockDim.x) {
    uint32_t m = 0;
    for (int j = 0; j < 16; ++j)
      m |= (uint32_t)(synd_table[i * 16 + j] & 1) << j;
    synd_rows[i] = m;
  }
  for (int i = threadIdx.x; i < n_s * kBits; i += blockDim.x)
    pos[i] = pos_g[(int64_t)f * n_s * kBits + i];

  // Stage the tile's rows: lines l0..l0+n_lines-1 of frame f are one
  // contiguous span of n_lines * W bytes.
  const uint8_t* src = pixels + ((int64_t)f * L + l0) * W;
  if ((W & 3) == 0 && (reinterpret_cast<uintptr_t>(src) & 3) == 0) {
    const int wpr = W >> 2;
    const uint32_t* src32 = reinterpret_cast<const uint32_t*>(src);
    const int total = n_lines * wpr;
    for (int k = threadIdx.x; k < total; k += blockDim.x) {
      const int r = k / wpr;
      rows[r * row_words + (k - r * wpr)] = __ldg(src32 + k);
    }
  } else {
    uint8_t* rows8 = reinterpret_cast<uint8_t*>(rows);
    const int total = n_lines * W;
    for (int k = threadIdx.x; k < total; k += blockDim.x) {
      const int r = k / W;
      rows8[r * row_words * 4 + (k - r * W)] = src[k];
    }
  }
  __syncthreads();

  const int j = threadIdx.x;
  if (j >= n_lines) return;
  const int64_t line = (int64_t)f * L + l0 + j;
  const uint8_t* row = reinterpret_cast<const uint8_t*>(rows + j * row_words);
  const int rv = ref[line], bk = black[line], wt = white[line];

  // Trial (0, 0) first: it is also the fallback read.
  uint64_t fb_hi, fb_lo;
  uint32_t fb_synd;
  read_trial(row, pos, synd_rows, max(rv, 1), min(rv, 254), fb_hi, fb_lo,
             fb_synd);
  uint64_t hi = fb_hi, lo = fb_lo;
  int pick = -1;
  for (int h = 0; h < n_h && pick < 0; ++h) {
    const int rl = max(rv - h, 1), rh = min(rv + h, 254);
    if (!(rl > bk && rh < wt)) continue;  // levels clip: trials invalid
    for (int s = 0; s < n_s; ++s) {
      uint64_t th = fb_hi, tl = fb_lo;
      uint32_t ts = fb_synd;
      if (h != 0 || s != 0)
        read_trial(row, pos + s * kBits, synd_rows, rl, rh, th, tl, ts);
      if (ts == synd_const) {
        pick = h * n_s + s;
        hi = th;
        lo = tl;
        break;
      }
    }
  }

  int32_t* wo = words + line * kWords;
#pragma unroll
  for (int w = 0; w < kWords; ++w) wo[w] = field(hi, lo, w * kWordBits, kWordBits);
  crc_read[line] = field(hi, lo, kCrcPos, 16);
  valid[line] = pick >= 0;
  hyst[line] = pick >= 0 ? pick / n_s : 0;
  shift[line] = pick >= 0 ? pick % n_s : 0;
}

}  // namespace

extern "C" {

// Launch on `stream`; returns cudaGetLastError() (0 on success). All
// pointers are device pointers; levels are per line, [F, L].
int stc007_binarize_frames(const uint8_t* pixels, const int32_t* pos,
                           const int32_t* ref, const int32_t* black,
                           const int32_t* white, const int32_t* synd_table,
                           int synd_const, int F, int L, int W, int n_h,
                           int n_s, int tile, int32_t* words,
                           int32_t* crc_read, uint8_t* valid, int32_t* hyst,
                           int32_t* shift, void* stream) {
  if (F < 0 || L < 0 || W < 1 || n_h < 1 || n_s < 1 || n_s > kMaxShifts ||
      tile < 1 || tile > 1024 || F > 65535)
    return (int)cudaErrorInvalidValue;
  if (F == 0 || L == 0) return 0;
  // Rows padded to an odd word count: conflict-free column reads.
  const int w4 = (W + 3) / 4;
  const int row_words = (w4 & 1) ? w4 : w4 + 1;
  const int64_t smem =
      4ll * (kBits + (int64_t)n_s * kBits + (int64_t)tile * row_words);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        stc007_binarize_frames_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int warps_threads = (tile + 31) / 32 * 32;
  const int threads = warps_threads > kMinThreads ? warps_threads : kMinThreads;
  const dim3 grid((L + tile - 1) / tile, F);
  stc007_binarize_frames_kernel<<<grid, threads, smem,
                                  static_cast<cudaStream_t>(stream)>>>(
      pixels, pos, ref, black, white, synd_table, (uint32_t)synd_const, L, W,
      n_h, n_s, tile, row_words, words, crc_read, valid, hyst, shift);
  return (int)cudaGetLastError();
}

// One group of L lines sharing one set of bit coordinates, with per-line
// levels: replaces sdvpcmdecoder_tpu/ops/pallas_binarize.py::
// stc007_fused_decode (the Pallas TPU kernel K2; wrapper
// sdvpcmdecoder_tpu_torch/ops/fused_binarize.py::stc007_fused_decode).
// K2's body is K1's per-line math over one frame, so this launches the same
// kernel with F = 1: pos is [1, n_s, 128], the levels [1, L]. The ragged
// last tile is masked in the kernel, where the TPU kernel padded the group
// on the host.
int stc007_binarize_group(const uint8_t* pixels, const int32_t* pos,
                          const int32_t* ref, const int32_t* black,
                          const int32_t* white, const int32_t* synd_table,
                          int synd_const, int L, int W, int n_h, int n_s,
                          int tile, int32_t* words, int32_t* crc_read,
                          uint8_t* valid, int32_t* hyst, int32_t* shift,
                          void* stream) {
  return stc007_binarize_frames(pixels, pos, ref, black, white, synd_table,
                                synd_const, 1, L, W, n_h, n_s, tile, words,
                                crc_read, valid, hyst, shift, stream);
}

const char* stc007_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
