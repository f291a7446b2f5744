// STC-007 trial-grid binarize for NVIDIA Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of sdvpcmdecoder_tpu/ops/
// pallas_binarize.py: stc007_fused_decode_frames (:182, K1; entry point
// stc007_binarize_frames) and stc007_fused_decode (:262, K2; entry point
// stc007_binarize_group, one group of lines sharing coordinates). Plain
// torch version: sdvpcmdecoder_tpu_torch/ops/binarize.py::
// stc007_frame_decode; wrappers: sdvpcmdecoder_tpu_torch/ops/
// fused_binarize.py::stc007_fused_decode_frames and ::stc007_fused_decode.
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
// trial (0, 0). Output: eight 14-bit words, the 16-bit read CRC, the CRC
// recomputed over the words (crc_calc), valid, and the chosen hysteresis
// depth and shift stage.
//
// Everything a call needs is computed here, so a wrapper call is one kernel
// launch and no copy: the bit-centre pixel columns of each frame (calc_ppb
// and bit_pixel_coords of binarize.py, INT_CALC_MULT = 128, with floor
// division as torch's `//`; PIX_SH_BG == PIX_SH_ED, so a stage shifts every
// bit alike), the levels read per line through strides (0 for per-frame
// levels), and crc_calc. The 128 packed syndrome rows travel by value in
// the launch's parameter space (constant bank), so the unrolled bit loop
// reads them as broadcast operands. The rows of the 112 word bits are the
// CRC rows of crc16_linear_table(112) and the last 16 map the read CRC onto
// itself, so crc_calc = syndrome ^ crc_read ^ CONST of the chosen read.
//
// What bounds it on this card: the pixel bytes it must read. A line's result
// depends only on its bit-centre columns, so a row needs the 32-byte sectors
// from its first to its last sampled column: at the synthetic encoder's
// coordinates (40, 1096) 1024 of a 1152-px row. A PAL batch of 128 frames x
// 588 lines is then 77.07 MB read (outputs 49 B per line, 3.69 MB more):
// 24.1 us at 3.35 TB/s; a 16-frame round 10.1 MB, 3.01 us. One trial is 128
// dependent Schmitt steps per line and a clean line needs one trial, so
// compute is a few us card-wide on clean captures, even at the INT32 issue
// rate (a quarter of the float32 one). On noisy lines at deep limits
// (INSANE) the serial trials of each warp's slowest line set the pace
// instead. chip_smoke.py's k1_bound counts both terms from a run's data.
//
// Design for that bound: a persistent grid of one-warp blocks (as many as
// fit: six per SM at 1152 px, 38 KB of shared memory each) walks over
// (frame, tile of <= 32 lines) items. Each row of a tile lands in the
// block's shared memory by its own TMA bulk copy (cp.async.bulk, completion
// counted in bytes on an mbarrier), issued by the lane that will read that
// line; once its lanes have read a tile, the warp issues the copies of its
// next one. Copies and trials overlap across the SM's warps: while some run
// trials, the others' rows are in flight. Whole rows are copied, 1152 bytes
// where the columns need 1024. A two-stage ring per warp (tile k+1 landing
// while tile k is read) was built and measured slower on an H100: it fits
// only three warps on an SM, and the trials, not the copies, then set the
// pace. Every lane reads one line; the trials stay serial per line with
// early exit (a clean line stops at trial (0, 0)). Splitting a failing
// line's trials across the warp's lanes, or reading two trials at once,
// measured slower on noisy lines there as well.
//
// Bank conflicts: a bulk copy needs a 16-byte aligned destination, so the
// row stride is a multiple of 16 bytes, and 32 lanes reading the same column
// of 32 rows meet at best 8 banks (stride an odd multiple of 16 bytes, as
// chosen here: 1168 B for 1152 px). The resulting 4-way conflicts are
// accepted: a trial is 128 loads per warp, ~5 us of shared-memory time per
// SM for 128 clean frames, below the memory bound, and staggering rows would
// give up the bulk copies. Rows whose width or address is not a multiple of
// 16 bytes are staged by the warp with plain loads instead (not the main
// path's shapes; tests/test_torch_kernels_cuda.py and chip_smoke.py check
// that path at a width of 1150 and at a 1-byte offset).

#include <cstdint>
#include <cstring>
#include <mutex>
#include <cuda_runtime.h>

namespace {

constexpr int kBits = 128;       // STC-007 data bits per line
constexpr int kWordBits = 14;    // bits per data word
constexpr int kWords = 8;        // data words per line
constexpr int kCrcPos = kWords * kWordBits;  // 112: read CRC, 16 bits
constexpr int kMaxShifts = 5;    // PIX_SH_BG/ED stages (pcmline.h:63-71)
constexpr int kWarp = 32;        // lines per item at most: one per lane
constexpr int kHeader = 128;     // the mbarrier, then the bit columns
constexpr int kMaxSmem = 227 * 1024;
// Bit geometry (stc007.py): first data bit 3 cells after data_start, 132
// bit cells between the coordinates, bit numbers clamped to the line's 137.
constexpr int kBitOfs = 3;
constexpr int kBitMax = 136;
constexpr int kBitsBetween = 132;
constexpr int kCalcMult = 128;

// PIX_SH_BG (== PIX_SH_ED), binarize.py:34-35.
__constant__ int kShift[kMaxShifts] = {0, 1, -1, 2, -2};

struct SyndRows {
  uint32_t v[kBits];  // bit j of row i = synd_table[i, j]
};

struct Params {
  const uint8_t* pixels;     // [F, L, W]
  const void* coords;        // [F, 2] int32/int64 (strides cs0, cs1), or
  int coords64;              //   null: every frame at (start, stop)
  long long cs0, cs1;
  int start, stop;
  const int32_t* lv[3];      // ref, black, white: element (f, l) at
  long long lsf[3], lsl[3];  //   f * lsf + l * lsl
  uint32_t synd_const, crc_const;
  int F, L, W, n_h, n_s, tile, tiles_per_frame, n_items, stride, bulk;
  int32_t* words;            // [F, L, 8]
  int32_t* crc_read;         // [F, L]
  int32_t* crc_calc;
  uint8_t* valid;
  int32_t* hyst;
  int32_t* shift;
};

// torch's `//` for a positive divisor: floor, where C's `/` truncates.
__device__ __forceinline__ int floordiv(int a, int b) {
  const int q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

// int32 arithmetic that wraps as torch's int32 tensors do.
__device__ __forceinline__ int wadd(int a, int b) {
  return (int)((uint32_t)a + (uint32_t)b);
}
__device__ __forceinline__ int wmul(int a, int b) {
  return (int)((uint32_t)a * (uint32_t)b);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t n) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_addr(bar)),
               "r"(n)
               : "memory");
}

// Waits for the phase of parity `parity` to complete. A copy that never
// lands traps after ~10 s (a launch error) instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  const long long t0 = clock64();
  do {
    if (clock64() - t0 > 20000000000ll) __trap();
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// One row, global -> shared, by the TMA; completes `bytes` on `bar`. The
// fence orders this warp's earlier generic reads of the slot before it.
__device__ __forceinline__ void bulk_row(void* dst, const void* src,
                                         uint32_t bytes, uint64_t* bar) {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

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
// of the syndrome rows of the set bits, without the constant).
__device__ __forceinline__ void read_trial(const uint8_t* row,
                                           const uint16_t* pos,
                                           const SyndRows& R, int rl, int rh,
                                           uint64_t& hi, uint64_t& lo,
                                           uint32_t& synd) {
  uint32_t prev = 0, s = 0;
  uint64_t h = 0, l = 0;
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const int v = row[pos[i]];
    prev = prev ? (v >= rh) : (v > rl);
    h = (h << 1) | prev;
    s ^= R.v[i] & (0u - prev);
  }
#pragma unroll
  for (int i = 64; i < kBits; ++i) {
    const int v = row[pos[i]];
    prev = prev ? (v >= rh) : (v > rl);
    l = (l << 1) | prev;
    s ^= R.v[i] & (0u - prev);
  }
  hi = h;
  lo = l;
  synd = s;
}

// Bit-centre pixel columns [n_s, 128] of frame f into pos (each lane a
// share): binarize.stc007_frame_bit_coords.
__device__ __forceinline__ void frame_columns(const Params& p, int f,
                                              uint16_t* pos, int lane) {
  int start = p.start, stop = p.stop;
  if (p.coords != nullptr) {
    const long long a = f * p.cs0, b = a + p.cs1;
    if (p.coords64) {
      const int64_t* c = static_cast<const int64_t*>(p.coords);
      start = (int)c[a];
      stop = (int)c[b];
    } else {
      const int32_t* c = static_cast<const int32_t*>(p.coords);
      start = c[a];
      stop = c[b];
    }
  }
  const int pixels = wadd(stop, -start);
  const int psm = floordiv(wadd(wmul(pixels, kCalcMult), kBitsBetween / 2),
                           kBitsBetween);
  const int half = floordiv(wadd(psm, 1), 2);
  for (int k = lane; k < p.n_s * kBits; k += kWarp) {
    const int bit = min((k & (kBits - 1)) + kBitOfs, kBitMax);
    const int base = wadd(floordiv(wadd(wmul(bit, psm), half), kCalcMult),
                          start);
    const int col = wadd(base, kShift[k / kBits]);
    pos[k] = (uint16_t)min(max(col, 0), p.W - 1);
  }
}

// Stage the rows of item k into `dst` (one slot of `stride` bytes a line):
// one bulk copy per row, issued by the row's lane, or plain loads.
__device__ __forceinline__ void stage_item(const Params& p, int k,
                                           uint8_t* dst, uint64_t* bar,
                                           int lane) {
  const int f = k / p.tiles_per_frame;
  const int l0 = (k - f * p.tiles_per_frame) * p.tile;
  const int n = min(p.tile, p.L - l0);
  const uint8_t* src = p.pixels + ((long long)f * p.L + l0) * p.W;
  if (p.bulk) {
    if (lane == 0) mbar_expect_tx(bar, (uint32_t)(n * p.W));
    __syncwarp();
    if (lane < n)
      bulk_row(dst + lane * p.stride, src + (long long)lane * p.W,
               (uint32_t)p.W, bar);
  } else {
    for (int r = 0; r < n; ++r)
      for (int c = lane; c < p.W; c += kWarp)
        dst[r * p.stride + c] = src[(long long)r * p.W + c];
  }
}

__device__ __forceinline__ int level(const Params& p, int i, int f, int l) {
  return p.lv[i][f * p.lsf[i] + l * p.lsl[i]];
}

__global__ void __launch_bounds__(kWarp)
    stc007_binarize_frames_kernel(const __grid_constant__ Params p,
                                  const __grid_constant__ SyndRows R) {
  extern __shared__ __align__(128) uint8_t smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  uint16_t* pos = reinterpret_cast<uint16_t*>(smem + kHeader);  // [n_s*128]
  uint8_t* rows = smem + kHeader + p.n_s * kBits * 2;  // [tile][stride]
  const int lane = threadIdx.x;

  if (p.bulk && lane == 0) {
    mbar_init(bar);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncwarp();
  if ((int)blockIdx.x < p.n_items) stage_item(p, blockIdx.x, rows, bar, lane);

  uint32_t parity = 0;
  for (int k = blockIdx.x; k < p.n_items; k += gridDim.x, parity ^= 1u) {
    const int f = k / p.tiles_per_frame;
    const int l0 = (k - f * p.tiles_per_frame) * p.tile;
    const int n = min(p.tile, p.L - l0);
    __syncwarp();  // the last item's reads of pos are done
    frame_columns(p, f, pos, lane);
    if (p.bulk) mbar_wait(bar, parity);
    __syncwarp();  // pos, and plainly staged rows, visible to every lane

    if (lane < n) {
      const int l = l0 + lane;
      const long long line = (long long)f * p.L + l;
      const uint8_t* row = rows + lane * p.stride;
      const int rv = level(p, 0, f, l), bk = level(p, 1, f, l),
                wt = level(p, 2, f, l);
      // Trial (0, 0) first: it is also the fallback read.
      uint64_t hi, lo;
      uint32_t synd;
      read_trial(row, pos, R, max(rv, 1), min(rv, 254), hi, lo, synd);
      const uint64_t fb_hi = hi, fb_lo = lo;
      const uint32_t fb_synd = synd;
      int pick = -1;
      for (int h = 0; h < p.n_h && pick < 0; ++h) {
        const int rl = max(rv - h, 1), rh = min(rv + h, 254);
        if (!(rl > bk && rh < wt)) continue;  // levels clip: trials invalid
        for (int st = 0; st < p.n_s; ++st) {
          uint64_t th = fb_hi, tl = fb_lo;
          uint32_t ts = fb_synd;
          if (h != 0 || st != 0)
            read_trial(row, pos + st * kBits, R, rl, rh, th, tl, ts);
          if (ts == p.synd_const) {
            pick = h * p.n_s + st;
            hi = th;
            lo = tl;
            synd = ts;
            break;
          }
        }
      }
      if (pick < 0) {
        hi = fb_hi;
        lo = fb_lo;
        synd = fb_synd;
      }
      int32_t w[kWords];
#pragma unroll
      for (int i = 0; i < kWords; ++i) w[i] = field(hi, lo, i * kWordBits,
                                                    kWordBits);
      int4* wo = reinterpret_cast<int4*>(p.words + line * kWords);
      wo[0] = make_int4(w[0], w[1], w[2], w[3]);
      wo[1] = make_int4(w[4], w[5], w[6], w[7]);
      const int32_t cr = field(hi, lo, kCrcPos, 16);
      p.crc_read[line] = cr;
      p.crc_calc[line] = (int32_t)((synd ^ (uint32_t)cr ^ p.crc_const)
                                   & 0xFFFFu);
      p.valid[line] = pick >= 0;
      p.hyst[line] = pick >= 0 ? pick / p.n_s : 0;
      p.shift[line] = pick >= 0 ? pick % p.n_s : 0;
    }

    __syncwarp();  // every lane is done with the rows
    const int next = k + gridDim.x;
    if (next < p.n_items) stage_item(p, next, rows, bar, lane);
  }
}

// The persistent grid for `smem` bytes of dynamic shared memory on device
// `dev`: blocks that fit on one SM times the SM count. The kernel's
// shared-memory attribute and the occupancy query are set and asked once
// per (device, size) and cached; each device's attribute only grows, so a
// cached size stays launchable. A mutex guards the cache: ctypes calls run
// without the GIL.
struct Residency {
  int dev, smem, blocks;
};
constexpr int kMaxDevices = 64;
constexpr int kCacheSize = 64;
std::mutex g_mu;
Residency g_cache[kCacheSize];
int g_cached = 0;
int g_attr[kMaxDevices];  // the largest attribute set per device so far

int resident_blocks(int dev, int smem, int* blocks) {
  std::lock_guard<std::mutex> lock(g_mu);
  for (int i = 0; i < g_cached; ++i)
    if (g_cache[i].dev == dev && g_cache[i].smem == smem) {
      *blocks = g_cache[i].blocks;
      return 0;
    }
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  cudaError_t e;
  if (smem > g_attr[dev]) {
    e = cudaFuncSetAttribute(stc007_binarize_frames_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return (int)e;
    g_attr[dev] = smem;
  }
  int sms = 0, per_sm = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, stc007_binarize_frames_kernel, kWarp, (size_t)smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  *blocks = per_sm * sms;
  if (g_cached < kCacheSize) g_cache[g_cached++] = {dev, smem, *blocks};
  return 0;
}

// Fill in the launch geometry of `p` and launch on `stream`.
int launch(Params p, const uint32_t* synd_rows, cudaStream_t stream) {
  if (p.F < 0 || p.L < 0 || p.W < 1 || p.W > 65536 || p.n_h < 1 ||
      p.n_s < 1 || p.n_s > kMaxShifts || p.tile < 1 || p.tile > kWarp ||
      synd_rows == nullptr ||
      (reinterpret_cast<uintptr_t>(p.words) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  if (p.F == 0 || p.L == 0) return 0;
  p.tiles_per_frame = (p.L + p.tile - 1) / p.tile;
  const long long items = (long long)p.F * p.tiles_per_frame;
  if (items > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  p.n_items = (int)items;
  // Row slots: an odd multiple of 16 bytes (see the bank note above).
  p.stride = (p.W + 15) / 16 * 16;
  if ((p.stride / 16) % 2 == 0) p.stride += 16;
  p.bulk = (p.W % 16 == 0) && (p.W * kWarp < (1 << 20)) &&
           (reinterpret_cast<uintptr_t>(p.pixels) & 15) == 0;
  const long long smem =
      kHeader + p.n_s * kBits * 2 + (long long)p.tile * p.stride;
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  int dev = 0, blocks = 0;
  const cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  const int rc = resident_blocks(dev, (int)smem, &blocks);
  if (rc != 0) return rc;
  const int grid = p.n_items < blocks ? p.n_items : blocks;
  SyndRows rows;
  std::memcpy(rows.v, synd_rows, sizeof(rows.v));
  stc007_binarize_frames_kernel<<<grid, kWarp, (size_t)smem, stream>>>(p,
                                                                       rows);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch on `stream`; returns a cudaError_t (0 on success). Pointers other
// than synd_rows (128 packed rows, host memory) are device pointers. coords
// is [F, 2] int32 (coords64 = 0) or int64 with element strides cs0, cs1;
// each level is read at f * sf + l * sl (sl = 0 for per-frame levels).
int stc007_binarize_frames(
    const uint8_t* pixels, const void* coords, int coords64, long long cs0,
    long long cs1, const int32_t* ref, long long ref_sf, long long ref_sl,
    const int32_t* black, long long black_sf, long long black_sl,
    const int32_t* white, long long white_sf, long long white_sl,
    const uint32_t* synd_rows, int synd_const, int crc_const, int F, int L,
    int W, int n_h, int n_s, int tile, int32_t* words, int32_t* crc_read,
    int32_t* crc_calc, uint8_t* valid, int32_t* hyst, int32_t* shift,
    void* stream) {
  Params p{};
  p.pixels = pixels;
  p.coords = coords;
  p.coords64 = coords64;
  p.cs0 = cs0;
  p.cs1 = cs1;
  p.lv[0] = ref;
  p.lv[1] = black;
  p.lv[2] = white;
  p.lsf[0] = ref_sf;
  p.lsf[1] = black_sf;
  p.lsf[2] = white_sf;
  p.lsl[0] = ref_sl;
  p.lsl[1] = black_sl;
  p.lsl[2] = white_sl;
  p.synd_const = (uint32_t)synd_const;
  p.crc_const = (uint32_t)crc_const;
  p.F = F;
  p.L = L;
  p.W = W;
  p.n_h = n_h;
  p.n_s = n_s;
  p.tile = tile;
  p.words = words;
  p.crc_read = crc_read;
  p.crc_calc = crc_calc;
  p.valid = valid;
  p.hyst = hyst;
  p.shift = shift;
  if (coords == nullptr) return (int)cudaErrorInvalidValue;
  return launch(p, synd_rows, static_cast<cudaStream_t>(stream));
}

// One group of L lines sharing the bit coordinates (start, stop), with
// per-line levels (element l at l * sl): the same kernel with F = 1. The
// ragged last tile is masked in the kernel, where the TPU kernel padded the
// group on the host.
int stc007_binarize_group(
    const uint8_t* pixels, int start, int stop, const int32_t* ref,
    long long ref_sl, const int32_t* black, long long black_sl,
    const int32_t* white, long long white_sl, const uint32_t* synd_rows,
    int synd_const, int crc_const, int L, int W, int n_h, int n_s, int tile,
    int32_t* words, int32_t* crc_read, int32_t* crc_calc, uint8_t* valid,
    int32_t* hyst, int32_t* shift, void* stream) {
  Params p{};
  p.pixels = pixels;
  p.coords = nullptr;
  p.start = start;
  p.stop = stop;
  p.lv[0] = ref;
  p.lv[1] = black;
  p.lv[2] = white;
  p.lsl[0] = ref_sl;
  p.lsl[1] = black_sl;
  p.lsl[2] = white_sl;
  p.synd_const = (uint32_t)synd_const;
  p.crc_const = (uint32_t)crc_const;
  p.F = 1;
  p.L = L;
  p.W = W;
  p.n_h = n_h;
  p.n_s = n_s;
  p.tile = tile;
  p.words = words;
  p.crc_read = crc_read;
  p.crc_calc = crc_calc;
  p.valid = valid;
  p.hyst = hyst;
  p.shift = shift;
  return launch(p, synd_rows, static_cast<cudaStream_t>(stream));
}

const char* stc007_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
