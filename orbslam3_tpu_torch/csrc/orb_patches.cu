// Per-keypoint ORB patch kernels for Hopper (sm_90a): IC-angle moments,
// fused binned rBRIEF, and orb_describe, which does both and the angle
// between them in one launch.  Plain C interface, loaded with ctypes by
// orbslam3_tpu_torch/ops/orb_patches.py, which also holds the plain PyTorch
// twins (ops/orient.ic_moments, ops/orient.angle_from_moments,
// ops/brief.compute_descriptors) and the launch geometry.
//
// What they replace (both TPU kernels of the repository):
//   ic_moments  <- orbslam3_tpu/ops/pallas_patches.py:58-74
//                  (_win_kernel(S_MOM=31, reduce_moments=True), pallas_call
//                  at :124, launched at :165-170)
//   brief_desc  <- orbslam3_tpu/ops/pallas_patches.py:76-88
//                  (_win_kernel(S_BRF=39, reduce_moments=False), launched at
//                  :171-176) followed by ops/brief.descriptors_from_patches
//                  (brief.py:67-84)
//   orb_describe <- both of the above and the jnp ops between them
//                  (pallas_patches.py:186-188: atan2, wrap, degrees), which
//                  is what extractor.extract calls once per frame
//   orb_describe_warp <- the same; the one-launch design before the Hopper
//                  redesign, kept to be timed beside it (no path runs it)
//
// What bounds them on the card: at the main path's shapes (1200 keypoints,
// a 2210x752 f32 atlas = 6.6 MB that stays in the 50 MB L2) the kernels
// need ~4 MB of distinct pixels, the 32 KB bin table and the keypoints:
// ~1.2 us at 3.35 TB/s, and no arithmetic to speak of.  What holds them
// above that on the card is the traffic from L2 into the SMs: the windows of
// neighbouring keypoints overlap (~12 MB of window rows for ~4 MB of
// distinct pixels), and L2 feeds the SMs at a few TB/s; and, in the older
// designs, chains of dependent L2 reads in too few warps.
//
// ic_moments, brief_desc, orb_describe_warp (the first designs): one warp per
// keypoint, four keypoints per block (300 blocks for 1200 keypoints).
// Pixels are read straight from the atlas through the read-only cache; a
// window row is 31 (39) neighbouring floats, so a warp's row read is one or
// two coalesced transactions.  Nothing is staged in shared memory.  BRIEF
// is fused: the kernel reads the keypoint's angle, picks the bin, samples
// the 256 pairs at the bin's int8 offsets and packs each 32-pair word with
// one __ballot_sync; the (N, 1521) patch tensor and the one-hot matmul
// stack, which exist only for the TPU's MXU, never exist here.  In
// orb_describe_warp a lane's 31 row reads of the moments do not depend on
// one another (the row test |u| <= umax[|v|] becomes |v| <= vlim with one
// vlim per lane), so they go out back to back.  Still each warp waits on
// four round trips to L2, one after another: xy, the raw rows, the bin's
// pair offsets (they depend on the angle), the blurred pixels (they depend
// on the offsets) -- with ~9 warps per SM to hide them.
//
// orb_describe (the Hopper design): two dependent trips per warp, xy and
// then one wave of asynchronous copies; everything after is shared memory
// and registers.
//   * A persistent grid: launch_geometry() in ops/orb_patches.py gives
//     K = min(10, ceil(N / #SMs)) warps a block and min(#SMs, ceil(N / K))
//     blocks, so 1200 keypoints take one round of 120 blocks of 10 warps,
//     one block per SM; a block walks keypoints blockIdx.x * K + warp in
//     steps of gridDim.x * K, so any N is covered.  Consecutive keypoints
//     (neighbouring grid cells of one level) share a block.
//   * The bin table (32 bins x 256 pairs x char4 = 32 KB) and umax (64 B)
//     are copied once per block into shared memory with 16-byte cp.async at
//     block start; the copy overlaps the first keypoint's windows, and the
//     angle -> offsets read becomes a shared-memory read.
//   * Both windows at once: as soon as a warp has its keypoint's xy it
//     issues the copies of the raw 31x31 window and of rows 1-37 of the
//     blurred 39x39 window (rows 0 and 38 are never sampled) into its own
//     slot of shared memory, both in flight together, before the angle
//     exists.  Where the atlas rows are 16-byte aligned (w % 4 == 0 and
//     aligned bases: every preset and drive width, 188 to 752) each
//     row goes as 16-byte cp.async of the aligned chunks that cover it (9
//     and 11 chunks: 9 + 13 copies a lane); any other atlas takes 4-byte
//     copies of the window's own columns (31 + 46 a lane) in the same
//     kernel.  The copies are cp.async.ca, through L1: where the windows of
//     a block's keypoints overlap, the later copies hit in L1 (a prototype
//     with .cg, L2 only, ran slower than orb_describe_warp).  Not 2D TMA
//     tiles: a TMA box needs the same alignment, a CUtensorMap encoded on
//     the host for every new atlas, and moves the same bytes; the TMA
//     variant tried on the card faulted (illegal instruction) and was not
//     pursued.
//   * Shared memory: 32,832 B of table + K x 11,328 B of windows = 146,112
//     B at K = 10, dynamic above 48 KB (cudaFuncSetAttribute once per
//     device), so one block per SM.  One slot per warp: a later round
//     (N > 10 x #SMs) restages after its compute.
//   * The arithmetic is orb_describe_warp's, read from shared memory: the
//     per-lane row-order fmaf sums and the same shuffle tree (moments
//     bit-equal to ic_moments'), the angle's three separate roundings, the
//     bin, the pair compares and the __ballot_sync packing.  No fast math.
//   * What still bounds it: the copies, all from L2 into the SMs (for 1200
//     keypoints 1200 x (31 x 9 + 37 x 11) x 16 B = 13.2 MB of staged rows,
//     where the byte bound counts ~4 MB of distinct pixels, and 120 x 32 KB
//     = 3.9 MB of table), then the compute of the one round, which nothing
//     overlaps.  Prototypes that ran slower or gained too little to keep: a
//     second slot per warp or fewer warps with two keypoints each (fewer
//     warps issue the copies), copies cut to each row's needed chunks with
//     an 8-bin table (bins 8-31 are quarter turns of bins 0-7), per-row
//     cp.async.bulk on an mbarrier (it bypasses L1).
//
// Exactness: moments are reduced per lane in row order, then by a fixed
// shuffle tree, so the result is deterministic.  On integer-valued pixels
// (pyramid level 0) every partial sum is below 961*255*15 < 2^24 and the
// moments are exact in any order.  The angle is computed operation by
// operation as orient.angle_from_moments does (atan2f, one add, one
// multiply, each rounded on its own: a contracted multiply-add could move
// an angle across a bin edge and change all 256 bits).  BRIEF compares
// exact integer pixels, so its bits are exact.

#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 4;   // the one-warp-per-keypoint kernels
constexpr int kThreads = kWarpsPerBlock * 32;
constexpr int kMomHalf = 15;
constexpr int kMomSize = 2 * kMomHalf + 1;      // 31
constexpr int kBriefHalf = 19;
constexpr int kBriefSize = 2 * kBriefHalf + 1;  // 39
constexpr int kBriefPairs = 256;
constexpr int kBriefWords = kBriefPairs / 32;   // 8
constexpr unsigned kFullMask = 0xffffffffu;

// orb_describe's shared memory: the table (pairs, then umax), then one slot
// per warp: the raw window (31 rows at stride 36 floats) and the blurred one
// (39 rows at stride 44).  A row of a window is staged from the 16-byte
// aligned column at or left of the window's first column (9 and 11 chunks
// of 4 floats); `off` is the window's first column within the staged row.
// ops/orb_patches.py keeps the same numbers (TABLE_BYTES, SLOT_BYTES,
// WARPS_MAX); the C entry refuses a geometry that disagrees with them.
constexpr int kNBins = 32;
constexpr int kMaxWarps = 10;
constexpr int kLaunchBound = 512;
constexpr int kPairBytes = kNBins * kBriefPairs * 4;          // 32768
constexpr int kTableBytes = kPairBytes + (kMomHalf + 1) * 4;  // 32832
constexpr int kRawChunks = 9;                                 // 36 >= 3 + 31
constexpr int kBlurChunks = 11;                               // 44 >= 3 + 39
constexpr int kRawStride = 4 * kRawChunks;
constexpr int kBlurStride = 4 * kBlurChunks;
constexpr int kRawFloats = kMomSize * kRawStride;             // 1116
constexpr int kBlurFloats = kBriefSize * kBlurStride;         // 1716
constexpr int kSlotBytes = (kRawFloats + kBlurFloats) * 4;    // 11328
constexpr int kMaxDescribeSmem = kTableBytes + kMaxWarps * kSlotBytes;
// every rotated pattern point lies within |dx|, |dy| <= 18 of the centre
// (brief._binned_offsets), so the blurred window's first and last rows are
// never sampled and are not staged
constexpr int kBriefReach = 18;
static_assert(kTableBytes % 16 == 0 && kSlotBytes % 16 == 0 && kRawStride % 4 == 0 &&
              kBlurStride % 4 == 0, "16-byte copies need 16-byte aligned rows");
static_assert(kMaxDescribeSmem <= 232448, "above a Hopper block's shared memory");

// m10 = sum(u * I), m01 = sum(v * I) over the circular 31x31 window whose
// top-left corner is clamp(floor(xy) - 15, 0, (h, w) - 31).  umax[|v|] is the
// half-width of row v (orient._umax_table).
__global__ void __launch_bounds__(kThreads)
ic_moments_kernel(const float* __restrict__ img, int h, int w,
                  const float* __restrict__ xy, int n,
                  const int* __restrict__ umax, float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int k = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (k >= n) return;  // the whole warp leaves together
  // float -> int truncates, as XLA's astype(int32) does (xy >= 0 here)
  const int xf = static_cast<int>(xy[2 * k]);
  const int yf = static_cast<int>(xy[2 * k + 1]);
  const int x0 = min(max(xf - kMomHalf, 0), w - kMomSize);
  const int y0 = min(max(yf - kMomHalf, 0), h - kMomSize);
  float m10 = 0.f;
  float m01 = 0.f;
  if (lane < kMomSize) {
    const int u = lane - kMomHalf;
    const int au = abs(u);
    const float* col = img + static_cast<size_t>(y0) * w + x0 + lane;
    for (int r = 0; r < kMomSize; ++r) {
      const int v = r - kMomHalf;
      if (au <= __ldg(umax + abs(v))) {
        const float pix = __ldg(col + static_cast<size_t>(r) * w);
        m10 += static_cast<float>(u) * pix;
        m01 += static_cast<float>(v) * pix;
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    m10 += __shfl_down_sync(kFullMask, m10, off);
    m01 += __shfl_down_sync(kFullMask, m01, off);
  }
  if (lane == 0) {
    out[2 * k] = m10;
    out[2 * k + 1] = m01;
  }
}

// Binned rBRIEF: bin = round(angle * bin_scale) mod n_bins; window corner
// clamp(round(xy) - 19, 0, (h, w) - 39); pair j of word wd compares
// I(corner + 19 + p) < I(corner + 19 + q), with (px, py, qx, qy) the int8
// offsets of pair 32*wd + j in bin `bin` (brief._binned_offsets).  Lane j of
// the warp evaluates pair 32*wd + j, so bit j of the ballot is that pair.
__global__ void __launch_bounds__(kThreads)
brief_desc_kernel(const float* __restrict__ img, int h, int w,
                  const float* __restrict__ xy,
                  const float* __restrict__ angle, int n,
                  const char4* __restrict__ pairs, float bin_scale,
                  int n_bins, unsigned int* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int k = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (k >= n) return;  // the whole warp leaves together
  // round half to even, as jnp.round
  const int xr = __float2int_rn(xy[2 * k]);
  const int yr = __float2int_rn(xy[2 * k + 1]);
  const int x0 = min(max(xr - kBriefHalf, 0), w - kBriefSize);
  const int y0 = min(max(yr - kBriefHalf, 0), h - kBriefSize);
  int bin = __float2int_rn(__fmul_rn(angle[k], bin_scale)) % n_bins;
  if (bin < 0) bin += n_bins;
  const float* c = img + static_cast<size_t>(y0 + kBriefHalf) * w +
                   (x0 + kBriefHalf);
  const char4* tab = pairs + static_cast<size_t>(bin) * kBriefPairs;
  unsigned int mine = 0u;
#pragma unroll
  for (int wd = 0; wd < kBriefWords; ++wd) {
    const char4 o = __ldg(tab + wd * 32 + lane);
    const float ip = __ldg(c + o.y * w + o.x);
    const float iq = __ldg(c + o.w * w + o.z);
    const unsigned int word = __ballot_sync(kFullMask, ip < iq);
    if (lane == wd) mine = word;
  }
  if (lane < kBriefWords) out[static_cast<size_t>(k) * kBriefWords + lane] = mine;
}

// The angle in degrees [0, 360) from the moments: atan2, wrap into
// [0, 2 pi), to degrees; three roundings, as orient.angle_from_moments.
__device__ __forceinline__ float angle_of(float m10, float m01) {
  float ang = atan2f(m01, m10);
  if (ang < 0.f) ang = __fadd_rn(ang, 6.2831855f);
  return __fmul_rn(ang, 57.29578f);
}

// The warp design (see the note at the top): moments, angle and descriptor
// of one keypoint in one warp, every pixel read from the atlases.  `raw` and
// `blur` are the two atlases, both (h, w).  Writes the angle to
// angle_out[k], the 8 descriptor words to desc_out[8k..], and, when mom_out
// is not null, [m10, m01] to mom_out[2k..].
__global__ void __launch_bounds__(kThreads)
orb_describe_warp_kernel(const float* __restrict__ raw,
                         const float* __restrict__ blur, int h, int w,
                         const float* __restrict__ xy, int n,
                         const int* __restrict__ umax,
                         const char4* __restrict__ pairs, float bin_scale,
                         int n_bins, float* __restrict__ angle_out,
                         unsigned int* __restrict__ desc_out,
                         float* __restrict__ mom_out) {
  const int lane = threadIdx.x & 31;
  const int k = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (k >= n) return;  // the whole warp leaves together
  const float x = xy[2 * k];
  const float y = xy[2 * k + 1];

  // 1. moments, as ic_moments_kernel sums them
  const int mx0 = min(max(static_cast<int>(x) - kMomHalf, 0), w - kMomSize);
  const int my0 = min(max(static_cast<int>(y) - kMomHalf, 0), h - kMomSize);
  float m10 = 0.f;
  float m01 = 0.f;
  if (lane < kMomSize) {
    const int u = lane - kMomHalf;
    const int au = abs(u);
    int vlim = -1;  // rows |v| <= vlim hold column u
#pragma unroll
    for (int v = 0; v <= kMomHalf; ++v) vlim += (au <= __ldg(umax + v)) ? 1 : 0;
    const float* col = raw + static_cast<size_t>(my0) * w + mx0 + lane;
    float pix[kMomSize];
#pragma unroll
    for (int r = 0; r < kMomSize; ++r) {
      pix[r] = (abs(r - kMomHalf) <= vlim)
                   ? __ldg(col + static_cast<size_t>(r) * w) : 0.f;
    }
    const float fu = static_cast<float>(u);
#pragma unroll
    for (int r = 0; r < kMomSize; ++r) {
      if (abs(r - kMomHalf) <= vlim) {
        m10 = fmaf(fu, pix[r], m10);
        m01 = fmaf(static_cast<float>(r - kMomHalf), pix[r], m01);
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    m10 += __shfl_down_sync(kFullMask, m10, off);
    m01 += __shfl_down_sync(kFullMask, m01, off);
  }
  m10 = __shfl_sync(kFullMask, m10, 0);
  m01 = __shfl_sync(kFullMask, m01, 0);

  // 2. angle
  const float ang = angle_of(m10, m01);
  if (lane == 0) {
    angle_out[k] = ang;
    if (mom_out != nullptr) {
      mom_out[2 * k] = m10;
      mom_out[2 * k + 1] = m01;
    }
  }

  // 3. bin and descriptor, as brief_desc_kernel
  const int bx0 = min(max(__float2int_rn(x) - kBriefHalf, 0), w - kBriefSize);
  const int by0 = min(max(__float2int_rn(y) - kBriefHalf, 0), h - kBriefSize);
  int bin = __float2int_rn(__fmul_rn(ang, bin_scale)) % n_bins;
  if (bin < 0) bin += n_bins;
  const float* c = blur + static_cast<size_t>(by0 + kBriefHalf) * w +
                   (bx0 + kBriefHalf);
  const char4* tab = pairs + static_cast<size_t>(bin) * kBriefPairs;
  unsigned int mine = 0u;
#pragma unroll
  for (int wd = 0; wd < kBriefWords; ++wd) {
    const char4 o = __ldg(tab + wd * 32 + lane);
    const float ip = __ldg(c + o.y * w + o.x);
    const float iq = __ldg(c + o.w * w + o.z);
    const unsigned int word = __ballot_sync(kFullMask, ip < iq);
    if (lane == wd) mine = word;
  }
  if (lane < kBriefWords) {
    desc_out[static_cast<size_t>(k) * kBriefWords + lane] = mine;
  }
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Both copy widths go through L1 (.ca): consecutive keypoints share a block
// and their windows overlap, so a block's copies hit in L1 where they meet.
__device__ __forceinline__ void cp_async_4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(smem_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_16(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Issue the copies of keypoint (x, y)'s two windows into a warp's slot: the
// raw 31x31 window at clamp(floor(xy) - 15) to s_raw, rows 1-37 of the
// blurred 39x39 window at clamp(round(xy) - 19) to s_blur.  kVec (the atlas
// rows are 16-byte aligned): 16-byte copies of the aligned chunks that
// cover each row, a chunk at or past the row's end skipped (w % 4 == 0, so
// a chunk is inside the row or wholly past it); returns the windows' first
// columns within the staged rows in offr / offb.  Otherwise 4-byte copies
// of the window's own columns, offr = offb = 0.
template <bool kVec>
__device__ __forceinline__ void stage_windows(
    const float* __restrict__ raw, const float* __restrict__ blur, int h,
    int w, float x, float y, float* s_raw, float* s_blur, int lane,
    int& offr, int& offb) {
  const int mx0 = min(max(static_cast<int>(x) - kMomHalf, 0), w - kMomSize);
  const int my0 = min(max(static_cast<int>(y) - kMomHalf, 0), h - kMomSize);
  const int bx0 = min(max(__float2int_rn(x) - kBriefHalf, 0), w - kBriefSize);
  const int by0 = min(max(__float2int_rn(y) - kBriefHalf, 0), h - kBriefSize);
  constexpr int r0 = kBriefHalf - kBriefReach;    // first staged blurred row
  constexpr int nr = 2 * kBriefReach + 1;         // staged blurred rows
  if (kVec) {
    const int ra = mx0 & ~3;
    const int ba = bx0 & ~3;
    offr = mx0 - ra;
    offb = bx0 - ba;
    const float* rs = raw + static_cast<size_t>(my0) * w + ra;
#pragma unroll
    for (int i = lane; i < kMomSize * kRawChunks; i += 32) {
      const int r = i / kRawChunks;
      const int c = 4 * (i - r * kRawChunks);
      if (ra + c < w) cp_async_16(s_raw + r * kRawStride + c, rs + static_cast<size_t>(r) * w + c);
    }
    const float* bs = blur + static_cast<size_t>(by0 + r0) * w + ba;
    float* bd = s_blur + r0 * kBlurStride;
#pragma unroll
    for (int i = lane; i < nr * kBlurChunks; i += 32) {
      const int r = i / kBlurChunks;
      const int c = 4 * (i - r * kBlurChunks);
      if (ba + c < w) cp_async_16(bd + r * kBlurStride + c, bs + static_cast<size_t>(r) * w + c);
    }
  } else {
    offr = 0;
    offb = 0;
    if (lane < kMomSize) {
      const float* rs = raw + static_cast<size_t>(my0) * w + mx0 + lane;
#pragma unroll
      for (int r = 0; r < kMomSize; ++r) {
        cp_async_4(s_raw + r * kRawStride + lane, rs + static_cast<size_t>(r) * w);
      }
    }
    const float* bs = blur + static_cast<size_t>(by0 + r0) * w + bx0;
    float* bd = s_blur + r0 * kBlurStride;
#pragma unroll 8
    for (int i = lane; i < nr * kBriefSize; i += 32) {
      const int r = i / kBriefSize;
      const int c = i - r * kBriefSize;
      cp_async_4(bd + r * kBlurStride + c, bs + static_cast<size_t>(r) * w + c);
    }
  }
}

// Moments, angle and descriptor of keypoint k from its staged windows, with
// orb_describe_warp_kernel's arithmetic.
__device__ __forceinline__ void describe_staged(
    const float* s_raw, const float* s_blur, int offr, int offb,
    const int* s_umax, const char4* s_pairs, int lane, int k, float bin_scale,
    float* __restrict__ angle_out, unsigned int* __restrict__ desc_out,
    float* __restrict__ mom_out) {
  float m10 = 0.f;
  float m01 = 0.f;
  if (lane < kMomSize) {
    const int u = lane - kMomHalf;
    const int au = abs(u);
    int vlim = -1;  // rows |v| <= vlim hold column u
#pragma unroll
    for (int v = 0; v <= kMomHalf; ++v) vlim += (au <= s_umax[v]) ? 1 : 0;
    const float fu = static_cast<float>(u);
    const float* col = s_raw + offr + lane;
#pragma unroll
    for (int r = 0; r < kMomSize; ++r) {
      if (abs(r - kMomHalf) <= vlim) {
        const float pix = col[r * kRawStride];
        m10 = fmaf(fu, pix, m10);
        m01 = fmaf(static_cast<float>(r - kMomHalf), pix, m01);
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    m10 += __shfl_down_sync(kFullMask, m10, off);
    m01 += __shfl_down_sync(kFullMask, m01, off);
  }
  m10 = __shfl_sync(kFullMask, m10, 0);
  m01 = __shfl_sync(kFullMask, m01, 0);

  const float ang = angle_of(m10, m01);
  if (lane == 0) {
    angle_out[k] = ang;
    if (mom_out != nullptr) {
      mom_out[2 * k] = m10;
      mom_out[2 * k + 1] = m01;
    }
  }

  int bin = __float2int_rn(__fmul_rn(ang, bin_scale)) % kNBins;
  if (bin < 0) bin += kNBins;
  const char4* tab = s_pairs + bin * kBriefPairs;
  const float* c = s_blur + kBriefHalf * kBlurStride + offb + kBriefHalf;
  unsigned int mine = 0u;
#pragma unroll
  for (int wd = 0; wd < kBriefWords; ++wd) {
    const char4 o = tab[wd * 32 + lane];
    const float ip = c[o.y * kBlurStride + o.x];
    const float iq = c[o.w * kBlurStride + o.z];
    const unsigned int word = __ballot_sync(kFullMask, ip < iq);
    if (lane == wd) mine = word;
  }
  if (lane < kBriefWords) {
    desc_out[static_cast<size_t>(k) * kBriefWords + lane] = mine;
  }
}

// The Hopper design (see the note at the top).  `table` is the device copy
// of the bin table (n_bins x 256 char4) followed by umax[0..15] (int32):
// kTableBytes, 16-byte aligned.  blockDim.x = 32 x warps; dynamic shared
// memory kTableBytes + warps x kSlotBytes.  kVec: the atlases' rows are
// 16-byte aligned (w % 4 == 0, both bases aligned).  The launch bound is
// kLaunchBound, above the kMaxWarps x 32 threads a block has: it caps the
// registers at 128 a thread, which ran faster on the card than the 204 that
// a 320-thread bound allows.
template <bool kVec>
__global__ void __launch_bounds__(kLaunchBound)
orb_describe_kernel(const float* __restrict__ raw,
                    const float* __restrict__ blur, int h, int w,
                    const float* __restrict__ xy, int n,
                    const unsigned char* __restrict__ table, float bin_scale,
                    float* __restrict__ angle_out,
                    unsigned int* __restrict__ desc_out,
                    float* __restrict__ mom_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const char4* s_pairs = reinterpret_cast<const char4*>(smem);
  const int* s_umax = reinterpret_cast<const int*>(smem + kPairBytes);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  float* s_raw = reinterpret_cast<float*>(smem + kTableBytes + warp * kSlotBytes);
  float* s_blur = s_raw + kRawFloats;

  // the table, once per block; in flight with the first windows
  for (int i = threadIdx.x; i < kTableBytes / 16; i += blockDim.x) {
    cp_async_16(smem + 16 * i, table + 16 * i);
  }
  const int step = gridDim.x * warps;
  int k = blockIdx.x * warps + warp;
  int offr = 0;
  int offb = 0;
  if (k < n) {
    stage_windows<kVec>(raw, blur, h, w, xy[2 * k], xy[2 * k + 1], s_raw, s_blur,
                        lane, offr, offb);
  }
  cp_async_wait_all();
  __syncthreads();  // the table and every warp's first windows have landed

  while (k < n) {  // the whole warp walks together
    describe_staged(s_raw, s_blur, offr, offb, s_umax, s_pairs, lane, k,
                    bin_scale, angle_out, desc_out, mom_out);
    k += step;
    if (k >= n) break;
    __syncwarp();  // every lane is done with the slot
    stage_windows<kVec>(raw, blur, h, w, xy[2 * k], xy[2 * k + 1], s_raw, s_blur,
                        lane, offr, offb);
    cp_async_wait_all();
    __syncwarp();
  }
}

// The floor: a kernel that does nothing, timed beside the others.
__global__ void orb_empty_kernel() {}

int launch_blocks(int n) { return (n + kWarpsPerBlock - 1) / kWarpsPerBlock; }

// cudaSetDevice only when the caller's device is not current.
cudaError_t use_device(int device) {
  int cur = -1;
  cudaError_t err = cudaGetDevice(&cur);
  if (err != cudaSuccess || cur == device) return err;
  return cudaSetDevice(device);
}

constexpr int kMaxDevices = 64;
bool smem_raised[kMaxDevices] = {};

}  // namespace

extern "C" {

// Each entry point launches on `stream` (PyTorch's current stream), does not
// synchronise, and returns cudaGetLastError() so that a refused launch is
// reported to the caller.  n must be > 0 (the wrapper checks).
int orb_ic_moments(int device, const float* img, int h, int w,
                   const float* xy, int n, const int* umax, float* out,
                   void* stream) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  ic_moments_kernel<<<launch_blocks(n), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(img, h, w, xy, n,
                                                           umax, out);
  return static_cast<int>(cudaGetLastError());
}

int orb_brief_desc(int device, const float* img, int h, int w,
                   const float* xy, const float* angle, int n,
                   const void* pairs, float bin_scale, int n_bins,
                   unsigned int* out, void* stream) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  brief_desc_kernel<<<launch_blocks(n), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      img, h, w, xy, angle, n, static_cast<const char4*>(pairs), bin_scale,
      n_bins, out);
  return static_cast<int>(cudaGetLastError());
}

// mom_out may be null.
int orb_describe_warp(int device, const float* raw, const float* blur, int h,
                      int w, const float* xy, int n, const int* umax,
                      const void* pairs, float bin_scale, int n_bins,
                      float* angle_out, unsigned int* desc_out, float* mom_out,
                      void* stream) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  orb_describe_warp_kernel<<<launch_blocks(n), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      raw, blur, h, w, xy, n, umax, static_cast<const char4*>(pairs),
      bin_scale, n_bins, angle_out, desc_out, mom_out);
  return static_cast<int>(cudaGetLastError());
}

// blocks x (32 x warps) threads with smem_bytes of dynamic shared memory,
// as orb_patches.launch_geometry computes them; a geometry that does not
// match this file's layout is refused with cudaErrorInvalidValue.  mom_out
// may be null.
int orb_describe(int device, const float* raw, const float* blur, int h, int w,
                 const float* xy, int n, const void* table, float bin_scale,
                 int blocks, int warps, int smem_bytes, float* angle_out,
                 unsigned int* desc_out, float* mom_out, void* stream) {
  if (device < 0 || device >= kMaxDevices || blocks < 1 || warps < 1 ||
      warps > kMaxWarps || smem_bytes != kTableBytes + warps * kSlotBytes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!smem_raised[device]) {
    err = cudaFuncSetAttribute(orb_describe_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxDescribeSmem);
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(orb_describe_kernel<false>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxDescribeSmem);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_raised[device] = true;
  }
  const bool vec = w % 4 == 0 && (reinterpret_cast<size_t>(raw) % 16) == 0 &&
                   (reinterpret_cast<size_t>(blur) % 16) == 0;
  auto* kern = vec ? orb_describe_kernel<true> : orb_describe_kernel<false>;
  kern<<<blocks, warps * 32, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      raw, blur, h, w, xy, n, static_cast<const unsigned char*>(table),
      bin_scale, angle_out, desc_out, mom_out);
  return static_cast<int>(cudaGetLastError());
}

int orb_empty(int device, void* stream) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  orb_empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

const char* orb_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
