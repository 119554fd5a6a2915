// Per-keypoint ORB patch kernels for Hopper (sm_90a): IC-angle moments,
// fused binned rBRIEF, and orb_describe, which does both and the angle
// between them in one launch.  Plain C interface, loaded with ctypes by
// orbslam3_tpu_torch/ops/orb_patches.py, which also holds the plain PyTorch
// twins (ops/orient.ic_moments, ops/orient.angle_from_moments,
// ops/brief.compute_descriptors).
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
//
// What bounds them on the card: at the main path's shapes (1200 keypoints,
// a 2210x752 f32 atlas = 6.6 MB that stays in the 50 MB L2) the two kernels
// read ~1.15 M (moments: 1200 x 961) and ~0.6 M (BRIEF: 1200 x 512) pixels:
// a few MB of L2 traffic and no arithmetic to speak of.  Both are bound by
// latency and launch overhead, not by bandwidth or FLOPs.
//
// What the design does about it: one warp per keypoint and four keypoints
// per block (300 blocks for 1200 keypoints, more than the 132 SMs hold in
// one wave, so the latency of dependent L2 reads is hidden by other warps).
// Pixels are read straight from the atlas through the read-only cache; a
// window row is 31 (39) neighbouring floats, so a warp's row read is one or
// two coalesced transactions.  Nothing is staged in shared memory: the TPU
// kernel's VMEM-pinned atlas, the 8-row-aligned loads, the pltpu.roll
// alignment and the scalar prefetch have no counterpart here.  BRIEF is
// fused: the kernel reads the keypoint's angle, picks the bin, samples the
// 256 pairs at the bin's int8 offsets and packs each 32-pair word with one
// __ballot_sync; the (N, 1521) patch tensor and the one-hot matmul stack,
// which exist only for the TPU's MXU, never exist here.
//
// orb_describe: the two kernels are latency-bound, and between them sit the
// elementwise launches of the angle.  One launch per frame does it all in
// one warp per keypoint.  A lane's 31 row reads of the moments do not
// depend on one another: the row test |u| <= umax[|v|] (umax does not
// increase with |v|) becomes |v| <= vlim with one vlim per lane, so the
// unrolled loads go out back to back and their latencies overlap
// instead of adding up.  The sums keep ic_moments' order (rows in order per
// lane, the same fused multiply-adds, the same shuffle tree), so the
// moments are bit-equal to ic_moments'.  The angle is computed operation by
// operation as orient.angle_from_moments does (atan2f, one add, one
// multiply, each rounded on its own: a contracted multiply-add could move
// an angle across a bin edge and change all 256 bits).  No fast math.
//
// Exactness: moments are reduced per lane in row order, then by a fixed
// shuffle tree, so the result is deterministic.  On integer-valued pixels
// (pyramid level 0) every partial sum is below 961*255*15 < 2^24 and the
// moments are exact in any order.  BRIEF compares exact integer pixels, so
// its bits are exact.

#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr int kThreads = kWarpsPerBlock * 32;
constexpr int kMomHalf = 15;
constexpr int kMomSize = 2 * kMomHalf + 1;      // 31
constexpr int kBriefHalf = 19;
constexpr int kBriefSize = 2 * kBriefHalf + 1;  // 39
constexpr int kBriefPairs = 256;
constexpr int kBriefWords = kBriefPairs / 32;   // 8
constexpr unsigned kFullMask = 0xffffffffu;

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

// Moments, angle and descriptor of one keypoint in one warp (see the note at
// the top).  `raw` and `blur` are the two atlases, both (h, w).  Writes the
// angle in degrees [0, 360) to angle_out[k], the 8 descriptor words to
// desc_out[8k..], and, when mom_out is not null, [m10, m01] to mom_out[2k..].
__global__ void __launch_bounds__(kThreads)
orb_describe_kernel(const float* __restrict__ raw,
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

  // 2. angle: atan2, wrap into [0, 2 pi), to degrees; three roundings
  float ang = atan2f(m01, m10);
  if (ang < 0.f) ang = __fadd_rn(ang, 6.2831855f);
  ang = __fmul_rn(ang, 57.29578f);
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

int launch_blocks(int n) { return (n + kWarpsPerBlock - 1) / kWarpsPerBlock; }

}  // namespace

extern "C" {

// Each entry point launches on `stream` (PyTorch's current stream), does not
// synchronise, and returns cudaGetLastError() so that a refused launch is
// reported to the caller.  n must be > 0 (the wrapper checks).
int orb_ic_moments(int device, const float* img, int h, int w,
                   const float* xy, int n, const int* umax, float* out,
                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
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
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  brief_desc_kernel<<<launch_blocks(n), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      img, h, w, xy, angle, n, static_cast<const char4*>(pairs), bin_scale,
      n_bins, out);
  return static_cast<int>(cudaGetLastError());
}

// mom_out may be null.
int orb_describe(int device, const float* raw, const float* blur, int h, int w,
                 const float* xy, int n, const int* umax, const void* pairs,
                 float bin_scale, int n_bins, float* angle_out,
                 unsigned int* desc_out, float* mom_out, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  orb_describe_kernel<<<launch_blocks(n), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      raw, blur, h, w, xy, n, umax, static_cast<const char4*>(pairs),
      bin_scale, n_bins, angle_out, desc_out, mom_out);
  return static_cast<int>(cudaGetLastError());
}

const char* orb_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
