// Sum-based CFAR detector (CA / SOCA / GOCA) for Hopper (sm_90a).
//
// Replaces sonar_slam_tpu/kernels/cfar_pallas.py::_cfar_kernel. For every
// pixel of a (B, R, C) float32 stack of polar sonar frames it forms the
// leading and lagging sums of the train_hs training cells beyond guard_hs
// along range (rows), takes their mean (CA), min (SOCA) or max (GOCA) over
// train_hs, sets thr = tau * stat and writes
//     det = (x > thr) & valid_row & (x > intensity_threshold)
// straight into a torch.bool tensor, plus the threshold map when the caller
// passes a pointer for it (the feature path does not).
//
// Design. One thread per output pixel, neighbouring threads on neighbouring
// columns, so each of the 2 * train_hs training-row reads of a warp is one
// coalesced 128-byte line. Row indices are clamped to [0, R-1]: with
// edge == 1 ("extend") that clamp IS the edge replication the Pallas wrapper
// builds as a padded copy, so no padded copy exists here; with edge == 0
// ("strict") rows within train_hs + guard_hs of either border are masked
// (det false, thr 0), as in sonar_slam_tpu/kernels/cfar.py::_valid_rows.
//
// Arithmetic order matches the Pallas kernel and the plain PyTorch version in
// cfar_cuda.py: the sums add j = guard+1 ... guard+train in order from 0, then
// stat = min(lead, lag) / train_hs (IEEE division), then thr = tau * stat.
// No product feeds an add, so no fused multiply-add can change a bit.
//
// Bound. Memory: one read of the image and one write of the mask (plus the
// optional threshold map); the 40 neighbour reads of a column are served
// from L1/L2. At the replay's shape (128, 512, 256) that is 67 MB in and
// 17 MB out per call. A faster version would stage row tiles in shared
// memory or keep a sliding sum; this one is the simple correct form.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void cfar_sum_kernel(const float* __restrict__ img,
                                bool* __restrict__ det,
                                float* __restrict__ thr_out,
                                int R, int C, long long total,
                                int train_hs, int guard_hs, float tau,
                                int mode, int use_gate, float gate,
                                int extend) {
  long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const long long plane = (long long)R * C;
  const long long b = idx / plane;
  const long long rem = idx - b * plane;
  const int r = (int)(rem / C);
  const int c = (int)(rem - (long long)r * C);
  const float* col = img + b * plane + c;

  const float x = col[(long long)r * C];
  float lead = 0.0f;
  float lag = 0.0f;
  for (int j = guard_hs + 1; j <= guard_hs + train_hs; ++j) {
    int rl = r - j;
    rl = rl < 0 ? 0 : rl;
    int rg = r + j;
    rg = rg > R - 1 ? R - 1 : rg;
    lead = lead + col[(long long)rl * C];
    lag = lag + col[(long long)rg * C];
  }

  float stat;
  if (mode == 0) {
    stat = __fdiv_rn(lead + lag, (float)(2 * train_hs));
  } else if (mode == 1) {
    stat = __fdiv_rn(fminf(lead, lag), (float)train_hs);
  } else {
    stat = __fdiv_rn(fmaxf(lead, lag), (float)train_hs);
  }
  const float thr = __fmul_rn(tau, stat);

  const int hw = train_hs + guard_hs;
  const bool valid = extend ? true : (r >= hw && r < R - hw);
  bool d = valid && (x > thr);
  if (use_gate) d = d && (x > gate);
  det[idx] = d;
  if (thr_out != nullptr) thr_out[idx] = valid ? thr : 0.0f;
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success). The
// caller has checked shapes, dtype, contiguity and device.
extern "C" int cfar_sum_launch(const void* img, void* det, void* thr,
                               int B, int R, int C, int train_hs,
                               int guard_hs, float tau, int mode,
                               int use_gate, float gate, int extend,
                               void* stream) {
  const long long total = (long long)B * R * C;
  if (total == 0) return 0;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  cfar_sum_kernel<<<(unsigned int)blocks, threads, 0,
                    (cudaStream_t)stream>>>(
      (const float*)img, (bool*)det, (float*)thr, R, C, total, train_hs,
      guard_hs, tau, mode, use_gate, gate, extend);
  return (int)cudaGetLastError();
}
