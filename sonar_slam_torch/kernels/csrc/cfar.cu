// CFAR detectors for Hopper (sm_90a): the sum-based variants (CA / SOCA /
// GOCA) and the order-statistic variant (OS), each with the intensity gate
// fused in.
//
// cfar_sum_kernel replaces sonar_slam_tpu/kernels/cfar_pallas.py::_cfar_kernel.
// For every pixel of a (B, R, C) float32 stack of polar sonar frames it forms the
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

// ---------------------------------------------------------------------------
// OS-CFAR: replaces sonar_slam_tpu/kernels/cfar_pallas.py::_cfar_os_kernel.
//
// For every pixel, kth = the k-th smallest (0-indexed) of its 2 * train_hs
// training cells (rows guard_hs < |i - r| <= guard_hs + train_hs, clamped to
// [0, R-1] as in the sum kernel), thr = tau * kth, and
//     det = (x > thr) & valid_row & (x > intensity_threshold).
//
// Selection. The Pallas kernel brackets kth by a counting bisection over
// [-1, 255] (8 integer steps, then os_float_refine_steps continuous ones): an
// upper bound within 256 * 2^-22 of kth on float images. Here kth is the
// EXACT order statistic, found by a rank count: cell i holds kth when
// #{cells < v_i} <= k < #{cells <= v_i}. The result is one of the inputs, so
// it equals the sorted window's k-th entry bit for bit (what the XLA path,
// the reference's nth_element and the plain PyTorch version compute) and the
// Pallas kernel's os_float_refine_steps has no counterpart here. Ties select
// the same value whichever tied cell is found.
//
// Design. One thread per pixel, neighbouring threads on neighbouring
// columns, so each of the 2 * train_hs loads of a warp is one coalesced
// line. The window size is a template parameter for the main path's
// train_hs = 20 (40 cells): the cells and the 40 x 40 comparisons unroll
// into registers. Any other window up to OS_MAX_CELLS cells takes the
// generic instantiation (NW = 0), whose runtime-sized array lives in local
// memory; that path is correct and slower, and nothing on the replay path
// uses it. Bound: compute, 2 * train_hs * 2 * train_hs compares per pixel
// (1600 at the main path's window), against one image read and one mask
// write.

constexpr int OS_MAX_CELLS = 128;

template <int NW>
__global__ void cfar_os_kernel(const float* __restrict__ img,
                               bool* __restrict__ det,
                               float* __restrict__ thr_out,
                               int R, int C, long long total,
                               int train_hs, int guard_hs, int rank, float tau,
                               int use_gate, float gate, int extend) {
  long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const long long plane = (long long)R * C;
  const long long b = idx / plane;
  const long long rem = idx - b * plane;
  const int r = (int)(rem / C);
  const int c = (int)(rem - (long long)r * C);
  const float* col = img + b * plane + c;

  // with NW > 0 the bounds are compile-time and the loops unroll fully
  const int th = NW > 0 ? NW / 2 : train_hs;
  const int n = 2 * th;
  float v[NW > 0 ? NW : OS_MAX_CELLS];
#pragma unroll(NW > 0 ? NW / 2 : 1)
  for (int j = 0; j < th; ++j) {
    const int off = guard_hs + 1 + j;
    int rl = r - off;
    rl = rl < 0 ? 0 : rl;
    int rg = r + off;
    rg = rg > R - 1 ? R - 1 : rg;
    v[2 * j] = col[(long long)rl * C];
    v[2 * j + 1] = col[(long long)rg * C];
  }

  float kth = 0.0f;
#pragma unroll(NW > 0 ? NW : 1)
  for (int i = 0; i < n; ++i) {
    int less = 0;
    int leq = 0;
#pragma unroll(NW > 0 ? NW : 1)
    for (int j = 0; j < n; ++j) {
      less += v[j] < v[i];
      leq += v[j] <= v[i];
    }
    if (less <= rank && rank < leq) kth = v[i];
  }
  const float thr = __fmul_rn(tau, kth);

  const float x = col[(long long)r * C];
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

// Launches on `stream` and returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for a window the kernel does not take. The caller
// has checked shapes, dtype, contiguity, device and 0 <= rank < 2*train_hs.
extern "C" int cfar_os_launch(const void* img, void* det, void* thr,
                              int B, int R, int C, int train_hs, int guard_hs,
                              int rank, float tau, int use_gate, float gate,
                              int extend, void* stream) {
  const long long total = (long long)B * R * C;
  if (2 * train_hs > OS_MAX_CELLS) return (int)cudaErrorInvalidValue;
  if (total == 0) return 0;
  const int threads = 256;
  const unsigned int blocks = (unsigned int)((total + threads - 1) / threads);
  cudaStream_t s = (cudaStream_t)stream;
  if (train_hs == 20) {
    cfar_os_kernel<40><<<blocks, threads, 0, s>>>(
        (const float*)img, (bool*)det, (float*)thr, R, C, total, train_hs,
        guard_hs, rank, tau, use_gate, gate, extend);
  } else {
    cfar_os_kernel<0><<<blocks, threads, 0, s>>>(
        (const float*)img, (bool*)det, (float*)thr, R, C, total, train_hs,
        guard_hs, rank, tau, use_gate, gate, extend);
  }
  return (int)cudaGetLastError();
}
