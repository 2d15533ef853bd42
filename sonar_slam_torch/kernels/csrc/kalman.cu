// The 12-state Kalman filter over a whole sensor event stream in one launch
// (CUDA, sm_90a).
//
// Counterpart of the JAX package's sonar_slam_tpu/estimators/kalman.py::
// kalman_scan, which runs the stream as one lax.scan (one device program);
// the JAX package has no Pallas kernel for it. The port's plain version is
// the event loop in sonar_slam_torch/estimators/kalman.py::kalman_scan,
// about sixteen small launches an event.
//
// What bounds it: the filter is one dependent chain. Each event reads the
// state the event before it wrote, so nothing runs in parallel across
// events, and the work of one event (a few 12x12x12 products) is far too
// small to fill even one SM. The kernel's time is the chain's latency: the
// depth of one event's arithmetic and its barriers, times the number of
// events. Bytes (the stream's 13 bytes an event in, 48 bytes an IMU event
// out) and operations (about 11,000 flops an IMU event) are far below the
// card's bounds.
//
// The design keeps everything off the chain that can be:
// * one block of five warps; thread (i, j) of the first 144 owns element
//   (i, j) of P, so each product of an event is one step of at most twelve
//   dependent FMAs, and the steps are separated by __syncthreads alone;
// * P and x live in shared memory for the whole stream, double-buffered so
//   that a step reads one copy and writes the other; A's rows i and j and
//   Q[i, j] live in each thread's registers, H and R in shared memory;
// * an IMU event takes four steps (A P and A x; A P Aᵀ + Q; H P, P Hᵀ and
//   the innovation; the gain and the update), any other event the last two.
//   S = H P Hᵀ + R and its adjugate inverse are computed in every warp at
//   once and spread by shuffles, so they need no barrier of their own, and
//   each owner of a row of P computes that row of K and of K H itself;
// * the event codes and measurements are staged into shared memory in
//   chunks, so no event waits on device memory;
// * x after each IMU event and the FOG yaw after each gyro event are
//   stored as they come; the stores are not on the chain.
//
// The arithmetic is the plain loop's, in float32, step for step: x <- A x,
// P <- A P Aᵀ + Q on IMU events; then S = H P Hᵀ + R, S⁻¹ by adjugate
// (rows r0, r1, r2: [r1×r2, r2×r0, r0×r1]ᵀ / det, divided), K = P Hᵀ S⁻¹,
// x <- x + K (z - H x), P <- P - (K H) P. Sums run in a fixed order with
// FMA contraction, so results agree with the loop to float32 rounding and
// repeat bit for bit from run to run (one block, no atomics).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int N = 12;             // the state
constexpr int M = 3;              // a measurement
constexpr int NN = N * N;
constexpr int MN = M * N;
constexpr int MM = M * M;
constexpr int KINDS = 4;          // event codes 0-3; any other code is skipped
constexpr int EVENT_IMU = 0;
constexpr int EVENT_GYRO = 3;
constexpr int THREADS = 160;      // five warps: 144 owners of P, 12 of A x
constexpr int CHUNK = 2048;       // events staged in shared memory at a time
constexpr unsigned FULL = 0xffffffffu;

struct Model {
  const float* A;                 // (12, 12) state transition
  const float* Q;                 // (12, 12) process noise
  const float* H[KINDS];          // (3, 12) by event code
  const float* R[KINDS];          // (3, 3) by event code
};

__global__ void __launch_bounds__(THREADS, 1)
kalman_filter_kernel(const int8_t* __restrict__ codes,
                     const float* __restrict__ z, int T, Model m,
                     float* __restrict__ x_out, float* __restrict__ P_out,
                     float* __restrict__ hist, float* __restrict__ yaw_gyro,
                     int* __restrict__ count) {
  __shared__ float sH[KINDS][MN];
  __shared__ float sR[KINDS][MM];
  __shared__ float sP[2][NN];
  __shared__ float sx[2][N];
  __shared__ float sAP[NN];       // A P
  __shared__ float sHP[MN];       // H P, (3, 12)
  __shared__ float sPHt[MN];      // P Hᵀ, (12, 3)
  __shared__ float sy[M];         // z - H x
  __shared__ int8_t scode[CHUNK];
  __shared__ float sz[CHUNK * M];

  const int t = threadIdx.x;
  const int lane = t & 31;
  const bool owner = t < NN;      // owns P[i, j]
  const bool xrow = !owner && t < NN + N;  // computes (A x)[i]
  const int i = owner ? t / N : (xrow ? t - NN : 0);
  const int j = owner ? t % N : 0;

  float Ai[N], Aj[N];
#pragma unroll
  for (int k = 0; k < N; ++k) {
    Ai[k] = m.A[i * N + k];
    Aj[k] = m.A[j * N + k];
  }
  const float q = owner ? m.Q[t] : 0.0f;
  for (int u = t; u < KINDS * MN; u += THREADS) sH[u / MN][u % MN] = m.H[u / MN][u % MN];
  for (int u = t; u < KINDS * MM; u += THREADS) sR[u / MM][u % MM] = m.R[u / MM][u % MM];
  if (owner) sP[0][t] = 0.0f;
  if (t < N) sx[0][t] = 0.0f;
  int cur = 0;
  int run = 0;
  float yg = 0.0f;                // the FOG yaw, kept by the owner of x[11]
  __syncthreads();

  for (int e = 0; e < T; ++e) {
    const int c = e % CHUNK;
    if (c == 0) {
      __syncthreads();            // every thread is done with the last chunk
      const int n = min(CHUNK, T - e);
      for (int u = t; u < n; u += THREADS) scode[u] = codes[e + u];
      for (int u = t; u < n * M; u += THREADS) sz[u] = z[(size_t)e * M + u];
      __syncthreads();
    }
    const int kind = scode[c];
    if (kind < 0 || kind >= KINDS) continue;  // a DVL event the gate skipped
    ++run;
    if (kind == EVENT_IMU) {
      // predict: x <- A x, P <- A P Aᵀ + Q
      if (owner) {
        float s = 0.0f;
#pragma unroll
        for (int k = 0; k < N; ++k) s = fmaf(Ai[k], sP[cur][k * N + j], s);
        sAP[t] = s;
      } else if (xrow) {
        float s = 0.0f;
#pragma unroll
        for (int k = 0; k < N; ++k) s = fmaf(Ai[k], sx[cur][k], s);
        sx[cur ^ 1][i] = s;
      }
      __syncthreads();
      if (owner) {
        float s = 0.0f;
#pragma unroll
        for (int k = 0; k < N; ++k) s = fmaf(sAP[i * N + k], Aj[k], s);
        sP[cur ^ 1][t] = q + s;
      }
      __syncthreads();
      cur ^= 1;
    }
    const float* H = sH[kind];
    // H P, P Hᵀ and the innovation z - H x
    if (t < MN) {
      const int r = t / N, col = t % N;
      float s = 0.0f;
#pragma unroll
      for (int k = 0; k < N; ++k) s = fmaf(H[r * N + k], sP[cur][k * N + col], s);
      sHP[t] = s;
    } else if (t < 2 * MN) {
      const int u = t - MN, row = u / M, r = u % M;
      float s = 0.0f;
#pragma unroll
      for (int k = 0; k < N; ++k) s = fmaf(sP[cur][row * N + k], H[r * N + k], s);
      sPHt[u] = s;
    } else if (t < 2 * MN + M) {
      const int r = t - 2 * MN;
      float s = 0.0f;
#pragma unroll
      for (int k = 0; k < N; ++k) s = fmaf(H[r * N + k], sx[cur][k], s);
      sy[r] = sz[c * M + r] - s;
    }
    __syncthreads();
    // S = H P Hᵀ + R in lanes 0-8 of every warp, spread to all its lanes
    float sv = 0.0f;
    if (lane < MM) {
      const int a = lane / M, b = lane % M;
      float s = 0.0f;
#pragma unroll
      for (int k = 0; k < N; ++k) s = fmaf(sHP[a * N + k], H[b * N + k], s);
      sv = sR[kind][lane] + s;
    }
    float S[MM];
#pragma unroll
    for (int v = 0; v < MM; ++v) S[v] = __shfl_sync(FULL, sv, v);
    // S⁻¹ by adjugate: cofactor row a = row a+1 × row a+2
    float cof[MM];
#pragma unroll
    for (int a = 0; a < M; ++a) {
      const float* p = S + ((a + 1) % M) * M;
      const float* r = S + ((a + 2) % M) * M;
      cof[a * M + 0] = p[1] * r[2] - p[2] * r[1];
      cof[a * M + 1] = p[2] * r[0] - p[0] * r[2];
      cof[a * M + 2] = p[0] * r[1] - p[1] * r[0];
    }
    const float det = S[0] * cof[0] + S[1] * cof[1] + S[2] * cof[2];
    if (owner) {
      // row i of K = P Hᵀ S⁻¹, with S⁻¹[b, col] = cof[col, b] / det
      float K[M];
#pragma unroll
      for (int col = 0; col < M; ++col) {
        float s = 0.0f;
#pragma unroll
        for (int b = 0; b < M; ++b) s = fmaf(sPHt[i * M + b], cof[col * M + b] / det, s);
        K[col] = s;
      }
      // P[i, j] - ((K H) P)[i, j], row i of K H formed here
      float s = 0.0f;
#pragma unroll
      for (int k = 0; k < N; ++k) {
        float kh = 0.0f;
#pragma unroll
        for (int r = 0; r < M; ++r) kh = fmaf(K[r], H[r * N + k], kh);
        s = fmaf(kh, sP[cur][k * N + j], s);
      }
      sP[cur ^ 1][t] = sP[cur][t] - s;
      if (j == 0) {
        float ky = 0.0f;
#pragma unroll
        for (int r = 0; r < M; ++r) ky = fmaf(K[r], sy[r], ky);
        const float xi = sx[cur][i] + ky;
        sx[cur ^ 1][i] = xi;
        if (kind == EVENT_IMU) hist[(size_t)e * N + i] = xi;
        if (kind == EVENT_GYRO && i == N - 1) {
          yg += xi;               // added in stream order
          yaw_gyro[e] = yg;
        }
      }
    }
    __syncthreads();
    cur ^= 1;
  }
  __syncthreads();
  if (owner) P_out[t] = sP[cur][t];
  if (t < N) x_out[t] = sx[cur][t];
  if (t == 0) *count = run;
}

}  // namespace

// Runs the T events of codes (int8) and z ((T, 3) float32) on the stream;
// writes x (12), P (12x12), hist[e] (12 floats after each IMU event e),
// yaw_gyro[e] (after each gyro event e) and count (events run). hist and
// yaw_gyro rows of other events are left as they were. Returns
// cudaGetLastError() (0 on success).
extern "C" int kalman_filter_launch(
    const void* codes, const void* z, int T, const void* A, const void* Q,
    const void* H_imu, const void* R_imu, const void* H_dvl, const void* R_dvl,
    const void* H_depth, const void* R_depth, const void* H_gyro,
    const void* R_gyro, void* x, void* P, void* hist, void* yaw_gyro,
    void* count, void* stream) {
  Model m;
  m.A = static_cast<const float*>(A);
  m.Q = static_cast<const float*>(Q);
  const void* H[KINDS] = {H_imu, H_dvl, H_depth, H_gyro};
  const void* R[KINDS] = {R_imu, R_dvl, R_depth, R_gyro};
  for (int k = 0; k < KINDS; ++k) {
    m.H[k] = static_cast<const float*>(H[k]);
    m.R[k] = static_cast<const float*>(R[k]);
  }
  kalman_filter_kernel<<<1, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(codes), static_cast<const float*>(z), T, m,
      static_cast<float*>(x), static_cast<float*>(P), static_cast<float*>(hist),
      static_cast<float*>(yaw_gyro), static_cast<int*>(count));
  return (int)cudaGetLastError();
}
