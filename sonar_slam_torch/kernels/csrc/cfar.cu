// CFAR detectors for Hopper (sm_90a): the sum-based variants (CA / SOCA /
// GOCA) and the order-statistic variant (OS), each with the intensity gate
// fused in. Three kernels:
//
//   cfar_sum_kernel      CA / SOCA / GOCA; replaces
//                        sonar_slam_tpu/kernels/cfar_pallas.py::_cfar_kernel.
//   cfar_os_mask_kernel  OS when only the mask is wanted and tau > 0 (the
//                        feature path); replaces the mask of
//                        cfar_pallas.py::_cfar_os_kernel.
//   cfar_os_kernel       OS with the threshold map, or any other tau: the
//                        exact selection of the k-th smallest cell, from a
//                        window kept sorted down each column
//                        (cfar_os_split_kernel for the main path's window,
//                        cfar_os_window_kernel for any other).
//
// Every pixel of a (B, R, C) float32 stack of polar sonar frames has
// 2 * train_hs training cells in its column: rows r - j (leading) and r + j
// (lagging) for j = guard_hs + 1 ... guard_hs + train_hs. Row indices are
// clamped to [0, R-1]: with edge == 1 ("extend") that clamp IS the edge
// replication the Pallas wrapper builds as a padded copy, so no padded copy
// exists here; with edge == 0 ("strict") rows within hw = train_hs + guard_hs
// of either border are masked (det false, thr 0), as in
// sonar_slam_tpu/kernels/cfar.py::_valid_rows. Each kernel writes
//     det = (x > thr) & valid_row & (x > intensity_threshold)
// straight into a torch.bool tensor, and the threshold map only when the
// caller passes a pointer for it (the feature path does not).
//
// What bounds them. One read of the image and one write of the mask: at the
// replay's shape (128, 512, 256) that is 67.1 MB in and 16.8 MB out, 25 us at
// 3.35 TB/s. The arithmetic (40 adds or 40 compares a pixel, 0.67 G
// operations) stays under that bound. Neither kernel does a matrix product,
// so wgmma and the tensor cores do not apply; what Hopper offers here is
// shared memory, 16-byte accesses and enough blocks in flight to hide the
// loads.
//
// The tile (shared by the sum and the OS mask kernels). A block of 256
// threads takes TILE_ROWS x TILE_COLS = 64 x 64 pixels of one frame: grid.x
// is the column tile, grid.y the row tile, grid.z the frame, so no index is
// divided. Shared memory holds the 64 + 2 * hw rows of the tile's 64 columns
// (hw above, hw below), each row index clamped as above: 29 KB at the main
// path's hw = 25. A block reloads its 2 * hw halo rows, which its neighbours
// also load (1.8x the image from L2, once from device memory); a whole
// 512-row column stripe with its halo (144 KB for 64 columns) would load
// each row once but leave one block per SM. Each thread owns a strip of
// STRIP = 4 consecutive rows of 4 adjacent columns: its image loads are
// float4 (16 bytes) when C is a multiple of 4, its raw values stay in
// registers, and its mask stores are one uchar4 a row. Four rows keep the
// kernels at 64 registers or fewer, so four or five blocks (32 or 40 warps)
// fit on an SM; with 8 rows the strip path's arrays took 95-165 registers,
// and even a launch that skips all window arithmetic ran slower.
//
// The gate and the list. A pixel at or below the intensity gate (or in a
// masked row) is never a detection, whatever its threshold, so on the
// feature path (no threshold map) only the gated pixels need their window.
// On the replay's pings that is 0.41% of them, mostly at the walls. Each
// warp counts its gated pixels. Up to LIST_PER_WARP, it appends them to a
// list in shared memory, and after a barrier the block's threads take the
// list one pixel a thread, reading each pixel's cells from the tile: one
// warp instruction serves up to 32 gated pixels of the block, where a warp
// working on its own gated pixels kept one lane of 32 busy. A warp with more
// gated pixels (a bright region, or no gate) takes the strip path instead:
// each thread reads the training rows of its strip from shared memory once,
// as float4, and uses each row for every pixel of the strip whose window
// holds it. A warp vote alone, skipping warps with no gated pixel, saved
// nothing measurable (a fifth of the warps skipped on the replay's pings):
// a block keeps its place on the SM until its slowest warp ends.

#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int TILE_ROWS = 64;
constexpr int TILE_COLS = 64;
constexpr int STRIP = 4;                       // rows a thread owns
constexpr int SLOTS = 4 * STRIP;               // pixels a thread owns
constexpr int GROUPS = TILE_COLS / 4;          // threadIdx.x: 4 columns each
constexpr int STRIPS = TILE_ROWS / STRIP;      // threadIdx.y
constexpr int TILE_THREADS = GROUPS * STRIPS;  // 256
// gated pixels a warp may put on the block's list (of its 512); counting
// instructions, the strip path costs about as much as listing 230 of them,
// and 64 or 256 here timed the same on the replay's pings
constexpr int LIST_PER_WARP = 128;
constexpr int LIST_CAP = LIST_PER_WARP * TILE_THREADS / 32;
constexpr int MAX_FRAMES = 65535;  // grid.z limit
// shared memory a block may use on Hopper (227 KB), and the list's share
constexpr int MAX_BLOCK_BYTES = 232448;
constexpr int LIST_BYTES = LIST_CAP * 8 + 16;
constexpr int OS_MAX_CELLS = 128;

struct Identity {
  __device__ __forceinline__ float operator()(float v) const { return v; }
};

struct Scale {
  float tau;
  __device__ __forceinline__ float operator()(float v) const {
    return __fmul_rn(tau, v);
  }
};

__device__ __forceinline__ int clamp_row(int r, int R) {
  return r < 0 ? 0 : (r > R - 1 ? R - 1 : r);
}

// Four columns c ... c+3 of one image row, zero beyond C. VEC: C % 4 == 0
// and the row is 16-byte aligned, so the group is wholly in or out.
template <bool VEC>
__device__ __forceinline__ float4 load4(const float* __restrict__ row, int c,
                                        int C) {
  if (VEC) {
    return c < C ? __ldg(reinterpret_cast<const float4*>(row + c))
                 : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  return make_float4(c < C ? row[c] : 0.0f, c + 1 < C ? row[c + 1] : 0.0f,
                     c + 2 < C ? row[c + 2] : 0.0f,
                     c + 3 < C ? row[c + 3] : 0.0f);
}

template <class Op>
__device__ __forceinline__ void put4(float* tile, int row, float4 v, Op op) {
  *reinterpret_cast<float4*>(tile + row * TILE_COLS + 4 * threadIdx.x) =
      make_float4(op(v.x), op(v.y), op(v.z), op(v.w));
}

// Fills the block's tile: shared row i holds op(image row
// clamp(R0 - hw + i)) for i in [0, TILE_ROWS + 2 * hw), R0 the tile's first
// row. Each thread loads its own strip (rows r0 ... r0 + STRIP - 1, columns
// c ... c + 3), keeping the raw values in x, and a share of the halo rows.
// The caller synchronises.
template <bool VEC, class Op>
__device__ __forceinline__ void load_tile(const float* __restrict__ frame,
                                          float* tile, int R, int C, int hw,
                                          int r0, int c, float (&x)[STRIP][4],
                                          Op op) {
  const int R0 = blockIdx.y * TILE_ROWS;
#pragma unroll
  for (int s = 0; s < STRIP; ++s) {
    const int r = r0 + s;
    const float4 v =
        load4<VEC>(frame + (long long)clamp_row(r, R) * C, c, C);
    x[s][0] = v.x;
    x[s][1] = v.y;
    x[s][2] = v.z;
    x[s][3] = v.w;
    put4(tile, r - R0 + hw, v, op);
  }
  for (int i = threadIdx.y; i < 2 * hw; i += STRIPS) {
    const int ti = i < hw ? i : i + TILE_ROWS;
    const int r = clamp_row(R0 - hw + ti, R);
    put4(tile, ti, load4<VEC>(frame + (long long)r * C, c, C), op);
  }
}

// Bit 4s+k: the pixel at row r0+s, column c+k lies in the frame, in a row
// that may detect, and passes the intensity gate. A pixel without its bit is
// never a detection.
__device__ __forceinline__ unsigned need_bits(const float (&x)[STRIP][4],
                                              int r0, int c, int R, int C,
                                              int hw, int extend, int use_gate,
                                              float gate) {
  unsigned bits = 0;
#pragma unroll
  for (int s = 0; s < STRIP; ++s) {
    const int r = r0 + s;
    const bool row_ok = r < R && (extend || (r >= hw && r < R - hw));
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (row_ok && c + k < C && (!use_gate || x[s][k] > gate))
        bits |= 1u << (4 * s + k);
    }
  }
  return bits;
}

// Appends the thread's gated pixels to the block's list: each one's offset
// in the tile to pos and, if xs is not null, its raw value to xs. Returns
// the index of the thread's first entry.
__device__ __forceinline__ int list_push(unsigned need, int base,
                                         const float (&x)[STRIP][4], int* pos,
                                         float* xs, int* n) {
  int e = need ? atomicAdd(n, __popc(need)) : 0;
  const int first = e;
#pragma unroll
  for (int i = 0; i < SLOTS; ++i) {
    if ((need >> i) & 1u) {
      pos[e] = base + (i >> 2) * TILE_COLS + (i & 3);
      if (xs != nullptr) xs[e] = x[i >> 2][i & 3];
      ++e;
    }
  }
  return first;
}

// The thread's detections, which the block left in pos (1 or 0) in the
// order list_push wrote its entries.
__device__ __forceinline__ unsigned list_pull(unsigned need, int e,
                                              const int* pos) {
  unsigned bits = 0;
#pragma unroll
  for (int i = 0; i < SLOTS; ++i) {
    if ((need >> i) & 1u) {
      if (pos[e]) bits |= 1u << i;
      ++e;
    }
  }
  return bits;
}

// Mask bit 4s+k to (row r0+s, column c+k), as one uchar4 a row when VEC.
template <bool VEC>
__device__ __forceinline__ void store_mask(bool* __restrict__ det,
                                           unsigned bits, int r0, int c,
                                           int R, int C) {
#pragma unroll
  for (int s = 0; s < STRIP; ++s) {
    const int r = r0 + s;
    if (r >= R) break;
    bool* row = det + (long long)r * C;
    const unsigned b = bits >> (4 * s);
    if (VEC) {
      if (c < C)
        *reinterpret_cast<uchar4*>(row + c) =
            make_uchar4(b & 1u, (b >> 1) & 1u, (b >> 2) & 1u, (b >> 3) & 1u);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (c + k < C) row[c + k] = (b >> k) & 1u;
    }
  }
}

template <bool VEC>
__device__ __forceinline__ void store_thr(float* __restrict__ thr,
                                          const float (&t)[STRIP][4], int r0,
                                          int c, int R, int C) {
#pragma unroll
  for (int s = 0; s < STRIP; ++s) {
    const int r = r0 + s;
    if (r >= R) break;
    float* row = thr + (long long)r * C;
    if (VEC) {
      if (c < C)
        *reinterpret_cast<float4*>(row + c) =
            make_float4(t[s][0], t[s][1], t[s][2], t[s][3]);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (c + k < C) row[c + k] = t[s][k];
    }
  }
}

// torch.minimum / torch.maximum: a NaN operand gives NaN
__device__ __forceinline__ float min_nan(float a, float b) {
  return (a < b || a != a) ? a : b;
}
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a > b || a != a) ? a : b;
}

// The threshold from a pixel's sums: the plain version's min / max / mean,
// IEEE division by train_hs (2 * train_hs for CA), then times tau.
__device__ __forceinline__ float sum_threshold(float lead, float lag, int mode,
                                               int th, float tau) {
  float stat;
  if (mode == 0) {
    stat = __fdiv_rn(lead + lag, (float)(2 * th));
  } else if (mode == 1) {
    stat = __fdiv_rn(min_nan(lead, lag), (float)th);
  } else {
    stat = __fdiv_rn(max_nan(lead, lag), (float)th);
  }
  return __fmul_rn(tau, stat);
}

// ---------------------------------------------------------------------------
// cfar_sum_kernel: for each pixel the leading and lagging sums of its
// train_hs training cells, their mean (CA), min (SOCA) or max (GOCA) over
// train_hs, thr = tau * stat.
//
// Arithmetic order matches the Pallas kernel and the plain PyTorch version in
// cfar_cuda.py exactly: each sum starts at 0.0f and adds j = guard+1 ...
// guard+train in order, then stat = min(lead, lag) / train_hs (IEEE
// division), then thr = tau * stat. No product feeds an add, so no fused
// multiply-add can change a bit. A sliding sum (add one row, subtract
// another) would round differently, so every pixel's 20 cells are added in
// full: one by one for a listed pixel, and on the strip path by walking the
// shared rows downwards for the leading sums and upwards for the lagging
// ones, so that every pixel meets its cells in the order j = guard+1,
// guard+2, ...
//
// T > 0 fixes train_hs = T and guard_hs = G at compile time (the main path's
// 20 and 5): the loops unroll and which pixel takes which row is decided by
// the compiler. T = 0 is the generic window, with the same code under
// runtime bounds.

// Leading and lagging training sums of the pixel at q in the tile, each from
// 0.0f, nearest cell first.
template <int T>
__device__ __forceinline__ void pixel_sums(const float* q, int g, int hw,
                                           float& lead, float& lag) {
  lead = 0.0f;
  lag = 0.0f;
#pragma unroll(T > 0 ? T : 1)
  for (int j = g + 1; j <= hw; ++j) {
    lead = lead + q[-j * TILE_COLS];
    lag = lag + q[j * TILE_COLS];
  }
}

// The sums of the thread's strip; p is its first pixel in the tile.
template <int T>
__device__ __forceinline__ void strip_sums(const float* p, int g, int hw,
                                           float (&lead)[STRIP][4],
                                           float (&lag)[STRIP][4]) {
#pragma unroll
  for (int s = 0; s < STRIP; ++s) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      lead[s][k] = 0.0f;
      lag[s][k] = 0.0f;
    }
  }
  // leading cells, nearest first: row o of the strip is cell j = s - o of
  // pixel s
#pragma unroll(T > 0 ? STRIP - 1 + T : 1)
  for (int o = STRIP - 2 - g; o >= -hw; --o) {
    const float4 w = *reinterpret_cast<const float4*>(p + o * TILE_COLS);
#pragma unroll
    for (int s = 0; s < STRIP; ++s) {
      const int j = s - o;
      if (j > g && j <= hw) {
        lead[s][0] = lead[s][0] + w.x;
        lead[s][1] = lead[s][1] + w.y;
        lead[s][2] = lead[s][2] + w.z;
        lead[s][3] = lead[s][3] + w.w;
      }
    }
  }
  // lagging cells, nearest first: row o is cell j = o - s of pixel s
#pragma unroll(T > 0 ? STRIP - 1 + T : 1)
  for (int o = g + 1; o < STRIP + hw; ++o) {
    const float4 w = *reinterpret_cast<const float4*>(p + o * TILE_COLS);
#pragma unroll
    for (int s = 0; s < STRIP; ++s) {
      const int j = o - s;
      if (j > g && j <= hw) {
        lag[s][0] = lag[s][0] + w.x;
        lag[s][1] = lag[s][1] + w.y;
        lag[s][2] = lag[s][2] + w.z;
        lag[s][3] = lag[s][3] + w.w;
      }
    }
  }
}

template <int T, int G, bool VEC>
__global__ void __launch_bounds__(TILE_THREADS)
    cfar_sum_kernel(const float* __restrict__ img, bool* __restrict__ det,
                    float* __restrict__ thr_out, int R, int C, int train_hs,
                    int guard_hs, float tau, int mode, int use_gate,
                    float gate, int extend) {
  extern __shared__ float4 smem[];
  __shared__ int list_pos[LIST_CAP];
  __shared__ int list_n;
  float* tile = reinterpret_cast<float*>(smem);
  const int th = T > 0 ? T : train_hs;
  const int g = T > 0 ? G : guard_hs;
  const int hw = th + g;
  const long long plane = (long long)R * C;
  const int r0 = blockIdx.y * TILE_ROWS + threadIdx.y * STRIP;
  const int c = blockIdx.x * TILE_COLS + 4 * threadIdx.x;
  // the thread's first pixel in the tile
  const int base = (threadIdx.y * STRIP + hw) * TILE_COLS + 4 * threadIdx.x;

  if (threadIdx.x == 0 && threadIdx.y == 0) list_n = 0;
  float x[STRIP][4];
  load_tile<VEC>(img + blockIdx.z * plane, tile, R, C, hw, r0, c, x,
                 Identity());
  __syncthreads();
  const unsigned need = need_bits(x, r0, c, R, C, hw, extend, use_gate, gate);
  // the threshold map needs every pixel's sums
  const bool strip_path =
      thr_out != nullptr ||
      __reduce_add_sync(0xffffffffu, __popc(need)) > LIST_PER_WARP;

  unsigned bits = 0;
  int first = 0;
  if (strip_path) {
    float lead[STRIP][4];
    float lag[STRIP][4];
    strip_sums<T>(tile + base, g, hw, lead, lag);
    // lead becomes the threshold map
#pragma unroll
    for (int s = 0; s < STRIP; ++s) {
      const int r = r0 + s;
      const bool valid = extend || (r >= hw && r < R - hw);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float t = sum_threshold(lead[s][k], lag[s][k], mode, th, tau);
        if (((need >> (4 * s + k)) & 1u) && x[s][k] > t)
          bits |= 1u << (4 * s + k);
        lead[s][k] = valid ? t : 0.0f;
      }
    }
    if (thr_out != nullptr)
      store_thr<VEC>(thr_out + blockIdx.z * plane, lead, r0, c, R, C);
  } else {
    first = list_push(need, base, x, list_pos, nullptr, &list_n);
  }
  __syncthreads();
  for (int e = threadIdx.x + GROUPS * threadIdx.y; e < list_n;
       e += TILE_THREADS) {
    const float* q = tile + list_pos[e];
    float lead, lag;
    pixel_sums<T>(q, g, hw, lead, lag);
    list_pos[e] = q[0] > sum_threshold(lead, lag, mode, th, tau);
  }
  __syncthreads();
  if (!strip_path) bits = list_pull(need, first, list_pos);
  store_mask<VEC>(det + blockIdx.z * plane, bits, r0, c, R, C);
}

// ---------------------------------------------------------------------------
// cfar_os_mask_kernel: the OS mask without selecting the k-th smallest cell.
//
// The mask needs only det = (x > fl(tau * kth)) & valid & gate, where kth is
// the rank-th smallest (0-indexed) of the pixel's cells v_i and fl() rounds
// to float32. For finite tau > 0, v -> fl(tau * v) is monotone
// non-decreasing on the extended reals (rounding, underflow to 0 and
// overflow to inf all keep the order, and -inf stays -inf), so fl(tau * kth)
// is the rank-th smallest of the w_i = fl(tau * v_i), and
//     x > fl(tau * kth)   <=>   #{i : w_i < x} >= rank + 1
// (a sorted list has at least rank + 1 entries below x exactly when its
// rank-th entry is below x). NaN cells sort last in the plain version's sort
// and never compare below x here; if rank reaches them, kth is NaN and the
// count stays at most rank, so both sides are false; a NaN pixel is false on
// both sides. The identity needs tau > 0: with tau == 0, fl(0 * -inf) is NaN,
// which breaks the order (a window whose rank-th cell is -inf has threshold
// NaN, so no detection, while the finite cells would still count below x).
// cfar_cuda.py routes any other tau, and every call that wants the threshold
// map, to cfar_os_kernel below.
//
// So the kernel counts: 40 compares a pixel at the main path's window and no
// selection. It is the Pallas kernel's own idea, counting cells against a
// level (cfar_pallas.py::_cfar_os_kernel's window_count_leq), applied once at
// x instead of at 22 bisection midpoints, and exact on float pings. The tile
// holds w = fl(tau * v), computed once per cell as it is loaded (each cell
// serves the 40 pixels of its column); the pixels' raw values stay in
// registers, or go on the list beside their offsets, since x is compared
// raw.

// How many training cells of the pixel at q in the tile lie below x.
template <int T>
__device__ __forceinline__ int pixel_count(const float* q, float x, int g,
                                           int hw) {
  int n = 0;
#pragma unroll(T > 0 ? T : 1)
  for (int j = g + 1; j <= hw; ++j)
    n += (q[-j * TILE_COLS] < x) + (q[j * TILE_COLS] < x);
  return n;
}

// The detections of the thread's strip by counting; p is its first pixel in
// the tile. Row o of the strip is a training cell of pixel s when
// guard < |o - s| <= hw.
template <int T, int G>
__device__ __forceinline__ unsigned strip_counts(const float* p,
                                                 const float (&x)[STRIP][4],
                                                 unsigned need, int g, int hw,
                                                 int rank) {
  int cnt[STRIP][4];
#pragma unroll
  for (int s = 0; s < STRIP; ++s) {
#pragma unroll
    for (int k = 0; k < 4; ++k) cnt[s][k] = 0;
  }
#pragma unroll(T > 0 ? 2 * (T + G) + STRIP : 1)
  for (int o = -hw; o < STRIP + hw; ++o) {
    const float4 w = *reinterpret_cast<const float4*>(p + o * TILE_COLS);
#pragma unroll
    for (int s = 0; s < STRIP; ++s) {
      const int d = o - s < 0 ? s - o : o - s;
      if (d > g && d <= hw) {
        cnt[s][0] += w.x < x[s][0];
        cnt[s][1] += w.y < x[s][1];
        cnt[s][2] += w.z < x[s][2];
        cnt[s][3] += w.w < x[s][3];
      }
    }
  }
  unsigned bits = 0;
#pragma unroll
  for (int i = 0; i < SLOTS; ++i) {
    if (((need >> i) & 1u) && cnt[i >> 2][i & 3] > rank) bits |= 1u << i;
  }
  return bits;
}

// Five blocks an SM: ptxas then gives it 48 registers and a 16-byte spill
// instead of 59, and the main path's call ran faster on the H100; the same
// bound on cfar_sum_kernel spilled 96 bytes and made it slower.
template <int T, int G, bool VEC>
__global__ void __launch_bounds__(TILE_THREADS, 5)
    cfar_os_mask_kernel(const float* __restrict__ img, bool* __restrict__ det,
                        int R, int C, int train_hs, int guard_hs, int rank,
                        float tau, int use_gate, float gate, int extend) {
  extern __shared__ float4 smem[];
  __shared__ int list_pos[LIST_CAP];
  __shared__ float list_x[LIST_CAP];
  __shared__ int list_n;
  float* tile = reinterpret_cast<float*>(smem);
  const int th = T > 0 ? T : train_hs;
  const int g = T > 0 ? G : guard_hs;
  const int hw = th + g;
  const long long plane = (long long)R * C;
  const int r0 = blockIdx.y * TILE_ROWS + threadIdx.y * STRIP;
  const int c = blockIdx.x * TILE_COLS + 4 * threadIdx.x;
  const int base = (threadIdx.y * STRIP + hw) * TILE_COLS + 4 * threadIdx.x;

  if (threadIdx.x == 0 && threadIdx.y == 0) list_n = 0;
  float x[STRIP][4];
  load_tile<VEC>(img + blockIdx.z * plane, tile, R, C, hw, r0, c, x,
                 Scale{tau});
  __syncthreads();
  const unsigned need = need_bits(x, r0, c, R, C, hw, extend, use_gate, gate);
  const bool strip_path =
      __reduce_add_sync(0xffffffffu, __popc(need)) > LIST_PER_WARP;

  unsigned bits = 0;
  int first = 0;
  if (strip_path)
    bits = strip_counts<T, G>(tile + base, x, need, g, hw, rank);
  else
    first = list_push(need, base, x, list_pos, list_x, &list_n);
  __syncthreads();
  for (int e = threadIdx.x + GROUPS * threadIdx.y; e < list_n;
       e += TILE_THREADS)
    list_pos[e] = pixel_count<T>(tile + list_pos[e], list_x[e], g, hw) > rank;
  __syncthreads();
  if (!strip_path) bits = list_pull(need, first, list_pos);
  store_mask<VEC>(det + blockIdx.z * plane, bits, r0, c, R, C);
}

// ---------------------------------------------------------------------------
// cfar_os_kernel: replaces sonar_slam_tpu/kernels/cfar_pallas.py::
// _cfar_os_kernel where the threshold map is wanted (or tau <= 0).
//
// For every pixel, kth = the rank-th smallest (0-indexed) of its 2 * train_hs
// training cells, thr = tau * kth, and det as above.
//
// Selection. The Pallas kernel brackets kth by a counting bisection over
// [-1, 255] (8 integer steps, then os_float_refine_steps continuous ones): an
// upper bound within 256 * 2^-22 of kth on float images. Here kth is the
// EXACT order statistic, read from the window kept sorted, so it is one of
// the inputs and equals the sorted window's rank-th entry bit for bit (what
// the XLA path, the reference's nth_element and the plain PyTorch version
// compute); os_float_refine_steps has no counterpart. The window is sorted as
// order-preserving unsigned keys: a float's bits with the sign bit flipped
// (non-negative) or all bits flipped (negative), every NaN as the key of the
// canonical NaN, above +inf, so NaN sorts last, as torch.sort puts it. Keys
// decode back to the float exactly (a NaN to the canonical NaN). -0 sorts
// before +0, where the sort finds them equal: kth may then differ from the
// plain version's in the sign of a zero, never in value.
//
// Design. The first design gave each pixel a thread that re-read its 40 cells
// from device memory and counted, for each cell, the cells below it: 3,200
// compares a pixel, 130 times the bytes bound. Moving down a column, a
// pixel's window drops two cells and gains two, so here a thread walks a
// strip of OS_STRIP consecutive rows of one column and keeps the window
// sorted in registers across them:
//   * a block stages its column stripe (32 columns x OS_BLOCK_ROWS rows and
//     hw halo rows above and below, row indices clamped: the extend edge's
//     replication) in shared memory as keys, each converted once; a warp
//     holds 32 adjacent columns, so every shared read is conflict-free and
//     every device load and store is one coalesced line;
//   * at the strip's first row the window is sorted once; at each next row
//     one predicated deletion (b[i] = a[i] >= d ? a[i+1] : a[i]) and one
//     insertion (a[i] = max(b[i-1], min(b[i], e))) per dropped and gained
//     cell, each about 2 operations an entry, update it in place.
// The main path's window (train_hs 20, rank 10; cfar_os_split_kernel) keeps
// its leading and lagging halves as two sorted arrays of 20, each updated
// with one deletion and one insertion a row (4 x 20 operations each), and
// reads the rank-th smallest of their union as
//     kth = min over i + j = rank + 1 of max(L[i-1], G[j-1])
// (the smallest rank + 1 cells are a prefix of each half; any other split's
// largest cell is no smaller): 21 operations. About 190 integer operations a
// pixel in place of 3,200 compares. Every other rank of that window
// (cfar_os_window_kernel<40>), and every other window up to OS_MAX_CELLS
// cells (cfar_os_window_kernel<OS_MAX_CELLS>, padded above with keys past
// every float's), keeps one sorted array of CAP keys, sorts it at the
// strip's first row by insertion, updates it with two deletions and two
// insertions a row and reads entry rank. Bound: the
// integer operations (min, max, compare, select) at the card's integer rate,
// not the bytes; PERF.md has the measured time beside both.

constexpr int OS_STRIP = 32;                      // rows a thread walks
constexpr int OS_WARPS = 8;                       // strips a block stacks
constexpr int OS_BLOCK_ROWS = OS_STRIP * OS_WARPS;
constexpr int OS_THREADS = 32 * OS_WARPS;
constexpr uint32_t NAN_KEY = 0xFFC00000u;  // the canonical NaN's key
constexpr uint32_t PAD_KEY = 0xFFFFFFFFu;  // above every float's key

__device__ __forceinline__ uint32_t float_key(float v) {
  const uint32_t u = __float_as_uint(v);
  if (v != v) return NAN_KEY;
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_float(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7FFFFFFFu) : ~k);
}

__device__ __forceinline__ uint32_t umin(uint32_t a, uint32_t b) {
  return a < b ? a : b;
}
__device__ __forceinline__ uint32_t umax(uint32_t a, uint32_t b) {
  return a > b ? a : b;
}

// Sorted a[0, N): remove one entry equal to d (present), leaving PAD_KEY at
// the top. Entries from d's first occurrence on are >= d and shift down.
template <int N>
__device__ __forceinline__ void sorted_delete(uint32_t (&a)[N], uint32_t d) {
#pragma unroll
  for (int i = 0; i < N - 1; ++i) a[i] = a[i] >= d ? a[i + 1] : a[i];
  a[N - 1] = PAD_KEY;
}

// Sorted a[0, N) with a[N-1] free (PAD_KEY): insert e. Entry i becomes the
// median of the old a[i-1], a[i] and e; walking down reads old values.
template <int N>
__device__ __forceinline__ void sorted_insert(uint32_t (&a)[N], uint32_t e) {
#pragma unroll
  for (int i = N - 1; i > 0; --i) a[i] = umax(a[i - 1], umin(a[i], e));
  a[0] = umin(a[0], e);
}

// Fills the block's key stripe: shared row i, column l holds the key of
// image row clamp(R0 - hw + i), column c0 + l (0 beyond C), for i in
// [0, OS_BLOCK_ROWS + 2 * hw). The caller synchronises.
__device__ __forceinline__ void stage_keys(const float* __restrict__ frame,
                                           uint32_t* keys, int R, int C,
                                           int R0, int c0, int hw) {
  const int lane = threadIdx.x;
  const int c = c0 + lane;
  const int rows = OS_BLOCK_ROWS + 2 * hw;
#pragma unroll 4
  for (int i = threadIdx.y; i < rows; i += OS_WARPS) {
    const int r = clamp_row(R0 - hw + i, R);
    keys[i * 32 + lane] =
        c < C ? float_key(__ldg(frame + (long long)r * C + c)) : 0u;
  }
}

// Threshold, mask and threshold map of the pixel at row r, column c.
__device__ __forceinline__ void os_finish(uint32_t kth_key, uint32_t x_key,
                                          bool* __restrict__ det,
                                          float* __restrict__ thr_out,
                                          long long idx, int r, int R, int hw,
                                          float tau, int use_gate, float gate,
                                          int extend) {
  const float thr = __fmul_rn(tau, key_float(kth_key));
  const float x = key_float(x_key);
  const bool valid = extend || (r >= hw && r < R - hw);
  bool d = valid && (x > thr);
  if (use_gate) d = d && (x > gate);
  det[idx] = d;
  if (thr_out != nullptr) thr_out[idx] = valid ? thr : 0.0f;
}

// The main path's window: train_hs = TH, rank = RANK (template), any guard.
template <int TH, int RANK>
__global__ void __launch_bounds__(OS_THREADS)
    cfar_os_split_kernel(const float* __restrict__ img, bool* __restrict__ det,
                         float* __restrict__ thr_out, int R, int C,
                         int guard_hs, float tau, int use_gate, float gate,
                         int extend) {
  extern __shared__ uint32_t os_keys[];
  const int g = guard_hs;
  const int hw = TH + g;
  const long long plane = (long long)R * C;
  const int R0 = blockIdx.y * OS_BLOCK_ROWS;
  const int c = blockIdx.x * 32 + threadIdx.x;
  stage_keys(img + blockIdx.z * plane, os_keys, R, C, R0, blockIdx.x * 32, hw);
  __syncthreads();
  const int r0 = R0 + threadIdx.y * OS_STRIP;
  if (c >= C || r0 >= R) return;
  // col[r * 32]: the key of image row r (clamped) in this thread's column
  const uint32_t* col = os_keys + threadIdx.x + (hw - R0) * 32;

  // leading cells rows r-hw ... r-g-1, lagging r+g+1 ... r+hw, at row r0
  uint32_t L[TH], G[TH];
#pragma unroll
  for (int j = 0; j < TH; ++j) {
    L[j] = col[(r0 - hw + j) * 32];
    G[j] = col[(r0 + g + 1 + j) * 32];
  }
  // odd-even transposition sort of both halves
#pragma unroll
  for (int round = 0; round < TH; ++round) {
#pragma unroll
    for (int i = round & 1; i + 1 < TH; i += 2) {
      const uint32_t lo = umin(L[i], L[i + 1]), hi = umax(L[i], L[i + 1]);
      L[i] = lo;
      L[i + 1] = hi;
      const uint32_t lo2 = umin(G[i], G[i + 1]), hi2 = umax(G[i], G[i + 1]);
      G[i] = lo2;
      G[i + 1] = hi2;
    }
  }
  const int rows = R - r0 < OS_STRIP ? R - r0 : OS_STRIP;
  const long long base = blockIdx.z * plane + (long long)r0 * C + c;
  for (int s = 0; s < rows; ++s) {
    const int r = r0 + s;
    if (s > 0) {
      // row r's leading window drops row r-1-hw and gains r-g-1; its
      // lagging window drops r+g and gains r+hw
      sorted_delete(L, col[(r - 1 - hw) * 32]);
      sorted_insert(L, col[(r - g - 1) * 32]);
      sorted_delete(G, col[(r + g) * 32]);
      sorted_insert(G, col[(r + hw) * 32]);
    }
    // the (RANK+1)-th smallest of L and G together
    uint32_t kth = PAD_KEY;
#pragma unroll
    for (int i = 0; i <= RANK + 1; ++i) {
      const int j = RANK + 1 - i;
      if (i > TH || j > TH) continue;
      const uint32_t m = i == 0 ? G[j - 1]
                                : (j == 0 ? L[i - 1] : umax(L[i - 1], G[j - 1]));
      kth = umin(kth, m);
    }
    os_finish(kth, col[r * 32], det, thr_out, base + (long long)s * C, r, R,
              hw, tau, use_gate, gate, extend);
  }
}

// Any window of 2 * train_hs <= CAP cells and any rank: one sorted array.
template <int CAP>
__global__ void __launch_bounds__(OS_THREADS)
    cfar_os_window_kernel(const float* __restrict__ img,
                          bool* __restrict__ det, float* __restrict__ thr_out,
                          int R, int C, int train_hs, int guard_hs, int rank,
                          float tau, int use_gate, float gate, int extend) {
  extern __shared__ uint32_t os_keys[];
  const int g = guard_hs;
  const int hw = train_hs + g;
  const long long plane = (long long)R * C;
  const int R0 = blockIdx.y * OS_BLOCK_ROWS;
  const int c = blockIdx.x * 32 + threadIdx.x;
  stage_keys(img + blockIdx.z * plane, os_keys, R, C, R0, blockIdx.x * 32, hw);
  __syncthreads();
  const int r0 = R0 + threadIdx.y * OS_STRIP;
  if (c >= C || r0 >= R) return;
  const uint32_t* col = os_keys + threadIdx.x + (hw - R0) * 32;

  uint32_t w[CAP];
#pragma unroll
  for (int i = 0; i < CAP; ++i) w[i] = PAD_KEY;
  for (int j = g + 1; j <= hw; ++j) {
    sorted_insert(w, col[(r0 - j) * 32]);
    sorted_insert(w, col[(r0 + j) * 32]);
  }
  const int rows = R - r0 < OS_STRIP ? R - r0 : OS_STRIP;
  const long long base = blockIdx.z * plane + (long long)r0 * C + c;
  for (int s = 0; s < rows; ++s) {
    const int r = r0 + s;
    if (s > 0) {
      sorted_delete(w, col[(r - 1 - hw) * 32]);
      sorted_insert(w, col[(r - g - 1) * 32]);
      sorted_delete(w, col[(r + g) * 32]);
      sorted_insert(w, col[(r + hw) * 32]);
    }
    uint32_t kth = PAD_KEY;
#pragma unroll
    for (int i = 0; i < CAP; ++i) kth = i == rank ? w[i] : kth;
    os_finish(kth, col[r * 32], det, thr_out, base + (long long)s * C, r, R,
              hw, tau, use_gate, gate, extend);
  }
}

// Dynamic shared bytes of a tile for half-window hw (the lists are static).
long long tile_bytes(int hw) {
  return (long long)(TILE_ROWS + 2 * hw) * TILE_COLS * 4;
}

bool aligned(const void* p, uintptr_t n) {
  return p == nullptr || ((uintptr_t)p % n) == 0;
}

dim3 tile_grid(int R, int C, int frames) {
  return dim3((unsigned)((C + TILE_COLS - 1) / TILE_COLS),
              (unsigned)((R + TILE_ROWS - 1) / TILE_ROWS), (unsigned)frames);
}

}  // namespace

// The widest half-window (train_hs + guard_hs) the tile kernels take.
extern "C" int cfar_max_half_window() {
  return ((MAX_BLOCK_BYTES - LIST_BYTES) / (TILE_COLS * 4) - TILE_ROWS) / 2;
}

// The three launchers return cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for a window the kernel does not take. Each launches
// on `stream`; the caller has checked shapes, dtype, contiguity and device.

extern "C" int cfar_sum_launch(const void* img, void* det, void* thr,
                               int B, int R, int C, int train_hs,
                               int guard_hs, float tau, int mode,
                               int use_gate, float gate, int extend,
                               void* stream) {
  if (train_hs + guard_hs > cfar_max_half_window())
    return (int)cudaErrorInvalidValue;
  if ((long long)B * R * C == 0) return 0;
  const int smem = (int)tile_bytes(train_hs + guard_hs);
  const bool vec = C % 4 == 0 && aligned(img, 16) && aligned(det, 4) &&
                   aligned(thr, 16);
  const bool main_window = train_hs == 20 && guard_hs == 5;
  void (*k)(const float*, bool*, float*, int, int, int, int, float, int, int,
            float, int) =
      main_window ? (vec ? cfar_sum_kernel<20, 5, true>
                         : cfar_sum_kernel<20, 5, false>)
                  : (vec ? cfar_sum_kernel<0, 0, true>
                         : cfar_sum_kernel<0, 0, false>);
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         smem);
  cudaStream_t s = (cudaStream_t)stream;
  const long long plane = (long long)R * C;
  for (int b0 = 0; b0 < B; b0 += MAX_FRAMES) {
    const int nb = B - b0 < MAX_FRAMES ? B - b0 : MAX_FRAMES;
    k<<<tile_grid(R, C, nb), dim3(GROUPS, STRIPS), smem, s>>>(
        (const float*)img + b0 * plane, (bool*)det + b0 * plane,
        thr == nullptr ? nullptr : (float*)thr + b0 * plane, R, C, train_hs,
        guard_hs, tau, mode, use_gate, gate, extend);
  }
  return (int)cudaGetLastError();
}

extern "C" int cfar_os_mask_launch(const void* img, void* det, int B, int R,
                                   int C, int train_hs, int guard_hs,
                                   int rank, float tau, int use_gate,
                                   float gate, int extend, void* stream) {
  if (train_hs + guard_hs > cfar_max_half_window() ||
      2 * train_hs > OS_MAX_CELLS || !(tau > 0.0f && tau <= FLT_MAX))
    return (int)cudaErrorInvalidValue;
  if ((long long)B * R * C == 0) return 0;
  const int smem = (int)tile_bytes(train_hs + guard_hs);
  const bool vec = C % 4 == 0 && aligned(img, 16) && aligned(det, 4);
  const bool main_window = train_hs == 20 && guard_hs == 5;
  void (*k)(const float*, bool*, int, int, int, int, int, float, int, float,
            int) =
      main_window ? (vec ? cfar_os_mask_kernel<20, 5, true>
                         : cfar_os_mask_kernel<20, 5, false>)
                  : (vec ? cfar_os_mask_kernel<0, 0, true>
                         : cfar_os_mask_kernel<0, 0, false>);
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         smem);
  cudaStream_t s = (cudaStream_t)stream;
  const long long plane = (long long)R * C;
  for (int b0 = 0; b0 < B; b0 += MAX_FRAMES) {
    const int nb = B - b0 < MAX_FRAMES ? B - b0 : MAX_FRAMES;
    k<<<tile_grid(R, C, nb), dim3(GROUPS, STRIPS), smem, s>>>(
        (const float*)img + b0 * plane, (bool*)det + b0 * plane, R, C,
        train_hs, guard_hs, rank, tau, use_gate, gate, extend);
  }
  return (int)cudaGetLastError();
}

// The widest half-window the OS selection kernels' stripe takes.
extern "C" int cfar_os_max_half_window() {
  return (MAX_BLOCK_BYTES / (32 * 4) - OS_BLOCK_ROWS) / 2;
}

extern "C" int cfar_os_launch(const void* img, void* det, void* thr,
                              int B, int R, int C, int train_hs, int guard_hs,
                              int rank, float tau, int use_gate, float gate,
                              int extend, void* stream) {
  const int n = 2 * train_hs;
  const int hw = train_hs + guard_hs;
  if (n > OS_MAX_CELLS || rank < 0 || rank >= n ||
      hw > cfar_os_max_half_window())
    return (int)cudaErrorInvalidValue;
  if ((long long)B * R * C == 0) return 0;
  const int smem = (OS_BLOCK_ROWS + 2 * hw) * 32 * 4;
  cudaStream_t s = (cudaStream_t)stream;
  const long long plane = (long long)R * C;
  const dim3 block(32, OS_WARPS);
  if (train_hs == 20 && rank == 10) {
    auto k = cfar_os_split_kernel<20, 10>;
    if (smem > 48 * 1024)
      cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem);
    for (int b0 = 0; b0 < B; b0 += MAX_FRAMES) {
      const int nb = B - b0 < MAX_FRAMES ? B - b0 : MAX_FRAMES;
      const dim3 grid((C + 31) / 32, (R + OS_BLOCK_ROWS - 1) / OS_BLOCK_ROWS,
                      nb);
      k<<<grid, block, smem, s>>>(
          (const float*)img + b0 * plane, (bool*)det + b0 * plane,
          thr == nullptr ? nullptr : (float*)thr + b0 * plane, R, C,
          guard_hs, tau, use_gate, gate, extend);
    }
    return (int)cudaGetLastError();
  }
  void (*k)(const float*, bool*, float*, int, int, int, int, int, float, int,
            float, int) =
      n == 40 ? cfar_os_window_kernel<40>
              : cfar_os_window_kernel<OS_MAX_CELLS>;
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  for (int b0 = 0; b0 < B; b0 += MAX_FRAMES) {
    const int nb = B - b0 < MAX_FRAMES ? B - b0 : MAX_FRAMES;
    const dim3 grid((C + 31) / 32, (R + OS_BLOCK_ROWS - 1) / OS_BLOCK_ROWS, nb);
    k<<<grid, block, smem, s>>>(
        (const float*)img + b0 * plane, (bool*)det + b0 * plane,
        thr == nullptr ? nullptr : (float*)thr + b0 * plane, R, C, train_hs,
        guard_hs, rank, tau, use_gate, gate, extend);
  }
  return (int)cudaGetLastError();
}
