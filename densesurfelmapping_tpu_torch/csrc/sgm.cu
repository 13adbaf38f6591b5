// Semi-global matching (SGM) scanline aggregation kernels for Hopper
// (sm_90a): the three SGM kernels of the stereo fuse step.  Plain C entry
// points, loaded with ctypes by densesurfelmapping_tpu_torch/ops/cuda/sgm.py;
// every entry launches on the caller's stream and returns
// cudaGetLastError().
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        --fmad=false -shared -Xcompiler -fPIC
//
// Semantics are those of the plain twins (ops/sgm.py, models/stereo.py's
// _axis_scan with the kernel grouping), which equal the JAX package's Pallas
// kernels (densesurfelmapping_tpu/ops/pallas/sgm.py) bitwise:
//   * one DP step along a scanline, per disparity plane d:
//       cand = min(L[d], min(L[d-1], L[d+1]) + P1, Lmin + P2)
//       L'[d] = cost[d] + (cand - Lmin)
//     with open d boundaries (L[-1] = L[D] = +inf) and a zero carry at the
//     first pixel of every path (L = C);
//   * carry_bf16: every add is rounded to bf16 (round to nearest even) and
//     L' is clamped at 9984 (the bf16 value of the 1e4 out-of-range cost);
//   * diagonal paths restart at the image border row;
//   * the free-entry restart (L' = C) where a plane enters range: forward
//     x scans at x == d, the +x-moving diagonals at x == d;
//   * each orientation's output is the sum over the directions sharing the
//     scan axis, in roll order (0, +1, -1) and in carry dtype, rounded ONCE
//     to bf16; a family's result is f32(forward) + f32(backward), and the
//     census aggregate is x family + y family.
// The TPU kernels' 128-lane padding with BIG, lane rolls, sublane shears and
// the transposed d-reversed x layout are Mosaic devices and have no
// counterpart here.
//
// Design.  Every scanline is independent: a row (horizontal paths), a
// column (vertical), a slope +-1 line (diagonals).  One block of
// round_up(D, 32) threads runs one line of one direction, one thread per
// disparity plane; the carry lives in a register, L[d-1], L[d+1] and the
// block minimum Lmin come through double-buffered shared memory (one
// __syncthreads per step).  Rule 1 above needs the three y-family
// directions of one orientation at the same (y, x, d) before the single
// bf16 rounding, so the line kernel writes each direction's f32 L to a
// scratch slab and a combine pass sums the slabs in roll order, rounds and
// adds: bitwise for every cost type and both carry dtypes.
// Bound on the H100: memory.  The census aggregate at KITTI size (H 376,
// W 1241, D' 127) must write the f32 (127, 376, 1241) result, 237 MB, and
// read two 1.9 MB census images: 71 us at 3.35 TB/s.  This first version
// also writes and reads 6 scratch slabs of 237 MB (2.8 GB more traffic), and
// its step loop is latency-bound (one block barrier per pixel of a line,
// 376-1241 steps); keeping the y family's three directions in one block, or
// in registers of one warp per line, is the next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr float kBigBf16 = 9984.0f;  // bf16(1e4): out-of-range cost, clamp
constexpr int kMaxThreads = 1024;

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fminf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// One DP step of a line.  Every thread of the block calls it (padding
// threads d >= D publish +inf); returns L' for the thread's plane.  `sl`
// (blockDim floats) and `smin` (32 floats) are this step's halves of the
// double buffers: the next write to them is two steps later, after the next
// step's barrier, so one barrier per step suffices.
template <bool BF16>
__device__ __forceinline__ float dp_step(float carry, float cost, int D,
                                         float p1, float p2, float* sl,
                                         float* smin) {
  const int d = threadIdx.x;
  const bool real = d < D;
  const float lv = real ? carry : CUDART_INF_F;
  sl[d] = lv;
  const float wm = warp_min(lv);
  if ((d & 31) == 0) smin[d >> 5] = wm;
  __syncthreads();
  float lmin = smin[0];
  for (int w = 1; w < (blockDim.x >> 5); ++w) lmin = fminf(lmin, smin[w]);
  if (!real) return 0.0f;
  const float dm = d > 0 ? sl[d - 1] : CUDART_INF_F;
  const float dp = d < D - 1 ? sl[d + 1] : CUDART_INF_F;
  if (BF16) {
    const float cand = fminf(fminf(carry, round_bf16(fminf(dm, dp) + p1)),
                             round_bf16(lmin + p2));
    return fminf(round_bf16(cost + round_bf16(cand - lmin)), kBigBf16);
  }
  const float cand = fminf(fminf(carry, fminf(dm, dp) + p1), lmin + p2);
  return cost + (cand - lmin);
}

// Cost of plane d at scan step t, row r of a materialized (L, R, D) bf16
// volume.
struct VolumeCost {
  const __nv_bfloat16* v;
  int R, D;
  __device__ float operator()(int t, int r, int d) const {
    return __bfloat162float(v[(static_cast<size_t>(t) * R + r) * D + d]);
  }
};

// Census Hamming cost of plane d (disparity d + min_d) at image (y, x):
// popcount(cl[y, x] ^ cr[y, x - d - min_d]), 9984 where x - d - min_d < 0.
struct CensusCost {
  const int* cl;
  const int* cr;
  int W, min_d;
  __device__ float operator()(int y, int x, int d) const {
    const int xs = x - d - min_d;
    if (xs < 0) return kBigBf16;
    const size_t row = static_cast<size_t>(y) * W;
    return static_cast<float>(__popc(cl[row + x] ^ cr[row + xs]));
  }
};

// ---------------------------------------------------------------------------
// Line kernel shared by B4 (volume cost) and B5 (census cost): one block per
// (line, slab); slab = orientation * g + direction, direction k shifting its
// row by rolls[k] per step.  Steps t run along axis 0 (L), rows r along
// axis 1 (R); the line of a block is (t, r) -> (t + dt, r + roll) from a
// start on the first step (any r) or on the border row the roll restarts
// (r = 0 for roll +1, R - 1 for roll -1).  Writes L' of every (t, r, d) to
// scratch[slab][(t * R + r) * D + d].
// entry: 0 none; 1 forward orientation at d + min_d == t (scan axis =
// image x); 2 roll == +1 directions at d + min_d == r (rows = image x).
// ---------------------------------------------------------------------------
template <class Cost, bool BF16>
__global__ void scan_lines_kernel(Cost cost, float* __restrict__ scratch,
                                  int L, int R, int D, int g, int roll0,
                                  int roll1, int roll2, float p1, float p2,
                                  int entry, int min_d) {
  extern __shared__ float smem[];  // 2 * blockDim (L) + 2 * 32 (min)
  float* sl[2] = {smem, smem + blockDim.x};
  float* smin[2] = {smem + 2 * blockDim.x, smem + 2 * blockDim.x + 32};

  const int slab = blockIdx.y;
  const int o = slab / g, k = slab % g;
  const int roll = k == 0 ? roll0 : (k == 1 ? roll1 : roll2);
  const int dt = o == 0 ? 1 : -1;
  const int t0 = o == 0 ? 0 : L - 1;
  const int n_lines = R + (roll != 0 ? L - 1 : 0);
  const int line = blockIdx.x;
  if (line >= n_lines) return;  // uniform across the block
  int t = t0, r = line;
  if (line >= R) {
    t = t0 + dt * (line - R + 1);
    r = roll > 0 ? 0 : R - 1;
  }
  const int d = threadIdx.x;
  const size_t slab_size = static_cast<size_t>(L) * R * D;
  float* out = scratch + slab * slab_size;
  const float p1v = BF16 ? round_bf16(p1) : p1;
  const float p2v = BF16 ? round_bf16(p2) : p2;

  float carry = 0.0f;
  int buf = 0;
  for (; t >= 0 && t < L && r >= 0 && r < R; t += dt, r += roll) {
    const float c = d < D ? cost(t, r, d) : 0.0f;
    float nxt = dp_step<BF16>(carry, c, D, p1v, p2v, sl[buf], smin[buf]);
    if (d < D) {
      const bool restart = (entry == 1 && o == 0 && d + min_d == t) ||
                           (entry == 2 && roll == 1 && d + min_d == r);
      if (restart) nxt = c;
      out[(static_cast<size_t>(t) * R + r) * D + d] = nxt;
      carry = nxt;
    }
    buf ^= 1;
  }
}

// Orientation total of element i over the g slabs starting at `s`, in roll
// order and carry dtype.
template <bool BF16>
__device__ __forceinline__ float orientation_total(const float* s,
                                                   size_t slab_size, int g,
                                                   size_t i) {
  float tot = s[i];
  for (int k = 1; k < g; ++k) {
    tot = tot + s[k * slab_size + i];
    if (BF16) tot = round_bf16(tot);
  }
  return round_bf16(tot);
}

// B4 combine: out[i] = f32(bf16(forward total)) + f32(bf16(backward total)).
template <bool BF16>
__global__ void combine_axis_kernel(const float* __restrict__ scratch,
                                    float* __restrict__ out, size_t n, int g) {
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
       i < n; i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    out[i] = orientation_total<BF16>(scratch, n, g, i) +
             orientation_total<BF16>(scratch + g * n, n, g, i);
  }
}

// B5 combine: out[d, y, x] += y-family sum of (y, x, d).  One block per
// (32 pixels of a row, row y): the slabs' (pixel, d) tile is read
// contiguously, transposed through shared memory, and added to the (D, H,
// W) output with consecutive threads on consecutive x.
template <bool BF16>
__global__ void combine_census_y_kernel(const float* __restrict__ scratch,
                                        float* __restrict__ out, int H, int W,
                                        int D, int g) {
  __shared__ float tile[32][129];
  const int y = blockIdx.y, x0 = blockIdx.x * 32;
  const int nx = min(32, W - x0);
  const size_t n = static_cast<size_t>(H) * W * D;
  const size_t base = (static_cast<size_t>(y) * W + x0) * D;
  for (int e = threadIdx.x; e < nx * D; e += blockDim.x) {
    const size_t i = base + e;
    tile[e / D][e % D] = orientation_total<BF16>(scratch, n, g, i) +
                         orientation_total<BF16>(scratch + g * n, n, g, i);
  }
  __syncthreads();
  for (int e = threadIdx.x; e < D * 32; e += blockDim.x) {
    const int d = e >> 5, xl = e & 31;
    if (xl < nx) {
      const size_t o = (static_cast<size_t>(d) * H + y) * W + x0 + xl;
      out[o] = out[o] + tile[xl][d];
    }
  }
}

// ---------------------------------------------------------------------------
// B6: horizontal forward and backward scans of one image row per block,
// census cost in the kernel, free entry on the forward orientation only.
// The forward pass writes f32(bf16(L)) to out[d, y, x]; the backward pass
// adds f32(bf16(L)) to the value the same thread wrote, so the x family
// needs no scratch and no second kernel.  Writes of one step are strided
// (one plane per thread); consecutive steps of a thread fill the same
// sectors, which L2 merges before they reach DRAM.
// ---------------------------------------------------------------------------
template <bool BF16>
__global__ void census_x_kernel(const int* __restrict__ cl,
                                const int* __restrict__ cr,
                                float* __restrict__ out, int H, int W, int D,
                                float p1, float p2, int min_d) {
  extern __shared__ float smem[];
  float* sl[2] = {smem, smem + blockDim.x};
  float* smin[2] = {smem + 2 * blockDim.x, smem + 2 * blockDim.x + 32};
  const int y = blockIdx.x;
  const int d = threadIdx.x;
  const CensusCost cost{cl, cr, W, min_d};
  const float p1v = BF16 ? round_bf16(p1) : p1;
  const float p2v = BF16 ? round_bf16(p2) : p2;
  int buf = 0;
  for (int pass = 0; pass < 2; ++pass) {
    float carry = 0.0f;
    for (int s = 0; s < W; ++s) {
      const int x = pass == 0 ? s : W - 1 - s;
      const float c = d < D ? cost(y, x, d) : 0.0f;
      float nxt = dp_step<BF16>(carry, c, D, p1v, p2v, sl[buf], smin[buf]);
      if (d < D) {
        if (pass == 0 && d + min_d == x) nxt = c;
        carry = nxt;
        const size_t o = (static_cast<size_t>(d) * H + y) * W + x;
        const float v = round_bf16(nxt);
        out[o] = pass == 0 ? v : out[o] + v;
      }
      buf ^= 1;
    }
  }
}

int line_threads(int D) { return ((D + 31) / 32) * 32; }

size_t line_smem(int threads) { return (2 * threads + 64) * sizeof(float); }

template <class Cost>
void launch_lines(Cost cost, float* scratch, int L, int R, int D, int g,
                  int roll0, int roll1, int roll2, float p1, float p2,
                  int carry_bf16, int entry, int min_d, cudaStream_t s) {
  const int threads = line_threads(D);
  const dim3 grid(R + L - 1, 2 * g);
  if (carry_bf16) {
    scan_lines_kernel<Cost, true><<<grid, threads, line_smem(threads), s>>>(
        cost, scratch, L, R, D, g, roll0, roll1, roll2, p1, p2, entry, min_d);
  } else {
    scan_lines_kernel<Cost, false><<<grid, threads, line_smem(threads), s>>>(
        cost, scratch, L, R, D, g, roll0, roll1, roll2, p1, p2, entry, min_d);
  }
}

}  // namespace

extern "C" {

// B4: axis scan of a materialized (L, R, D) bf16 volume -> f32 (L, R, D).
// scratch: 2 * g * L * R * D floats.
int sgm_axis_scan(const void* v, float* scratch, float* out, int L, int R,
                  int D, int g, int roll0, int roll1, int roll2, float p1,
                  float p2, int carry_bf16, int entry, int min_d,
                  void* stream) {
  if (D < 1 || D > kMaxThreads || g < 1 || g > 3) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const VolumeCost cost{static_cast<const __nv_bfloat16*>(v), R, D};
  launch_lines(cost, scratch, L, R, D, g, roll0, roll1, roll2, p1, p2,
               carry_bf16, entry, min_d, s);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t n = static_cast<size_t>(L) * R * D;
  const int blocks = static_cast<int>((n + 255) / 256 < 132 * 16
                                          ? (n + 255) / 256
                                          : 132 * 16);
  if (carry_bf16) {
    combine_axis_kernel<true><<<blocks, 256, 0, s>>>(scratch, out, n, g);
  } else {
    combine_axis_kernel<false><<<blocks, 256, 0, s>>>(scratch, out, n, g);
  }
  return static_cast<int>(cudaGetLastError());
}

// B6: the x family of the census aggregate, written to out (D, H, W).
int sgm_census_x(const int* cl, const int* cr, float* out, int H, int W,
                 int D, float p1, float p2, int min_d, int carry_bf16,
                 void* stream) {
  if (D < 1 || D > 128) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = line_threads(D);
  if (carry_bf16) {
    census_x_kernel<true><<<H, threads, line_smem(threads), s>>>(
        cl, cr, out, H, W, D, p1, p2, min_d);
  } else {
    census_x_kernel<false><<<H, threads, line_smem(threads), s>>>(
        cl, cr, out, H, W, D, p1, p2, min_d);
  }
  return static_cast<int>(cudaGetLastError());
}

// B5: the y family (vertical + diagonals) of the census aggregate, added to
// out (D, H, W), which holds the x family.  scratch: 2 * g * H * W * D
// floats.
int sgm_census_y(const int* cl, const int* cr, float* scratch, float* out,
                 int H, int W, int D, int g, int roll0, int roll1, int roll2,
                 float p1, float p2, int min_d, int carry_bf16,
                 void* stream) {
  if (D < 1 || D > 128 || g < 1 || g > 3) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const CensusCost cost{cl, cr, W, min_d};
  // scan axis = image y (L = H), rows = image x (R = W)
  launch_lines(cost, scratch, H, W, D, g, roll0, roll1, roll2, p1, p2,
               carry_bf16, /*entry=*/2, min_d, s);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((W + 31) / 32, H);
  if (carry_bf16) {
    combine_census_y_kernel<true><<<grid, 256, 0, s>>>(scratch, out, H, W, D,
                                                       g);
  } else {
    combine_census_y_kernel<false><<<grid, 256, 0, s>>>(scratch, out, H, W,
                                                        D, g);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
