// SLIC superpixel kernels for Hopper (sm_90a): the three kernels of one SLIC
// iteration of the fuse step.  Plain C entry points, loaded with ctypes by
// densesurfelmapping_tpu_torch/ops/cuda/slic.py; every entry launches on the
// caller's stream and returns cudaGetLastError().
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        --fmad=false -shared -Xcompiler -fPIC
// --fmad=false matters: the plain PyTorch twin (ops/superpixel.py) rounds
// after every elementwise op, and a contracted multiply-add in the
// assignment cost would move the last bit and flip tie-breaks.
//
// Semantics are those of the plain twin, which follows the JAX package's XLA
// path (densesurfelmapping_tpu/ops/superpixel.py); the TPU kernels they
// replace are densesurfelmapping_tpu/ops/pallas/slic.py.  The TPU kernels'
// 0/1 expansion matmuls, column-block grid and lane padding have no
// counterpart here: on this card a thread reads its seed planes directly.

#include <cuda_runtime.h>

namespace {

constexpr float kBigCost = 1e10f;
// x / 100 as the plain twin (and XLA) compute it: a multiply by the
// correctly rounded f32 reciprocal
constexpr float kInv100 = 1.0f / 100.0f;

// Sum N per-thread values over the block; the totals land in thread 0.
// blockDim.x is a multiple of 32 (at most 1024).  The reduction order is
// fixed, so the result is deterministic.
template <int N>
__device__ void block_sum(float (&v)[N], float* smem /* N * 32 floats */) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    float s = v[k];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(0xffffffffu, s, o);
    if (lane == 0) smem[k * 32 + warp] = s;
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int k = 0; k < N; ++k) {
      float s = lane < nwarps ? smem[k * 32 + lane] : 0.0f;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(0xffffffffu, s, o);
      v[k] = s;
    }
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// B1 slic_assign: one pixel-assignment sweep.
// Replaces ops/pallas/slic.py::_assign_call (assign_pixels_pallas).
// One thread per pixel of the padded (h, w) frame.  Each pixel scans its 3x3
// neighbour seeds in the reference order (x offset outer, y offset inner)
// with a strict-< running minimum, keeping a with-depth and a no-depth best,
// and writes its new seed id.  A seed chosen by an updated pixel inside its
// 2sp x 2sp window is flagged in `claimed` (atomicOr of 1: order-free, so
// the result is deterministic).
// Bound on the H100: memory.  A KITTI frame (376 x 1280, 1.9 MB per f32
// plane) reads the image, inverse depth and assignment planes and writes
// one: 7.7 MB per launch, 2.3 us at 3.35 TB/s.  The five seed planes
// (30 KB each) are re-read by the 64 pixels of a tile through L1/L2 (45
// loads per pixel).  Coalesced row-major threads and no intermediate planes
// in device memory are the design's answer; staging the seed planes of a
// block in shared memory is the next step.
// ---------------------------------------------------------------------------
__global__ void slic_assign_kernel(
    const float* __restrict__ image, const float* __restrict__ inv_depth,
    const int* __restrict__ assignment, const float* __restrict__ seed_x,
    const float* __restrict__ seed_y, const float* __restrict__ seed_i,
    const float* __restrict__ seed_d, const unsigned char* __restrict__ stable,
    int* __restrict__ new_assignment, int* __restrict__ claimed, int h, int w,
    int cols, int oh, int ow, int sp) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= w || y >= h) return;
  // the plain twin finds claims by scanning zero-padded windows; the pad
  // value 0 reads as seed 0's id, so seed 0 is claimed in every sweep
  if (x == 0 && y == 0) atomicOr(&claimed[0], 1);

  const int idx = y * w + x;
  const int half = sp / 2;
  const int ty = y / sp, tx = x / sp, ry = y % sp, rx = x % sp;
  const int vr = oh / sp, vc = ow / sp;  // seeds of the reference grid
  const bool pixel_valid = y < oh && x < ow;
  const float xf = static_cast<float>(x);
  const float yf = static_cast<float>(y);
  const float half_sq = static_cast<float>(half * half);
  const float img = image[idx];
  const float invd = inv_depth[idx];

  float best_d = kBigCost, best_nd = kBigCost;
  int best_d_idx = -1, best_nd_idx = -1;
  bool all_hasd = invd > 0.0f;
  for (int di = -1; di <= 1; ++di) {
    for (int dj = -1; dj <= 1; ++dj) {
      const int nty = ty + dj, ntx = tx + di;
      // update_pixels candidate gate |off*sp + sp/2 - r| < sp
      // (fusion_functions.cpp:416-420) on an existing seed
      const bool gate = pixel_valid && nty >= 0 && nty < vr && ntx >= 0 &&
                        ntx < vc && abs(dj * sp + half - ry) < sp &&
                        abs(di * sp + half - rx) < sp;
      if (!gate) continue;  // cost kBigCost: never taken
      const int nbf = nty * cols + ntx;
      const float sd = seed_d[nbf];
      const float ex = seed_x[nbf] - xf;
      const float ey = seed_y[nbf] - yf;
      const float dist = ex * ex + ey * ey;
      const float idiff = seed_i[nbf] - img;
      const float nodepth = dist / half_sq + idiff * idiff * kInv100;
      const float sdinv = sd > 0.0f ? 1.0f / fmaxf(sd, 1e-20f) : 0.0f;
      const float ddiff = sdinv - invd;
      const float withd = nodepth + ddiff * ddiff * 400.0f;
      const bool hasd = sd > 0.0f && invd > 0.0f;
      const float cost_d = hasd ? withd : nodepth;
      if (cost_d < best_d) {
        best_d = cost_d;
        best_d_idx = nbf;
      }
      if (nodepth < best_nd) {
        best_nd = nodepth;
        best_nd_idx = nbf;
      }
      all_hasd = all_hasd && hasd;
    }
  }
  int chosen = all_hasd ? best_d_idx : best_nd_idx;
  const float best_cost = all_hasd ? best_d : best_nd;
  if (best_cost >= kBigCost) chosen = -1;

  // pixels of a stable seed keep it
  const int asg = assignment[idx];
  const bool cur_stable = asg >= 0 && stable[asg] != 0;
  const bool updated = pixel_valid && !cur_stable;
  const int na = updated ? chosen : asg;
  new_assignment[idx] = na;

  if (updated && na >= 0) {
    // 2sp x 2sp window [off*sp - sp/2, off*sp + 3sp/2) of the chosen seed
    // (ops/pallas/slic.py::_window_gate)
    const int dj = na / cols - ty, di = na % cols - tx;
    const bool in_win = ry >= dj * sp - half && ry < dj * sp + sp + half &&
                        rx >= di * sp - half && rx < di * sp + sp + half;
    if (in_win) atomicOr(&claimed[na], 1);
  }
}

// Window pixel of thread t of seed block b, and whether the reference's
// clamped seed-update scan visits it (0 <= y < oh-1, 0 <= x < ow-1,
// fusion_functions.cpp:486-489).
__device__ __forceinline__ bool window_pixel(int b, int cols, int sp, int oh,
                                             int ow, int w, int* idx) {
  const int t = threadIdx.x;
  const int side = 2 * sp;
  if (t >= side * side) return false;
  const int y = (b / cols) * sp - sp / 2 + t / side;
  const int x = (b % cols) * sp - sp / 2 + t % side;
  if (y < 0 || y >= oh - 1 || x < 0 || x >= ow - 1) return false;
  *idx = y * w + x;
  return true;
}

// ---------------------------------------------------------------------------
// B2 slic_centroid: per-seed membership sums.
// Replaces ops/pallas/slic.py::_centroid_call (update_seeds_pallas).
// One block per seed, one thread per pixel of its 2sp x 2sp window; the six
// sums (n, sum x, sum y, sum intensity, n with depth > 0.1, sum of those
// depths) are block reductions, so no atomics and a deterministic result.
// Bound on the H100: memory.  Windows overlap 4x, so a KITTI launch
// requests 23 MB of assignment/image/depth through L2 for 5.8 MB of unique
// pixel planes and 180 KB of output.
// ---------------------------------------------------------------------------
__global__ void slic_centroid_kernel(const float* __restrict__ image,
                                     const float* __restrict__ depth,
                                     const int* __restrict__ assignment,
                                     float* __restrict__ out, int w, int cols,
                                     int n_seeds, int oh, int ow, int sp) {
  __shared__ float smem[6 * 32];
  const int b = blockIdx.x;
  float v[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  int idx;
  if (window_pixel(b, cols, sp, oh, ow, w, &idx) && assignment[idx] == b) {
    const float d = depth[idx];
    v[0] = 1.0f;
    v[1] = static_cast<float>(idx % w);
    v[2] = static_cast<float>(idx / w);
    v[3] = image[idx];
    if (d > 0.1f) {
      v[4] = 1.0f;
      v[5] = d;
    }
  }
  block_sum<6>(v, smem);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < 6; ++k) out[k * n_seeds + b] = v[k];
  }
}

// ---------------------------------------------------------------------------
// B3 slic_huber: the five Huber-Newton steps of each seed's mean depth.
// Replaces ops/pallas/slic.py::_huber_call, which the TPU runs once per
// step (5 launches per iteration).  A step of one seed reads only that
// seed's pixels and its own mean, so one block per seed runs all five steps
// and the |delta| < 0.01 latch with the mean in shared memory: one launch
// per iteration.  Each step is a block reduction of sum psi(mean - d) and
// the inlier count over the member pixels with depth > 0.1.
// Bound on the H100: memory: 3.9 MB of unique assignment and depth planes
// (15 MB requested through the 4x-overlapping windows) read once per
// launch; the pixels stay in registers across the five steps.
// ---------------------------------------------------------------------------
__global__ void slic_huber_kernel(const float* __restrict__ depth,
                                  const int* __restrict__ assignment,
                                  const float* __restrict__ mean_in,
                                  const unsigned char* __restrict__ conv_in,
                                  float* __restrict__ mean_out, int w,
                                  int cols, int oh, int ow, int sp, float hr) {
  __shared__ float smem[2 * 32];
  __shared__ float s_mean;
  __shared__ int s_conv;
  const int b = blockIdx.x;
  int idx;
  bool mem = window_pixel(b, cols, sp, oh, ow, w, &idx) &&
             assignment[idx] == b;
  const float d = mem ? depth[idx] : 0.0f;
  mem = mem && d > 0.1f;
  if (threadIdx.x == 0) {
    s_mean = mean_in[b];
    s_conv = conv_in[b] != 0;
  }
  __syncthreads();
  for (int it = 0; it < 5; ++it) {
    const float r = s_mean - d;
    const bool inl = r < hr && r > -hr;
    const float psi = inl ? 2.0f * r : (r > 0.0f ? hr : -hr);
    float v[2] = {mem ? psi : 0.0f, (mem && inl) ? 1.0f : 0.0f};
    block_sum<2>(v, smem);
    if (threadIdx.x == 0) {
      const float delta = -v[0] / (2.0f * v[1] + 10.0f);
      if (!s_conv) s_mean = s_mean + delta;
      s_conv = s_conv || fabsf(delta) < 0.01f;
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) mean_out[b] = s_mean;
}

int seed_block(int sp) { return ((4 * sp * sp + 31) / 32) * 32; }

}  // namespace

extern "C" {

int slic_assign(const float* image, const float* inv_depth,
                const int* assignment, const float* seed_x,
                const float* seed_y, const float* seed_i, const float* seed_d,
                const unsigned char* stable, int* new_assignment, int* claimed,
                int h, int w, int cols, int oh, int ow, int sp,
                void* stream) {
  const dim3 block(32, 8);
  const dim3 grid((w + block.x - 1) / block.x, (h + block.y - 1) / block.y);
  slic_assign_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      image, inv_depth, assignment, seed_x, seed_y, seed_i, seed_d, stable,
      new_assignment, claimed, h, w, cols, oh, ow, sp);
  return static_cast<int>(cudaGetLastError());
}

int slic_centroid(const float* image, const float* depth,
                  const int* assignment, float* out, int w, int rows, int cols,
                  int oh, int ow, int sp, void* stream) {
  const int n_seeds = rows * cols;
  slic_centroid_kernel<<<n_seeds, seed_block(sp), 0,
                         static_cast<cudaStream_t>(stream)>>>(
      image, depth, assignment, out, w, cols, n_seeds, oh, ow, sp);
  return static_cast<int>(cudaGetLastError());
}

int slic_huber(const float* depth, const int* assignment, const float* mean_in,
               const unsigned char* conv_in, float* mean_out, int w, int rows,
               int cols, int oh, int ow, int sp, float hr, void* stream) {
  slic_huber_kernel<<<rows * cols, seed_block(sp), 0,
                      static_cast<cudaStream_t>(stream)>>>(
      depth, assignment, mean_in, conv_in, mean_out, w, cols, oh, ow, sp, hr);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
