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
// counterpart here: on this card a thread reads its seed planes directly,
// and B2/B3 stage the pixels of a strip of seeds in shared memory.  Their
// launch geometry comes from ops/cuda/slic.py (`centroid_plan`,
// `huber_plan`), checked on the CPU.

#include <cuda_runtime.h>

namespace {

constexpr float kBigCost = 1e10f;
// x / 100 as the plain twin (and XLA) compute it: a multiply by the
// correctly rounded f32 reciprocal
constexpr float kInv100 = 1.0f / 100.0f;

// ---------------------------------------------------------------------------
// B1 slic_assign: one pixel-assignment sweep.
// Replaces ops/pallas/slic.py::_assign_call (assign_pixels_pallas).
// One thread per pixel of the padded (h, w) frame.  Each pixel scans its 3x3
// neighbour seeds in the reference order (x offset outer, y offset inner)
// with a strict-< running minimum, keeping a with-depth and a no-depth best,
// and writes its new seed id.  A seed chosen by an updated pixel inside its
// 2sp x 2sp window is flagged in `claimed` (atomicOr of 1: order-free, so
// the result is deterministic).  The spatial term divides by (sp/2)^2 as the
// twin does on the card: a multiply by the f32 reciprocal `inv_half_sq`
// (PyTorch-CUDA computes x / scalar so), so kernel and twin agree at every
// sp, not only where (sp/2)^2 is a power of two.
// Bound on the H100: memory.  A KITTI frame (376 x 1280, 1.9 MB per f32
// plane) reads the image, inverse depth and assignment planes and writes
// one: 7.7 MB per launch, 2.3 us at 3.35 TB/s.  The four seed planes
// (30 KB each) are re-read by the 64 pixels of a tile through L1/L2.
// Coalesced row-major threads and no intermediate planes in device memory
// are the design's answer; B1 is not redesigned yet (it ranked third by
// lost device time, PERF.md).
// ---------------------------------------------------------------------------
__global__ void slic_assign_kernel(
    const float* __restrict__ image, const float* __restrict__ inv_depth,
    const int* __restrict__ assignment, const float* __restrict__ seed_x,
    const float* __restrict__ seed_y, const float* __restrict__ seed_i,
    const float* __restrict__ seed_d, const unsigned char* __restrict__ stable,
    int* __restrict__ new_assignment, int* __restrict__ claimed, int h, int w,
    int cols, int oh, int ow, int sp, float inv_half_sq) {
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
      const float nodepth = dist * inv_half_sq + idiff * idiff * kInv100;
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

// ---------------------------------------------------------------------------
// B2 and B3 share one launch shape: a warp per seed, kStripSeeds warps per
// block on neighbouring seeds of one seed row.  The block stages the union
// of their 2sp x 2sp windows (2sp rows, (kStripSeeds + 1) sp columns) of the
// planes it needs in shared memory once, by 16-byte cp.async: warp w copies
// rows w, w + kStripSeeds, ..., lane l the row's 16-byte chunks l, l + 32,
// from the 4-aligned column at or left of the union's first (the padded
// width is a multiple of 4, so a chunk lies wholly inside or outside the
// frame), with no division per element.  The windows overlap 4x, so each
// pixel comes from L2 about 2.25 times instead of 4.  One barrier ends the
// staging and none follows: lane l of a warp then takes the window pixels
// l + 32 j (row-major in the window, j < per_lane), sums in a fixed order,
// and a __shfl_xor_sync butterfly leaves every total, bitwise the same, in
// every lane.  KITTI's 7,520 warps are one wave when a thread holds at most
// 32 registers (8 blocks per SM): B2 does (31), B3 does not (38: 6 blocks,
// 1.2 waves).  Measured on the H100 (PERF.md), both sit at 6-12x their
// byte bounds with the clock at its maximum and the same time back to back
// from a CUDA graph; staging by 4-byte copies with a division per element
// cost them 2-4 us, and what holds the rest is not measured yet.
// ---------------------------------------------------------------------------
constexpr int kStripSeeds = 8;  // ops/cuda/slic.py STRIP_SEEDS
constexpr unsigned kFull = 0xffffffffu;

// The cp.async helper clobbers "memory": the compiler keeps every ordinary
// load and store on its side of the copy, as written.  A chunk outside the
// frame is zero-filled (src-size 0).
__device__ __forceinline__ void cp_async16_zfill(void* smem, const void* gmem,
                                                 bool in) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst),
               "l"(gmem), "r"(in ? 16 : 0)
               : "memory");
}

// The strip of block (blockIdx.x, seed row blockIdx.y): its windows' union
// starts at row y0, column x0; the staged tile holds 2sp rows of `chunks`
// 16-byte chunks from column xa = x0 rounded down to a multiple of 4, so
// column x0 sits at tile column off = x0 - xa.
struct Strip {
  int sp, side, chunks, stride, y0, x0, xa, off, tile_n;

  __device__ Strip(int sp_, int chunks_)
      : sp(sp_),
        side(2 * sp_),
        chunks(chunks_),
        stride(4 * chunks_),
        y0(static_cast<int>(blockIdx.y) * sp_ - sp_ / 2),
        x0(static_cast<int>(blockIdx.x) * kStripSeeds * sp_ - sp_ / 2),
        xa(x0 & ~3),
        off(x0 - xa),
        tile_n(2 * sp_ * 4 * chunks_) {}

  // stage one 4-byte plane of the union into s (then stage_done)
  __device__ void stage(const void* plane, void* s, int h, int w) const {
    const char* g = static_cast<const char*>(plane);
    char* d = static_cast<char*>(s);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    for (int r = warp; r < side; r += kStripSeeds) {
      const int y = y0 + r;
      for (int c = lane; c < chunks; c += 32) {
        const int x = xa + 4 * c;
        const bool in = y >= 0 && y < h && x >= 0 && x < w;
        cp_async16_zfill(
            d + 16 * (r * chunks + c),
            g + (in ? 4 * (static_cast<size_t>(y) * w + x) : 0), in);
      }
    }
  }

  __device__ static void stage_done() {
    asm volatile("cp.async.commit_group;" ::: "memory");
    asm volatile("cp.async.wait_group 0;" ::: "memory");
    __syncthreads();
  }
};

// A lane's walk over its warp's seed window: pixel k = lane + 32 j sits at
// window (wy, wx), advanced without a division per step.
struct WindowWalk {
  int wy, wx, dy, dx, side, col0;

  __device__ WindowWalk(const Strip& s, int warp, int lane)
      : wy(lane / s.side),
        wx(lane % s.side),
        dy(32 / s.side),
        dx(32 % s.side),
        side(s.side),
        col0(warp * s.sp) {}

  __device__ bool inside() const { return wy < side; }
  __device__ int x(const Strip& s) const { return s.x0 + col0 + wx; }
  __device__ int y(const Strip& s) const { return s.y0 + wy; }
  // the pixel's index in the staged tiles
  __device__ int at(const Strip& s) const {
    return wy * s.stride + s.off + col0 + wx;
  }
  // the reference's clamped seed-update scan visits the pixel:
  // 0 <= y < oh-1, 0 <= x < ow-1 (fusion_functions.cpp:486-489)
  __device__ bool scanned(const Strip& s, int oh, int ow) const {
    return inside() && y(s) >= 0 && y(s) < oh - 1 && x(s) >= 0 &&
           x(s) < ow - 1;
  }
  __device__ void next() {
    wx += dx;
    wy += dy;
    if (wx >= side) {
      wx -= side;
      ++wy;
    }
  }
};

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// ---------------------------------------------------------------------------
// B2 slic_centroid: per-seed membership sums.
// Replaces ops/pallas/slic.py::_centroid_call (update_seeds_pallas).
// The strip shape above, staging image, depth and assignment: each lane
// sums, over its window pixels that belong to the seed and that the
// reference's scan visits, the count, x, y and intensity, and the count and
// sum of the depths > 0.1, in window order; then six butterflies (the
// counts as ints).  No atomics, a fixed order: deterministic.
// Bound on the H100: memory: 5.8 MB of unique image, depth and assignment
// planes and 180 KB of output per KITTI launch.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kStripSeeds * 32) slic_centroid_kernel(
    const float* __restrict__ image, const float* __restrict__ depth,
    const int* __restrict__ assignment, float* __restrict__ out, int h, int w,
    int cols, int n_seeds, int oh, int ow, int sp, int chunks, int per_lane) {
  extern __shared__ float4 s_tiles[];  // image, depth, assignment tiles
  const Strip s(sp, chunks);
  float* s_img = reinterpret_cast<float*>(s_tiles);
  float* s_dep = s_img + s.tile_n;
  int* s_asg = reinterpret_cast<int*>(s_dep + s.tile_n);
  s.stage(image, s_img, h, w);
  s.stage(depth, s_dep, h, w);
  s.stage(assignment, s_asg, h, w);
  Strip::stage_done();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c = static_cast<int>(blockIdx.x) * kStripSeeds + warp;
  if (c >= cols) return;  // the whole warp: no barrier follows
  const int b = static_cast<int>(blockIdx.y) * cols + c;
  int n = 0, nd = 0;
  float sx = 0.0f, sy = 0.0f, si = 0.0f, sd = 0.0f;
  WindowWalk p(s, warp, lane);
#pragma unroll 8
  for (int j = 0; j < per_lane; ++j, p.next()) {
    if (!p.scanned(s, oh, ow)) continue;
    const int t = p.at(s);
    if (s_asg[t] == b) {
      ++n;
      sx += static_cast<float>(p.x(s));
      sy += static_cast<float>(p.y(s));
      si += s_img[t];
      const float d = s_dep[t];
      if (d > 0.1f) {
        ++nd;
        sd += d;
      }
    }
  }
  n = warp_sum(n);
  sx = warp_sum(sx);
  sy = warp_sum(sy);
  si = warp_sum(si);
  nd = warp_sum(nd);
  sd = warp_sum(sd);
  if (lane == 0) {
    out[b] = static_cast<float>(n);
    out[n_seeds + b] = sx;
    out[2 * n_seeds + b] = sy;
    out[3 * n_seeds + b] = si;
    out[4 * n_seeds + b] = static_cast<float>(nd);
    out[5 * n_seeds + b] = sd;
  }
}

// ---------------------------------------------------------------------------
// B3 slic_huber: the five Huber-Newton steps of each seed's mean depth.
// Replaces ops/pallas/slic.py::_huber_call, which the TPU runs once per
// step (5 launches per iteration).  A step of one seed reads only that
// seed's pixels and its own mean, so all five steps and the |delta| < 0.01
// latch run in one launch, in the strip shape above, staging depth and
// assignment.  About a quarter of a window's pixels belong to its seed, so
// the warp first lists its members with depth > 0.1 (ballot + popc, in
// window order) in shared memory, and each step walks only the list: lane
// l takes entries l, l + 32, ... (2 at KITTI, not per_lane = 8), read from
// shared memory in every step (4% faster than keeping them in registers,
// PERF.md).  A step sums psi(mean - d) and the inlier count in that order,
// a butterfly leaves both totals in every lane, and every lane takes the
// Newton step and the latch itself: no block barrier, no serial thread-0
// step.
// Bound on the H100: memory: 3.9 MB of unique assignment and depth planes
// per KITTI launch.  At this size the instructions issued (the windows'
// walk, the five steps) are what the design cuts.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kStripSeeds * 32) slic_huber_kernel(
    const float* __restrict__ depth, const int* __restrict__ assignment,
    const float* __restrict__ mean_in,
    const unsigned char* __restrict__ conv_in, float* __restrict__ mean_out,
    int h, int w, int cols, int oh, int ow, int sp, int chunks, int per_lane,
    float hr) {
  // depth, assignment tiles; then the member lists
  extern __shared__ float4 s_tiles[];
  const Strip s(sp, chunks);
  float* s_dep = reinterpret_cast<float*>(s_tiles);
  int* s_asg = reinterpret_cast<int*>(s_dep + s.tile_n);
  s.stage(depth, s_dep, h, w);
  s.stage(assignment, s_asg, h, w);
  Strip::stage_done();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c = static_cast<int>(blockIdx.x) * kStripSeeds + warp;
  if (c >= cols) return;  // the whole warp: no barrier follows
  const int b = static_cast<int>(blockIdx.y) * cols + c;
  float* list = s_dep + 2 * s.tile_n + warp * 32 * per_lane;
  const unsigned below = (1u << lane) - 1u;  // the lanes before this one
  int n = 0;                                 // members listed so far
  WindowWalk p(s, warp, lane);
  // every lane runs per_lane steps, so each ballot sees the whole warp
#pragma unroll 8
  for (int j = 0; j < per_lane; ++j, p.next()) {
    float d = 0.0f;
    bool mem = false;
    if (p.scanned(s, oh, ow)) {
      const int t = p.at(s);
      d = s_dep[t];
      mem = s_asg[t] == b && d > 0.1f;
    }
    const unsigned vote = __ballot_sync(kFull, mem);
    if (mem) list[n + __popc(vote & below)] = d;
    n += __popc(vote);
  }
  __syncwarp();

  float mean = mean_in[b];
  bool conv = conv_in[b] != 0;
  for (int it = 0; it < 5; ++it) {
    float sa = 0.0f;
    int cnt = 0;
    for (int i = lane; i < n; i += 32) {
      const float r = mean - list[i];
      const bool inl = r < hr && r > -hr;
      sa += inl ? 2.0f * r : (r > 0.0f ? hr : -hr);
      cnt += inl;
    }
    sa = warp_sum(sa);
    cnt = warp_sum(cnt);
    const float delta = -sa / (2.0f * static_cast<float>(cnt) + 10.0f);
    if (!conv) mean = mean + delta;
    conv = conv || fabsf(delta) < 0.01f;
  }
  if (lane == 0) mean_out[b] = mean;
}

// Opt a strip kernel into `smem` bytes of dynamic shared memory (needed
// above 48 KB) and launch it, one block per kStripSeeds seeds of a row.
template <typename... Params, typename... Args>
int launch_strip(void (*kernel)(Params...), int rows, int cols, int smem,
                 void* stream, Args... args) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((cols + kStripSeeds - 1) / kStripSeeds, rows);
  kernel<<<grid, kStripSeeds * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      args...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int slic_assign(const float* image, const float* inv_depth,
                const int* assignment, const float* seed_x,
                const float* seed_y, const float* seed_i, const float* seed_d,
                const unsigned char* stable, int* new_assignment, int* claimed,
                int h, int w, int cols, int oh, int ow, int sp,
                void* stream) {
  // the f32 reciprocal, as PyTorch-CUDA takes it for x / (sp/2)^2
  const float inv_half_sq = 1.0f / static_cast<float>((sp / 2) * (sp / 2));
  const dim3 block(32, 8);
  const dim3 grid((w + block.x - 1) / block.x, (h + block.y - 1) / block.y);
  slic_assign_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      image, inv_depth, assignment, seed_x, seed_y, seed_i, seed_d, stable,
      new_assignment, claimed, h, w, cols, oh, ow, sp, inv_half_sq);
  return static_cast<int>(cudaGetLastError());
}

int slic_centroid(const float* image, const float* depth,
                  const int* assignment, float* out, int h, int w, int rows,
                  int cols, int oh, int ow, int sp, int chunks, int per_lane,
                  int smem, void* stream) {
  return launch_strip(slic_centroid_kernel, rows, cols, smem, stream, image,
                      depth, assignment, out, h, w, cols, rows * cols, oh,
                      ow, sp, chunks, per_lane);
}

int slic_huber(const float* depth, const int* assignment, const float* mean_in,
               const unsigned char* conv_in, float* mean_out, int h, int w,
               int rows, int cols, int oh, int ow, int sp, int chunks,
               int per_lane, int smem, float hr, void* stream) {
  return launch_strip(slic_huber_kernel, rows, cols, smem, stream, depth,
                      assignment, mean_in, conv_in, mean_out, h, w, cols, oh,
                      ow, sp, chunks, per_lane, hr);
}

}  // extern "C"
