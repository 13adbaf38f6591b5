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
// counterpart here: B1 stages the seeds around a tile of pixels in shared
// memory, and B2/B3 stage the pixels of a strip of seeds.  Their launch
// geometry comes from ops/cuda/slic.py (`assign_plan`, `centroid_plan`,
// `huber_plan`), checked on the CPU.
//
// Stream axis: each entry takes nb frames (the streams of a multi-session
// fleet, the counterpart of jax.vmap over the TPU kernels, which adds a
// grid axis per stream) and launches once for all of them.  blockIdx.z is
// the stream; stream z's pixel planes start z * h * w elements and its
// seed planes z * rows * cols elements after the first, and nothing else
// in a block depends on z.  nb = 1 is the single-frame launch.

#include <cuda_runtime.h>

namespace {

constexpr float kBigCost = 1e10f;
// x / 100 as the plain twin (and XLA) compute it: a multiply by the
// correctly rounded f32 reciprocal
constexpr float kInv100 = 1.0f / 100.0f;

// ---------------------------------------------------------------------------
// B1 slic_assign: one pixel-assignment sweep.
// Replaces ops/pallas/slic.py::_assign_call (assign_pixels_pallas).
// A block of 32 x 8 threads takes a tile of kTileX x kTileY pixels (thread
// (lx, ly) the pixels (x0 + lx, y0 + ly + 8 k), k < 4), a warp 32
// consecutive pixels of one row, so every load and store is one coalesced
// 128-byte run.  The block stages the seeds of the cells its tile touches and
// a one-seed ring around them (nsy x nsx, from the plan; 6 x 6 at sp 8) in
// shared memory once: x, y, intensity and 1/max(depth, 1e-20) (the division
// done once per staged seed, the value the per-candidate division gave), or
// -1 for a seed without depth, and the seed's id (-1 off the reference
// grid).  A pixel at offset r of its cell admits, per axis, offsets {-1, 0}
// when r < sp/2, {0} when r == sp/2 and {0, +1} when r > sp/2 (the
// reference's gate |off sp + sp/2 - r| < sp), so its candidates are a 2 x 2
// block of staged seeds with some predicated off: every lane runs the same
// four slots, and the admitted ones in the reference order (x offset
// outer, y inner) with a strict-< running minimum.  A row-major warp still
// spans four cells, so the only per-lane difference is which slots are on.
// A thread's cell column needs one division, once; cell rows come from a
// per-block table, so no pixel divides.  The image, inverse-depth and
// assignment loads of a thread's four pixels, and the stable[assignment]
// gathers, are issued before the staging barrier, not one pixel after
// another.  Claims: the gate admits only seeds whose 2sp x 2sp window holds
// the pixel, so an updated pixel claims the seed it chose; the block marks
// its staged seeds in shared flags and writes each claimed seed's byte once
// (the C entry zeroes the claims with cudaMemsetAsync first; seed 0 is
// always claimed, as the plain twin finds claims in zero-padded windows and
// the pad value 0 is seed 0's id).  The spatial term divides by (sp/2)^2 as
// the twin does on the card: a multiply by the f32 reciprocal `inv_half_sq`
// (PyTorch-CUDA computes x / scalar so).
// Bound on the H100: memory.  A KITTI frame (376 x 1280, 1.9 MB per f32
// plane) reads the image, inverse depth and assignment planes and writes
// one: 7.7 MB per launch, 2.3 us at 3.35 TB/s; about 3.5 admitted
// candidates per pixel of ~25 instructions each.
// ---------------------------------------------------------------------------
constexpr int kTileX = 32;   // ops/cuda/slic.py ASSIGN_TILE
constexpr int kTileY = 32;
constexpr int kAssignRows = 8;                     // thread rows of a block
constexpr int kAssignPix = kTileY / kAssignRows;   // pixels of a thread

__global__ void __launch_bounds__(kTileX * kAssignRows) slic_assign_kernel(
    const float* __restrict__ image, const float* __restrict__ inv_depth,
    const int* __restrict__ assignment, const float* __restrict__ seed_x,
    const float* __restrict__ seed_y, const float* __restrict__ seed_i,
    const float* __restrict__ seed_d, const unsigned char* __restrict__ stable,
    int* __restrict__ new_assignment, unsigned char* __restrict__ claimed,
    int h, int w, int cols, int n_seeds, int oh, int ow, int sp, int nsy,
    int nsx, float inv_half_sq) {
  // this block's stream: its planes
  const size_t px0 = static_cast<size_t>(blockIdx.z) * h * w;
  const size_t sd0 = static_cast<size_t>(blockIdx.z) * n_seeds;
  image += px0;
  inv_depth += px0;
  assignment += px0;
  new_assignment += px0;
  seed_x += sd0;
  seed_y += sd0;
  seed_i += sd0;
  seed_d += sd0;
  stable += sd0;
  claimed += sd0;
  const int ns = nsy * nsx;
  extern __shared__ float4 s_seed[];                  // [ns] x, y, i, 1/d
  int* s_id = reinterpret_cast<int*>(s_seed + ns);    // [ns] id or -1
  int* s_claim = s_id + ns;                           // [ns] claimed flags
  int* s_row = s_claim + ns;   // [kTileY] (cell row - scy0) << 8 | offset
  const int tid = threadIdx.y * kTileX + threadIdx.x;
  const int x0 = blockIdx.x * kTileX, y0 = blockIdx.y * kTileY;
  const int x = x0 + threadIdx.x;

  // the thread's pixels: every load first, then the dependent gathers
  float img[kAssignPix], invd[kAssignPix];
  int asg[kAssignPix];
  bool cur_stable[kAssignPix];
#pragma unroll
  for (int k = 0; k < kAssignPix; ++k) {
    const int y = y0 + threadIdx.y + kAssignRows * k;
    const bool in = x < w && y < h;
    const size_t idx = static_cast<size_t>(y) * w + x;
    img[k] = in ? image[idx] : 0.0f;
    invd[k] = in ? inv_depth[idx] : 0.0f;
    asg[k] = in ? assignment[idx] : -1;
  }
#pragma unroll
  for (int k = 0; k < kAssignPix; ++k)
    cur_stable[k] = asg[k] >= 0 && stable[asg[k]] != 0;

  // the staged seeds: cells [scy0, scy0 + nsy) x [scx0, scx0 + nsx)
  const int scy0 = y0 / sp - 1, scx0 = x0 / sp - 1;
  const int vr = oh / sp, vc = ow / sp;  // seeds of the reference grid
  for (int i = tid; i < ns; i += kTileX * kAssignRows) {
    const int cy = scy0 + i / nsx, cx = scx0 + i % nsx;
    int id = -1;
    if (cy >= 0 && cy < vr && cx >= 0 && cx < vc) {
      id = cy * cols + cx;
      const float sd = seed_d[id];
      // 1/depth as the per-candidate division gave it; -1 marks no depth
      // (a depth of +inf has depth and 1/depth 0)
      s_seed[i] = make_float4(seed_x[id], seed_y[id], seed_i[id],
                              sd > 0.0f ? 1.0f / fmaxf(sd, 1e-20f) : -1.0f);
    }
    s_id[i] = id;
    s_claim[i] = 0;
  }
  if (tid < kTileY) {
    const int y = y0 + tid, ty = y / sp;
    s_row[tid] = ((ty - scy0) << 8) | (y - ty * sp);
  }
  // once per stream: block (0, 0) of each z
  if (tid == 0 && blockIdx.x == 0 && blockIdx.y == 0) claimed[0] = 1;
  __syncthreads();

  const int half = sp / 2;
  const int tx = x / sp, rx = x - tx * sp;
  const int bx = tx - scx0 - (rx < half);   // staged column of slot a = 0
  const int nx = rx == half ? 1 : 2;        // admitted x offsets
  const float xf = static_cast<float>(x);
#pragma unroll
  for (int k = 0; k < kAssignPix; ++k) {
    const int ly = threadIdx.y + kAssignRows * k;
    const int y = y0 + ly;
    if (x >= w || y >= h) continue;
    int na = asg[k];
    // pixels of a stable seed keep it; so do pixels outside the image
    if (y < oh && x < ow && !cur_stable[k]) {
      const int row = s_row[ly];
      const int ry = row & 255;
      const int by = (row >> 8) - (ry < half);
      const int ny = ry == half ? 1 : 2;
      const float yf = static_cast<float>(y);
      const float pim = img[k], pinv = invd[k];
      float best_d = kBigCost, best_nd = kBigCost;
      int best_d_s = -1, best_nd_s = -1;
      bool all_hasd = pinv > 0.0f;
#pragma unroll
      for (int a = 0; a < 2; ++a) {
#pragma unroll
        for (int b = 0; b < 2; ++b) {
          if (a >= nx || b >= ny) continue;
          const int s = (by + b) * nsx + bx + a;
          if (s_id[s] < 0) continue;  // no seed there: never a candidate
          const float4 sd = s_seed[s];
          const float ex = sd.x - xf;
          const float ey = sd.y - yf;
          const float dist = ex * ex + ey * ey;
          const float idiff = sd.z - pim;
          const float nodepth = dist * inv_half_sq + idiff * idiff * kInv100;
          const bool hasd = sd.w >= 0.0f && pinv > 0.0f;
          const float ddiff = sd.w - pinv;
          const float withd = nodepth + ddiff * ddiff * 400.0f;
          const float cost_d = hasd ? withd : nodepth;
          if (cost_d < best_d) {
            best_d = cost_d;
            best_d_s = s;
          }
          if (nodepth < best_nd) {
            best_nd = nodepth;
            best_nd_s = s;
          }
          all_hasd = all_hasd && hasd;
        }
      }
      const int best_s = all_hasd ? best_d_s : best_nd_s;
      const float best_cost = all_hasd ? best_d : best_nd;
      na = -1;
      if (best_cost < kBigCost) {
        na = s_id[best_s];
        s_claim[best_s] = 1;   // the gate keeps the pixel in its window
      }
    }
    new_assignment[static_cast<size_t>(y) * w + x] = na;
  }
  __syncthreads();
  for (int i = tid; i < ns; i += kTileX * kAssignRows)
    if (s_claim[i]) claimed[s_id[i]] = 1;
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
  // stream z: its planes; out is (6, nb, rows, cols)
  const size_t px0 = static_cast<size_t>(blockIdx.z) * h * w;
  image += px0;
  depth += px0;
  assignment += px0;
  out += static_cast<size_t>(blockIdx.z) * n_seeds;
  const size_t plane = static_cast<size_t>(gridDim.z) * n_seeds;
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
    out[plane + b] = sx;
    out[2 * plane + b] = sy;
    out[3 * plane + b] = si;
    out[4 * plane + b] = static_cast<float>(nd);
    out[5 * plane + b] = sd;
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
    int h, int w, int cols, int n_seeds, int oh, int ow, int sp, int chunks,
    int per_lane, float hr) {
  // stream z: its planes
  const size_t px0 = static_cast<size_t>(blockIdx.z) * h * w;
  const size_t sd0 = static_cast<size_t>(blockIdx.z) * n_seeds;
  depth += px0;
  assignment += px0;
  mean_in += sd0;
  conv_in += sd0;
  mean_out += sd0;
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
// above 48 KB) and launch it, one block per kStripSeeds seeds of a row and
// stream.
template <typename... Params, typename... Args>
int launch_strip(void (*kernel)(Params...), int rows, int cols, int nb,
                 int smem, void* stream, Args... args) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((cols + kStripSeeds - 1) / kStripSeeds, rows, nb);
  kernel<<<grid, kStripSeeds * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      args...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int slic_assign(const float* image, const float* inv_depth,
                const int* assignment, const float* seed_x,
                const float* seed_y, const float* seed_i, const float* seed_d,
                const unsigned char* stable, int* new_assignment,
                unsigned char* claimed, int nb, int h, int w, int rows,
                int cols, int oh, int ow, int sp, int nsy, int nsx, int smem,
                void* stream) {
  // the plan's staged seed grid must hold every tile's cells and their ring
  if (sp < 2 || sp > 16 || nb < 1 || nb > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  int need_y = 0, need_x = 0;
  for (int y0 = 0; y0 < h; y0 += kTileY) {
    const int n = (y0 + kTileY - 1) / sp - y0 / sp + 3;
    need_y = n > need_y ? n : need_y;
  }
  for (int x0 = 0; x0 < w; x0 += kTileX) {
    const int n = (x0 + kTileX - 1) / sp - x0 / sp + 3;
    need_x = n > need_x ? n : need_x;
  }
  if (nsy < need_y || nsx < need_x || nsx > 255 ||
      smem != nsy * nsx * 24 + 4 * kTileY)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      cudaMemsetAsync(claimed, 0, static_cast<size_t>(nb) * rows * cols, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  // the f32 reciprocal, as PyTorch-CUDA takes it for x / (sp/2)^2
  const float inv_half_sq = 1.0f / static_cast<float>((sp / 2) * (sp / 2));
  const dim3 block(kTileX, kAssignRows);
  const dim3 grid((w + kTileX - 1) / kTileX, (h + kTileY - 1) / kTileY, nb);
  slic_assign_kernel<<<grid, block, smem, s>>>(
      image, inv_depth, assignment, seed_x, seed_y, seed_i, seed_d, stable,
      new_assignment, claimed, h, w, cols, rows * cols, oh, ow, sp, nsy, nsx,
      inv_half_sq);
  return static_cast<int>(cudaGetLastError());
}

int slic_centroid(const float* image, const float* depth,
                  const int* assignment, float* out, int nb, int h, int w,
                  int rows, int cols, int oh, int ow, int sp, int chunks,
                  int per_lane, int smem, void* stream) {
  if (nb < 1 || nb > 65535) return static_cast<int>(cudaErrorInvalidValue);
  return launch_strip(slic_centroid_kernel, rows, cols, nb, smem, stream,
                      image, depth, assignment, out, h, w, cols, rows * cols,
                      oh, ow, sp, chunks, per_lane);
}

int slic_huber(const float* depth, const int* assignment, const float* mean_in,
               const unsigned char* conv_in, float* mean_out, int nb, int h,
               int w, int rows, int cols, int oh, int ow, int sp, int chunks,
               int per_lane, int smem, float hr, void* stream) {
  if (nb < 1 || nb > 65535) return static_cast<int>(cudaErrorInvalidValue);
  return launch_strip(slic_huber_kernel, rows, cols, nb, smem, stream, depth,
                      assignment, mean_in, conv_in, mean_out, h, w, cols,
                      rows * cols, oh, ow, sp, chunks, per_lane, hr);
}

}  // extern "C"
