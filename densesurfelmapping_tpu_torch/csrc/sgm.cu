// Semi-global matching (SGM) scanline aggregation kernels for Hopper
// (sm_90a): the three SGM kernels of the stereo fuse step.  Plain C entry
// points, loaded with ctypes by densesurfelmapping_tpu_torch/ops/cuda/sgm.py;
// every entry launches on the caller's stream and returns a CUDA error code.
// The launch geometry (bands, columns per warp, threads, shared bytes, slab)
// comes from the wrapper's plan (ops/cuda/sgm.py: axis_plan, census_x_plan,
// census_y_plan), which also states where the scans meet; the entries check
// it and refuse another.
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
//     first pixel of every path (which gives L' = C);
//   * carry_bf16: every add is rounded to bf16 (round to nearest even) and
//     L' is clamped at 9984 (the bf16 value of the 1e4 out-of-range cost);
//   * diagonal paths restart at the image border (a zero carry);
//   * the free-entry restart (L' = C) where a plane enters range: forward
//     x scans at x == d + min_d, the roll = +1 diagonals at x == d + min_d;
//   * each orientation's output is the sum over the directions sharing the
//     scan axis, in roll order and in carry dtype, rounded ONCE to bf16; a
//     family's result is f32(forward) + f32(backward), and the census
//     aggregate is x family + y family.
// The TPU kernels' 128-lane padding with BIG, lane rolls, sublane shears and
// the transposed d-reversed x layout are Mosaic devices and have no
// counterpart here.
//
// Design.  Every kernel but B4's wide route runs a warp step: lane l of a
// warp holds planes 4l..4l+3 of one path in registers (D <= 128; planes >= D
// are pads), L[d-1] / L[d+1] across lanes come from one __shfl_up /
// __shfl_down, and Lmin is one redux.sync minimum on the float bits (every
// L is >= +0, so unsigned order is float order); no block barrier and no
// shared memory sit inside a step.  B6 runs a row's two orientations as two warps of one
// block.  B5 runs each orientation's scan down the image as bands of columns,
// one block per SM, each holding its band's row state of all g directions in
// shared memory (the TPU kernel's resident row carries); the diagonal
// carries that cross a band edge go to the neighbouring band through a ring
// in device memory.  In both, the forward and backward scans meet in the
// middle: each passes its first half's bf16 totals to the other through a
// (H, W, 128) slab, and the second halves write out f32(forward) +
// f32(backward), so no pass over out follows the scans.  B4 (a materialized
// volume) runs the same step and meeting with the cost read from the volume:
// a line per warp pair for the roll set (0), B5's bands for (0, +1, -1).
// Only for 128 < D <= 1024 (more planes than a warp holds) does B4 keep its
// first design: every scanline its own block, one thread per plane, one
// block barrier per step, one f32 scratch slab per direction and a combine
// pass for the roll-order sum.
//
// Designs tried and not kept: a 16-CTA thread-block cluster per orientation
// for B5, with the halos in distributed shared memory, runs the scan on 32
// of the 132 SMs, and the step is latency-bound per warp, so it was slower
// than bands over every SM; a separate combine pass over a (2, H, W, 128)
// slab after the scans moved more bytes than the meeting in the middle.

#include <climits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr float kBigBf16 = 9984.0f;  // bf16(1e4): out-of-range cost, clamp
constexpr int kMaxThreads = 1024;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxSmem = 232448;     // opt-in shared memory of one block

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fminf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// ---------------------------------------------------------------------------
// B4 for 128 < D <= 1024 (the wide route; D <= 128 runs axis_line_kernel or
// axis_band_kernel below): one DP step of a line.  Every thread of the
// block calls it (padding threads d >= D publish +inf); returns L' for the
// thread's plane.  `sl` (blockDim floats) and `smin` (32 floats) are this
// step's halves of the double buffers: the next write to them is two steps
// later, after the next step's barrier, so one barrier per step suffices.
// ---------------------------------------------------------------------------
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

// B4 line kernel: one block per (line, slab); slab = orientation * g +
// direction, direction k shifting its row by rolls[k] per step.  Steps t run
// along axis 0 (L), rows r along axis 1 (R); the line of a block is (t, r) ->
// (t + dt, r + roll) from a start on the first step (any r) or on the border
// row the roll restarts (r = 0 for roll +1, R - 1 for roll -1).  Writes L' of
// every (t, r, d) to scratch[slab][(t * R + r) * D + d].
// entry: 0 none; 1 forward orientation at d + min_d == t (scan axis =
// image x); 2 roll == +1 directions at d + min_d == r (rows = image x).
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

int line_threads(int D) { return ((D + 31) / 32) * 32; }

size_t line_smem(int threads) { return (2 * threads + 64) * sizeof(float); }

// ---------------------------------------------------------------------------
// The warp step of B5 and B6.  Lane l holds planes 4l + j (j = 0..3) in
// v[j]; every loop over j is unrolled, so the arrays live in registers.
// Pad planes (d >= D) carry +inf cost: in f32 their L stays +inf; with bf16
// carries it is clamped to 9984, which is >= every real L, so neither Lmin
// nor a real plane's min(L[d-1], L[d+1]) changes (for D == 1 the d+1 pad
// gives round_bf16(9984 + P1) >= 9984 >= L[0], which loses to L[0] as +inf
// would).
// ---------------------------------------------------------------------------
struct Planes {
  float v[4];
};

__device__ __forceinline__ Planes load4(const float* p) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  return Planes{{t.x, t.y, t.z, t.w}};
}

__device__ __forceinline__ void store4(float* p, const Planes& a) {
  *reinterpret_cast<float4*>(p) = make_float4(a.v[0], a.v[1], a.v[2], a.v[3]);
}

template <bool BF16>
__device__ __forceinline__ float dp_update(float carry, float nb, float cost,
                                           float lmin, float lmin_p2,
                                           float p1) {
  if (BF16) {
    const float cand = fminf(fminf(carry, round_bf16(nb + p1)), lmin_p2);
    return fminf(round_bf16(cost + round_bf16(cand - lmin)), kBigBf16);
  }
  const float cand = fminf(fminf(carry, nb + p1), lmin_p2);
  return cost + (cand - lmin);
}

// The open d boundaries of a lane's shuffled neighbours: fmaxf with +inf on
// lane 0 (left) and lane 31 (right), with -inf (a no-op) elsewhere.
struct Edges {
  float left, right;
};

__device__ __forceinline__ Edges lane_edges(int lane) {
  return Edges{lane == 0 ? CUDART_INF_F : -CUDART_INF_F,
               lane == 31 ? CUDART_INF_F : -CUDART_INF_F};
}

// L' of the lane's four planes from the carry s and the cost c.
template <bool BF16>
__device__ __forceinline__ Planes warp_dp(const Planes& s, const Planes& c,
                                          float p1, float p2, Edges e) {
  const float local = fminf(fminf(s.v[0], s.v[1]), fminf(s.v[2], s.v[3]));
  const float lmin =
      __uint_as_float(__reduce_min_sync(kFull, __float_as_uint(local)));
  // planes 4l - 1 and 4l + 4
  const float left = fmaxf(__shfl_up_sync(kFull, s.v[3], 1), e.left);
  const float right = fmaxf(__shfl_down_sync(kFull, s.v[0], 1), e.right);
  const float lp2 = BF16 ? round_bf16(lmin + p2) : lmin + p2;
  Planes r;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float dm = j == 0 ? left : s.v[j - 1];
    const float dp = j == 3 ? right : s.v[j + 1];
    r.v[j] = dp_update<BF16>(s.v[j], fminf(dm, dp), c.v[j], lmin, lp2, p1);
  }
  return r;
}

// Census rows are staged in shared memory in four phases, (i & 3) * q +
// (i >> 2): lane l reads index base - 4l - j for its plane 4l + j, so for a
// fixed j the 32 lanes read 32 consecutive words (no bank conflict).
__device__ __forceinline__ int phase_index(int i, int q) {
  return (i & 3) * q + (i >> 2);
}

// The census codes a lane needs at image column x, cr[x - min_d - d] for its
// planes d = 4l + j, walked along x: one step moves every code one plane
// (a register move and one shuffle) and loads one new code.  `crs` holds the
// permuted cr row segment whose index 0 is image column s0; codes left of
// column 0 are never read (their planes are out of range).
struct CensusWalk {
  int cr[4];
  float pad[4];   // -inf on real planes, +inf on pad planes (d >= D)

  __device__ __forceinline__ void init(int D, int lane) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      pad[j] = 4 * lane + j < D ? -CUDART_INF_F : CUDART_INF_F;
  }
  // index clamped at 0: a code left of the segment belongs to a plane that
  // is out of range (or a pad) at x, and its cost never reads it
  __device__ __forceinline__ static int at(const int* crs, int q, int i) {
    return crs[phase_index(max(i, 0), q)];
  }
  __device__ __forceinline__ void load(const int* crs, int q, int s0, int x,
                                       int min_d, int lane) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      cr[j] = at(crs, q, x - min_d - 4 * lane - j - s0);
  }
  // x -> x + 1: plane d takes plane d - 1's code
  __device__ __forceinline__ void step_right(const int* crs, int q, int s0,
                                             int x, int min_d, int lane) {
    const int up = __shfl_up_sync(kFull, cr[3], 1);
    cr[3] = cr[2];
    cr[2] = cr[1];
    cr[1] = cr[0];
    cr[0] = lane == 0 ? at(crs, q, x - min_d - s0) : up;
  }
  // x -> x - 1: plane d takes plane d + 1's code
  __device__ __forceinline__ void step_left(const int* crs, int q, int s0,
                                            int x, int min_d, int lane) {
    const int down = __shfl_down_sync(kFull, cr[0], 1);
    cr[0] = cr[1];
    cr[1] = cr[2];
    cr[2] = cr[3];
    cr[3] = lane == 31 ? at(crs, q, x - min_d - 127 - s0) : down;
  }
  // cost of the lane's planes at x: popcount(cl ^ cr) where x - d - min_d >=
  // 0, else 9984; +inf on pads
  __device__ __forceinline__ Planes cost(int clv, int x, int min_d,
                                         int lane) const {
    const int u = x - min_d - 4 * lane;
    Planes c;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      c.v[j] = fmaxf(u >= j ? static_cast<float>(__popc(clv ^ cr[j]))
                            : kBigBf16,
                     pad[j]);
    return c;
  }
};

// Free-entry restart: planes with x == d + min_d restart at their cost.  Only
// 128 columns can hold one, so the caller tests `x - min_d` first.
__device__ __forceinline__ void entry_restart(Planes& L, const Planes& c,
                                              int x, int min_d, int lane) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (x == 4 * lane + j + min_d) L.v[j] = c.v[j];
}

__device__ __forceinline__ bool entry_column(int x, int min_d) {
  return static_cast<unsigned>(x - min_d) < 128u;
}

// B5 and B6 pass a first half's bf16 totals to the other orientation through
// a (H, W, 128) slab, planes fastest: each lane stores its four planes (8
// bytes; a warp's store is one aligned 256-byte run), straight from
// registers.
__device__ __forceinline__ void store_bf16x4(__nv_bfloat16* p,
                                             const Planes& tot) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(tot.v[0], tot.v[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(tot.v[2], tot.v[3]);
  uint2 v;
  v.x = *reinterpret_cast<const unsigned*>(&lo);
  v.y = *reinterpret_cast<const unsigned*>(&hi);
  *reinterpret_cast<uint2*>(p) = v;
}

__device__ __forceinline__ float4 bf16x4_to_float4(uint2 u) {
  const float2 lo =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// ---------------------------------------------------------------------------
// B6 (replaces _census_call_x, densesurfelmapping_tpu/ops/pallas/sgm.py:497):
// the x family of the census aggregate, out[d, y, x] = f32(bf16(forward)) +
// f32(bf16(backward)).  One block of two warps per image row: warp 0 scans x
// forward (free entry at x == d + min_d), warp 1 backward, at the same time;
// the row's census is staged in shared memory once, and each lane walks its
// planes' right-census codes along x with one shuffle per step.  The warps
// meet at mid-row: the first half of each scan stores bf16(L) to the slab,
// the second half adds the other warp's value and writes out through a
// staged tile, so out is written once, 128 bytes of one plane per store.
// Bound on the H100: bytes.  It reads two census images (3.7 MB at KITTI size
// 376 x 1241) and writes the f32 (127, 376, 1241) family (237 MB): 72 us at
// 3.35 TB/s; the slab adds 119 MB written and read.  The old design (one
// block of 128 threads per row, a block barrier and a 4-warp shared-memory
// minimum per step, a read-modify-write of out on the backward pass) took
// 2368.8 us; here a step's dependency chain is one redux, two shuffles and
// the update, with no barrier.  The tile's flush stalls the warp while its
// 127 stores drain (every row's warp writes the same columns at once, so
// the stores scatter over out); giving the stores to writer warps, or
// spreading them over the steps, measured slower.
// ---------------------------------------------------------------------------
constexpr int kXTile = 32;    // columns of a warp's staged out tile
constexpr int kXAhead = 8;    // steps the other orientation's total is fetched ahead
constexpr int kXRing = 2 * kXAhead;

// The cp.async helpers clobber "memory": the compiler keeps every ordinary
// load and store on its side of the copy, as written.
__device__ __forceinline__ void cp_async8(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" ::"r"(dst),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <bool BF16>
__global__ void __launch_bounds__(64)
    census_x_kernel(const int* __restrict__ cl, const int* __restrict__ cr,
                    float* __restrict__ out, __nv_bfloat16* __restrict__ slab,
                    int H, int W, int D, float p1, float p2, int min_d) {
  // [2 warps][kXTile][32 chunks] f32 out tiles, [2 warps][kXRing][32] the
  // other orientation's fetched totals, then the row's census
  extern __shared__ __align__(16) int smem_x[];
  const int q = (W + 3) >> 2;
  const int o = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float4* tile = reinterpret_cast<float4*>(smem_x) + o * kXTile * 32;
  uint2* ring = reinterpret_cast<uint2*>(smem_x + 2 * kXTile * 128) +
                o * kXRing * 32 + lane;
  int* cr_s = smem_x + 2 * kXTile * 128 + 2 * kXRing * 32 * 2;   // [4 q]
  int* cl_s = cr_s + 4 * q;                                      // [W]
  const int y = blockIdx.x;
  const size_t row = static_cast<size_t>(y) * W;
  for (int i = threadIdx.x; i < W; i += blockDim.x) {
    cl_s[i] = cl[row + i];
    cr_s[phase_index(i, q)] = cr[row + i];
  }
  __syncthreads();

  const bool fwd = o == 0;
  const float p1v = BF16 ? round_bf16(p1) : p1;
  const float p2v = BF16 ? round_bf16(p2) : p2;
  const Edges edges = lane_edges(lane);
  // the slab row: bf16 totals, planes fastest; the forward warp writes
  // x < mid, the backward warp x >= mid
  __nv_bfloat16* srow = slab + row * 128 + 4 * lane;
  const int mid = W >> 1;
  const int first = fwd ? mid : W - mid;   // steps before the meeting
  auto x_at = [&](int s) { return fwd ? s : W - 1 - s; };
  Planes L;
  CensusWalk walk;
  walk.init(D, lane);
  auto step = [&](int s) {
    const int x = x_at(s);
    if (s == 0) {
      walk.load(cr_s, q, 0, x, min_d, lane);
    } else if (fwd) {
      walk.step_right(cr_s, q, 0, x, min_d, lane);
    } else {
      walk.step_left(cr_s, q, 0, x, min_d, lane);
    }
    const Planes c = walk.cost(cl_s[x], x, min_d, lane);
    L = s == 0 ? c : warp_dp<BF16>(L, c, p1v, p2v, edges);
    if (fwd && entry_column(x, min_d)) entry_restart(L, c, x, min_d, lane);
  };

  for (int s = 0; s < first; ++s) {
    step(s);
    store_bf16x4(srow + x_at(s) * 128, L);
  }
  // the other warp's first half is in the slab
  __syncthreads();

  // Second half: x runs over the other warp's first half.  Its total for
  // step s is fetched kXAhead steps ahead into a ring (one cp.async group
  // per step), f32(bf16(L)) + f32(other) is staged in a tile of kXTile
  // columns (chunk c of column r at c ^ r), and each full tile is written
  // with lane = column: 128 bytes of one plane per store.
  auto fetch = [&](int s) {
    if (s < W) cp_async8(ring + (s % kXRing) * 32, srow + x_at(s) * 128);
    cp_async_commit();
  };
  for (int s = first; s < first + kXAhead; ++s) fetch(s);
  const size_t plane = static_cast<size_t>(H) * W;
  for (int t0 = first; t0 < W; t0 += kXTile) {
    const int n = min(kXTile, W - t0);
    // lowest column of the tile; column x sits in tile row x - xlo
    const int xlo = fwd ? t0 : W - t0 - n;
    for (int s = t0; s < t0 + n; ++s) {
      step(s);
      fetch(s + kXAhead);
      asm volatile("cp.async.wait_group %0;" ::"n"(kXAhead) : "memory");
      const uint2 u = ring[(s % kXRing) * 32];
      const float4 other = bf16x4_to_float4(u);
      const int r = x_at(s) - xlo;
      tile[r * 32 + (lane ^ r)] =
          make_float4(round_bf16(L.v[0]) + other.x,
                      round_bf16(L.v[1]) + other.y,
                      round_bf16(L.v[2]) + other.z,
                      round_bf16(L.v[3]) + other.w);
    }
    __syncwarp();
    if (lane < n) {
      float* op = out + row + xlo + lane;
#pragma unroll 4
      for (int c = 0; c < 32 && 4 * c < D; ++c) {
        const float4 v = tile[lane * 32 + (c ^ lane)];
        const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (4 * c + j < D) op[(4 * c + j) * plane] = e[j];
      }
    }
    __syncwarp();
  }
}

// Shared bytes of a B6 block: two out tiles, two fetch rings, the row's
// census (the plan's census_x_plan computes the same).
size_t census_x_smem(int W) {
  return sizeof(float) * 2 * kXTile * 128 + sizeof(uint2) * 2 * kXRing * 32 +
         sizeof(int) * (4 * ((W + 3) / 4) + W);
}

// ---------------------------------------------------------------------------
// B5 (replaces _census_call_y, densesurfelmapping_tpu/ops/pallas/sgm.py:382):
// the y family (vertical + diagonals, `rolls` in roll order) of the census
// aggregate, added to out (D, H, W), which holds the x family.
// Like the TPU kernel, which keeps the whole row's carries of all g
// directions resident in VMEM and advances row by row, each orientation's
// scan keeps its row state (g x W x 128 f32, 1.9 MB at KITTI size) on chip:
// split over `nbands` blocks of `ncols` columns, one block per SM (66 bands
// of 19 columns per orientation at KITTI width on 132 SMs), in a
// double-buffered shared-memory state.  Per image row a block stages its
// band's census segment (chunks of kRows rows by cp.async), and each warp
// runs the warp step of its column for all g directions from one census
// cost and sums the directions in roll order in carry dtype; one block
// barrier ends the row.  The diagonal carries that leave a band go to the
// neighbouring band through a ring of kHaloRows rows in device memory, each
// value tagged with its row in one 64-bit word, so only a band's two edge
// warps ever wait on another block.  The two orientations meet at mid-image:
// a first half stores bf16(total) to the slab; in the second half the block
// fetches, two rows ahead, the other orientation's totals and out's values
// of its band's row, adds f32(own) + f32(other) into them, and writes the
// row back (consecutive threads on consecutive x of one plane).  The blocks
// wait on each other, so the grid is a cooperative launch: all blocks
// resident or no launch.
// Bound on the H100: bytes.  It reads two census images (3.7 MB) and reads
// and writes the f32 (127, 376, 1241) output (474 MB): 143 us at 3.35 TB/s;
// the slab adds 119 MB written and read.  The old design (one 128-thread
// block per line and direction, six f32 scratch slabs of 237 MB and a
// combine pass: 2.84 GB of scratch traffic) took 2883.0 us.  The scan's own
// floor is H rows of a warp step's latency, not the bytes.
// ---------------------------------------------------------------------------
constexpr int kRows = 8;        // census rows per cp.async chunk
constexpr int kHaloRows = 4;    // rows of a halo ring in device memory
constexpr int kYThreads = 640;  // most threads of a B5 block

struct CensusY {
  const int* cl;
  const int* cr;
  float* out;
  __nv_bfloat16* slab;
  // [2 o][nbands][2 side][G][kHaloRows][128] tagged carries, then the rows
  // each band has finished, [2 o][nbands] (u32); zeroed before the launch
  unsigned long long* halo;
  int H, W, D, min_d, ncols, cpw, nbands;
  int rolls[3];
  float p1, p2;
};

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(dst),
               "l"(gmem)
               : "memory");
}

// A halo value travels with the row it belongs to in one 64-bit word (tag in
// the high half), which a relaxed access reads or writes whole: the reader
// needs no flag and the writer no fence.
__device__ __forceinline__ void store_tagged(unsigned long long* p, float v,
                                             unsigned tag) {
  const unsigned long long w =
      (static_cast<unsigned long long>(tag) << 32) | __float_as_uint(v);
  asm volatile("st.relaxed.gpu.global.b64 [%0], %1;" ::"l"(p), "l"(w)
               : "memory");
}

__device__ __forceinline__ unsigned long long load_tagged(
    const unsigned long long* p) {
  unsigned long long w;
  asm volatile("ld.relaxed.gpu.global.b64 %0, [%1];"
               : "=l"(w)
               : "l"(p)
               : "memory");
  return w;
}

__device__ __forceinline__ unsigned load_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void store_relaxed(unsigned* p, unsigned v) {
  asm volatile("st.relaxed.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

// What a lane needs of its band column cx (image column x = x0 + cx), the
// same on every row: where its planes' four right-census codes sit in a
// staged row (cr[x - min_d - d] for d = 4 lane + j, at segment index
// cx + D - 1 - d; an index below 0 belongs to a pad plane and is clamped),
// the floor of each plane's cost (-inf; 9984 where x - min_d - d < 0; +inf
// on pad planes d >= D), and the plane that restarts at the free entry
// x == d + min_d of the roll = +1 directions.
struct Column {
  int idx[4];
  float lo[4];
  bool restart[4];  // this lane's plane j is the entry plane
  bool entry;       // the column has an entry plane
};

__device__ __forceinline__ Column band_column(int cx, int x0, int D,
                                             int min_d, int q, int lane) {
  Column c;
  const int x = x0 + cx;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int d = 4 * lane + j;
    c.idx[j] = phase_index(max(cx + D - 1 - d, 0), q);
    c.lo[j] = d >= D ? CUDART_INF_F
                     : (x - min_d - d < 0 ? kBigBf16 : -CUDART_INF_F);
  }
  const int de = x - min_d;
  c.entry = de >= 0 && de < D;
#pragma unroll
  for (int j = 0; j < 4; ++j) c.restart[j] = c.entry && 4 * lane + j == de;
  return c;
}

// ONE: every warp owns at most one column (cpw == 1: bands of at most 20
// columns, widths up to 1320 on 132 SMs, KITTI's 1241 among them), whose
// Column and addresses are computed once instead of on every row.  The
// general column loop alone is 3-4% slower at KITTI size
// (experiments/torch_sgm_time.py on an NVIDIA H100 80GB HBM3, 700.00 W:
// 8 paths 932.6-942.4 us against 900.2-909.6 us, 4 paths 682.6-685.2
// against 661.2-667.2 us), so the fork stays.
template <bool BF16, int G, bool ONE>
__global__ void __launch_bounds__(kYThreads, 1)
    census_y_kernel(const CensusY a) {
  const int nbands = a.nbands;
  const int o = blockIdx.x / nbands;        // 0 forward, 1 backward
  const int band = blockIdx.x - o * nbands;
  const int H = a.H, W = a.W, D = a.D, min_d = a.min_d, ncols = a.ncols;
  const int x0 = band * ncols;
  const int nb = min(ncols, W - x0);        // columns of this band
  const int S = ncols + 2;                  // state columns: halo, band, halo
  const int seglen = ncols + D - 1;         // cr columns the band reads
  const int q = (seglen + 3) >> 2;
  const int crow = 4 * q + ncols;           // ints of one staged census row
  const int s0 = x0 - min_d - (D - 1);      // image column of segment 0
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int ca = warp * a.cpw, cb = min(nb, ca + a.cpw);  // warp's columns
  int rolls[G];
  bool right_moving = false, left_moving = false;
#pragma unroll
  for (int k = 0; k < G; ++k) {
    rolls[k] = a.rolls[k];
    right_moving |= rolls[k] > 0;
    left_moving |= rolls[k] < 0;
  }
  // Halo exchange with the neighbouring bands: side 0 carries the
  // right-moving (roll +1) carries of a band's last column to the band on
  // its right, side 1 the left-moving ones of its first column to the left.
  // The roll sets are (0) and (0, +1, -1) (the entry refuses others): with
  // diagonals both ways, a band runs at most one row ahead of a neighbour
  // (each needs the other's previous row), so a ring of kHaloRows rows is
  // never overwritten unread.
  const bool from_left = right_moving && band > 0;
  const bool from_right = left_moving && band < nbands - 1;
  const bool to_right = right_moving && band < nbands - 1;
  const bool to_left = left_moving && band > 0;
  auto halo_at = [&](int bnd, int side, int k, int t) {
    return a.halo +
           ((((static_cast<size_t>(o) * nbands + bnd) * 2 + side) * G + k) *
                kHaloRows +
            t % kHaloRows) *
               128 +
           4 * lane;
  };
  unsigned* done = reinterpret_cast<unsigned*>(
                       a.halo + static_cast<size_t>(2) * nbands * 2 * G *
                                    kHaloRows * 128) +
                   o * nbands;

  // Row state, double-buffered by row parity: direction k's carries of the
  // band's columns at state columns 1..nb, with a zero carry (pad planes
  // +inf) in columns 0 and nb + 1 for a diagonal entering from outside the
  // image; a band's edge column takes the carry that enters from a
  // neighbouring band from that band's halo ring instead.  Row t reads
  // buffer t & 1 at column cx + 1 - roll and writes buffer (t + 1) & 1 at
  // cx + 1.  The zero carries of the first row give L' = C, as the start of
  // every path does.
  extern __shared__ __align__(16) float smem_y[];
  float* state = smem_y;                                        // [2][G][S][128]
  int* census = reinterpret_cast<int*>(state + 2 * G * S * 128);  // [2][kRows][crow]
  // second half, by step modulo 4 (fetched two rows ahead): the other
  // orientation's bf16 totals of the row, [4][ncols][32] uint2 (4 planes
  // each), and out's values of the row, [4][4 j][32 l][ncolsp] f32 for
  // plane 4 l + j (an odd row length, so a warp's lanes hit distinct banks)
  const int ncolsp = ncols | 1;
  uint2* obuf = reinterpret_cast<uint2*>(census + 2 * kRows * crow);
  float* outbuf = reinterpret_cast<float*>(obuf + 4 * ncols * 32);
  for (int i = tid; i < 2 * G * S * 128; i += nthreads)
    state[i] = (i & 127) < D ? 0.0f : CUDART_INF_F;
  auto row_y = [&](int t) { return o == 0 ? t : H - 1 - t; };
  // chunk c of census rows (t in [c kRows, c kRows + kRows)) into buffer c & 1
  auto census_fetch = [&](int c) {
    int* buf = census + (c & 1) * kRows * crow;
    for (int r = 0; r < kRows && c * kRows + r < H; ++r) {
      const size_t row = static_cast<size_t>(row_y(c * kRows + r)) * W;
      int* dst = buf + r * crow;
      for (int e = tid; e < seglen; e += nthreads) {
        if (s0 + e >= 0 && s0 + e < W) {
          cp_async4(dst + phase_index(e, q), a.cr + row + s0 + e);
        } else {
          dst[phase_index(e, q)] = 0;
        }
      }
      for (int e = tid; e < nb; e += nthreads)
        cp_async4(dst + 4 * q + e, a.cl + row + x0 + e);
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
  };

  const float p1v = BF16 ? round_bf16(a.p1) : a.p1;
  const float p2v = BF16 ? round_bf16(a.p2) : a.p2;
  const Edges edges = lane_edges(lane);
  const int GS = G * S * 128;               // floats of one state buffer
  // slab elements from one row of the orientation's scan to the next
  const long long slab_step = (o == 0 ? 1LL : -1LL) * W * 128;
  // The two orientations meet in the middle: the forward scan's rows
  // [0, H / 2) and the backward scan's [H / 2, H) go to the slab, and in
  // its second half each scan adds f32(bf16(own)) + f32(other) to out.
  const int first = o == 0 ? H / 2 : H - H / 2;   // steps before the meeting
  const size_t plane = static_cast<size_t>(H) * W;
  auto ob_at = [&](int b, int d, int c) {
    return outbuf + (b * 128 + (d & 3) * 32 + (d >> 2)) * ncolsp + c;
  };
  // f(d, c) for this thread's share of the band's (plane, column) pairs of
  // a row, e = d nb + c, consecutive threads on consecutive e (d = e / nb in
  // f32 is exact: e < 2^13 and (e + 0.5) / nb is at least 0.5 / nb from an
  // integer).  The warps of the band's edge columns wait on the halo and end
  // each row last, so the others take their share when there are others.
  const int last = (nb - 1) / a.cpw;        // warp of the band's last column
  const bool halo_warps = from_left || to_left || from_right || to_right;
  const int nedge = halo_warps ? (last > 0 ? 2 : 1) : 0;
  const bool share = nthreads > 32 * nedge;
  const bool edge = halo_warps && (warp == 0 || warp == last);
  const int wtid = share ? tid - 32 * ((halo_warps && warp > 0) +
                                       (halo_warps && last > 0 && warp > last))
                         : tid;
  const int nworkers = share ? nthreads - 32 * nedge : nthreads;
  const float inv_nb = 1.0f / nb;
  auto each_out = [&](auto&& f) {
    if (share && edge) return;
    for (int e = wtid; e < nb * D; e += nworkers) {
      const int d = __float2int_rz((static_cast<float>(e) + 0.5f) * inv_nb);
      f(d, e - d * nb);
    }
  };
  // Step s's other totals and out values into buffer s & 3 (cp.async), once
  // the other scan's first half is done (its count of rows finished).  Row
  // t fetches row t + 2 into the buffer that row t - 2 used, whose last
  // access (writeback(t - 2), at the start of row t - 1) is ordered before
  // the fetch by the barrier that ends row t - 1; no thread relies on which
  // elements another thread wrote or read.
  const unsigned* other_done = done + (1 - 2 * o) * nbands + band;
  auto prefetch = [&](int s) {
    const int b = s & 3;
    const size_t r = static_cast<size_t>(row_y(s)) * W + x0;
    for (int i = tid; i < nb * 16; i += nthreads)
      cp_async16(reinterpret_cast<char*>(obuf + b * ncols * 32) + 16 * i,
                 reinterpret_cast<const char*>(a.slab + r * 128) + 16 * i);
    each_out([&](int d, int c) {
      cp_async4(ob_at(b, d, c), a.out + d * plane + r + c);
    });
  };
  // out's row of step s, summed, back to out
  auto writeback = [&](int s) {
    const int b = s & 3;
    const size_t r = static_cast<size_t>(row_y(s)) * W + x0;
    each_out([&](int d, int c) { a.out[d * plane + r + c] = *ob_at(b, d, c); });
  };

  // One row of one column: the census cost, the g directions' steps (the
  // carries entering from a neighbouring band last), the halo carries out,
  // the state, and the orientation total to the slab.  `st` is the lane's
  // offset of column cx in a state buffer, `rb` the offset of the buffer
  // row t reads, `sp` the lane's slab address on row t.  Only a band's two
  // edge columns touch the halo, on a path of their own.
  auto column_step = [&](int t, int cx, const Column& col, const int* crow_t,
                         int rb, int st, __nv_bfloat16* sp) {
    const bool in_left = t > 0 && from_left && cx == 0;
    const bool in_right = t > 0 && from_right && cx == nb - 1;
    const bool out_right = to_right && cx == nb - 1 && t + 1 < H;
    const bool out_left = to_left && cx == 0 && t + 1 < H;
    const bool halo = in_left || in_right || out_right || out_left;
    bool ext[G];
    unsigned long long hv[G][4];
#pragma unroll
    for (int k = 0; k < G; ++k)
      ext[k] = (rolls[k] > 0 && in_left) || (rolls[k] < 0 && in_right);
    auto halo_in = [&](int k) {
      return rolls[k] > 0 ? halo_at(band - 1, 0, k, t - 1)
                          : halo_at(band + 1, 1, k, t - 1);
    };
    if (halo) {
      // the carries entering from the neighbouring bands (row t - 1) go
      // out first and are checked after the other directions' steps
#pragma unroll
      for (int k = 0; k < G; ++k) {
        if (ext[k]) {
          const unsigned long long* h = halo_in(k);
#pragma unroll
          for (int j = 0; j < 4; ++j) hv[k][j] = load_tagged(h + j);
        }
      }
    }

    const int clv = crow_t[4 * q + cx];
    Planes c;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      c.v[j] = fmaxf(static_cast<float>(__popc(clv ^ crow_t[col.idx[j]])),
                     col.lo[j]);
    Planes L[G];
    auto step = [&](int k, const Planes& carry) {
      L[k] = warp_dp<BF16>(carry, c, p1v, p2v, edges);
      if (rolls[k] == 1 && col.entry) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          L[k].v[j] = col.restart[j] ? c.v[j] : L[k].v[j];
      }
    };
    auto publish = [&]() {
#pragma unroll
      for (int k = 0; k < G; ++k) {
        unsigned long long* h = nullptr;
        if (rolls[k] > 0 && out_right) h = halo_at(band, 0, k, t);
        if (rolls[k] < 0 && out_left) h = halo_at(band, 1, k, t);
        if (h != nullptr) {
#pragma unroll
          for (int j = 0; j < 4; ++j) store_tagged(h + j, L[k].v[j], t + 1);
        }
      }
    };
#pragma unroll
    for (int k = 0; k < G; ++k)
      if (!ext[k])
        step(k, load4(state + rb + st + (k * S - rolls[k]) * 128));
    if (halo) {
      // with one column a band's outgoing carries need the incoming ones
      const bool late = nb == 1;
      if ((out_right || out_left) && !late) publish();
#pragma unroll
      for (int k = 0; k < G; ++k) {
        if (!ext[k]) continue;
        const unsigned long long* h = halo_in(k);
        Planes v;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          while (static_cast<unsigned>(hv[k][j] >> 32) !=
                 static_cast<unsigned>(t))
            hv[k][j] = load_tagged(h + j);
          v.v[j] = __uint_as_float(static_cast<unsigned>(hv[k][j]));
        }
        step(k, v);
      }
      if ((out_right || out_left) && late) publish();
    }
    Planes tot;
#pragma unroll
    for (int k = 0; k < G; ++k) {
      store4(state + (GS - rb) + st + k * S * 128, L[k]);
      if (k == 0) {
        tot = L[k];
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          tot.v[j] = tot.v[j] + L[k].v[j];
          if (BF16) tot.v[j] = round_bf16(tot.v[j]);
        }
      }
    }
    if (t < first) {
      store_bf16x4(sp, tot);
    } else {
      const int b = t & 3;
      const float4 v = bf16x4_to_float4(obuf[(b * ncols + cx) * 32 + lane]);
      const float e[4] = {round_bf16(tot.v[0]) + v.x,
                          round_bf16(tot.v[1]) + v.y,
                          round_bf16(tot.v[2]) + v.z,
                          round_bf16(tot.v[3]) + v.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float* p = ob_at(b, 4 * lane + j, cx);
        *p = *p + e[j];
      }
    }
  };
  auto lane_state = [&](int cx) { return (cx + 1) * 128 + 4 * lane; };
  auto lane_slab = [&](int cx) {
    return a.slab + (static_cast<size_t>(row_y(0)) * W + x0 + cx) * 128 +
           4 * lane;
  };

  Column col;
  int st = 0;
  __nv_bfloat16* sp = nullptr;
  if (ONE) {
    col = band_column(ca, x0, D, min_d, q, lane);
    st = lane_state(ca);
    sp = lane_slab(ca);
  }
  census_fetch(0);
  asm volatile("cp.async.wait_group 0;" ::: "memory");
  __syncthreads();
  for (int t = 0; t < H; ++t) {
    // out's row of step t - 1, summed on row t - 1, back to out; no fetch of
    // this row touches its buffer
    if (t - 1 >= first) writeback(t - 1);
    if (t == first) {
      // The meeting: wait (once) for the other scan's whole first half,
      // which never waits on this scan, so neither can block the other;
      // every thread acquires it.  Then this row's and the next row's
      // fetches, complete before the row starts.
      while (load_acquire(other_done) < static_cast<unsigned>(H - first)) {
      }
      prefetch(t);
      if (t + 1 < H) prefetch(t + 1);
      asm volatile("cp.async.commit_group;" ::: "memory");
      asm volatile("cp.async.wait_group 0;" ::: "memory");
      __syncthreads();
    }
    // one group per row (row t + 2's fetch, or none), then a census chunk
    // every kRows rows
    if (t + 2 > first + 1 && t + 2 < H) prefetch(t + 2);
    asm volatile("cp.async.commit_group;" ::: "memory");
    if (t % kRows == 0) census_fetch(t / kRows + 1);
    const int* crow_t = census + ((t / kRows) & 1) * kRows * crow +
                        (t % kRows) * crow;
    const int rb = (t & 1) * GS;
    if (ONE) {
      if (ca < nb) column_step(t, ca, col, crow_t, rb, st, sp);
      sp += slab_step;
    } else {
      for (int cx = ca; cx < cb; ++cx)
        column_step(t, cx, band_column(cx, x0, D, min_d, q, lane), crow_t,
                    rb, lane_state(cx), lane_slab(cx) + t * slab_step);
    }
    // the carries a warp reads next row were written by other warps, and
    // so were the fetched rows: all but this row's groups are complete
    if (t % kRows == 0) {
      asm volatile("cp.async.wait_group 2;" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 1;" ::: "memory");
    }
    __syncthreads();
    if (tid == 0) {
      __threadfence();   // the row's slab stores before the count
      store_relaxed(done + band, t + 1);
    }
  }
  if (H - 1 >= first) writeback(H - 1);
}


// Launch a kernel whose blocks wait on each other: every block must be
// resident at once, which a cooperative launch guarantees (or refuses).
template <typename Kernel, typename Arg>
int launch_cooperative(Kernel kernel, const Arg& a, int blocks, int threads,
                       int smem, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeCooperative;
  attr.val.cooperative = 1;
  cudaLaunchConfig_t cfg{};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, kernel, a));
}

// the bands of B5 wait on each other
template <bool BF16, int G, bool ONE>
int census_y_run(const CensusY& a, int threads, int smem, cudaStream_t s) {
  return launch_cooperative(census_y_kernel<BF16, G, ONE>, a, 2 * a.nbands,
                            threads, smem, s);
}

template <bool BF16, int G, bool ONE>
int census_y_occupancy(int threads, int smem, int* n) {
  auto kernel = census_y_kernel<BF16, G, ONE>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(n, kernel, threads,
                                                        smem);
  return static_cast<int>(err);
}

// Calls f.operator()<BF16, G, ONE>() for the instantiation of (carry dtype,
// g, one column per warp).
template <class F>
int census_y_dispatch(bool bf16, int g, bool one, const F& f) {
#define SGM_Y_CASE(B, G_, O) \
  if (bf16 == B && g == G_ && one == O) return f.template operator()<B, G_, O>();
  SGM_Y_CASE(false, 1, true) SGM_Y_CASE(false, 1, false)
  SGM_Y_CASE(false, 3, true) SGM_Y_CASE(false, 3, false)
  SGM_Y_CASE(true, 1, true) SGM_Y_CASE(true, 1, false)
  SGM_Y_CASE(true, 3, true) SGM_Y_CASE(true, 3, false)
#undef SGM_Y_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

struct CensusYLaunch {
  const CensusY& a;
  int threads, smem;
  cudaStream_t s;
  template <bool B, int G, bool O>
  int operator()() const { return census_y_run<B, G, O>(a, threads, smem, s); }
};

struct CensusYOccupancy {
  int threads, smem;
  int* n;
  template <bool B, int G, bool O>
  int operator()() const { return census_y_occupancy<B, G, O>(threads, smem, n); }
};

// Bytes of B5's halo buffer: the tagged halo rings and the rows done.
size_t census_y_halo_bytes(int g, int nbands) {
  return 8 * (static_cast<size_t>(2) * nbands * 2 * g * kHaloRows * 128) +
         4 * 2 * static_cast<size_t>(nbands);
}

// Shared bytes of a B5 block: the double-buffered row state, two census
// chunks, and four rows of the other scan's totals and of out (the plan's
// census_y_plan computes the same).
size_t census_y_smem(int D, int g, int ncols) {
  const size_t q = (ncols + D - 1 + 3) / 4;
  return 4 * (static_cast<size_t>(2) * g * (ncols + 2) * 128 +
              2 * kRows * (4 * q + ncols)) +
         4 * static_cast<size_t>(ncols) * 256 +
         4 * 4 * 128 * static_cast<size_t>(ncols | 1);
}

// The roll sets B5 runs: (0) for 4 paths, (0, +1, -1) for 8.
bool census_y_rolls_ok(int g, int roll0, int roll1, int roll2) {
  return (g == 1 && roll0 == 0) ||
         (g == 3 && roll0 == 0 && roll1 == 1 && roll2 == -1);
}

// A plan's bands, checked: they cover [0, W), every band has a column, the
// warps cover the band.
bool bands_ok(int W, int nbands, int ncols, int cpw, int threads) {
  if (nbands < 1 || ncols < 1 || cpw < 1) return false;
  if (static_cast<long>(nbands) * ncols < W || (nbands - 1) * ncols >= W)
    return false;
  if (threads % 32 != 0 || threads < 32 || threads > kYThreads) return false;
  return (threads / 32) * cpw >= ncols;
}

bool census_y_geometry_ok(int W, int D, int g, int nbands, int ncols,
                          int cpw, int threads, int smem) {
  return bands_ok(W, nbands, ncols, cpw, threads) && smem <= kMaxSmem &&
         static_cast<size_t>(smem) == census_y_smem(D, g, ncols);
}

// ---------------------------------------------------------------------------
// B4 for D <= 128 (replaces _axis_call, densesurfelmapping_tpu/ops/pallas/
// sgm.py:181): the axis scan of a materialized (L, R, D) bf16 volume, out
// (L, R, D) f32 = f32(bf16(forward total)) + f32(bf16(backward total)), on
// the warp step of B5 and B6 (`warp_dp`: four planes a lane, shuffles and a
// redux, no block barrier inside a step), the directions of an orientation
// summed in registers in roll order in carry dtype and rounded once, and
// the orientations meeting at step L / 2 through a bf16 (L, R, 128) slab, so
// there is no f32 scratch and no combine pass.  The matcher's two roll sets
// have a kernel each:
//   * (0) (the x family, and the y family of 4 paths): its lines are
//     independent, so a block of two warps runs line r forward and backward
//     at once, as B6 runs an image row (axis_line_kernel);
//   * (0, +1, -1) (the y family of 8 paths): the diagonals couple the rows,
//     so each orientation runs as B5's bands, one block per SM with its
//     band's row state in shared memory and the diagonal carries crossing
//     band edges through B5's tagged ring, a cooperative launch
//     (axis_band_kernel).
// The cost comes from the volume, not a census: a step's row (t, r) is D
// contiguous bf16 values, staged by 16-byte cp.async from the chunk that
// holds its start (the row is only 2-byte aligned when D is odd), the tail
// cut at the row's end, and read back with the lane's four planes; pad
// planes (d >= D) cost +inf, as in B5/B6.  Entry restarts carry over
// exactly: entry 'x' restarts every direction of the forward orientation at
// t == d + min_d (B6's free entry), entry 'y' the roll +1 direction of both
// orientations at r == d + min_d (B5's); the diagonals restart at the
// volume's border rows through B5's zero state columns.  The first step of
// a path runs the update on a zero carry, as the plain twin does (which
// gives L = C, clamped at 9984 with bf16 carries).
// Bound on the H100: bytes.  At KITTI size (x family L 1241, R 376; y
// family L 376, R 1241; D 127) each launch reads the 118.5 MB bf16 volume
// and writes the 237 MB f32 out: 106 us at 3.35 TB/s; the slab adds 119 MB
// written and read.
// ---------------------------------------------------------------------------
constexpr int kLAhead = 6;     // steps a line's rows are fetched ahead
constexpr int kLRing = 8;      // staged rows of a line (>= kLAhead + 2)
constexpr int kLRowBytes = 272;  // one staged row: 16 ceil((14 + 256) / 16)
constexpr int kVRing = 4;      // staged band rows (fetched two ahead)

// cp.async to a shared-window address (__cvta_generic_to_shared): a loop
// that converts once keeps the conversion out of every step
__device__ __forceinline__ void cp_async16_n(unsigned dst, const void* gmem,
                                             int n) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst),
               "l"(gmem), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async8_to(unsigned dst, const void* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" ::"r"(dst),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ unsigned shared_address(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Stage `bytes` bytes from `src` (2-byte aligned) to `dst` (16-byte
// aligned) by 16-byte cp.async from the 16-byte chunk holding src, thread i
// of n taking chunks i, i + n, ...  The last chunk is cut at src + bytes
// (src-size), so nothing past the run is read; the first chunk starts at or
// before src inside the volume (its base is 16-byte aligned: the wrapper
// checks).  The run starts at bf16 element `run_offset(src)` of dst.
__device__ __forceinline__ void stage_run(void* dst, const void* src,
                                          int bytes, int i, int n) {
  const uintptr_t b = reinterpret_cast<uintptr_t>(src);
  const char* a = reinterpret_cast<const char*>(b & ~uintptr_t{15});
  const int end = static_cast<int>(b & 15) + bytes;
  const unsigned d = shared_address(dst);
  for (int c = i; 16 * c < end; c += n)
    cp_async16_n(d + 16 * c, a + 16 * c, min(16, end - 16 * c));
}

__device__ __forceinline__ int run_offset(const void* src) {
  return static_cast<int>(reinterpret_cast<uintptr_t>(src) & 15) >> 1;
}

// The lane's planes d = 4 lane + j of a staged bf16 row; +inf on pads.
__device__ __forceinline__ Planes volume_cost(const unsigned short* row,
                                              int D, int lane) {
  Planes c;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int d = 4 * lane + j;
    c.v[j] = d < D ? __uint_as_float(static_cast<unsigned>(row[d]) << 16)
                   : CUDART_INF_F;
  }
  return c;
}

// f32(bf16(own)) + f32(other) of the lane's planes d = 4 lane + j < D to
// out's row, straight from registers (a store staged for coalescing cost a
// third more time in the line kernel on the H100).
__device__ __forceinline__ void store_sum(float* out_row, const Planes& own,
                                          uint2 other, int D, int lane) {
  const float4 w = bf16x4_to_float4(other);
  const float e[4] = {round_bf16(own.v[0]) + w.x, round_bf16(own.v[1]) + w.y,
                      round_bf16(own.v[2]) + w.z, round_bf16(own.v[3]) + w.w};
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (4 * lane + j < D) out_row[4 * lane + j] = e[j];
}

__device__ __forceinline__ Planes zero_carry(int D, int lane) {
  Planes z;
#pragma unroll
  for (int j = 0; j < 4; ++j) z.v[j] = 4 * lane + j < D ? 0.0f : CUDART_INF_F;
  return z;
}

// One block of two warps per line r: warp 0 runs it forward, warp 1
// backward.  Step s's row is fetched kLAhead steps ahead into a ring (one
// cp.async group per step; lanes 0-16 copy its chunks); in the second half
// the other warp's bf16 totals come in the same group (the first kLAhead of
// them in groups of their own once the first halves are done).  A step
// costs what the warp issues more than its DP chain (about 500 cycles a
// step at KITTI size on the H100, where the chain is under 100), so the
// row, slab and out addresses advance by a stride (no 64-bit index
// products a step), shared addresses are converted once, and each lane
// stores its four planes of out straight from registers (store_sum).
// Measured there
// (experiments/torch_sgm_time.py): a staged, coalesced out store cost a
// third more time, steps run in fenced chunks of four 38% more, and
// fetching 12 or 24 steps ahead instead of 6 up to 5% more.
template <bool BF16>
__global__ void __launch_bounds__(64)
    axis_line_kernel(const __nv_bfloat16* __restrict__ v,
                     float* __restrict__ out, __nv_bfloat16* __restrict__ slab,
                     int L, int R, int D, float p1, float p2, int entry_x,
                     int min_d) {
  __shared__ __align__(16) unsigned char s_rows[2][kLRing][kLRowBytes];
  __shared__ uint2 s_other[2][kLRing][32];
  const int o = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool fwd = o == 0;
  const int first = fwd ? L >> 1 : L - (L >> 1);  // steps before the meeting
  // step 0's row, and the element strides from a step's row to the next
  const size_t row0 = static_cast<size_t>(fwd ? 0 : L - 1) * R + blockIdx.x;
  const long long vstride = (fwd ? 1LL : -1LL) * R * D;
  const long long sstride = (fwd ? 1LL : -1LL) * R * 128;
  const float p1v = BF16 ? round_bf16(p1) : p1;
  const float p2v = BF16 ? round_bf16(p2) : p2;
  const Edges edges = lane_edges(lane);
  const unsigned char* rows = s_rows[o][0];
  const uint2* others = s_other[o][0] + lane;
  const unsigned rows_s = shared_address(rows) + 16 * lane;
  const unsigned others_s = shared_address(others);
  // the next row and other total to fetch, and their steps
  const __nv_bfloat16* vf = v + row0 * D;
  const __nv_bfloat16* of = slab + row0 * 128 + 4 * lane;
  int sf = 0, so = 0;
  auto fetch_row = [&]() {
    if (sf < L) {
      const uintptr_t b = reinterpret_cast<uintptr_t>(vf);
      const int end = static_cast<int>(b & 15) + 2 * D;
      if (16 * lane < end)
        cp_async16_n(rows_s + (sf & (kLRing - 1)) * kLRowBytes,
                     reinterpret_cast<const char*>(b & ~uintptr_t{15}) +
                         16 * lane,
                     min(16, end - 16 * lane));
    }
    vf += vstride;
    ++sf;
  };
  auto fetch_other = [&]() {
    if (so < L) cp_async8_to(others_s + (so & (kLRing - 1)) * 32 * 8, of);
    of += sstride;
    ++so;
  };
  // step s's row, slab and out addresses
  const __nv_bfloat16* vs = v + row0 * D;
  __nv_bfloat16* ss = slab + row0 * 128 + 4 * lane;
  float* os = out + row0 * D;
  Planes Lc = zero_carry(D, lane);
  // wait for step s's group (kLAhead younger ones may be in flight), then
  // the step; every lane commits every group
  auto step = [&](int s) {
    asm volatile("cp.async.wait_group %0;" ::"n"(kLAhead) : "memory");
    __syncwarp();
    const Planes c = volume_cost(
        reinterpret_cast<const unsigned short*>(
            rows + (s & (kLRing - 1)) * kLRowBytes) + run_offset(vs),
        D, lane);
    Lc = warp_dp<BF16>(Lc, c, p1v, p2v, edges);
    if (entry_x && fwd && entry_column(s, min_d))
      entry_restart(Lc, c, s, min_d, lane);
    vs += vstride;
  };
  for (int s = 0; s < kLAhead; ++s) {
    fetch_row();
    cp_async_commit();
  }
  for (int s = 0; s < first; ++s) {
    fetch_row();
    cp_async_commit();
    step(s);
    store_bf16x4(ss, Lc);
    ss += sstride;
    os += vstride;
  }
  // the other warp's first half is in the slab
  __syncthreads();
  of += first * sstride;   // step first's row of the slab
  so = first;
  for (int s = first; s < first + kLAhead; ++s) {
    fetch_other();
    cp_async_commit();
  }
  for (int s = first; s < L; ++s) {
    fetch_row();
    fetch_other();
    cp_async_commit();
    step(s);
    store_sum(os, Lc, others[(s & (kLRing - 1)) * 32], D, lane);
    os += vstride;
  }
}

struct AxisBand {
  const __nv_bfloat16* v;
  float* out;
  __nv_bfloat16* slab;
  // B5's layout for g = 3: [2 o][nbands][2 side][3][kHaloRows][128] tagged
  // carries, then [2 o][nbands] rows done (u32); zeroed before the launch
  unsigned long long* halo;
  int L, R, D, min_d, ncols, cpw, nbands, entry;
  float p1, p2;
};

// Bytes of a staged band row: ncols D bf16 from the chunk holding its start.
__host__ __device__ inline int band_row_bytes(int ncols, int D) {
  return 16 * ((2 * ncols * D + 29) / 16);
}

// Shared bytes of a B4 band block: the double-buffered row state, kVRing
// staged volume rows and four rows of the other orientation's totals (the
// plan's axis_plan computes the same).
size_t axis_band_smem(int D, int ncols) {
  return 4 * (static_cast<size_t>(2) * 3 * (ncols + 2) * 128) +
         static_cast<size_t>(kVRing) * band_row_bytes(ncols, D) +
         static_cast<size_t>(4) * ncols * 256;
}

// The rolls of the band kernel's directions, in roll order.
__device__ __forceinline__ int band_roll(int k) {
  return k == 0 ? 0 : (k == 1 ? 1 : -1);
}

// B5's structure (see census_y_kernel) with the cost of a staged volume row
// and out written, not added: each orientation's scan runs down axis 0 as
// `nbands` bands of rows (volume axis 1), one block each, the row state of
// the three directions in shared memory, the diagonal carries that leave a
// band through the tagged halo ring, one block barrier per step.  Step t's
// band row of the volume (ncols D contiguous bf16) is staged two steps
// ahead; in the second half so are the other orientation's totals of the
// band's rows, and each warp writes f32(own) + f32(other) of its rows.
template <bool BF16>
__global__ void __launch_bounds__(kYThreads, 1)
    axis_band_kernel(const AxisBand a) {
  constexpr int G = 3;
  const int nbands = a.nbands;
  const int o = blockIdx.x / nbands;        // 0 forward, 1 backward
  const int band = blockIdx.x - o * nbands;
  const int L = a.L, R = a.R, D = a.D, min_d = a.min_d, ncols = a.ncols;
  const int x0 = band * ncols;
  const int nb = min(ncols, R - x0);        // rows of this band
  const int S = ncols + 2;                  // state columns: halo, band, halo
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int ca = warp * a.cpw, cb = min(nb, ca + a.cpw);  // warp's rows
  // halo sides as in B5: side 0 carries the roll +1 carries of a band's
  // last row to the band after it, side 1 the roll -1 carries of its first
  // row to the band before it
  const bool from_left = band > 0, from_right = band < nbands - 1;
  const bool to_right = from_right, to_left = from_left;
  auto halo_at = [&](int bnd, int side, int k, int t) {
    return a.halo +
           ((((static_cast<size_t>(o) * nbands + bnd) * 2 + side) * G + k) *
                kHaloRows +
            t % kHaloRows) *
               128 +
           4 * lane;
  };
  unsigned* done = reinterpret_cast<unsigned*>(
                       a.halo + static_cast<size_t>(2) * nbands * 2 * G *
                                    kHaloRows * 128) +
                   o * nbands;

  extern __shared__ __align__(16) float smem_b[];
  float* state = smem_b;                                    // [2][G][S][128]
  const int row_bytes = band_row_bytes(ncols, D);
  unsigned char* vrows =                                    // [kVRing][row_bytes]
      reinterpret_cast<unsigned char*>(state + 2 * G * S * 128);
  uint2* obuf = reinterpret_cast<uint2*>(vrows + kVRing * row_bytes);  // [4][ncols][32]
  for (int i = tid; i < 2 * G * S * 128; i += nthreads)
    state[i] = (i & 127) < D ? 0.0f : CUDART_INF_F;
  auto row_y = [&](int t) { return o == 0 ? t : L - 1 - t; };
  auto band_row = [&](int t) {
    return a.v + (static_cast<size_t>(row_y(t)) * R + x0) * D;
  };
  auto vfetch = [&](int t) {
    if (t < L)
      stage_run(vrows + (t % kVRing) * row_bytes, band_row(t), 2 * nb * D,
                tid, nthreads);
  };
  // step s's other totals of the band's rows into buffer s & 3
  auto prefetch = [&](int s) {
    const int b = s & 3;
    const size_t r = static_cast<size_t>(row_y(s)) * R + x0;
    for (int i = tid; i < nb * 16; i += nthreads)
      cp_async16(reinterpret_cast<char*>(obuf + b * ncols * 32) + 16 * i,
                 reinterpret_cast<const char*>(a.slab + r * 128) + 16 * i);
  };

  const float p1v = BF16 ? round_bf16(a.p1) : a.p1;
  const float p2v = BF16 ? round_bf16(a.p2) : a.p2;
  const Edges edges = lane_edges(lane);
  const int GS = G * S * 128;               // floats of one state buffer
  const int first = o == 0 ? L / 2 : L - L / 2;   // steps before the meeting
  const unsigned* other_done = done + (1 - 2 * o) * nbands + band;

  // Step t of band row cx (volume row x = x0 + cx), as B5's column_step.
  auto row_step = [&](int t, int cx, int rb, const unsigned short* vrow) {
    const int x = x0 + cx;
    const bool in_left = t > 0 && from_left && cx == 0;
    const bool in_right = t > 0 && from_right && cx == nb - 1;
    const bool out_right = to_right && cx == nb - 1 && t + 1 < L;
    const bool out_left = to_left && cx == 0 && t + 1 < L;
    const bool halo = in_left || in_right || out_right || out_left;
    bool ext[G];
    unsigned long long hv[G][4];
#pragma unroll
    for (int k = 0; k < G; ++k)
      ext[k] = (band_roll(k) > 0 && in_left) || (band_roll(k) < 0 && in_right);
    auto halo_in = [&](int k) {
      return band_roll(k) > 0 ? halo_at(band - 1, 0, k, t - 1)
                              : halo_at(band + 1, 1, k, t - 1);
    };
    if (halo) {
#pragma unroll
      for (int k = 0; k < G; ++k) {
        if (ext[k]) {
          const unsigned long long* h = halo_in(k);
#pragma unroll
          for (int j = 0; j < 4; ++j) hv[k][j] = load_tagged(h + j);
        }
      }
    }
    const Planes c = volume_cost(vrow + cx * D, D, lane);
    const bool restart_x = a.entry == 1 && o == 0 && entry_column(t, min_d);
    const bool restart_y = a.entry == 2 && entry_column(x, min_d);
    Planes Lk[G];
    auto step = [&](int k, const Planes& carry) {
      Lk[k] = warp_dp<BF16>(carry, c, p1v, p2v, edges);
      if (restart_x) entry_restart(Lk[k], c, t, min_d, lane);
      if (restart_y && band_roll(k) == 1) entry_restart(Lk[k], c, x, min_d, lane);
    };
    auto publish = [&]() {
#pragma unroll
      for (int k = 0; k < G; ++k) {
        unsigned long long* h = nullptr;
        if (band_roll(k) > 0 && out_right) h = halo_at(band, 0, k, t);
        if (band_roll(k) < 0 && out_left) h = halo_at(band, 1, k, t);
        if (h != nullptr) {
#pragma unroll
          for (int j = 0; j < 4; ++j) store_tagged(h + j, Lk[k].v[j], t + 1);
        }
      }
    };
    const int st = (cx + 1) * 128 + 4 * lane;
#pragma unroll
    for (int k = 0; k < G; ++k)
      if (!ext[k])
        step(k, load4(state + rb + st + (k * S - band_roll(k)) * 128));
    if (halo) {
      // with one row a band's outgoing carries need the incoming ones
      const bool late = nb == 1;
      if ((out_right || out_left) && !late) publish();
#pragma unroll
      for (int k = 0; k < G; ++k) {
        if (!ext[k]) continue;
        const unsigned long long* h = halo_in(k);
        Planes hc;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          while (static_cast<unsigned>(hv[k][j] >> 32) !=
                 static_cast<unsigned>(t))
            hv[k][j] = load_tagged(h + j);
          hc.v[j] = __uint_as_float(static_cast<unsigned>(hv[k][j]));
        }
        step(k, hc);
      }
      if ((out_right || out_left) && late) publish();
    }
    Planes tot;
#pragma unroll
    for (int k = 0; k < G; ++k) {
      store4(state + (GS - rb) + st + k * S * 128, Lk[k]);
      if (k == 0) {
        tot = Lk[k];
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          tot.v[j] = tot.v[j] + Lk[k].v[j];
          if (BF16) tot.v[j] = round_bf16(tot.v[j]);
        }
      }
    }
    const size_t row = static_cast<size_t>(row_y(t)) * R + x;
    if (t < first) {
      store_bf16x4(a.slab + row * 128 + 4 * lane, tot);
    } else {
      store_sum(a.out + row * D, tot,
                obuf[((t & 3) * ncols + cx) * 32 + lane], D, lane);
    }
  };

  vfetch(0);
  cp_async_commit();
  vfetch(1);
  cp_async_commit();
  asm volatile("cp.async.wait_group 1;" ::: "memory");
  __syncthreads();
  for (int t = 0; t < L; ++t) {
    if (t == first) {
      // the meeting, as in B5: wait once for the other scan's first half,
      // then this step's and the next step's other totals
      while (load_acquire(other_done) < static_cast<unsigned>(L - first)) {
      }
      prefetch(t);
      if (t + 1 < L) prefetch(t + 1);
      cp_async_commit();
      asm volatile("cp.async.wait_group 0;" ::: "memory");
      __syncthreads();
    }
    // one group per step: step t + 2's band row (and other totals)
    vfetch(t + 2);
    if (t >= first && t + 2 < L) prefetch(t + 2);
    cp_async_commit();
    const unsigned short* vrow =
        reinterpret_cast<const unsigned short*>(vrows +
                                                (t % kVRing) * row_bytes) +
        run_offset(band_row(t));
    const int rb = (t & 1) * GS;
    for (int cx = ca; cx < cb; ++cx) row_step(t, cx, rb, vrow);
    // step t + 1's group is complete; the barrier shows it, and this step's
    // state, to every warp
    asm volatile("cp.async.wait_group 1;" ::: "memory");
    __syncthreads();
    if (tid == 0) {
      __threadfence();   // the step's slab stores before the count
      store_relaxed(done + band, t + 1);
    }
  }
}

}  // namespace

extern "C" {

// B4 for 128 < D <= 1024: PR 2's line kernel and combine pass over an f32
// scratch of 2 * g * L * R * D floats (any roll set of 1-3 shifts).
int sgm_axis_lines(const void* v, float* scratch, float* out, int L, int R,
                   int D, int g, int roll0, int roll1, int roll2, float p1,
                   float p2, int carry_bf16, int entry, int min_d,
                   void* stream) {
  if (D < 1 || D > kMaxThreads || g < 1 || g > 3) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const VolumeCost cost{static_cast<const __nv_bfloat16*>(v), R, D};
  const int threads = line_threads(D);
  const dim3 grid(R + L - 1, 2 * g);
  if (carry_bf16) {
    scan_lines_kernel<VolumeCost, true>
        <<<grid, threads, line_smem(threads), s>>>(
            cost, scratch, L, R, D, g, roll0, roll1, roll2, p1, p2, entry,
            min_d);
  } else {
    scan_lines_kernel<VolumeCost, false>
        <<<grid, threads, line_smem(threads), s>>>(
            cost, scratch, L, R, D, g, roll0, roll1, roll2, p1, p2, entry,
            min_d);
  }
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

// B4 for D <= 128 -> f32 out (L, R, D).  slab: bf16 (L, R, 128).  Rolls (0):
// axis_line_kernel, R blocks of 64 threads (the geometry arguments
// are not read).  Rolls
// (0, +1, -1): axis_band_kernel, 2 * nbands blocks of `threads` threads
// with `smem` bytes (the plan's), halo: census_y_halo_bytes(3, nbands)
// bytes, zeroed here.  v must be 16-byte aligned.
int sgm_axis_warp(const void* v, float* out, void* slab, void* halo, int L,
                  int R, int D, int g, int roll0, int roll1, int roll2,
                  float p1, float p2, int carry_bf16, int entry, int min_d,
                  int nbands, int ncols, int cpw, int threads, int smem,
                  void* stream) {
  if (D < 1 || D > 128 || L < 1 || R < 1 || entry < 0 || entry > 2 ||
      !census_y_rolls_ok(g, roll0, roll1, roll2) ||
      reinterpret_cast<uintptr_t>(v) % 16 != 0)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* vb = static_cast<const __nv_bfloat16*>(v);
  auto* sl = static_cast<__nv_bfloat16*>(slab);
  if (g == 1) {
    auto kernel =
        carry_bf16 ? axis_line_kernel<true> : axis_line_kernel<false>;
    kernel<<<R, 64, 0, s>>>(vb, out, sl, L, R, D, p1, p2, entry == 1,
                            min_d);
    return static_cast<int>(cudaGetLastError());
  }
  if (!bands_ok(R, nbands, ncols, cpw, threads) || smem > kMaxSmem ||
      static_cast<size_t>(smem) != axis_band_smem(D, ncols))
    return cudaErrorInvalidValue;
  const cudaError_t err =
      cudaMemsetAsync(halo, 0, census_y_halo_bytes(3, nbands), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const AxisBand a{vb, out, sl, static_cast<unsigned long long*>(halo), L, R,
                   D, min_d, ncols, cpw, nbands, entry, p1, p2};
  return carry_bf16 ? launch_cooperative(axis_band_kernel<true>, a,
                                         2 * nbands, threads, smem, s)
                    : launch_cooperative(axis_band_kernel<false>, a,
                                         2 * nbands, threads, smem, s);
}

// B6: the x family of the census aggregate, written to out (D, H, W).
// slab: bf16 (H, W, 128); smem: census_x_smem(W) bytes.
int sgm_census_x(const int* cl, const int* cr, float* out, void* slab, int H,
                 int W, int D, float p1, float p2, int min_d, int carry_bf16,
                 int smem, void* stream) {
  if (D < 1 || D > 128 || H < 1 || W < 1 ||
      static_cast<size_t>(smem) != census_x_smem(W) || smem > kMaxSmem)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* sl = static_cast<__nv_bfloat16*>(slab);
  auto kernel = carry_bf16 ? census_x_kernel<true> : census_x_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<H, 64, smem, s>>>(cl, cr, out, sl, H, W, D, p1, p2, min_d);
  return static_cast<int>(cudaGetLastError());
}

// B5: the y family (vertical + diagonals) of the census aggregate, added to
// out (D, H, W), which holds the x family.  slab: bf16 (H, W, 128); halo:
// census_y_halo_bytes(g, nbands) bytes, zeroed here; the geometry (nbands
// bands of ncols columns, cpw columns per warp, threads, smem) is the plan's.
int sgm_census_y(const int* cl, const int* cr, float* out, void* slab,
                 void* halo, int H, int W, int D, int g,
                 int roll0, int roll1, int roll2, float p1, float p2,
                 int min_d, int carry_bf16, int nbands, int ncols, int cpw,
                 int threads, int smem, void* stream) {
  if (D < 1 || D > 128 || H < 1 ||
      !census_y_rolls_ok(g, roll0, roll1, roll2) ||
      !census_y_geometry_ok(W, D, g, nbands, ncols, cpw, threads, smem))
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(halo, 0, census_y_halo_bytes(g, nbands),
                                    s);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto* sl = static_cast<__nv_bfloat16*>(slab);
  CensusY a{cl, cr, out, sl, static_cast<unsigned long long*>(halo), H, W,
            D, min_d, ncols, cpw, nbands, {roll0, roll1, roll2}, p1, p2};
  return census_y_dispatch(carry_bf16 != 0, g, cpw == 1,
                           CensusYLaunch{a, threads, smem, s});
}

// How many B5 blocks of this geometry one SM holds at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor); the cooperative launch
// needs all 2 * nbands resident.
int sgm_census_y_occupancy(int D, int g, int carry_bf16, int cpw,
                           int threads, int smem, int* n) {
  if (D < 1 || D > 128 || (g != 1 && g != 3) || cpw < 1)
    return cudaErrorInvalidValue;
  return census_y_dispatch(carry_bf16 != 0, g, cpw == 1,
                           CensusYOccupancy{threads, smem, n});
}

}  // extern "C"
