// The per-seed plane fit for Hopper (sm_90a): each seed's window, gates and
// five Huber Gauss-Newton steps in one launch.  Plain C entry point, loaded
// with ctypes by densesurfelmapping_tpu_torch/ops/cuda/planefit.py; it
// launches on the caller's stream and returns cudaGetLastError().
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        --fmad=false -shared -Xcompiler -fPIC
// --fmad=false: every elementwise step rounds as the plain twin's op does.
//
// Semantics are those of the plain twin, `ops/normals.py::seed_plane_fields`
// (the reference's `calculate_sp_depth_norms_kernel` with `get_huber_norm`,
// fusion_functions.cpp:792-914 and :104-188, and the pixel normals of
// `calculate_pixels_norms_kernel`, :664-712).  The kernel replaces no TPU
// kernel: the JAX package runs the plane fit as plain XLA
// (densesurfelmapping_tpu/ops/normals.py).  The twin is ~2,000 small
// PyTorch ops a frame: the space map and the pixel normals over the frame,
// nine (R, C, 4 sp^2) window copies, the gates, and five Gauss-Newton steps
// each of ~45 elementwise ops, 14 window sums and a 4 x 4 cofactor solve of
// ~275 ops.  Here a warp takes a seed and nothing is materialized:
//
// 1. Lane l walks the seed's 2sp x 2sp window pixels l + 32 j (row-major in
//    the window), straight from the padded depth and assignment planes.  A
//    pixel inside the raw image (last row and column included) whose
//    assignment is the seed is a member (its squared distance to the seed's
//    centroid enters max_dist); a member with depth > 0.05 counts in nd; one
//    whose depth lies within huber_range of the seed's mean depth is an
//    inlier (ni).  For an inlier the lane back-projects the pixel, adds the
//    point to the point sum, computes its right x down cross-product normal
//    from the neighbours' depths with the view-angle and interior gates, and
//    adds it to the normal sum; a ballot appends the point to the warp's
//    inlier list in shared memory, in window order.
// 2. Butterflies leave nd, ni, max_dist and the two sums in every lane.  A
//    seed that fails the gates (nd >= 16, ni / nd >= 0.8, a non-zero normal
//    sum) keeps its fields and skips the fit (warp-uniform).
// 3. The list is centred on its mean; each Gauss-Newton step walks it (~ni /
//    32 entries a lane) for the residual, the Huber weights and the 4 + 10
//    sums of the normal equations, reduces them by butterflies, and every
//    lane solves the damped 4 x 4 system by the twin's cofactor expansion
//    in registers and takes the step.
// 4. Lane 0 uncentres the plane, projects the seed's centroid onto it,
//    orients the normal toward the camera and writes the five fields.
//
// Sums are taken in this kernel's order (per lane in window order, then a
// butterfly), not in torch.sum's: the fit is not bitwise to the twin; the
// counts, max_dist and the gates that decide a seed's `ok` are.  Scalar
// divisions the twin does by a Python float (x / fx) are the multiply by the
// f32 reciprocal that PyTorch-CUDA computes for them.
//
// Stream axis: blockIdx.z is the stream; its pixel planes start z * h * w
// elements and its seed planes z * n_seeds (x 3 for the vectors) elements
// after the first.  nb = 1 is the single-frame launch.
//
// Column slabs (`parallel/frame_sharding.py`): the planes may be a slab of
// the frame's columns whose seed column 0 is the frame's seed column col0
// (pixel column col0 * sp; negative in the first slab's halo).  Pixel
// coordinates, the in-image and interior tests and the back-projection are
// the frame's; a seed's flat id is r * grid_cols + (col0 + c), or -1 off the
// frame's grid; a window pixel outside the slab reads depth 0 and
// assignment 0, and a right neighbour outside it depth 0, as the twin's
// zero padding gives.  A whole frame is col0 = 0, grid_cols = cols.
// Bound on the H100: memory, 3.9 MB of depth and assignment planes a KITTI
// frame and ~0.4 MB of seed fields; ~0.45 GFLOP of Gauss-Newton steps.

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kSeeds = 8;  // warps (seeds) of a block, planefit.py SEEDS

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// clamp_min(v, 1e-20) as torch takes it: NaN stays NaN
__device__ __forceinline__ float clamp_tiny(float v) {
  return v < 1e-20f ? 1e-20f : v;
}

// sqrt of the sum of squares, summed in the twin's order over the last axis
__device__ __forceinline__ float norm3(float a, float b, float c) {
  return sqrtf((a * a + b * b) + c * c);
}

__device__ __forceinline__ float dot3(float a0, float a1, float a2, float b0,
                                      float b1, float b2) {
  return (a0 * b0 + a1 * b1) + a2 * b2;
}

struct Camera {
  float inv_fx, inv_fy, cx, cy;
};

// back_project: ((u - cx) / fx * d, (v - cy) / fy * d, d)
__device__ __forceinline__ float3 back_project(const Camera& cam, float u,
                                               float v, float d) {
  return make_float3((u - cam.cx) * cam.inv_fx * d,
                     (v - cam.cy) * cam.inv_fy * d, d);
}

// The damped 4 x 4 solve of `ops/normals.py::_solve4`, term for term: the
// cofactors by 3 x 3 determinants, the determinant along row 0, and
// x = adj(H) b / det.
__device__ __forceinline__ float det3(const float (&m)[4][4], int r0, int r1,
                                      int r2, int c0, int c1, int c2) {
  return m[r0][c0] * (m[r1][c1] * m[r2][c2] - m[r1][c2] * m[r2][c1]) -
         m[r0][c1] * (m[r1][c0] * m[r2][c2] - m[r1][c2] * m[r2][c0]) +
         m[r0][c2] * (m[r1][c0] * m[r2][c1] - m[r1][c1] * m[r2][c0]);
}

__device__ __forceinline__ void solve4(const float (&m)[4][4],
                                       const float (&b)[4], float (&x)[4]) {
  float cof[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r0 = i == 0 ? 1 : 0, r1 = i <= 1 ? 2 : 1, r2 = i <= 2 ? 3 : 2;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c0 = j == 0 ? 1 : 0, c1 = j <= 1 ? 2 : 1, c2 = j <= 2 ? 3 : 2;
      const float minor = det3(m, r0, r1, r2, c0, c1, c2);
      cof[i][j] = (i + j) % 2 == 0 ? minor : -minor;
    }
  }
  const float det = ((m[0][0] * cof[0][0] + m[0][1] * cof[0][1]) +
                     m[0][2] * cof[0][2]) + m[0][3] * cof[0][3];
  const float inv_det = 1.0f / det;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    x[i] = (((cof[0][i] * b[0] + cof[1][i] * b[1]) + cof[2][i] * b[2]) +
            cof[3][i] * b[3]) * inv_det;
}

// The pixel normal at frame pixel (px, py), plane column lx, of depth d
// (`pixel_normals`): the normalised cross product (right - me) x
// (down - me), kept where the pixel is interior (rows and columns
// 1 .. size - 2), the three depths are >= 0.1 and the view-angle
// |n . me| / |me| >= max_angle_cos; else zero.
__device__ __forceinline__ float3 pixel_normal(
    const float* __restrict__ depth, int w, int oh, int ow, int px, int py,
    int lx, float d, float3 me, const Camera& cam, float max_angle_cos) {
  const float3 zero = make_float3(0.0f, 0.0f, 0.0f);
  if (py < 1 || py >= oh - 1 || px < 1 || px >= ow - 1 || lx + 1 >= w)
    return zero;
  const size_t at = static_cast<size_t>(py) * w + lx;
  const float dr = depth[at + 1], dd = depth[at + w];
  const float3 r = back_project(cam, static_cast<float>(px + 1),
                                static_cast<float>(py), dr);
  const float3 dn = back_project(cam, static_cast<float>(px),
                                 static_cast<float>(py + 1), dd);
  const float a0 = r.x - me.x, a1 = r.y - me.y, a2 = r.z - me.z;
  const float b0 = dn.x - me.x, b1 = dn.y - me.y, b2 = dn.z - me.z;
  float n0 = a1 * b2 - a2 * b1, n1 = a2 * b0 - a0 * b2,
        n2 = a0 * b1 - a1 * b0;
  const float len = clamp_tiny(norm3(n0, n1, n2));
  n0 = n0 / len;
  n1 = n1 / len;
  n2 = n2 / len;
  const float view = dot3(n0, n1, n2, me.x, me.y, me.z) /
                     clamp_tiny(norm3(me.x, me.y, me.z));
  const bool keep = d >= 0.1f && dr >= 0.1f && dd >= 0.1f &&
                    fabsf(view) >= max_angle_cos;
  return keep ? make_float3(n0, n1, n2) : zero;
}

// One warp per seed, kSeeds seeds a block; blockIdx.z the stream.  Shared
// memory: each warp's inlier list, three planes of 4 sp^2 floats.
__global__ void __launch_bounds__(kSeeds * 32) planefit_kernel(
    const float* __restrict__ depth, const int* __restrict__ assignment,
    const float* __restrict__ seed_x, const float* __restrict__ seed_y,
    const float* __restrict__ seed_md, const float* __restrict__ norm_in,
    const float* __restrict__ pos_in, const float* __restrict__ vc_in,
    const float* __restrict__ size_in, float* __restrict__ norm_out,
    float* __restrict__ pos_out, float* __restrict__ md_out,
    float* __restrict__ vc_out, float* __restrict__ size_out, int h, int w,
    int cols, int n_seeds, int oh, int ow, int sp, int col0, int grid_cols,
    Camera cam, float hr, float max_angle_cos) {
  const size_t px0 = static_cast<size_t>(blockIdx.z) * h * w;
  const size_t sd0 = static_cast<size_t>(blockIdx.z) * n_seeds;
  depth += px0;
  assignment += px0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = static_cast<int>(blockIdx.x) * kSeeds + warp;
  if (b >= n_seeds) return;  // the whole warp: no barrier follows
  const size_t s = sd0 + b;

  const int side = 2 * sp, k_win = side * side;
  extern __shared__ float s_list[];
  float* lx = s_list + warp * 3 * k_win;
  float* ly = lx + k_win;
  float* lz = ly + k_win;

  const int r = b / cols, gc = col0 + b - r * cols;  // the frame's column
  const int fid = gc >= 0 && gc < grid_cols ? r * grid_cols + gc : -1;
  const int xorg = col0 * sp;  // the frame's column of plane column 0
  const int y0 = r * sp - sp / 2, x0 = gc * sp - sp / 2;
  const float sx = seed_x[s], sy = seed_y[s], md = seed_md[s];

  // 1. the window walk
  const unsigned below = (1u << lane) - 1u;
  int nd = 0, ni = 0, n = 0;
  float max_dist = 0.0f;
  float sn0 = 0.0f, sn1 = 0.0f, sn2 = 0.0f;   // inlier normal sum
  float sp0 = 0.0f, sp1 = 0.0f, sp2 = 0.0f;   // inlier point sum
  for (int t0 = 0; t0 < k_win; t0 += 32) {
    const int t = t0 + lane;
    const int py = y0 + t / side, px = x0 + t % side;
    bool inl = false;
    float3 p = make_float3(0.0f, 0.0f, 0.0f);
    if (t < k_win && py >= 0 && py < oh && px >= 0 && px < ow) {
      const int lx = px - xorg;
      const bool in_plane = lx >= 0 && lx < w;
      const size_t at = static_cast<size_t>(py) * w + lx;
      if ((in_plane ? assignment[at] : 0) == fid) {
        const float ex = static_cast<float>(px) - sx;
        const float ey = static_cast<float>(py) - sy;
        max_dist = fmaxf(max_dist, ex * ex + ey * ey);
        const float d = in_plane ? depth[at] : 0.0f;
        if (d > 0.05f) {
          ++nd;
          const float res = md - d;
          inl = res < hr && res > -hr;
        }
        if (inl) {
          ++ni;
          p = back_project(cam, static_cast<float>(px),
                           static_cast<float>(py), d);
          sp0 += p.x;
          sp1 += p.y;
          sp2 += p.z;
          const float3 nrm = pixel_normal(depth, w, oh, ow, px, py, lx, d,
                                          p, cam, max_angle_cos);
          sn0 += nrm.x;
          sn1 += nrm.y;
          sn2 += nrm.z;
        }
      }
    }
    const unsigned vote = __ballot_sync(kFull, inl);
    if (inl) {
      const int i = n + __popc(vote & below);
      lx[i] = p.x;
      ly[i] = p.y;
      lz[i] = p.z;
    }
    n += __popc(vote);
  }

  // 2. the gates
  nd = warp_sum(nd);
  ni = warp_sum(ni);
  max_dist = warp_max(max_dist);
  sn0 = warp_sum(sn0);
  sn1 = warp_sum(sn1);
  sn2 = warp_sum(sn2);
  const float fnd = static_cast<float>(nd), fni = static_cast<float>(ni);
  const float nlen = norm3(sn0, sn1, sn2);
  const bool ok = fnd >= 16.0f && fni / fmaxf(fnd, 1.0f) >= 0.8f &&
                  nlen > 1e-20f;
  if (!ok) {
    if (lane == 0) {
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        norm_out[3 * s + i] = norm_in[3 * s + i];
        pos_out[3 * s + i] = pos_in[3 * s + i];
      }
      md_out[s] = md;
      vc_out[s] = vc_in[s];
      size_out[s] = size_in[s];
    }
    return;
  }
  sp0 = warp_sum(sp0);
  sp1 = warp_sum(sp1);
  sp2 = warp_sum(sp2);
  const float cnt = fmaxf(fni, 1.0f);
  const float m0 = sp0 / cnt, m1 = sp1 / cnt, m2 = sp2 / cnt;
  const float len = clamp_tiny(nlen);
  float nv[4] = {sn0 / len, sn1 / len, sn2 / len, 0.0f};  // n_avg, nb = 0

  // 3. the Gauss-Newton steps over the centred inlier list
  __syncwarp();
  for (int i = lane; i < n; i += 32) {
    lx[i] = lx[i] - m0;
    ly[i] = ly[i] - m1;
    lz[i] = lz[i] - m2;
  }
  __syncwarp();
  for (int it = 0; it < 5; ++it) {
    float jac[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    float hs[10] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f,
                    0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    for (int i = lane; i < n; i += 32) {
      const float a[4] = {lx[i], ly[i], lz[i], 1.0f};
      float res = a[0] * nv[0];
      res = res + a[1] * nv[1];
      res = res + a[2] * nv[2];
      res = res + a[3] * nv[3];
      const bool in = res < hr && res > -hr;
      const float jw = in ? 2.0f * res
                          : (res >= hr ? hr : (res <= -hr ? -hr : 0.0f));
      const float hw = in ? 2.0f : 0.0f;
#pragma unroll
      for (int p = 0; p < 4; ++p) jac[p] += a[p] * jw;
      int q = 0;
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const float hwp = hw * a[p];
#pragma unroll
        for (int o = p; o < 4; ++o) hs[q++] += hwp * a[o];
      }
    }
#pragma unroll
    for (int p = 0; p < 4; ++p) jac[p] = warp_sum(jac[p]);
#pragma unroll
    for (int q = 0; q < 10; ++q) hs[q] = warp_sum(hs[q]);
    float hess[4][4];
    int q = 0;
#pragma unroll
    for (int p = 0; p < 4; ++p) {
#pragma unroll
      for (int o = p; o < 4; ++o) hess[p][o] = hess[o][p] = hs[q++];
      hess[p][p] = hess[p][p] + 5.0f;
    }
    float step[4];
    solve4(hess, jac, step);
#pragma unroll
    for (int p = 0; p < 4; ++p) nv[p] = nv[p] - step[p];
  }

  // 4. the plane, the centroid on it, the orientation, the fields
  if (lane != 0) return;
  const float nb = nv[3] - dot3(nv[0], nv[1], nv[2], m0, m1, m2);
  const float safe = clamp_tiny(norm3(nv[0], nv[1], nv[2]));
  const float pn0 = nv[0] / safe, pn1 = nv[1] / safe, pn2 = nv[2] / safe;
  const float pd = nb / safe;
  float3 avg = back_project(cam, sx, sy, md);
  const float k = -dot3(avg.x, avg.y, avg.z, pn0, pn1, pn2) - pd;
  avg.x = avg.x + k * pn0;
  avg.y = avg.y + k * pn1;
  avg.z = avg.z + k * pn2;
  const float view = -dot3(pn0, pn1, pn2, avg.x, avg.y, avg.z) /
                     clamp_tiny(norm3(avg.x, avg.y, avg.z));
  const bool flip = view < 0.0f;
  norm_out[3 * s + 0] = flip ? -pn0 : pn0;
  norm_out[3 * s + 1] = flip ? -pn1 : pn1;
  norm_out[3 * s + 2] = flip ? -pn2 : pn2;
  pos_out[3 * s + 0] = avg.x;
  pos_out[3 * s + 1] = avg.y;
  pos_out[3 * s + 2] = avg.z;
  md_out[s] = avg.z;
  vc_out[s] = fabsf(view);
  size_out[s] = sqrtf(max_dist);
}

}  // namespace

extern "C" {

int planefit(const float* depth, const int* assignment, const float* seed_x,
             const float* seed_y, const float* seed_md, const float* norm_in,
             const float* pos_in, const float* vc_in, const float* size_in,
             float* norm_out, float* pos_out, float* md_out, float* vc_out,
             float* size_out, int nb, int h, int w, int rows, int cols,
             int oh, int ow, int sp, int col0, int grid_cols, float fx,
             float fy, float cx, float cy, float hr, float max_angle_cos,
             void* stream) {
  if (sp < 2 || sp > 16 || nb < 1 || nb > 65535 || h != rows * sp ||
      w != cols * sp || oh > h || grid_cols < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  // each warp's inlier list: three planes of a window's 4 sp^2 floats
  const int smem = kSeeds * 3 * 4 * sp * sp * static_cast<int>(sizeof(float));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        planefit_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int n_seeds = rows * cols;
  const dim3 grid((n_seeds + kSeeds - 1) / kSeeds, 1, nb);
  // x / fx as PyTorch-CUDA computes it: a multiply by the f32 reciprocal
  const Camera cam{1.0f / fx, 1.0f / fy, cx, cy};
  planefit_kernel<<<grid, kSeeds * 32, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      depth, assignment, seed_x, seed_y, seed_md, norm_in, pos_in, vc_in,
      size_in, norm_out, pos_out, md_out, vc_out, size_out, h, w, cols,
      n_seeds, oh, ow, sp, col0, grid_cols, cam, hr, max_angle_cos);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
