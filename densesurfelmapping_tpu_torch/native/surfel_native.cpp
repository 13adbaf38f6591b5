// Native host-side runtime for densesurfelmapping_tpu.
//
// The reference's whole runtime is C++; in this framework the TPU owns the
// compute and the host-side pieces that remain hot are I/O serialization and
// pose-graph traversal over large maps.  This library provides:
//   * PLY surfel-mesh writer (ascii + binary)   — the reference emits one
//     6-vertex hexagon + 4 faces per surfel via ofstream<< (surfel_map.cpp:
//     1219-1280); formatting millions of floats dominates, so it's native.
//   * PCD cloud writer (ascii + binary)         — save_cloud equivalent.
//   * pose-graph BFS over CSR adjacency          — get_driftfree_poses
//     (surfel_map.cpp:1643-1674) for graphs too big for Python.
//
// Plain C ABI, loaded via ctypes (no pybind11 in this image).

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// PLY mesh writer
// verts: n_verts*3 f32, colors: n_verts u8 (gray), faces: n_faces*3 i64
// returns 0 on success
// ---------------------------------------------------------------------------
int dsm_write_ply_mesh(const char* path, const float* verts,
                       const uint8_t* colors, int64_t n_verts,
                       const int64_t* faces, int64_t n_faces, int binary) {
    FILE* f = fopen(path, binary ? "wb" : "w");
    if (!f) return 1;
    fprintf(f, "ply\nformat %s 1.0\nelement vertex %lld\n"
               "property float x\nproperty float y\nproperty float z\n"
               "property uchar red\nproperty uchar green\nproperty uchar blue\n"
               "element face %lld\n"
               "property list uchar int vertex_index\nend_header\n",
            binary ? "binary_little_endian" : "ascii",
            (long long)n_verts, (long long)n_faces);
    if (binary) {
        // interleave into a write buffer: 12B xyz + 3B rgb per vertex
        const size_t stride = 15;
        std::vector<uint8_t> buf((size_t)n_verts * stride);
        for (int64_t i = 0; i < n_verts; i++) {
            memcpy(&buf[i * stride], &verts[i * 3], 12);
            uint8_t c = colors[i];
            buf[i * stride + 12] = c;
            buf[i * stride + 13] = c;
            buf[i * stride + 14] = c;
        }
        fwrite(buf.data(), 1, buf.size(), f);
        const size_t fstride = 13;  // u8 count + 3*i32
        std::vector<uint8_t> fbuf((size_t)n_faces * fstride);
        for (int64_t i = 0; i < n_faces; i++) {
            fbuf[i * fstride] = 3;
            int32_t idx[3] = {(int32_t)faces[i * 3], (int32_t)faces[i * 3 + 1],
                              (int32_t)faces[i * 3 + 2]};
            memcpy(&fbuf[i * fstride + 1], idx, 12);
        }
        fwrite(fbuf.data(), 1, fbuf.size(), f);
    } else {
        for (int64_t i = 0; i < n_verts; i++) {
            int c = colors[i];
            fprintf(f, "%g %g %g %d %d %d\n", verts[i * 3], verts[i * 3 + 1],
                    verts[i * 3 + 2], c, c, c);
        }
        for (int64_t i = 0; i < n_faces; i++) {
            fprintf(f, "3 %lld %lld %lld\n", (long long)faces[i * 3],
                    (long long)faces[i * 3 + 1], (long long)faces[i * 3 + 2]);
        }
    }
    fclose(f);
    return 0;
}

// ---------------------------------------------------------------------------
// PCD x/y/z/intensity writer
// ---------------------------------------------------------------------------
int dsm_write_pcd(const char* path, const float* xyzi, int64_t n,
                  int binary) {
    FILE* f = fopen(path, binary ? "wb" : "w");
    if (!f) return 1;
    fprintf(f, "# .PCD v0.7 - Point Cloud Data file format\nVERSION 0.7\n"
               "FIELDS x y z intensity\nSIZE 4 4 4 4\nTYPE F F F F\n"
               "COUNT 1 1 1 1\nWIDTH %lld\nHEIGHT 1\n"
               "VIEWPOINT 0 0 0 1 0 0 0\nPOINTS %lld\nDATA %s\n",
            (long long)n, (long long)n, binary ? "binary" : "ascii");
    if (binary) {
        fwrite(xyzi, sizeof(float), (size_t)n * 4, f);
    } else {
        for (int64_t i = 0; i < n; i++)
            fprintf(f, "%g %g %g %g\n", xyzi[i * 4], xyzi[i * 4 + 1],
                    xyzi[i * 4 + 2], xyzi[i * 4 + 3]);
    }
    fclose(f);
    return 0;
}

// ---------------------------------------------------------------------------
// BFS over CSR adjacency (get_driftfree_poses semantics: depth < radius,
// insertion order = discovery order, root first)
// out must hold n_nodes ints; returns count
// ---------------------------------------------------------------------------
int64_t dsm_bfs(const int64_t* indptr, const int64_t* indices,
                int64_t n_nodes, int64_t root, int64_t radius,
                int64_t* out) {
    if (root >= n_nodes || radius <= 0) return 0;
    std::vector<uint8_t> seen(n_nodes, 0);
    std::vector<int64_t> cur, nxt;
    int64_t count = 0;
    seen[root] = 1;
    out[count++] = root;
    cur.push_back(root);
    for (int64_t depth = 1; depth < radius && !cur.empty(); depth++) {
        nxt.clear();
        for (int64_t node : cur) {
            for (int64_t e = indptr[node]; e < indptr[node + 1]; e++) {
                int64_t nb = indices[e];
                if (!seen[nb]) {
                    seen[nb] = 1;
                    out[count++] = nb;
                    nxt.push_back(nb);
                }
            }
        }
        cur.swap(nxt);
    }
    return count;
}

}  // extern "C"

extern "C" {

// ---------------------------------------------------------------------------
// Packed frame encoder: f32 intensity + f32 depth -> one u8 buffer of
// [u8 intensity bytes | f16 depth bytes] (the upload layout of
// core/state.pack_frame).  Python-side numpy clip/astype costs ~2-4 ms per
// KITTI frame; this loop is memory-bound (~0.3 ms).
// img/dep: n f32; out: 3*n u8. returns 0.
// ---------------------------------------------------------------------------
int dsm_pack_frame(const float* img, const float* dep, int64_t n,
                   uint8_t* out) {
    uint8_t* oi = out;
    _Float16* od = reinterpret_cast<_Float16*>(out + n);
    for (int64_t i = 0; i < n; ++i) {
        float v = img[i];
        v = v < 0.0f ? 0.0f : (v > 255.0f ? 255.0f : v);
        oi[i] = (uint8_t)v;
    }
    for (int64_t i = 0; i < n; ++i) {
        od[i] = (_Float16)dep[i];
    }
    return 0;
}

// ---------------------------------------------------------------------------
// Batched frame encoder: B frames packed concurrently (one thread per
// frame).  The single-frame loop is memory-bound at ~0.75 ms/KITTI frame;
// the multi-session driver packs one frame per stream per round, which
// serialized into B x 0.75 ms of host time per batched dispatch — the
// dominant slice of the round-2 multi-session scaling loss.
// imgs/deps: B x n f32 (contiguous); out: B x 3n u8. returns 0.
// ---------------------------------------------------------------------------
int dsm_pack_frames(const float* imgs, const float* deps, int64_t b,
                    int64_t n, uint8_t* out) {
    if (b == 1) return dsm_pack_frame(imgs, deps, n, out);
    std::vector<std::thread> pool;
    pool.reserve(b);
    for (int64_t k = 0; k < b; ++k) {
        pool.emplace_back(dsm_pack_frame, imgs + k * n, deps + k * n, n,
                          out + k * 3 * n);
    }
    for (auto& t : pool) t.join();
    return 0;
}

// Pointer-array variant: frames live in B separate numpy buffers and the
// outputs are rows of the (B, 3n) upload buffer — no host-side stacking
// copies (the dev container has nproc=1, where every avoidable memcpy is
// pure frame-budget; on multi-core production hosts the per-frame threads
// additionally overlap).
int dsm_pack_frames_ptrs(const float** imgs, const float** deps, int64_t b,
                         int64_t n, uint8_t** outs) {
    if (b == 1) return dsm_pack_frame(imgs[0], deps[0], n, outs[0]);
    std::vector<std::thread> pool;
    pool.reserve(b);
    for (int64_t k = 0; k < b; ++k) {
        pool.emplace_back(dsm_pack_frame, imgs[k], deps[k], n, outs[k]);
    }
    for (auto& t : pool) t.join();
    return 0;
}

}  // extern "C"
