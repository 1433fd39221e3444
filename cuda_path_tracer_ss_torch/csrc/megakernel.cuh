// Device math of the forward-render megakernel: one call of render_pixel_t()
// traces every sample of one pixel (eye ray, bounces with next-event
// estimation and scatter, one bounce per loop iteration with per-lane path
// regeneration) and returns the pixel's radiance SUM over samples.
//
// Replaces the per-lane body of the TPU kernel
// cuda_path_tracer_ss_tpu/ops/pallas/megakernel.py::_make_render_kernel in
// three variants (reference-parity estimator; physical = unbiased MIS
// estimator; physical with the bidirectional carries), each untextured or
// textured (the TPU kernel's _texture_block: color and normal maps), each
// with linear sweeps or the supercell grid's, and with float32 or bfloat16
// storage of the radiance / throughput carries (state_bf16).
// Scalar float32 code, one path per thread; the plain PyTorch
// version in ops/cuda/megakernel.py states the same formulas in the same
// operation order, so with FMA contraction off (-fmad=false) the two agree
// per pixel up to the math library's ulps.
//
// The header is also valid host C++ (CPT_HD collapses to `inline`), so the
// same math can be compiled with a host compiler and exercised on a CPU.
//
// Numerics that are part of the function: best_t starts at +inf and a hit is
// best_t < inf; spec_exp is +inf for delta mirrors and tested with isfinite;
// every max(x, eps) / degenerate-determinant guard of the reference is kept.
// Never build with --use_fast_math. fmaxf/fminf drop a NaN operand where the
// tensor version would propagate it; every such NaN (only reachable through an
// infinite ior) lands in a comparison that is false either way.
#pragma once

#include <math.h>
#include <stdint.h>

#include <string.h>

#if defined(__CUDACC__)
#include <cuda_bf16.h>
#define CPT_HD __host__ __device__ __forceinline__
#define CPT_RSQRT(x) rsqrtf(x)
#else
#define CPT_HD inline
#define CPT_RSQRT(x) (1.0f / sqrtf(x))
#endif

namespace cpt {

constexpr int S_COLS = 5;     // cx cy cz r mat
constexpr int T_COLS = 19;    // v0 e1 e2 n0 n1 n2 mat
constexpr int M_COLS = 20;    // diff spec absorb emit specExp ior pd ps prf rough pure ct
constexpr int PL_COLS = 6;    // pos power
constexpr int AL_COLS = 23;   // tri A (9) tri B (9) power (3) tri index, material index
constexpr int CAM_FLOATS = 16;

constexpr float RAY_BUMP_EPSILON = 1e-4f;
constexpr float INV_PI = (float)0.31830988618;
constexpr float FOUR_PI = (float)(4.0 * 3.141592653589793);
constexpr float TWO_PI = (float)(2.0 * 3.141592653589793);
constexpr float INV24 = 1.0f / 16777216.0f;
// Ceiling of every MIS density ratio and chain carry of the bidirectional
// weights, applied before squaring or carrying on: keeps inf (and inf * 0 =
// NaN) out where a density underflows; at the ceiling the weight is 0 anyway.
constexpr float MIS_RATIO_CLAMP = 1e18f;

// The supercell grid (ops/cuda/megakernel.py: PackedGrid). `idx` is the CSR
// table [sc_sph_start (SC+1), sc_tri_start (SC+1), supercell sphere ids,
// supercell triangle ids, global sphere ids, global triangle ids] (start
// tables at sc_off, absolute offsets into idx); `scal` = origin (3), cell
// size (3). res: grid cells per axis; F: cells per supercell axis; sc:
// supercells per axis, SC of them. A null idx selects the linear sweeps.
struct GridTables {
    const int* __restrict__ idx = nullptr;
    const float* __restrict__ scal;
    int res[3], F, sc[3], SC, sc_off, gs_off, n_gs, gt_off, n_gt;
};

// Read-only device (or, in a host build, host) tables; nothing writes them
// while a render runs.
struct SceneTables {
    const float* __restrict__ spheres;
    const float* __restrict__ triangles;
    const float* __restrict__ materials;
    const float* __restrict__ point_lights;
    const float* __restrict__ area_lights;
    const float* __restrict__ background;
    int num_spheres, num_triangles, num_materials, num_point_lights, num_area_lights;
    // The texture bundle (null / 0 on an untextured scene): atlas [texels][3]
    // (every texture's h x w texels, row-major from the top row), meta [K][3]
    // = (first texel, h, w), triuv [T][6] corner UVs, matids [M][2] = (color
    // map, normal map) per material, -1 = none.
    const float* __restrict__ tex_atlas;
    const float* __restrict__ tex_meta;
    const float* __restrict__ tex_triuv;
    const float* __restrict__ tex_matids;
    int num_textures;
    GridTables grid;
};

// The tables as a kernel instantiation sees them: with GRID false the grid is
// null at compile time, so every grid branch of the inlined sweeps folds away
// and the linear instantiation is the code without a grid.
template <bool GRID>
CPT_HD SceneTables grid_tables(const SceneTables& sc) {
    SceneTables s = sc;
    if (!GRID) s.grid.idx = nullptr;
    return s;
}

// The small tables: every table of `sc` but the texel atlas and the grid's.
// Their size in floats, as stage_tables lays them out.
CPT_HD int small_table_floats(const SceneTables& sc) {
    int n = sc.num_spheres * S_COLS + sc.num_triangles * T_COLS + sc.num_materials * M_COLS
            + sc.num_point_lights * PL_COLS + sc.num_area_lights * AL_COLS + 3;
    if (sc.num_textures > 0) {
        n += sc.num_textures * 3 + sc.num_materials * 2 + sc.num_triangles * 6;
    }
    return n;
}

// n floats from src to dst + off, worker `tid` of `workers` taking every
// workers-th float; returns the copy and moves off past it.
CPT_HD const float* copy_table(const float* src, int n, float* dst, int& off, int tid,
                               int workers) {
    float* d = dst + off;
    for (int k = tid; k < n; k += workers) d[k] = src[k];
    off += n;
    return d;
}

// Copies the small tables of `sc` into dst (small_table_floats(sc) floats,
// worker `tid` of `workers` doing its share; the caller synchronises) and
// returns `sc` pointed at the copy. Only the rows a table's count covers are
// copied: the sweeps, the shading and the texture block read no others.
CPT_HD SceneTables stage_tables(const SceneTables& sc, float* dst, int tid, int workers) {
    SceneTables s = sc;
    int off = 0;
    s.spheres = copy_table(sc.spheres, sc.num_spheres * S_COLS, dst, off, tid, workers);
    s.triangles = copy_table(sc.triangles, sc.num_triangles * T_COLS, dst, off, tid, workers);
    s.materials = copy_table(sc.materials, sc.num_materials * M_COLS, dst, off, tid, workers);
    s.point_lights = copy_table(sc.point_lights, sc.num_point_lights * PL_COLS, dst, off, tid,
                                workers);
    s.area_lights = copy_table(sc.area_lights, sc.num_area_lights * AL_COLS, dst, off, tid,
                               workers);
    s.background = copy_table(sc.background, 3, dst, off, tid, workers);
    if (sc.num_textures > 0) {
        s.tex_meta = copy_table(sc.tex_meta, sc.num_textures * 3, dst, off, tid, workers);
        s.tex_matids = copy_table(sc.tex_matids, sc.num_materials * 2, dst, off, tid, workers);
        s.tex_triuv = copy_table(sc.tex_triuv, sc.num_triangles * 6, dst, off, tid, workers);
    }
    return s;
}

struct RenderParams {
    float cam[CAM_FLOATS];  // rot 9, pos 3, tan(fov/2), z_near, sample clamp, spare
    int seed, pixel_offset, n_local, sample_offset, spp, max_bounces, width, height;
    float inv_width, inv_height, aspect;  // 1/width, 1/height, height/width
    // Store the radiance / throughput carries as bfloat16 between bounces
    // (the TPU kernel's state_bf16); the arithmetic stays float32.
    int state_bf16 = 0;
};

// The parameters as a kernel instantiation sees them: state_bf16 fixed at
// compile time, so the float32 instantiations carry no bfloat16 stores.
template <bool BF16>
CPT_HD RenderParams bf16_params(const RenderParams& p) {
    RenderParams q = p;
    q.state_bf16 = BF16 ? 1 : 0;
    return q;
}

// The grid of `sc` from a packed bundle: idx and scal (null idx: linear
// sweeps) and meta = (rx, ry, rz, F, sc_off, gs_off, n_gs, gt_off, n_gt).
inline void set_grid(SceneTables& sc, const int* idx, const float* scal, const int* meta) {
    GridTables& g = sc.grid;
    g.idx = idx;
    g.scal = scal;
    if (idx == nullptr) return;
    g.F = meta[3];
    for (int k = 0; k < 3; ++k) {
        g.res[k] = meta[k];
        g.sc[k] = (meta[k] + g.F - 1) / g.F;
    }
    g.SC = g.sc[0] * g.sc[1] * g.sc[2];
    g.sc_off = meta[4];
    g.gs_off = meta[5]; g.n_gs = meta[6];
    g.gt_off = meta[7]; g.n_gt = meta[8];
}

// The three derived floats are rounded from double quotients, as the tensor
// version rounds its Python-float constants.
inline void set_image_size(RenderParams& p, int width, int height) {
    p.width = width; p.height = height;
    p.inv_width = (float)(1.0 / (double)width);
    p.inv_height = (float)(1.0 / (double)height);
    p.aspect = (float)((double)height / (double)width);
}

// ---- Threefry-2x32, 13 rounds (utils/rng.py) -------------------------------

CPT_HD uint32_t rotl32(uint32_t x, int d) { return (x << d) | (x >> (32 - d)); }

CPT_HD void threefry2x32_13(uint32_t k0, uint32_t k1, uint32_t x0, uint32_t x1,
                            uint32_t& o0, uint32_t& o1) {
    const uint32_t ks0 = k0, ks1 = k1, ks2 = k0 ^ k1 ^ 0x1BD11BDAu;
    x0 += ks0; x1 += ks1;
    x0 += x1; x1 = rotl32(x1, 13); x1 ^= x0;
    x0 += x1; x1 = rotl32(x1, 15); x1 ^= x0;
    x0 += x1; x1 = rotl32(x1, 26); x1 ^= x0;
    x0 += x1; x1 = rotl32(x1, 6);  x1 ^= x0;
    x0 += ks1; x1 += ks2 + 1u;
    x0 += x1; x1 = rotl32(x1, 17); x1 ^= x0;
    x0 += x1; x1 = rotl32(x1, 29); x1 ^= x0;
    x0 += x1; x1 = rotl32(x1, 16); x1 ^= x0;
    x0 += x1; x1 = rotl32(x1, 24); x1 ^= x0;
    x0 += ks2; x1 += ks0 + 2u;
    x0 += x1; x1 = rotl32(x1, 13); x1 ^= x0;
    x0 += x1; x1 = rotl32(x1, 15); x1 ^= x0;
    x0 += x1; x1 = rotl32(x1, 26); x1 ^= x0;
    x0 += x1; x1 = rotl32(x1, 6);  x1 ^= x0;
    x0 += ks0; x1 += ks1 + 3u;
    x0 += x1; x1 = rotl32(x1, 17); x1 ^= x0;
    o0 = x0; o1 = x1;
}

// Two U[0,1) draws for (seed, pixel, sample, pair): the LOW 24 bits, masked.
CPT_HD void uniform_pair(int seed, int pixel, int sample, int pair, float& u0, float& u1) {
    uint32_t o0, o1;
    threefry2x32_13((uint32_t)seed, (uint32_t)pixel, (uint32_t)sample, (uint32_t)pair, o0, o1);
    u0 = (float)(o0 & 0x00FFFFFFu) * INV24;
    u1 = (float)(o1 & 0x00FFFFFFu) * INV24;
}

// ---- small vector helpers ----------------------------------------------------

CPT_HD float dot3(float ax, float ay, float az, float bx, float by, float bz) {
    return ax * bx + ay * by + az * bz;
}

CPT_HD void normalize3(float x, float y, float z, float eps, float& ox, float& oy, float& oz) {
    const float inv = CPT_RSQRT(fmaxf(x * x + y * y + z * z, eps));
    ox = x * inv; oy = y * inv; oz = z * inv;
}

// rotate +Y onto target t, applied to sample s (CudaTracer.cu:579-585)
CPT_HD void rotate_y_to(float tx, float ty, float tz, float sx, float sy, float sz,
                        float& ox, float& oy, float& oz) {
    float w = 1.0f + ty;
    float rx = tz;
    const float ry = 0.0f;
    float rz = -tx;
    const float n2 = w * w + rx * rx + rz * rz;
    const bool degen = n2 < 1e-12f;
    const float inv = CPT_RSQRT(degen ? 1.0f : n2);
    w = w * inv; rx = rx * inv; rz = rz * inv;
    const float t_x = ry * sz - rz * sy + w * sx;
    const float t_y = rz * sx - rx * sz + w * sy;
    const float t_z = rx * sy - ry * sx + w * sz;
    const float qx = sx + 2.0f * (ry * t_z - rz * t_y);
    const float qy = sy + 2.0f * (rz * t_x - rx * t_z);
    const float qz = sz + 2.0f * (rx * t_y - ry * t_x);
    ox = degen ? sx : qx;
    oy = degen ? -sy : qy;
    oz = degen ? -sz : qz;
}

// ---- primitive tests -----------------------------------------------------------

CPT_HD bool sphere_t(float ox, float oy, float oz, float dx, float dy, float dz,
                     float cx, float cy, float cz, float r, float& t) {
    const float vx = ox - cx, vy = oy - cy, vz = oz - cz;
    const float b = 2.0f * dot3(dx, dy, dz, vx, vy, vz);
    const float c = vx * vx + vy * vy + vz * vz - r * r;
    const float disc = b * b - 4.0f * c;
    const float sq = sqrtf(fmaxf(disc, 0.0f));
    const float t0 = (-b - sq) * 0.5f;
    const float t1 = (-b + sq) * 0.5f;
    t = t0 < 0.0f ? t1 : t0;
    return (disc >= 0.0f) && (t >= 0.0f);
}

// Moller-Trumbore with precomputed edges; tri points at v0 e1 e2.
CPT_HD bool triangle_t(float ox, float oy, float oz, float dx, float dy, float dz,
                       const float* tri, float& t, float& w1, float& w2) {
    const float v0x = tri[0], v0y = tri[1], v0z = tri[2];
    const float e1x = tri[3], e1y = tri[4], e1z = tri[5];
    const float e2x = tri[6], e2y = tri[7], e2z = tri[8];
    const float qx = dy * e2z - dz * e2y;
    const float qy = dz * e2x - dx * e2z;
    const float qz = dx * e2y - dy * e2x;
    const float det = e1x * qx + e1y * qy + e1z * qz;
    const bool degen = fabsf(det) <= 1e-7f;
    const float inv = 1.0f / (degen ? 1.0f : det);
    const float sx = ox - v0x, sy = oy - v0y, sz = oz - v0z;
    const float rx = sy * e1z - sz * e1y;
    const float ry = sz * e1x - sx * e1z;
    const float rz = sx * e1y - sy * e1x;
    t = (e2x * rx + e2y * ry + e2z * rz) * inv;
    w1 = (sx * qx + sy * qy + sz * qz) * inv;
    w2 = (dx * rx + dy * ry + dz * rz) * inv;
    const float w0 = 1.0f - w1 - w2;
    return (!degen) && (t > 0.0f) && (w0 >= 0.0f) && (w1 >= 0.0f) && (w2 >= 0.0f);
}

struct Hit {
    float t;           // +inf on a miss
    float nx, ny, nz;  // sphere: unit; triangle: barycentric, UNNORMALISED
    int mat;           // 0 on a miss
    int prim;          // sphere i: i; triangle i: num_spheres + i; -1 on a miss
};

// The Hit of the winner: sphere best_s, or triangle best_tri (barycentrics
// bw1, bw2), or a miss when both are -1.
CPT_HD Hit hit_of(const SceneTables& sc, float ox, float oy, float oz, float dx, float dy,
                  float dz, float best_t, int best_s, int best_tri, float bw1, float bw2) {
    Hit h;
    h.t = best_t; h.nx = 0.0f; h.ny = 0.0f; h.nz = 0.0f; h.mat = 0; h.prim = -1;
    if (best_tri >= 0) {
        h.prim = sc.num_spheres + best_tri;
        const float* tr = sc.triangles + best_tri * T_COLS;
        const float w0 = 1.0f - bw1 - bw2;
        h.nx = tr[9] * w0 + tr[12] * bw1 + tr[15] * bw2;
        h.ny = tr[10] * w0 + tr[13] * bw1 + tr[16] * bw2;
        h.nz = tr[11] * w0 + tr[14] * bw1 + tr[17] * bw2;
        h.mat = (int)tr[18];
    } else if (best_s >= 0) {
        h.prim = best_s;
        const float* s = sc.spheres + best_s * S_COLS;
        const float px = ox + dx * best_t, py = oy + dy * best_t, pz = oz + dz * best_t;
        normalize3(px - s[0], py - s[1], pz - s[2], 1e-20f, h.nx, h.ny, h.nz);
        h.mat = (int)s[4];
    }
    return h;
}

// ---- supercell-grid sweeps (the TPU kernel's grid branch of _make_sweep_fns) ----
//
// The global (wide) primitives first, then every supercell box in turn. Each
// thread gates a box on its OWN ray: the box must hold primitives and its
// slab interval must reach [0, t_limit] (the thread's best t so far, or the
// shadow distance). Only then does the thread walk the box's CSR ranges,
// reading the ids straight from global memory. Visit order differs from the
// linear sweep's, so the tie rule is explicit and index-based: a triangle's
// index is num_spheres + its id, and (t < best) || (t == best && idx >=
// best_idx) makes the largest index of the nearest t win, as the linear
// sweep's t <= best_t does.

CPT_HD float safe_inv(float d) {
    return 1.0f / ((fabsf(d) < 1e-12f) ? ((d < 0.0f) ? -1e-12f : 1e-12f) : d);
}

// Whether the ray segment [0, t_limit] overlaps supercell (bx, by, bz)'s box
// (clipped to the grid on the high side); iv is the guarded inverse direction.
CPT_HD bool supercell_slab(const GridTables& g, int bx, int by, int bz, float ox, float oy,
                           float oz, float ivx, float ivy, float ivz, float t_limit) {
    const float fF = (float)g.F;
    const float fx = (float)(bx * g.F), fy = (float)(by * g.F), fz = (float)(bz * g.F);
    const float hx = fminf(fx + fF, (float)g.res[0]);
    const float hy = fminf(fy + fF, (float)g.res[1]);
    const float hz = fminf(fz + fF, (float)g.res[2]);
    const float* s = g.scal;
    const float t0x = (s[0] + fx * s[3] - ox) * ivx, t1x = (s[0] + hx * s[3] - ox) * ivx;
    const float t0y = (s[1] + fy * s[4] - oy) * ivy, t1y = (s[1] + hy * s[4] - oy) * ivy;
    const float t0z = (s[2] + fz * s[5] - oz) * ivz, t1z = (s[2] + hz * s[5] - oz) * ivz;
    const float tn = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                           fmaxf(fminf(t0z, t1z), 0.0f));
    const float tf = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)), fmaxf(t0z, t1z));
    return (tn <= tf) && (tn <= t_limit);
}

CPT_HD void grid_sphere(const SceneTables& sc, int i, float ox, float oy, float oz, float dx,
                        float dy, float dz, float& best_t, int& best_i) {
    const float* s = sc.spheres + i * S_COLS;
    float t;
    if (sphere_t(ox, oy, oz, dx, dy, dz, s[0], s[1], s[2], s[3], t)
        && (t < best_t || (t == best_t && i >= best_i))) {
        best_t = t; best_i = i;
    }
}

CPT_HD void grid_triangle(const SceneTables& sc, int i, float ox, float oy, float oz, float dx,
                          float dy, float dz, float& best_t, int& best_i, float& bw1, float& bw2) {
    const int id = sc.num_spheres + i;
    float t, w1, w2;
    if (triangle_t(ox, oy, oz, dx, dy, dz, sc.triangles + i * T_COLS, t, w1, w2)
        && (t < best_t || (t == best_t && id >= best_i))) {
        best_t = t; best_i = id; bw1 = w1; bw2 = w2;
    }
}

// The walk both grid sweeps take: the global lists, then every non-empty
// supercell whose box the ray segment [0, t_limit] reaches, spheres before
// triangles. t_limit is read anew at each box (the nearest-hit sweep lowers
// it as it goes). visit(is_triangle, id) returns true to stop the walk, and
// the walk then returns true.
template <class Visit>
CPT_HD bool grid_walk(const GridTables& g, float ox, float oy, float oz, float dx, float dy,
                      float dz, const float& t_limit, Visit visit) {
    const int* idx = g.idx;
    for (int j = g.gs_off; j < g.gs_off + g.n_gs; ++j) {
        if (visit(false, idx[j])) return true;
    }
    for (int j = g.gt_off; j < g.gt_off + g.n_gt; ++j) {
        if (visit(true, idx[j])) return true;
    }
    const float ivx = safe_inv(dx), ivy = safe_inv(dy), ivz = safe_inv(dz);
    const int* sph_start = idx + g.sc_off;
    const int* tri_start = sph_start + g.SC + 1;
    int bi = 0;
    for (int bz = 0; bz < g.sc[2]; ++bz) {
        for (int by = 0; by < g.sc[1]; ++by) {
            for (int bx = 0; bx < g.sc[0]; ++bx, ++bi) {
                const int s0 = sph_start[bi], s1 = sph_start[bi + 1];
                const int t0 = tri_start[bi], t1 = tri_start[bi + 1];
                if ((s1 == s0 && t1 == t0)
                    || !supercell_slab(g, bx, by, bz, ox, oy, oz, ivx, ivy, ivz, t_limit)) {
                    continue;
                }
                for (int j = s0; j < s1; ++j) {
                    if (visit(false, idx[j])) return true;
                }
                for (int j = t0; j < t1; ++j) {
                    if (visit(true, idx[j])) return true;
                }
            }
        }
    }
    return false;
}

CPT_HD Hit intersect_sweep_grid(const SceneTables& sc, float ox, float oy, float oz,
                                float dx, float dy, float dz) {
    float best_t = INFINITY, bw1 = 0.0f, bw2 = 0.0f;
    int best_i = -1;
    grid_walk(sc.grid, ox, oy, oz, dx, dy, dz, best_t, [&](bool tri, int i) {
        if (tri) {
            grid_triangle(sc, i, ox, oy, oz, dx, dy, dz, best_t, best_i, bw1, bw2);
        } else {
            grid_sphere(sc, i, ox, oy, oz, dx, dy, dz, best_t, best_i);
        }
        return false;
    });
    const int S = sc.num_spheres;
    return hit_of(sc, ox, oy, oz, dx, dy, dz, best_t, best_i < S ? best_i : -1,
                  best_i >= S ? best_i - S : -1, bw1, bw2);
}

CPT_HD bool occludes_sphere(const SceneTables& sc, int i, float ox, float oy, float oz,
                            float wx, float wy, float wz, float max_d) {
    const float* s = sc.spheres + i * S_COLS;
    float t;
    return sphere_t(ox, oy, oz, wx, wy, wz, s[0], s[1], s[2], s[3], t) && t <= max_d;
}

CPT_HD bool occludes_triangle(const SceneTables& sc, int i, float ox, float oy, float oz,
                              float wx, float wy, float wz, float max_d) {
    float t, w1, w2;
    return triangle_t(ox, oy, oz, wx, wy, wz, sc.triangles + i * T_COLS, t, w1, w2)
           && t <= max_d;
}

CPT_HD bool occlusion_sweep_grid(const SceneTables& sc, float ox, float oy, float oz,
                                 float wx, float wy, float wz, float max_d) {
    return grid_walk(sc.grid, ox, oy, oz, wx, wy, wz, max_d, [&](bool tri, int i) {
        return tri ? occludes_triangle(sc, i, ox, oy, oz, wx, wy, wz, max_d)
                   : occludes_sphere(sc, i, ox, oy, oz, wx, wy, wz, max_d);
    });
}

// ---- the two sweeps every call site takes: the grid's when the tables carry
// one, else linear ------------------------------------------------------------

// Nearest hit. Linear sweep tie rule: valid && t <= best_t, so the LATER
// primitive wins equal t; spheres first, then triangles.
CPT_HD Hit intersect_sweep(const SceneTables& sc, float ox, float oy, float oz,
                           float dx, float dy, float dz) {
    if (sc.grid.idx != nullptr) return intersect_sweep_grid(sc, ox, oy, oz, dx, dy, dz);
    float best_t = INFINITY;
    int best_s = -1, best_tri = -1;
    float bw1 = 0.0f, bw2 = 0.0f;
    for (int i = 0; i < sc.num_spheres; ++i) {
        const float* s = sc.spheres + i * S_COLS;
        float t;
        if (sphere_t(ox, oy, oz, dx, dy, dz, s[0], s[1], s[2], s[3], t) && t <= best_t) {
            best_t = t; best_s = i;
        }
    }
    for (int i = 0; i < sc.num_triangles; ++i) {
        float t, w1, w2;
        if (triangle_t(ox, oy, oz, dx, dy, dz, sc.triangles + i * T_COLS, t, w1, w2)
            && t <= best_t) {
            best_t = t; best_tri = i; bw1 = w1; bw2 = w2;
        }
    }
    return hit_of(sc, ox, oy, oz, dx, dy, dz, best_t, best_s, best_tri, bw1, bw2);
}

// Any hit within max_d; stops at the first occluder.
CPT_HD bool occlusion_sweep(const SceneTables& sc, float ox, float oy, float oz,
                            float wx, float wy, float wz, float max_d) {
    if (sc.grid.idx != nullptr) return occlusion_sweep_grid(sc, ox, oy, oz, wx, wy, wz, max_d);
    for (int i = 0; i < sc.num_spheres; ++i) {
        const float* s = sc.spheres + i * S_COLS;
        float t;
        if (sphere_t(ox, oy, oz, wx, wy, wz, s[0], s[1], s[2], s[3], t) && t <= max_d) return true;
    }
    for (int i = 0; i < sc.num_triangles; ++i) {
        float t, w1, w2;
        if (triangle_t(ox, oy, oz, wx, wy, wz, sc.triangles + i * T_COLS, t, w1, w2)
            && t <= max_d) return true;
    }
    return false;
}

// ---- color and normal mapping (the TPU kernel's _texture_block) ----------------
//
// ops/texture.py states the same functions on tensors. The arctangent and
// arcsine are the reference's branchless polynomials, never the math
// library's atan2f / asinf: both engines of the reference evaluate these, so
// sphere UVs agree per pixel. The atlas is read by direct indexed loads.

constexpr float PI_F = (float)3.141592653589793;
constexpr float HALF_PI = (float)(3.141592653589793 / 2);
constexpr float QUARTER_PI = (float)(3.141592653589793 / 4);
constexpr float ATAN_BIG = (float)2.414213562373095;   // tan(3 pi / 8)
constexpr float ATAN_MID = (float)0.4142135623730950;  // tan(pi / 8)
constexpr float ATAN_C0 = (float)8.05374449538e-2;
constexpr float ATAN_C1 = (float)1.38776856032e-1;
constexpr float ATAN_C2 = (float)1.99777106478e-1;
constexpr float ATAN_C3 = (float)3.33329491539e-1;

// sign with sign(0) = 0
CPT_HD float sign0(float x) { return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f); }

// Branchless float32 arctangent (Cephes atanf coefficients, max error ~1e-7).
CPT_HD float poly_atan(float x) {
    const float ax = fabsf(x);
    const bool big = ax > ATAN_BIG;
    const bool mid = ax > ATAN_MID;
    const float safe_ax = fmaxf(ax, 1e-12f);
    const float t = big ? -1.0f / safe_ax : (mid ? (ax - 1.0f) / (ax + 1.0f) : ax);
    const float y0 = big ? HALF_PI : (mid ? QUARTER_PI : 0.0f);
    const float z = t * t;
    const float p = ((((ATAN_C0 * z - ATAN_C1) * z + ATAN_C2) * z - ATAN_C3) * z) * t + t;
    return sign0(x) * (y0 + p);
}

// Four-quadrant arctangent on poly_atan; |x| floored at 1e-12 (the uv pole).
CPT_HD float poly_atan2(float y, float x) {
    const float safe_x = (fabsf(x) < 1e-12f) ? ((x < 0.0f) ? -1e-12f : 1e-12f) : x;
    const float a = poly_atan(y / safe_x);
    return (x < 0.0f) ? a + ((y >= 0.0f) ? PI_F : -PI_F) : a;
}

// arcsin on [-1, 1] via poly_atan.
CPT_HD float poly_asin(float x) {
    const float xc = fminf(fmaxf(x, -1.0f), 1.0f);
    return poly_atan(xc / sqrtf(fmaxf(1.0f - xc * xc, 1e-12f)));
}

// Floor modulo: -1 wraps to n - 1 (C's % would give -1).
CPT_HD int wrap_index(int x, int n) { return ((x % n) + n) % n; }

// One bilinear, wrap-around fetch of texture `tid` at (u, v); v = 0 at the
// BOTTOM of the image. With AUX also the four corners' flat atlas indices and
// weights (order 00, 10, 01, 11) and d sample / d u, d v per channel (floor and
// the wrap carry no derivative).
struct TexFetch {
    float val[3];
    int idx[4];
    float w[4];
    float du[3], dv[3];
};

template <bool AUX>
CPT_HD void tex_fetch(const SceneTables& sc, float tid, float u, float v, TexFetch& f) {
    const int k = (int)fminf(fmaxf(tid, 0.0f), (float)(sc.num_textures - 1));
    const float* meta = sc.tex_meta + 3 * k;
    const float th = meta[1], tw = meta[2];
    const int base = (int)meta[0], hi = (int)th, wi = (int)tw;
    const float uu = (u - floorf(u)) * tw - 0.5f;
    const float vv = (1.0f - (v - floorf(v))) * th - 0.5f;
    const float x0 = floorf(uu);
    const float y0 = floorf(vv);
    const float fx = uu - x0;
    const float fy = vv - y0;
    const int xa = wrap_index((int)x0, wi), xb = wrap_index((int)(x0 + 1.0f), wi);
    const int ya = wrap_index((int)y0, hi), yb = wrap_index((int)(y0 + 1.0f), hi);
    const int i00 = base + ya * wi + xa, i10 = base + ya * wi + xb;
    const int i01 = base + yb * wi + xa, i11 = base + yb * wi + xb;
    const float w00 = (1.0f - fx) * (1.0f - fy);
    const float w10 = fx * (1.0f - fy);
    const float w01 = (1.0f - fx) * fy;
    const float w11 = fx * fy;
    const float* a = sc.tex_atlas;
    for (int c = 0; c < 3; ++c) {
        const float c00 = a[3 * i00 + c], c10 = a[3 * i10 + c];
        const float c01 = a[3 * i01 + c], c11 = a[3 * i11 + c];
        f.val[c] = c00 * w00 + c10 * w10 + c01 * w01 + c11 * w11;
        if (AUX) {
            f.du[c] = ((c10 - c00) * (1.0f - fy) + (c11 - c01) * fy) * tw;
            f.dv[c] = -((c01 - c00) * (1.0f - fx) + (c11 - c10) * fx) * th;
        }
    }
    if (AUX) {
        f.idx[0] = i00; f.idx[1] = i10; f.idx[2] = i01; f.idx[3] = i11;
        f.w[0] = w00; f.w[1] = w10; f.w[2] = w01; f.w[3] = w11;
    }
}

// UV-aligned tangent of triangle row `tri` (v0 e1 e2 ...) with corner UVs `uv`:
// (e1 dv2 - e2 dv1) / det, or the unit e1 where the UV map is degenerate.
CPT_HD void tri_uv_tangent(const float* tri, const float* uv, float& tx, float& ty, float& tz) {
    const float e1x = tri[3], e1y = tri[4], e1z = tri[5];
    const float e2x = tri[6], e2y = tri[7], e2z = tri[8];
    const float du1 = uv[2] - uv[0], dv1 = uv[3] - uv[1];
    const float du2 = uv[4] - uv[0], dv2 = uv[5] - uv[1];
    const float det = du1 * dv2 - du2 * dv1;
    const bool det_bad = fabsf(det) < 1e-12f;
    const float inv_det = det_bad ? 0.0f : 1.0f / det;
    tx = (e1x * dv2 - e2x * dv1) * inv_det;
    ty = (e1y * dv2 - e2y * dv1) * inv_det;
    tz = (e1z * dv2 - e2z * dv1) * inv_det;
    if (det_bad || (tx * tx + ty * ty + tz * tz) < 1e-16f) {
        const float e1inv = CPT_RSQRT(fmaxf(e1x * e1x + e1y * e1y + e1z * e1z, 1e-20f));
        tx = e1x * e1inv; ty = e1y * e1inv; tz = e1z * e1inv;
    }
}

// Sphere tangent (longitude circles) of the unit normal, with a pole fallback.
CPT_HD void sphere_tangent(float nux, float nuz, float& tx, float& ty, float& tz) {
    const float st2 = nuz * nuz + nux * nux;
    const bool st_deg = st2 < 1e-12f;
    const float st_inv = CPT_RSQRT(fmaxf(st2, 1e-20f));
    tx = st_deg ? 1.0f : -nuz * st_inv;
    ty = 0.0f;
    tz = st_deg ? 0.0f : nux * st_inv;
}

// The normal map's perturbation of raw normal n by texel t, tangent source tg
// orthonormalised against the unit normal; the result keeps n's length.
CPT_HD void perturb_normal(float nx, float ny, float nz, float tgx, float tgy, float tgz,
                           float t0, float t1, float t2, float& ox, float& oy, float& oz) {
    const float n2 = nx * nx + ny * ny + nz * nz;
    const float inv_nl = CPT_RSQRT(fmaxf(n2, 1e-20f));
    const float nux = nx * inv_nl, nuy = ny * inv_nl, nuz = nz * inv_nl;
    const float tdn = tgx * nux + tgy * nuy + tgz * nuz;
    float pox = tgx - nux * tdn, poy = tgy - nuy * tdn, poz = tgz - nuz * tdn;
    const float po_inv = CPT_RSQRT(fmaxf(pox * pox + poy * poy + poz * poz, 1e-20f));
    pox = pox * po_inv; poy = poy * po_inv; poz = poz * po_inv;
    const float bx = nuy * poz - nuz * poy;
    const float by = nuz * pox - nux * poz;
    const float bz = nux * poy - nuy * pox;
    const float tnx = t0 * 2.0f - 1.0f;
    const float tny = t1 * 2.0f - 1.0f;
    const float tnz = fmaxf(t2 * 2.0f - 1.0f, 1e-3f);
    const float ppx = pox * tnx + bx * tny + nux * tnz;
    const float ppy = poy * tnx + by * tny + nuy * tnz;
    const float ppz = poz * tnx + bz * tny + nuz * tnz;
    const float pp_inv = CPT_RSQRT(fmaxf(ppx * ppx + ppy * ppy + ppz * ppz, 1e-20f));
    const float s = pp_inv * sqrtf(fmaxf(n2, 1e-20f));
    ox = ppx * s; oy = ppy * s; oz = ppz * s;
}

// ---- derivatives of the polynomial arctangent / arcsine (the backward kernel's
// UV-swim chain), in the convention of reverse-mode autodiff of the same
// formulas: |x|' = +1 at 0, sign' = 0, a clamped input carries nothing.

CPT_HD float poly_atan_d(float x) {
    const float ax = fabsf(x);
    const bool big = ax > ATAN_BIG;
    const bool mid = ax > ATAN_MID;
    float t, dt;  // t(|x|) and dt / d|x|
    if (big) {
        t = -1.0f / ax;
        dt = 1.0f / (ax * ax);
    } else if (mid) {
        t = (ax - 1.0f) / (ax + 1.0f);
        dt = 2.0f / ((ax + 1.0f) * (ax + 1.0f));
    } else {
        t = ax;
        dt = 1.0f;
    }
    const float z = t * t;
    const float P = ((ATAN_C0 * z - ATAN_C1) * z + ATAN_C2) * z - ATAN_C3;
    const float dP = (3.0f * ATAN_C0 * z - 2.0f * ATAN_C1) * z + ATAN_C2;
    // p = P(z) t^3 + t
    const float dp = 2.0f * dP * z * z + 3.0f * P * z + 1.0f;
    return sign0(x) * dp * dt * ((x >= 0.0f) ? 1.0f : -1.0f);
}

// d poly_atan2(y, x) / dy and / dx
CPT_HD void poly_atan2_d(float y, float x, float& d_y, float& d_x) {
    const bool floored = fabsf(x) < 1e-12f;
    const float safe_x = floored ? ((x < 0.0f) ? -1e-12f : 1e-12f) : x;
    const float q = y / safe_x;
    const float da = poly_atan_d(q);
    d_y = da / safe_x;
    d_x = floored ? 0.0f : -da * q / safe_x;
}

CPT_HD float poly_asin_d(float x) {
    const float xc = fminf(fmaxf(x, -1.0f), 1.0f);
    const float dxc = (x > -1.0f && x < 1.0f) ? 1.0f : ((x == -1.0f || x == 1.0f) ? 0.5f : 0.0f);
    const float m_raw = 1.0f - xc * xc;
    const float dm = (m_raw > 1e-12f) ? 1.0f : ((m_raw == 1e-12f) ? 0.5f : 0.0f);
    const float r = sqrtf(fmaxf(m_raw, 1e-12f));
    const float q = xc / r;
    return poly_atan_d(q) * (1.0f / r + xc * xc * dm / (r * r * r)) * dxc;
}

// What the replay of the backward kernel keeps of the texture block.
struct TexAux {
    bool has_c, has_n;
    float tex[3];     // texel multiplier of the diffuse albedo (1 without a color map)
    TexFetch c, n;    // the color and normal-map fetches (idx / w / du / dv)
    float uvg[6];     // triangle: du/dp, dv/dp; sphere: du/dnux, du/dnuz, dv/dnuy, 0, 0, 0
    float raw[3];     // the normal before the perturbation
};

// Color and normal mapping at a hit (primitive `prim`, material `mat`) of the
// ray (o, d): m (M_COLS material columns, a local copy) gets its diffuse
// columns multiplied by the color map, (nx, ny, nz) is perturbed by the normal
// map. AUX (the backward kernel's replay) also fills `aux`, with the UV-swim
// partials when UVG.
template <bool AUX, bool UVG>
CPT_HD void texture_block(const SceneTables& sc, float ox, float oy, float oz,
                          float dx, float dy, float dz, int prim, int mat, float* m,
                          float& nx, float& ny, float& nz, TexAux* aux) {
    const float n2 = nx * nx + ny * ny + nz * nz;
    const float inv_nl = CPT_RSQRT(fmaxf(n2, 1e-20f));
    const float nux = nx * inv_nl, nuy = ny * inv_nl, nuz = nz * inv_nl;
    float u, v, tgx, tgy, tgz;
    if (prim < sc.num_spheres) {
        // procedural spherical UVs of the unit normal
        u = 0.5f + poly_atan2(nuz, nux) / TWO_PI;
        v = 0.5f + poly_asin(nuy) / PI_F;
        sphere_tangent(nux, nuz, tgx, tgy, tgz);
        if (AUX && UVG) {
            float a_dz, a_dx;
            poly_atan2_d(nuz, nux, a_dz, a_dx);
            aux->uvg[0] = a_dx / TWO_PI;
            aux->uvg[1] = a_dz / TWO_PI;
            aux->uvg[2] = poly_asin_d(nuy) / PI_F;
            aux->uvg[3] = aux->uvg[4] = aux->uvg[5] = 0.0f;
        }
    } else {
        // barycentric recompute of the winning triangle
        const int ti = prim - sc.num_spheres;
        const float* tri = sc.triangles + ti * T_COLS;
        const float* uv = sc.tex_triuv + ti * 6;
        float t, w1, w2;
        triangle_t(ox, oy, oz, dx, dy, dz, tri, t, w1, w2);
        const float w0 = 1.0f - (w1 + w2);
        u = uv[0] * w0 + uv[2] * w1 + uv[4] * w2;
        v = uv[1] * w0 + uv[3] * w1 + uv[5] * w2;
        tri_uv_tangent(tri, uv, tgx, tgy, tgz);
        if (AUX && UVG) {
            // uv is affine in the hit point on a fixed triangle: the gradients
            // of its plane barycentrics are the dual basis of (e1, e2)
            const float e1x = tri[3], e1y = tri[4], e1z = tri[5];
            const float e2x = tri[6], e2y = tri[7], e2z = tri[8];
            const float d11 = e1x * e1x + e1y * e1y + e1z * e1z;
            const float d22 = e2x * e2x + e2y * e2y + e2z * e2z;
            const float d12 = e1x * e2x + e1y * e2y + e1z * e2z;
            const float detm = d11 * d22 - d12 * d12;
            const float inv_m = (fabsf(detm) < 1e-18f) ? 0.0f : 1.0f / detm;
            const float gax = (d22 * e1x - d12 * e2x) * inv_m;
            const float gay = (d22 * e1y - d12 * e2y) * inv_m;
            const float gaz = (d22 * e1z - d12 * e2z) * inv_m;
            const float gbx = (d11 * e2x - d12 * e1x) * inv_m;
            const float gby = (d11 * e2y - d12 * e1y) * inv_m;
            const float gbz = (d11 * e2z - d12 * e1z) * inv_m;
            const float du1 = uv[2] - uv[0], dv1 = uv[3] - uv[1];
            const float du2 = uv[4] - uv[0], dv2 = uv[5] - uv[1];
            aux->uvg[0] = du1 * gax + du2 * gbx;
            aux->uvg[1] = du1 * gay + du2 * gby;
            aux->uvg[2] = du1 * gaz + du2 * gbz;
            aux->uvg[3] = dv1 * gax + dv2 * gbx;
            aux->uvg[4] = dv1 * gay + dv2 * gby;
            aux->uvg[5] = dv1 * gaz + dv2 * gbz;
        }
    }
    const float m_tex = sc.tex_matids[2 * mat], m_nmap = sc.tex_matids[2 * mat + 1];
    const bool has_c = m_tex >= 0.0f, has_n = m_nmap >= 0.0f;
    if (AUX) {
        aux->has_c = has_c; aux->has_n = has_n;
        aux->tex[0] = aux->tex[1] = aux->tex[2] = 1.0f;
        aux->raw[0] = nx; aux->raw[1] = ny; aux->raw[2] = nz;
    }
    if (has_c) {
        TexFetch f;
        tex_fetch<AUX>(sc, m_tex, u, v, f);
        m[0] = m[0] * f.val[0];
        m[1] = m[1] * f.val[1];
        m[2] = m[2] * f.val[2];
        if (AUX) {
            aux->c = f;
            aux->tex[0] = f.val[0]; aux->tex[1] = f.val[1]; aux->tex[2] = f.val[2];
        }
    }
    if (has_n) {
        TexFetch f;
        tex_fetch<AUX>(sc, m_nmap, u, v, f);
        perturb_normal(nx, ny, nz, tgx, tgy, tgz, f.val[0], f.val[1], f.val[2], nx, ny, nz);
        if (AUX) aux->n = f;
    }
}

// ---- next-event estimation ---------------------------------------------------------

// Reference-parity direct light from one sampled light point: falloff
// cos_l * p_diff / pi / (4 pi) / d^2, shadow ray from the bumped hit point.
// The shadow sweep runs only where its result can change the sum.
CPT_HD void light_contribution(const SceneTables& sc, float px, float py, float pz,
                               float nx, float ny, float nz, const float* m,
                               float lx, float ly, float lz, float pwx, float pwy, float pwz,
                               float& dir_r, float& dir_g, float& dir_b) {
    const float offx = lx - px, offy = ly - py, offz = lz - pz;
    const float d2 = fmaxf(offx * offx + offy * offy + offz * offz, 1e-12f);
    const float dist = sqrtf(d2);
    const float inv_d = 1.0f / dist;
    const float wx = offx * inv_d, wy = offy * inv_d, wz = offz * inv_d;
    const float cos_l = fmaxf(0.0f, dot3(nx, ny, nz, wx, wy, wz));
    const float m_pd = m[14];
    float lit = 0.0f;
    if (cos_l > 0.0f && m_pd > 0.0f) {
        const bool occ = occlusion_sweep(sc, px + nx * RAY_BUMP_EPSILON, py + ny * RAY_BUMP_EPSILON,
                                         pz + nz * RAY_BUMP_EPSILON, wx, wy, wz,
                                         dist - 2.0f * RAY_BUMP_EPSILON);
        lit = occ ? 0.0f : cos_l;
    }
    const float scale = lit * m_pd * INV_PI / FOUR_PI / d2;
    dir_r += pwx * m[0] * scale;
    dir_g += pwy * m[1] * scale;
    dir_b += pwz * m[2] * scale;
}

// ---- BSDF cascade scatter (CudaTracer.cu:208-318) -----------------------------

// Branch taken by scatter_sample.
constexpr int BRANCH_NONE = 0, BRANCH_DIFFUSE = 1, BRANCH_COOK_TORRANCE = 2,
              BRANCH_GLOSS = 3, BRANCH_REFRACT = 4;

// One uniform picks diffuse / specular (Cook-Torrance, Phong or mirror) /
// refraction; only the branch taken is evaluated. Returns false when the
// path dies (no branch taken, or refraction under total internal reflection).
// `branch` receives the branch taken (BRANCH_NONE when the path dies) and
// `ct_w` the Cook-Torrance weight that scales the specular colour (1 on every
// other branch): the forward render ignores both, the replay of the backward
// kernel stores them.
CPT_HD bool scatter_sample(float dx, float dy, float dz, float nx, float ny, float nz,
                           float px, float py, float pz, float cos_i,
                           float u_branch, float u_a, float u_b, const float* m,
                           float& new_ox, float& new_oy, float& new_oz,
                           float& new_dx, float& new_dy, float& new_dz,
                           float& wr, float& wg, float& wb, int& branch, float& ct_w) {
    branch = BRANCH_NONE; ct_w = 1.0f;
    const float m_exp = m[12], m_ior = m[13], m_pd = m[14], m_ps = m[15], m_prf = m[16];
    const float m_rough = m[17];
    const bool pure = m[18] > 0.5f, ct = m[19] > 0.5f;

    const bool outside = cos_i > 0.0f;
    const float n1 = outside ? 1.0f : m_ior;
    const float n2 = outside ? m_ior : 1.0f;
    const float cos_pos = fabsf(cos_i);
    const float n_ratio = n1 / fmaxf(n2, 1e-12f);
    const float sin_t2 = n_ratio * n_ratio * (1.0f - cos_pos * cos_pos);
    const bool tir = sin_t2 > 1.0f;
    const float cos_t = sqrtf(tir ? 1.0f : fmaxf(1.0f - sin_t2, 0.0f));
    const float rs = (n1 * cos_pos - n2 * cos_t) / fmaxf(n1 * cos_pos + n2 * cos_t, 1e-12f);
    const float rp = (n2 * cos_pos - n1 * cos_t) / fmaxf(n2 * cos_pos + n1 * cos_t, 1e-12f);
    const float fres = tir ? 1.0f : (rs * rs + rp * rp) * 0.5f;

    const float p_diff = m_pd;
    const float p_spec = m_ps * (pure ? 1.0f : fres);
    const float p_refr = m_prf * (1.0f - fres);
    const bool take_diff = u_branch < p_diff;
    const bool take_spec = (!take_diff) && (u_branch < p_diff + p_spec);
    const bool take_refr = (!take_diff) && (!take_spec) && (u_branch < p_diff + p_spec + p_refr);

    const float theta = u_a * TWO_PI;

    if (take_diff) {
        const float yy = sqrtf(u_b);
        const float rr = sqrtf(fmaxf(1.0f - yy * yy, 0.0f));
        rotate_y_to(nx, ny, nz, rr * cosf(theta), yy, rr * sinf(theta), new_dx, new_dy, new_dz);
        new_ox = px + nx * RAY_BUMP_EPSILON;
        new_oy = py + ny * RAY_BUMP_EPSILON;
        new_oz = pz + nz * RAY_BUMP_EPSILON;
        wr = m[0]; wg = m[1]; wb = m[2];
        branch = BRANCH_DIFFUSE;
        return true;
    }
    if (take_spec) {
        float spw = 1.0f;
        if (ct) {
            // Beckmann microfacet draw; the origin is bumped along the
            // microfacet normal (reference quirk)
            const float u_ac = fminf(u_a, (float)(1.0 - 1e-7));
            const float btan = -(m_rough * m_rough) * log1pf(-u_ac);
            const float binv = CPT_RSQRT(1.0f + btan * btan);
            const float bphi = u_b * TWO_PI;
            const float sb = btan * binv, cb2 = binv;
            float mx, my, mz;
            rotate_y_to(nx, ny, nz, sb * cosf(bphi), cb2, sb * sinf(bphi), mx, my, mz);
            const float cos_m = fabsf(dot3(dx, dy, dz, mx, my, mz));
            const float ctx = dx + 2.0f * cos_m * mx;
            const float cty = dy + 2.0f * cos_m * my;
            const float ctz = dz + 2.0f * cos_m * mz;
            float hx, hy, hz;
            normalize3(ctx - dx, cty - dy, ctz - dz, 1e-12f, hx, hy, hz);
            const float nh = fabsf(dot3(nx, ny, nz, hx, hy, hz));
            const float nl = fabsf(dot3(nx, ny, nz, ctx, cty, ctz));
            const float vh = fmaxf(fabsf(dot3(dx, dy, dz, hx, hy, hz)), 1e-12f);
            const float nv = fmaxf(fabsf(cos_i), 1e-6f);
            const float geom = fminf(fminf(1.0f, 2.0f * nh * nl / vh), 2.0f * nh * nv / vh);
            spw = geom / nv;
            ct_w = spw;
            branch = BRANCH_COOK_TORRANCE;
            new_dx = ctx; new_dy = cty; new_dz = ctz;
            new_ox = px + mx * RAY_BUMP_EPSILON;
            new_oy = py + my * RAY_BUMP_EPSILON;
            new_oz = pz + mz * RAY_BUMP_EPSILON;
        } else {
            // reference quirk: the mirror direction uses +|cos_i| also from
            // inside (unnormalised, outward-bent)
            branch = BRANCH_GLOSS;
            const float mrx = dx + 2.0f * cos_pos * nx;
            const float mry = dy + 2.0f * cos_pos * ny;
            const float mrz = dz + 2.0f * cos_pos * nz;
            if (isfinite(m_exp)) {
                const float pexp = 1.0f / (m_exp + 1.0f);
                const float s_cl = fminf(fmaxf(u_b, 1e-12f), 1.0f);
                const float ph_y = expf(pexp * logf(s_cl));
                const float ph_r = sqrtf(fmaxf(1.0f - ph_y * ph_y, 0.0f));
                rotate_y_to(mrx, mry, mrz, ph_r * cosf(theta), ph_y, ph_r * sinf(theta),
                            new_dx, new_dy, new_dz);
            } else {
                new_dx = mrx; new_dy = mry; new_dz = mrz;
            }
            new_ox = px + nx * RAY_BUMP_EPSILON;
            new_oy = py + ny * RAY_BUMP_EPSILON;
            new_oz = pz + nz * RAY_BUMP_EPSILON;
        }
        wr = m[3] * spw; wg = m[4] * spw; wb = m[5] * spw;
        return true;
    }
    if (take_refr && !tir) {
        const float k = n_ratio * cos_pos - cos_t;
        float rfx, rfy, rfz;
        normalize3(n_ratio * dx + k * nx, n_ratio * dy + k * ny, n_ratio * dz + k * nz, 1e-12f,
                   rfx, rfy, rfz);
        new_dx = rfx; new_dy = rfy; new_dz = rfz;
        new_ox = px + rfx * RAY_BUMP_EPSILON;
        new_oy = py + rfy * RAY_BUMP_EPSILON;
        new_oz = pz + rfz * RAY_BUMP_EPSILON;
        wr = 1.0f; wg = 1.0f; wb = 1.0f;
        branch = BRANCH_REFRACT;
        return true;
    }
    return false;
}

// ---- physical (unbiased MIS) estimator -------------------------------------------
//
// Replaces the physical block of the TPU megakernel (_phong_pdf_p ...
// _physical_direct in cuda_path_tracer_ss_tpu/ops/pallas/megakernel.py):
// uniform-area light sampling in the correct measure with power-heuristic MIS
// against the scatter continuation, and, under BIDIR, the three-way weights
// against the light tracer's camera connections (render/bidir.py). A lobe
// whose selection probability is 0 contributes an exact 0 and is skipped; a
// shadow sweep runs only where a lobe term is non-zero.

// (n+1)/(2 pi) cos^n about the unit lobe axis; an infinite exponent is a
// delta lobe (density 0).
CPT_HD float phong_pdf_p(float ax, float ay, float az, float exponent,
                         float wx, float wy, float wz) {
    const float cos_a = dot3(wx, wy, wz, ax, ay, az);
    const bool finite = isfinite(exponent);
    const float e = finite ? exponent : 1.0f;
    const float safe = fmaxf(cos_a, 1e-12f);
    const float pdf = (e + 1.0f) / TWO_PI * expf(e * logf(safe));
    return (finite && cos_a > 0.0f) ? pdf : 0.0f;
}

// The Beckmann sampler's exact density of microfacet normal m about axis a.
CPT_HD float beckmann_pdf_p(float ax, float ay, float az, float roughness,
                            float mx, float my, float mz) {
    const float cos_t = dot3(mx, my, mz, ax, ay, az);
    const float r2 = roughness * roughness;
    const bool valid = (cos_t > 0.0f) && (roughness > 0.0f);
    const float cos_safe = fmaxf(cos_t, 1e-12f);
    const float sin_t = sqrtf(fmaxf(1.0f - cos_t * cos_t, 1e-12f));
    const float tan_t = sin_t / cos_safe;
    const float r2_safe = fmaxf(r2, 1e-12f);
    const float pdf = expf(-tan_t / r2_safe) * (1.0f + tan_t * tan_t)
                      / (TWO_PI * r2_safe * sin_t);
    return valid ? pdf : 0.0f;
}

// The image of +Y under rotate_y_to(target): the true unit lobe axis even for
// an unnormalised target.
CPT_HD void lobe_axis(float tx, float ty, float tz, float& ax, float& ay, float& az) {
    rotate_y_to(tx, ty, tz, 0.0f, 1.0f, 0.0f, ax, ay, az);
}

// Fresnel reflectance of the reference's cascade at |cos_i| for the side hit.
CPT_HD float fresnel_p(float cos_i, float m_ior) {
    const bool outside = cos_i > 0.0f;
    const float n1 = outside ? 1.0f : m_ior;
    const float n2 = outside ? m_ior : 1.0f;
    const float cos_pos = fabsf(cos_i);
    const float n_ratio = n1 / fmaxf(n2, 1e-12f);
    const float sin_t2 = n_ratio * n_ratio * (1.0f - cos_pos * cos_pos);
    const float cos_t = sqrtf((sin_t2 < 1.0f) ? fmaxf(1.0f - sin_t2, 0.0f) : 1.0f);
    const float rs = (n1 * cos_pos - n2 * cos_t) / fmaxf(n1 * cos_pos + n2 * cos_t, 1e-12f);
    const float rp = (n2 * cos_pos - n1 * cos_t) / fmaxf(n2 * cos_pos + n1 * cos_t, 1e-12f);
    return (sin_t2 > 1.0f) ? 1.0f : (rs * rs + rp * rp) * 0.5f;
}

// Selection probability of the specular branch. Where the Fresnel term is
// undefined (inf/inf at an infinite ior on a material not flagged pure) the
// cascade's comparisons never take the branch: its probability is 0 here too.
CPT_HD float spec_probability(float cos_i, const float* m) {
    const float p_spec = m[15] * ((m[18] > 0.5f) ? 1.0f : fresnel_p(cos_i, m[13]));
    return (p_spec > 0.0f) ? p_spec : 0.0f;
}

// Per-surfel lobe description shared by the physical NEE and the continuation
// density. An axis is built only for a lobe that can be selected.
struct Lobes {
    float nux, nuy, nuz;   // unit normal (eps 1e-12)
    float gax, gay, gaz;   // Phong lobe axis: the quirk mirror direction's
    float cax, cay, caz;   // Cook-Torrance lobe axis: the raw normal's
    float prob_g, prob_ct, nv;
};

CPT_HD Lobes physical_lobes(float dx, float dy, float dz, float nx, float ny, float nz,
                            float cos_i, const float* m) {
    Lobes lb;
    normalize3(nx, ny, nz, 1e-12f, lb.nux, lb.nuy, lb.nuz);
    const bool ct = m[19] > 0.5f;
    const float p_spec = spec_probability(cos_i, m);
    const float cos_pos = fabsf(cos_i);
    lb.prob_g = ct ? 0.0f : p_spec;
    lb.prob_ct = (ct && m[17] > 0.0f) ? p_spec : 0.0f;
    lb.gax = lb.gay = lb.gaz = 0.0f;
    lb.cax = lb.cay = lb.caz = 0.0f;
    if (lb.prob_g > 0.0f) {
        lobe_axis(dx + 2.0f * cos_pos * nx, dy + 2.0f * cos_pos * ny, dz + 2.0f * cos_pos * nz,
                  lb.gax, lb.gay, lb.gaz);
    }
    if (lb.prob_ct > 0.0f) lobe_axis(nx, ny, nz, lb.cax, lb.cay, lb.caz);
    lb.nv = fmaxf(fabsf(cos_i), 1e-6f);
    return lb;
}

// f*cos scalars per lobe and their densities toward direction w:
// contribution = diffuse * s_d + spec * (p_g + s_ct).
CPT_HD void lobe_terms(const Lobes& lb, const float* m, float dx, float dy, float dz,
                       float nx, float ny, float nz, float wx, float wy, float wz,
                       float& s_d, float& p_g, float& s_ct, float& p_ct, float& cos_s) {
    cos_s = fmaxf(0.0f, dot3(lb.nux, lb.nuy, lb.nuz, wx, wy, wz));
    s_d = m[14] * INV_PI * cos_s;
    p_g = 0.0f; s_ct = 0.0f; p_ct = 0.0f;
    if (lb.prob_g > 0.0f) {
        p_g = lb.prob_g * phong_pdf_p(lb.gax, lb.gay, lb.gaz, m[12], wx, wy, wz);
    }
    if (lb.prob_ct > 0.0f) {
        float hx, hy, hz;
        normalize3(wx - dx, wy - dy, wz - dz, 1e-12f, hx, hy, hz);
        const float dh = fmaxf(fabsf(dot3(dx, dy, dz, hx, hy, hz)), 1e-12f);
        const float p_dir = beckmann_pdf_p(lb.cax, lb.cay, lb.caz, m[17], hx, hy, hz) / (4.0f * dh);
        p_ct = lb.prob_ct * p_dir;
        const float nh = fabsf(dot3(nx, ny, nz, hx, hy, hz));
        const float nl = fabsf(dot3(nx, ny, nz, wx, wy, wz));
        const float geom = fminf(fminf(1.0f, 2.0f * nh * nl / dh), 2.0f * nh * lb.nv / dh);
        s_ct = geom / lb.nv * p_ct;
    }
}

// Areas and unit geometric normals of an area light's two triangles.
struct LightGeom {
    float area0, area1, total;
    float n0x, n0y, n0z, n1x, n1y, n1z;
};

CPT_HD void tri_geom(const float* v, float& area, float& nx, float& ny, float& nz) {
    const float e1x = v[3] - v[0], e1y = v[4] - v[1], e1z = v[5] - v[2];
    const float e2x = v[6] - v[0], e2y = v[7] - v[1], e2z = v[8] - v[2];
    const float rx = e1y * e2z - e1z * e2y;
    const float ry = e1z * e2x - e1x * e2z;
    const float rz = e1x * e2y - e1y * e2x;
    const float n2 = rx * rx + ry * ry + rz * rz;
    area = 0.5f * sqrtf(fmaxf(n2, 1e-12f));
    const float inv = CPT_RSQRT(fmaxf(n2, 1e-12f));
    nx = rx * inv; ny = ry * inv; nz = rz * inv;
}

CPT_HD LightGeom al_light_geom(const float* al) {
    LightGeom g;
    tri_geom(al, g.area0, g.n0x, g.n0y, g.n0z);
    tri_geom(al + 9, g.area1, g.n1x, g.n1y, g.n1z);
    g.total = g.area0 + g.area1;
    return g;
}

// Uniform-area point on the light (area-proportional triangle pick,
// sqrt-reparameterised barycentrics) and the picked triangle's unit normal.
CPT_HD void al_sample_point(const LightGeom& g, const float* al, float u1, float u2, float upick,
                            float& lx, float& ly, float& lz, float& nlx, float& nly, float& nlz) {
    const bool first = upick < (g.area0 / g.total);
    const float su = sqrtf(fminf(fmaxf(u1, 0.0f), 1.0f));
    const float w0 = 1.0f - su;
    const float w1 = su * (1.0f - u2);
    const float w2 = su * u2;
    const float* v = first ? al : al + 9;
    lx = v[0] * w0 + v[3] * w1 + v[6] * w2;
    ly = v[1] * w0 + v[4] * w1 + v[7] * w2;
    lz = v[2] * w0 + v[5] * w1 + v[8] * w2;
    nlx = first ? g.n0x : g.n1x;
    nly = first ? g.n0y : g.n1y;
    nlz = first ? g.n0z : g.n1z;
}

// Chain-model solid-angle densities per label of scattering d -> w; a delta
// lobe reports its branch probability (the pdf-model convention of
// render/bidir.py, evaluated by the eye side and the light side alike).
CPT_HD void chain_model_lobes(float dx, float dy, float dz, float nx, float ny, float nz,
                              float cos_i, float wx, float wy, float wz, const float* m,
                              float& p_diff, float& p_gloss, float& p_ct, float& p_refr) {
    const float m_exp = m[12], m_rough = m[17];
    const bool ct = m[19] > 0.5f;
    const float p_spec = spec_probability(cos_i, m);
    const float cos_pos = fabsf(cos_i);

    float nux, nuy, nuz;
    normalize3(nx, ny, nz, 1e-12f, nux, nuy, nuz);
    const float cos_w = fmaxf(0.0f, dot3(wx, wy, wz, nux, nuy, nuz));
    p_diff = m[14] * cos_w * INV_PI;

    p_gloss = 0.0f;
    if (!ct) {
        if (isfinite(m_exp)) {
            float gax, gay, gaz;
            lobe_axis(dx + 2.0f * cos_pos * nx, dy + 2.0f * cos_pos * ny,
                      dz + 2.0f * cos_pos * nz, gax, gay, gaz);
            p_gloss = p_spec * phong_pdf_p(gax, gay, gaz, m_exp, wx, wy, wz);
        } else {
            p_gloss = p_spec;
        }
    }
    p_ct = 0.0f;
    if (ct) {
        float hx, hy, hz;
        normalize3(wx - dx, wy - dy, wz - dz, 1e-12f, hx, hy, hz);
        const float dm = dot3(dx, dy, dz, hx, hy, hz);
        if ((m_rough > 0.0f) && (dm < 0.0f)) {
            float cax, cay, caz;
            lobe_axis(nx, ny, nz, cax, cay, caz);
            const float p_ct_cont = beckmann_pdf_p(cax, cay, caz, m_rough, hx, hy, hz)
                                    / (4.0f * fmaxf(fabsf(dm), 1e-12f));
            p_ct = p_spec * p_ct_cont;
        } else {
            p_ct = p_spec;
        }
    }
    p_refr = m[16] * (1.0f - fresnel_p(cos_i, m[13]));
}

// Chain-model density of the branch that scatter_sample took.
CPT_HD float chain_model_taken(float dx, float dy, float dz, float nx, float ny, float nz,
                               float cos_i, float wx, float wy, float wz, const float* m,
                               int branch) {
    float p_diff, p_gloss, p_ct, p_refr;
    chain_model_lobes(dx, dy, dz, nx, ny, nz, cos_i, wx, wy, wz, m, p_diff, p_gloss, p_ct, p_refr);
    if (branch == BRANCH_DIFFUSE) return p_diff;
    if (branch == BRANCH_COOK_TORRANCE || branch == BRANCH_GLOSS) {
        return (m[19] > 0.5f) ? p_ct : p_gloss;
    }
    return (branch == BRANCH_REFRACT) ? p_refr : 0.0f;
}

// Effective solid-angle density of the scatter continuation that was taken:
// what MIS weighs an emission hit against.
CPT_HD float physical_prev_pdf(const Lobes& lb, const float* m, float dx, float dy, float dz,
                               float ndx, float ndy, float ndz, int branch) {
    if (branch == BRANCH_DIFFUSE) {
        const float cos_new = fmaxf(0.0f, dot3(ndx, ndy, ndz, lb.nux, lb.nuy, lb.nuz));
        return m[14] * cos_new * INV_PI;
    }
    if (branch == BRANCH_GLOSS) {
        return lb.prob_g * phong_pdf_p(lb.gax, lb.gay, lb.gaz, m[12], ndx, ndy, ndz);
    }
    if (branch == BRANCH_COOK_TORRANCE) {
        float hx, hy, hz;
        normalize3(ndx - dx, ndy - dy, ndz - dz, 1e-12f, hx, hy, hz);
        const float dm = dot3(dx, dy, dz, hx, hy, hz);
        if (!(dm < 0.0f)) return 0.0f;
        return lb.prob_ct * beckmann_pdf_p(lb.cax, lb.cay, lb.caz, m[17], hx, hy, hz)
               / (4.0f * fmaxf(fabsf(dm), 1e-12f));
    }
    return 0.0f;
}

// The eye side's bidirectional carries at a hit: the count ratio nu, the
// chain ratio T up to this vertex, the previous vertex's outgoing cosine and
// the squared arrival distance.
struct BidirIn {
    float nu, T, pco, t2;
    bool is_primary;
};

// Physical-mode direct radiance at a hit: emission times its MIS weight plus
// per-lobe NEE over point and area lights. Draws of bounce pair base `pair0`:
// +2+2i (u1, u2), +3+2i (unused, pick). `prim` is the hit primitive
// (spheres first, then triangles); area-light column 21 is the light's first
// triangle.
template <bool BIDIR>
CPT_HD void physical_direct(const SceneTables& sc, int seed, int pixel, int sample, int pair0,
                            float px, float py, float pz, float nx, float ny, float nz,
                            float dx, float dy, float dz, float t_w, float pp,
                            const Lobes& lb, const float* m, int prim, const BidirIn& bd,
                            float& dir_r, float& dir_g, float& dir_b) {
    const float cos_i = -dot3(dx, dy, dz, nx, ny, nz);
    const bool inside = cos_i <= 0.0f;
    const int num_als = sc.num_area_lights;
    const float n_l = num_als ? (float)num_als : 1.0f;

    // emission MIS weight for a BSDF-sampled hit on a light
    float a_hit = 0.0f, cgx = 0.0f, cgy = 0.0f, cgz = 0.0f;
    for (int i = 0; i < num_als; ++i) {
        const float* al = sc.area_lights + i * AL_COLS;
        const int t0 = (int)al[21] + sc.num_spheres;
        if (prim == t0 || prim == t0 + 1) {
            const LightGeom g = al_light_geom(al);
            a_hit = g.total;
            cgx = (prim == t0) ? g.n0x : g.n1x;
            cgy = (prim == t0) ? g.n0y : g.n1y;
            cgz = (prim == t0) ? g.n0z : g.n1z;
        }
    }
    const float cos_l_hit = fabsf(dot3(dx, dy, dz, cgx, cgy, cgz));
    const float p_l_hit = (t_w * t_w) / fmaxf(a_hit * cos_l_hit, 1e-12f);
    float w_emit = 1.0f;
    if constexpr (!BIDIR) {
        if ((pp > 0.0f) && (a_hit > 0.0f)) {
            w_emit = (pp * pp) / fmaxf(pp * pp + p_l_hit * p_l_hit, 1e-20f);
        }
    } else {
        // three-way weight: BSDF hit vs NEE vs the light tracer's camera
        // connection / emitter splat
        const float r_nee = fminf((pp > 0.0f) ? p_l_hit / fmaxf(pp, 1e-20f) : 0.0f,
                                  MIS_RATIO_CLAMP);
        const float inv_pl_a = 1.0f / fmaxf(n_l * a_hit, 1e-20f);
        const float l_emit_hit = 0.5f * cos_l_hit * INV_PI * bd.pco / bd.t2;
        const float rho = fminf(bd.nu * inv_pl_a * (bd.is_primary ? 1.0f : l_emit_hit) * bd.T,
                                MIS_RATIO_CLAMP);
        if (a_hit > 0.0f) w_emit = 1.0f / (1.0f + r_nee * r_nee + rho * rho);
    }
    dir_r = m[9] * w_emit;
    dir_g = m[10] * w_emit;
    dir_b = m[11] * w_emit;
    if (inside) return;  // NEE only from outside

    const float sox = px + lb.nux * RAY_BUMP_EPSILON;
    const float soy = py + lb.nuy * RAY_BUMP_EPSILON;
    const float soz = pz + lb.nuz * RAY_BUMP_EPSILON;

    for (int i = 0; i < sc.num_point_lights; ++i) {
        const float* pl = sc.point_lights + i * PL_COLS;
        const float offx = pl[0] - px, offy = pl[1] - py, offz = pl[2] - pz;
        const float d2 = fmaxf(offx * offx + offy * offy + offz * offz, 1e-12f);
        const float dist = sqrtf(d2);
        const float inv_d = 1.0f / dist;
        const float wx = offx * inv_d, wy = offy * inv_d, wz = offz * inv_d;
        float s_d, p_g, s_ct, p_ct, cos_s;
        lobe_terms(lb, m, dx, dy, dz, nx, ny, nz, wx, wy, wz, s_d, p_g, s_ct, p_ct, cos_s);
        if (s_d == 0.0f && p_g == 0.0f && s_ct == 0.0f) continue;
        const bool occ = occlusion_sweep(sc, sox, soy, soz, wx, wy, wz,
                                         dist - 2.0f * RAY_BUMP_EPSILON);
        const float vis = occ ? 0.0f : 1.0f;
        const float irr = vis / (FOUR_PI * d2);
        dir_r += pl[3] * irr * (m[0] * s_d + m[3] * (p_g + s_ct));
        dir_g += pl[4] * irr * (m[1] * s_d + m[4] * (p_g + s_ct));
        dir_b += pl[5] * irr * (m[2] * s_d + m[5] * (p_g + s_ct));
    }

    for (int i = 0; i < num_als; ++i) {
        const float* al = sc.area_lights + i * AL_COLS;
        const LightGeom g = al_light_geom(al);
        float u1, u2, u3, upick;
        uniform_pair(seed, pixel, sample, pair0 + 2 + 2 * i, u1, u2);
        uniform_pair(seed, pixel, sample, pair0 + 3 + 2 * i, u3, upick);
        float lx, ly, lz, nlx, nly, nlz;
        al_sample_point(g, al, u1, u2, upick, lx, ly, lz, nlx, nly, nlz);
        const float offx = lx - px, offy = ly - py, offz = lz - pz;
        const float d2 = fmaxf(offx * offx + offy * offy + offz * offz, 1e-12f);
        const float dist = sqrtf(d2);
        const float inv_d = 1.0f / dist;
        const float wx = offx * inv_d, wy = offy * inv_d, wz = offz * inv_d;
        float s_d, p_g, s_ct, p_ct, cos_s;
        lobe_terms(lb, m, dx, dy, dz, nx, ny, nz, wx, wy, wz, s_d, p_g, s_ct, p_ct, cos_s);
        if (s_d == 0.0f && p_g == 0.0f && s_ct == 0.0f) continue;
        const float cos_l = fabsf(dot3(nlx, nly, nlz, wx, wy, wz));
        const bool occ = occlusion_sweep(sc, sox, soy, soz, wx, wy, wz,
                                         dist - 2.0f * RAY_BUMP_EPSILON);
        const float geo = occ ? 0.0f : cos_l * g.total / d2;
        const float p_l = d2 / fmaxf(g.total * cos_l, 1e-12f);
        const float p_b = m[14] * cos_s * INV_PI;
        float lt_d = 0.0f, lt_g = 0.0f, lt_ct = 0.0f;  // (nu p_LT / p_NEE * p_l)^2 per label, clamped
        if constexpr (BIDIR) {
            const float l_emit = 0.5f * cos_l * INV_PI
                                 * fabsf(dot3(lb.nux, lb.nuy, lb.nuz, wx, wy, wz)) / d2;
            const float cos_rev = dot3(wx, wy, wz, nx, ny, nz);
            float lam_d, lam_g, lam_ct, lam_r;
            chain_model_lobes(-wx, -wy, -wz, nx, ny, nz, cos_rev, -dx, -dy, -dz, m,
                              lam_d, lam_g, lam_ct, lam_r);
            const float geo_prev = bd.pco / fmaxf(bd.t2, 1e-12f);
            const float base = (bd.nu / n_l) * bd.T * l_emit;
            const float r_lt_d = base * (bd.is_primary ? 1.0f : lam_d * geo_prev);
            const float r_lt_g = bd.is_primary ? 0.0f : base * lam_g * geo_prev;
            const float r_lt_ct = bd.is_primary ? 0.0f : base * lam_ct * geo_prev;
            const float rl_d = fminf(r_lt_d * p_l, MIS_RATIO_CLAMP);
            const float rl_g = fminf(r_lt_g * p_l, MIS_RATIO_CLAMP);
            const float rl_ct = fminf(r_lt_ct * p_l, MIS_RATIO_CLAMP);
            lt_d = rl_d * rl_d;
            lt_g = rl_g * rl_g;
            lt_ct = rl_ct * rl_ct;
        }
        const float w_d = (p_l * p_l) / fmaxf(p_l * p_l + p_b * p_b + lt_d, 1e-12f);
        const float w_g = (p_l * p_l) / fmaxf(p_l * p_l + p_g * p_g + lt_g, 1e-12f);
        const float w_ct = (p_l * p_l) / fmaxf(p_l * p_l + p_ct * p_ct + lt_ct, 1e-12f);
        const float* le = sc.materials + (int)al[22] * M_COLS + 9;
        dir_r += le[0] * (m[0] * s_d * geo * w_d + m[3] * (p_g * geo * w_g + s_ct * geo * w_ct));
        dir_g += le[1] * (m[1] * s_d * geo * w_d + m[4] * (p_g * geo * w_g + s_ct * geo * w_ct));
        dir_b += le[2] * (m[2] * s_d * geo * w_d + m[5] * (p_g * geo * w_g + s_ct * geo * w_ct));
    }
}

// ---- adjoints of the physical estimator (the backward kernel's physical mode) ----
//
// Hand-written reverse-mode derivatives of the physical estimator above: what
// the TPU backward kernel takes with jax.vjp over _physical_direct (its
// direct_fn) and _physical_prev_pdf (its pdf_fn) in
// cuda_path_tracer_ss_tpu/ops/pallas/megakernel_vjp.py. The conventions are
// those of reverse-mode autodiff of the same formulas: a max(x, eps) clamp
// passes its cotangent only where x > eps, a branch choice, a mask, an
// occlusion or a light draw carries nothing, |x|' = sgn(x). Every output
// cotangent is ADDED to. A lobe whose selection probability is 0 still has a
// gradient in that probability (spec_avg's at spec_avg = 0), so an adjoint
// evaluates a lobe wherever the material's flags allow it, where the forward
// skips it. The clamps the reference lacks stay: where the Fresnel term is
// undefined (an infinite ior not flagged pure) the specular probability is 0
// and passes nothing.

// sign with sgn(0) = +1 (not copysign: -0.0 counts as >= 0)
CPT_HD float sgn(float x) { return x >= 0.0f ? 1.0f : -1.0f; }

CPT_HD void cross3(float ax, float ay, float az, float bx, float by, float bz,
                   float& ox, float& oy, float& oz) {
    ox = ay * bz - az * by;
    oy = az * bx - ax * bz;
    oz = ax * by - ay * bx;
}

// VJP of normalize3 at v with cotangent g. Where the eps clamp is live the
// forward is v * const, so the projection term drops.
CPT_HD void norm3_vjp(float vx, float vy, float vz, float gx, float gy, float gz, float eps,
                      float& ax, float& ay, float& az) {
    const float n2 = vx * vx + vy * vy + vz * vz;
    const float inv = CPT_RSQRT(fmaxf(n2, eps));
    const float nx = vx * inv, ny = vy * inv, nz = vz * inv;
    const float proj = (n2 > eps) ? (nx * gx + ny * gy + nz * gz) : 0.0f;
    ax = (gx - nx * proj) * inv;
    ay = (gy - ny * proj) * inv;
    az = (gz - nz * proj) * inv;
}

// VJP of rotate_y_to(target t, sample s) with cotangent g of the rotated
// vector: (A_target, A_sample). Recomputes the quaternion, the degenerate
// fallback included (there the output is (sx, -sy, -sz) and t gets nothing).
CPT_HD void rot_y_to_vjp(float tx, float ty, float tz, float sx, float sy, float sz,
                         float gx, float gy, float gz,
                         float& atx, float& aty, float& atz,
                         float& asx, float& asy, float& asz) {
    const float w0 = 1.0f + ty;
    const float rx = tz, rz = -tx;
    const float n2 = w0 * w0 + rx * rx + rz * rz;
    if (n2 < 1e-12f) {
        atx = 0.0f; aty = 0.0f; atz = 0.0f;
        asx = gx; asy = -gy; asz = -gz;
        return;
    }
    const float inv = CPT_RSQRT(n2);
    const float w = w0 * inv;
    const float rhx = rx * inv, rhz = rz * inv;
    // u = r_hat x s + w*s   (r_hat's y component is 0)
    const float ux = -rhz * sy + w * sx;
    const float uy = rhz * sx - rhx * sz + w * sy;
    const float uz = rhx * sy + w * sz;
    // o = s + 2 r_hat x u:  A_rhat += u x (2g);  A_u = (2g) x r_hat
    const float g2x = 2.0f * gx, g2y = 2.0f * gy, g2z = 2.0f * gz;
    float arx, ary, arz, aux, auy, auz, cx, cy, cz, ex, ey, ez;
    cross3(ux, uy, uz, g2x, g2y, g2z, arx, ary, arz);
    cross3(g2x, g2y, g2z, rhx, 0.0f, rhz, aux, auy, auz);
    // u = r_hat x s + w s:  A_rhat += s x A_u;  A_s = A_u x r_hat + w A_u + g
    cross3(sx, sy, sz, aux, auy, auz, cx, cy, cz);
    arx += cx; ary += cy; arz += cz;
    cross3(aux, auy, auz, rhx, 0.0f, rhz, ex, ey, ez);
    asx = ex + w * aux + gx;
    asy = ey + w * auy + gy;
    asz = ez + w * auz + gz;
    const float aw = sx * aux + sy * auy + sz * auz;
    // w = w0*inv; r_hat = r*inv  (raw r = (tz, 0, -tx): its y adjoint drops)
    float aw0 = inv * aw;
    float arx_r = inv * arx;
    float arz_r = inv * arz;
    const float ainv = w0 * aw + rx * arx + rz * arz;
    const float an2 = -0.5f * inv * inv * inv * ainv;
    aw0 += 2.0f * w0 * an2;
    arx_r += 2.0f * rx * an2;
    arz_r += 2.0f * rz * an2;
    atx = -arz_r;
    aty = aw0;
    atz = arx_r;
    (void)ary;
}

// Adds the adjoint of a unit lobe axis (lobe_axis(t) = rotate_y_to(t, +Y)) to
// the cotangent of its target t.
CPT_HD void lobe_axis_vjp(float tx, float ty, float tz, float gx, float gy, float gz, float* a_t) {
    if (gx == 0.0f && gy == 0.0f && gz == 0.0f) return;
    float ax, ay, az, u0, u1, u2;
    rot_y_to_vjp(tx, ty, tz, 0.0f, 1.0f, 0.0f, gx, gy, gz, ax, ay, az, u0, u1, u2);
    a_t[0] += ax; a_t[1] += ay; a_t[2] += az;
}

// w = A / max(S, eps) with S = A + B: cotangent a_w -> a_A, a_B.
CPT_HD void mis_ratio_vjp(float A, float S, float eps, float a_w, float& a_A, float& a_B) {
    const float sc = fmaxf(S, eps);
    a_A = a_w / sc;
    a_B = (S > eps) ? -a_w * A / (sc * sc) : 0.0f;
    a_A += a_B;
}

// Adjoint of phong_pdf_p: cotangent a_pdf -> the axis, the exponent, w.
CPT_HD void phong_pdf_vjp(float ax, float ay, float az, float exponent, float wx, float wy,
                          float wz, float a_pdf, float* a_axis, float& a_exp, float* a_w) {
    const float cos_a = dot3(wx, wy, wz, ax, ay, az);
    if (a_pdf == 0.0f || !isfinite(exponent) || !(cos_a > 0.0f)) return;
    const float safe = fmaxf(cos_a, 1e-12f);
    const float lg = logf(safe);
    const float pdf = (exponent + 1.0f) / TWO_PI * expf(exponent * lg);
    a_exp += a_pdf * (pdf / (exponent + 1.0f) + pdf * lg);
    if (cos_a > 1e-12f) {
        const float a_c = a_pdf * pdf * exponent / safe;
        a_w[0] += a_c * ax; a_w[1] += a_c * ay; a_w[2] += a_c * az;
        a_axis[0] += a_c * wx; a_axis[1] += a_c * wy; a_axis[2] += a_c * wz;
    }
}

// Adjoint of beckmann_pdf_p: cotangent a_pdf -> the axis, the roughness, m.
CPT_HD void beckmann_pdf_vjp(float ax, float ay, float az, float roughness, float mx, float my,
                             float mz, float a_pdf, float* a_axis, float& a_rough, float* a_m) {
    const float cos_t = dot3(mx, my, mz, ax, ay, az);
    if (a_pdf == 0.0f || !(cos_t > 0.0f) || !(roughness > 0.0f)) return;
    const float r2 = roughness * roughness;
    const float cos_safe = fmaxf(cos_t, 1e-12f);
    const float s2 = 1.0f - cos_t * cos_t;
    const float sin_t = sqrtf(fmaxf(s2, 1e-12f));
    const float tan_t = sin_t / cos_safe;
    const float r2_safe = fmaxf(r2, 1e-12f);
    const float pdf = expf(-tan_t / r2_safe) * (1.0f + tan_t * tan_t)
                      / (TWO_PI * r2_safe * sin_t);
    // ln pdf = -tan/r2 + ln(1 + tan^2) - ln(2 pi r2) - ln sin
    const float a_tan = a_pdf * pdf * (-1.0f / r2_safe + 2.0f * tan_t / (1.0f + tan_t * tan_t));
    const float a_sin = -a_pdf * pdf / sin_t + a_tan / cos_safe;
    float a_c = (s2 > 1e-12f) ? -a_sin * cos_t / sin_t : 0.0f;
    if (cos_t > 1e-12f) a_c += -a_tan * tan_t / cos_safe;
    if (r2 > 1e-12f) {
        a_rough += a_pdf * pdf * (tan_t / (r2_safe * r2_safe) - 1.0f / r2_safe) * 2.0f * roughness;
    }
    a_m[0] += a_c * ax; a_m[1] += a_c * ay; a_m[2] += a_c * az;
    a_axis[0] += a_c * mx; a_axis[1] += a_c * my; a_axis[2] += a_c * mz;
}

// Adjoint of fresnel_p: cotangent a_f of the reflectance -> cos_i, the ior.
CPT_HD void fresnel_p_vjp(float cos_i, float m_ior, float a_f, float& a_cos, float& a_ior) {
    const bool outside = cos_i > 0.0f;
    const float n1 = outside ? 1.0f : m_ior;
    const float n2 = outside ? m_ior : 1.0f;
    const float cos_pos = fabsf(cos_i);
    const float n2s = fmaxf(n2, 1e-12f);
    const float n_ratio = n1 / n2s;
    const float sin_t2 = n_ratio * n_ratio * (1.0f - cos_pos * cos_pos);
    if (sin_t2 > 1.0f) return;  // total internal reflection: a constant 1
    const float cos_t = sqrtf((sin_t2 < 1.0f) ? fmaxf(1.0f - sin_t2, 0.0f) : 1.0f);
    const float ds_raw = n1 * cos_pos + n2 * cos_t, dp_raw = n2 * cos_pos + n1 * cos_t;
    const float ds = fmaxf(ds_raw, 1e-12f), dp = fmaxf(dp_raw, 1e-12f);
    const float rs = (n1 * cos_pos - n2 * cos_t) / ds;
    const float rp = (n2 * cos_pos - n1 * cos_t) / dp;
    // F = (rs^2 + rp^2) / 2; rs = (n1 c - n2 ct) / ds, rp = (n2 c - n1 ct) / dp
    const float a_ns = a_f * rs / ds, a_np = a_f * rp / dp;
    const float a_ds = (ds_raw > 1e-12f) ? -a_f * rs * rs / ds : 0.0f;
    const float a_dp = (dp_raw > 1e-12f) ? -a_f * rp * rp / dp : 0.0f;
    float a_n1 = (a_ns + a_ds) * cos_pos + (a_dp - a_np) * cos_t;
    float a_n2 = (a_ds - a_ns) * cos_t + (a_np + a_dp) * cos_pos;
    float a_c = (a_ns + a_ds) * n1 + (a_np + a_dp) * n2;
    const float a_ct = (a_ds - a_ns) * n2 + (a_dp - a_np) * n1;
    if (sin_t2 < 1.0f) {
        // cos_t = sqrt(1 - sin_t2), sin_t2 = n_ratio^2 (1 - c^2), n_ratio = n1 / n2
        const float a_st2 = -a_ct / (2.0f * cos_t);
        const float a_nr = a_st2 * 2.0f * n_ratio * (1.0f - cos_pos * cos_pos);
        a_c += a_st2 * n_ratio * n_ratio * (-2.0f * cos_pos);
        a_n1 += a_nr / n2s;
        if (n2 > 1e-12f) a_n2 += -a_nr * n_ratio / n2s;
    }
    a_ior += outside ? a_n2 : a_n1;
    a_cos += sgn(cos_i) * a_c;
}

// Adjoint of spec_probability: -> cos_i and the spec_avg / ior columns of a_m.
CPT_HD void spec_probability_vjp(float cos_i, const float* m, float a_p, float& a_cos,
                                 float* a_m) {
    if (a_p == 0.0f) return;
    const bool pure = m[18] > 0.5f;
    const float f = pure ? 1.0f : fresnel_p(cos_i, m[13]);
    if (isnan(m[15] * f)) return;
    a_m[15] += a_p * f;
    if (!pure) fresnel_p_vjp(cos_i, m[13], a_p * m[15], a_cos, a_m[13]);
}

// Cotangents of the fields of a Lobes.
struct LobesAdj {
    float nux = 0.0f, nuy = 0.0f, nuz = 0.0f;
    float gax = 0.0f, gay = 0.0f, gaz = 0.0f;
    float cax = 0.0f, cay = 0.0f, caz = 0.0f;
    float prob_g = 0.0f, prob_ct = 0.0f, nv = 0.0f;
};

// physical_lobes with the axis of every lobe the material's flags allow (the
// Phong lobe's unless Cook-Torrance, the Cook-Torrance lobe's at a roughness
// above 0), also where its probability is 0: what the adjoints evaluate. The
// values the forward reads are the same.
CPT_HD Lobes physical_lobes_all(float dx, float dy, float dz, float nx, float ny, float nz,
                                float cos_i, const float* m) {
    Lobes lb = physical_lobes(dx, dy, dz, nx, ny, nz, cos_i, m);
    const bool ct = m[19] > 0.5f;
    const float cos_pos = fabsf(cos_i);
    if (!ct && !(lb.prob_g > 0.0f)) {
        lobe_axis(dx + 2.0f * cos_pos * nx, dy + 2.0f * cos_pos * ny, dz + 2.0f * cos_pos * nz,
                  lb.gax, lb.gay, lb.gaz);
    }
    if (ct && m[17] > 0.0f && !(lb.prob_ct > 0.0f)) lobe_axis(nx, ny, nz, lb.cax, lb.cay, lb.caz);
    return lb;
}

// Adjoint of physical_lobes: cotangent `a` of the lobes -> d, n, cos_i and the
// material columns (spec_avg, ior).
CPT_HD void physical_lobes_vjp(float dx, float dy, float dz, float nx, float ny, float nz,
                               float cos_i, const float* m, const LobesAdj& a,
                               float* a_d, float* a_n, float& a_cos, float* a_m) {
    float t0, t1, t2;
    norm3_vjp(nx, ny, nz, a.nux, a.nuy, a.nuz, 1e-12f, t0, t1, t2);
    a_n[0] += t0; a_n[1] += t1; a_n[2] += t2;
    const bool ct = m[19] > 0.5f;
    const float a_ps = (ct ? 0.0f : a.prob_g) + ((ct && m[17] > 0.0f) ? a.prob_ct : 0.0f);
    spec_probability_vjp(cos_i, m, a_ps, a_cos, a_m);
    const float cos_pos = fabsf(cos_i);
    // the Phong axis about the quirk mirror direction d + 2 |cos_i| n
    float a_mr[3] = {0.0f, 0.0f, 0.0f};
    lobe_axis_vjp(dx + 2.0f * cos_pos * nx, dy + 2.0f * cos_pos * ny, dz + 2.0f * cos_pos * nz,
                  a.gax, a.gay, a.gaz, a_mr);
    for (int c = 0; c < 3; ++c) {
        a_d[c] += a_mr[c];
        a_n[c] += 2.0f * cos_pos * a_mr[c];
    }
    a_cos += sgn(cos_i) * 2.0f * dot3(nx, ny, nz, a_mr[0], a_mr[1], a_mr[2]);
    // the Cook-Torrance axis about the raw normal
    lobe_axis_vjp(nx, ny, nz, a.cax, a.cay, a.caz, a_n);
    if (cos_pos > 1e-6f) a_cos += sgn(cos_i) * a.nv;
}

// Adjoint of lobe_terms toward w: cotangents of (s_d, p_g, s_ct, p_ct,
// cos_s) -> the lobes (alb), the material columns (diff_avg, spec_exp,
// roughness), d, the raw normal n and w.
CPT_HD void lobe_terms_vjp(const Lobes& lb, const float* m, float dx, float dy, float dz,
                           float nx, float ny, float nz, float wx, float wy, float wz,
                           float a_sd, float a_pg, float a_sct, float a_pct, float a_cs,
                           LobesAdj& alb, float* a_m, float* a_d, float* a_n, float* a_w) {
    const float craw = dot3(lb.nux, lb.nuy, lb.nuz, wx, wy, wz);
    const float cos_s = fmaxf(0.0f, craw);
    a_m[14] += a_sd * INV_PI * cos_s;
    const float a_c = a_cs + a_sd * m[14] * INV_PI;
    if (craw > 0.0f) {
        alb.nux += a_c * wx; alb.nuy += a_c * wy; alb.nuz += a_c * wz;
        a_w[0] += a_c * lb.nux; a_w[1] += a_c * lb.nuy; a_w[2] += a_c * lb.nuz;
    }
    if (!(m[19] > 0.5f)) {
        // p_g = prob_g * phong(gloss axis, spec_exp, w)
        if (a_pg == 0.0f) return;
        alb.prob_g += a_pg * phong_pdf_p(lb.gax, lb.gay, lb.gaz, m[12], wx, wy, wz);
        float a_ax[3] = {0.0f, 0.0f, 0.0f};
        phong_pdf_vjp(lb.gax, lb.gay, lb.gaz, m[12], wx, wy, wz, a_pg * lb.prob_g, a_ax, a_m[12],
                      a_w);
        alb.gax += a_ax[0]; alb.gay += a_ax[1]; alb.gaz += a_ax[2];
        return;
    }
    if (!(m[17] > 0.0f) || (a_sct == 0.0f && a_pct == 0.0f)) return;
    // the Cook-Torrance reflection branch: h = normalize(w - d)
    const float hvx = wx - dx, hvy = wy - dy, hvz = wz - dz;
    float hx, hy, hz;
    normalize3(hvx, hvy, hvz, 1e-12f, hx, hy, hz);
    const float dh_raw = dot3(dx, dy, dz, hx, hy, hz);
    const float dh = fmaxf(fabsf(dh_raw), 1e-12f);
    const float beck = beckmann_pdf_p(lb.cax, lb.cay, lb.caz, m[17], hx, hy, hz);
    const float p_dir = beck / (4.0f * dh);
    const float p_ct = lb.prob_ct * p_dir;
    const float nh_r = dot3(nx, ny, nz, hx, hy, hz), nl_r = dot3(nx, ny, nz, wx, wy, wz);
    const float nh = fabsf(nh_r), nl = fabsf(nl_r);
    const float a1 = 2.0f * nh * nl / dh;
    const float b1 = 2.0f * nh * lb.nv / dh;
    const float inner = fminf(1.0f, a1);
    const float geom = fminf(inner, b1);
    // s_ct = geom / nv * p_ct, p_ct = prob_ct * p_dir, p_dir = beck / (4 dh)
    const float a_pct_all = a_pct + a_sct * geom / lb.nv;
    const float a_geom = a_sct * p_ct / lb.nv;
    alb.nv += -a_sct * geom * p_ct / (lb.nv * lb.nv);
    alb.prob_ct += a_pct_all * p_dir;
    const float a_pdir = a_pct_all * lb.prob_ct;
    const float a_beck = a_pdir / (4.0f * dh);
    float a_dh = -a_pdir * p_dir / dh;
    // geom = min(min(1, a1), b1)
    const float ab1 = (b1 < inner) ? a_geom : 0.0f;
    const float aa1 = ((a1 < 1.0f) && (b1 >= inner)) ? a_geom : 0.0f;
    const float a_nh = aa1 * 2.0f * nl / dh + ab1 * 2.0f * lb.nv / dh;
    const float a_nl = aa1 * 2.0f * nh / dh;
    alb.nv += ab1 * 2.0f * nh / dh;
    a_dh += -aa1 * a1 / dh - ab1 * b1 / dh;
    float a_h[3] = {0.0f, 0.0f, 0.0f};
    const float snh = sgn(nh_r) * a_nh, snl = sgn(nl_r) * a_nl;
    a_n[0] += snh * hx + snl * wx; a_n[1] += snh * hy + snl * wy; a_n[2] += snh * hz + snl * wz;
    a_h[0] += snh * nx; a_h[1] += snh * ny; a_h[2] += snh * nz;
    a_w[0] += snl * nx; a_w[1] += snl * ny; a_w[2] += snl * nz;
    if (fabsf(dh_raw) > 1e-12f) {
        const float adr = sgn(dh_raw) * a_dh;
        a_d[0] += adr * hx; a_d[1] += adr * hy; a_d[2] += adr * hz;
        a_h[0] += adr * dx; a_h[1] += adr * dy; a_h[2] += adr * dz;
    }
    float a_ax[3] = {0.0f, 0.0f, 0.0f};
    beckmann_pdf_vjp(lb.cax, lb.cay, lb.caz, m[17], hx, hy, hz, a_beck, a_ax, a_m[17], a_h);
    alb.cax += a_ax[0]; alb.cay += a_ax[1]; alb.caz += a_ax[2];
    float avx, avy, avz;
    norm3_vjp(hvx, hvy, hvz, a_h[0], a_h[1], a_h[2], 1e-12f, avx, avy, avz);
    a_w[0] += avx; a_w[1] += avy; a_w[2] += avz;
    a_d[0] -= avx; a_d[1] -= avy; a_d[2] -= avz;
}

// Whether a light sample toward w can contribute or carry a gradient: some
// lobe the material's flags allow has a non-zero density (or cosine) there.
CPT_HD bool lobes_reach(const Lobes& lb, const float* m, float dx, float dy, float dz,
                        float wx, float wy, float wz, float cos_s) {
    if (cos_s > 0.0f) return true;
    if (!(m[19] > 0.5f)) return phong_pdf_p(lb.gax, lb.gay, lb.gaz, m[12], wx, wy, wz) != 0.0f;
    if (!(m[17] > 0.0f)) return false;
    float hx, hy, hz;
    normalize3(wx - dx, wy - dy, wz - dz, 1e-12f, hx, hy, hz);
    return beckmann_pdf_p(lb.cax, lb.cay, lb.caz, m[17], hx, hy, hz) != 0.0f;
}

// Cotangents of the fields of a LightGeom.
struct LightGeomAdj {
    float area0 = 0.0f, area1 = 0.0f, total = 0.0f;
    float n0x = 0.0f, n0y = 0.0f, n0z = 0.0f, n1x = 0.0f, n1y = 0.0f, n1z = 0.0f;
};

// Adjoint of tri_geom at the triangle v[9]: cotangents of the area and the
// unit normal -> the three vertices' (added to rows row .. row + 8).
template <class Sink>
CPT_HD void tri_geom_vjp(const float* v, float a_area, float anx, float any, float anz, int row,
                         Sink& acc) {
    const float e1x = v[3] - v[0], e1y = v[4] - v[1], e1z = v[5] - v[2];
    const float e2x = v[6] - v[0], e2y = v[7] - v[1], e2z = v[8] - v[2];
    float rx, ry, rz;
    cross3(e1x, e1y, e1z, e2x, e2y, e2z, rx, ry, rz);
    const float n2 = rx * rx + ry * ry + rz * rz;
    const float inv = CPT_RSQRT(fmaxf(n2, 1e-12f));
    float arx = anx * inv, ary = any * inv, arz = anz * inv;
    if (n2 > 1e-12f) {
        // area = sqrt(n2) / 2, unit normal = r n2^-1/2
        const float a_n2 = a_area * 0.25f * inv
                           - 0.5f * inv * inv * inv * (anx * rx + any * ry + anz * rz);
        arx += 2.0f * rx * a_n2; ary += 2.0f * ry * a_n2; arz += 2.0f * rz * a_n2;
    }
    // r = e1 x e2
    float a1x, a1y, a1z, a2x, a2y, a2z;
    cross3(e2x, e2y, e2z, arx, ary, arz, a1x, a1y, a1z);
    cross3(arx, ary, arz, e1x, e1y, e1z, a2x, a2y, a2z);
    acc.add(row + 0, -(a1x + a2x)); acc.add(row + 1, -(a1y + a2y)); acc.add(row + 2, -(a1z + a2z));
    acc.add(row + 3, a1x); acc.add(row + 4, a1y); acc.add(row + 5, a1z);
    acc.add(row + 6, a2x); acc.add(row + 7, a2y); acc.add(row + 8, a2z);
}

// Adjoint of al_light_geom at area-light row `al`: -> its six vertices'
// (added to rows row .. row + 17).
template <class Sink>
CPT_HD void al_light_geom_vjp(const float* al, const LightGeomAdj& a, int row, Sink& acc) {
    tri_geom_vjp(al, a.area0 + a.total, a.n0x, a.n0y, a.n0z, row, acc);
    tri_geom_vjp(al + 9, a.area1 + a.total, a.n1x, a.n1y, a.n1z, row + 9, acc);
}

// Adjoint of al_sample_point: cotangents of the point (a_l) and of the
// picked triangle's normal (a_nl) -> the six vertices' (added to rows row ..
// row + 17) and the geometry's (ag). The pick and the draws carry nothing.
template <class Sink>
CPT_HD void al_sample_point_vjp(const LightGeom& g, float u1, float u2, float upick,
                                const float* a_l, const float* a_nl, LightGeomAdj& ag, int row,
                                Sink& acc) {
    const bool first = upick < (g.area0 / g.total);
    const float su = sqrtf(fminf(fmaxf(u1, 0.0f), 1.0f));
    const float w[3] = {1.0f - su, su * (1.0f - u2), su * u2};
    const int v0 = row + (first ? 0 : 9);
    for (int k = 0; k < 3; ++k) {
        for (int c = 0; c < 3; ++c) acc.add(v0 + 3 * k + c, a_l[c] * w[k]);
    }
    if (first) {
        ag.n0x += a_nl[0]; ag.n0y += a_nl[1]; ag.n0z += a_nl[2];
    } else {
        ag.n1x += a_nl[0]; ag.n1y += a_nl[1]; ag.n1z += a_nl[2];
    }
}

// Adjoint of the unit direction w = (l - p) / |l - p| with d2 = max(|l - p|^2,
// eps): cotangents of w and d2 -> of the offset l - p.
CPT_HD void light_direction_vjp(float offx, float offy, float offz, float d2, float dist,
                                const float* a_w, float a_d2, float* a_off) {
    const float inv_d = 1.0f / dist;
    const float a_inv = dot3(a_w[0], a_w[1], a_w[2], offx, offy, offz);
    a_d2 += -a_inv * inv_d * inv_d * 0.5f / dist;
    a_off[0] = a_w[0] * inv_d; a_off[1] = a_w[1] * inv_d; a_off[2] = a_w[2] * inv_d;
    if (offx * offx + offy * offy + offz * offz > 1e-12f) {
        a_off[0] += 2.0f * offx * a_d2; a_off[1] += 2.0f * offy * a_d2; a_off[2] += 2.0f * offz * a_d2;
    }
    (void)d2;
}

// Adjoint of physical_prev_pdf of the branch taken at (d, raw normal n,
// material m) toward the continuation nd, the lobes built from (d, n, m):
// cotangent a_pdf -> d, n, nd and the material columns.
CPT_HD void physical_prev_pdf_vjp(float dx, float dy, float dz, float nx, float ny, float nz,
                                  float ndx, float ndy, float ndz, const float* m, int branch,
                                  float a_pdf, float* a_d, float* a_n, float* a_nd, float* a_m) {
    if (a_pdf == 0.0f) return;
    const float cos_i = -dot3(dx, dy, dz, nx, ny, nz);
    const Lobes lb = physical_lobes_all(dx, dy, dz, nx, ny, nz, cos_i, m);
    LobesAdj alb;
    if (branch == BRANCH_DIFFUSE) {
        // m_pd max(0, nd . nu) / pi
        const float craw = dot3(ndx, ndy, ndz, lb.nux, lb.nuy, lb.nuz);
        a_m[14] += a_pdf * fmaxf(0.0f, craw) * INV_PI;
        if (craw > 0.0f) {
            const float a_c = a_pdf * m[14] * INV_PI;
            a_nd[0] += a_c * lb.nux; a_nd[1] += a_c * lb.nuy; a_nd[2] += a_c * lb.nuz;
            alb.nux += a_c * ndx; alb.nuy += a_c * ndy; alb.nuz += a_c * ndz;
        }
    } else if (branch == BRANCH_GLOSS) {
        alb.prob_g += a_pdf * phong_pdf_p(lb.gax, lb.gay, lb.gaz, m[12], ndx, ndy, ndz);
        float a_ax[3] = {0.0f, 0.0f, 0.0f};
        phong_pdf_vjp(lb.gax, lb.gay, lb.gaz, m[12], ndx, ndy, ndz, a_pdf * lb.prob_g, a_ax,
                      a_m[12], a_nd);
        alb.gax += a_ax[0]; alb.gay += a_ax[1]; alb.gaz += a_ax[2];
    } else if (branch == BRANCH_COOK_TORRANCE) {
        const float hvx = ndx - dx, hvy = ndy - dy, hvz = ndz - dz;
        float hx, hy, hz;
        normalize3(hvx, hvy, hvz, 1e-12f, hx, hy, hz);
        const float dm = dot3(dx, dy, dz, hx, hy, hz);
        if (!(dm < 0.0f)) return;
        // prob_ct beck(h) / (4 max(|dm|, eps))
        const float den = 4.0f * fmaxf(fabsf(dm), 1e-12f);
        const float beck = beckmann_pdf_p(lb.cax, lb.cay, lb.caz, m[17], hx, hy, hz);
        alb.prob_ct += a_pdf * beck / den;
        const float a_beck = a_pdf * lb.prob_ct / den;
        float a_h[3] = {0.0f, 0.0f, 0.0f}, a_ax[3] = {0.0f, 0.0f, 0.0f};
        if (fabsf(dm) > 1e-12f) {
            // d/d dm of 1/(4|dm|) at dm < 0: +1/(4 dm^2)
            const float a_dm = a_pdf * lb.prob_ct * beck * 4.0f / (den * den);
            a_d[0] += a_dm * hx; a_d[1] += a_dm * hy; a_d[2] += a_dm * hz;
            a_h[0] += a_dm * dx; a_h[1] += a_dm * dy; a_h[2] += a_dm * dz;
        }
        beckmann_pdf_vjp(lb.cax, lb.cay, lb.caz, m[17], hx, hy, hz, a_beck, a_ax, a_m[17], a_h);
        alb.cax += a_ax[0]; alb.cay += a_ax[1]; alb.caz += a_ax[2];
        float avx, avy, avz;
        norm3_vjp(hvx, hvy, hvz, a_h[0], a_h[1], a_h[2], 1e-12f, avx, avy, avz);
        a_nd[0] += avx; a_nd[1] += avy; a_nd[2] += avz;
        a_d[0] -= avx; a_d[1] -= avy; a_d[2] -= avz;
    } else {
        return;
    }
    float a_cos = 0.0f;
    physical_lobes_vjp(dx, dy, dz, nx, ny, nz, cos_i, m, alb, a_d, a_n, a_cos, a_m);
    // cos_i = -d . n
    a_d[0] -= a_cos * nx; a_d[1] -= a_cos * ny; a_d[2] -= a_cos * nz;
    a_n[0] -= a_cos * dx; a_n[1] -= a_cos * dy; a_n[2] -= a_cos * dz;
}

// Where physical_direct_vjp adds the rows it owns: per point light
// `pl_stride` rows from row_pl0 (position 3, power 3); the emission rows of an
// area light's material at mat * pcols + 9; under GEO per area light
// `al_stride` rows from row_al0, its six vertices from +3.
struct DirectRows {
    int row_pl0, pl_stride, pcols, row_al0, al_stride;
};

// Adjoint of physical_direct<false> at one hit, and its value: `dir`
// receives the direct radiance by physical_direct's own arithmetic, (gx, gy,
// gz) is its cotangent. Adds the cotangents of the hit point (a_p), the
// shading normal (a_n), the incoming direction (a_d), the hit distance (a_t),
// the carried density (a_pp) and the hit material's 20 columns (a_m), and
// adds the point-light rows, the emission rows of the area lights' materials
// and, under GEO, the area lights' vertex rows into `acc`. `lb` receives the
// lobes (physical_lobes_all). Occlusion, the light draws and the picks carry
// nothing. `occ_out` (point lights first, then area lights), when given,
// receives 1 where a shadow ray ran and was occluded, else 0.
template <bool GEO, class Sink>
CPT_HD void physical_direct_vjp(const SceneTables& sc, int seed, int pixel, int sample,
                                int pair0, float px, float py, float pz, float nx, float ny,
                                float nz, float dx, float dy, float dz, float t_w, float pp,
                                const float* m, int prim, const DirectRows& R, float gx,
                                float gy, float gz, Sink& acc, float* dir, float* a_p,
                                float* a_n, float* a_d, float& a_t, float& a_pp, float* a_m,
                                Lobes& lb, int* occ_out = nullptr) {
    const float cos_i = -dot3(dx, dy, dz, nx, ny, nz);
    const bool inside = cos_i <= 0.0f;
    const int num_pls = sc.num_point_lights, num_als = sc.num_area_lights;
    lb = physical_lobes_all(dx, dy, dz, nx, ny, nz, cos_i, m);
    if (occ_out) {
        for (int i = 0; i < num_pls + num_als; ++i) occ_out[i] = 0;
    }

    // emission MIS weight for a BSDF-sampled hit on a light
    float a_hit = 0.0f, cgx = 0.0f, cgy = 0.0f, cgz = 0.0f;
    int hit_light = -1;
    bool hit_first = false;
    for (int i = 0; i < num_als; ++i) {
        const float* al = sc.area_lights + i * AL_COLS;
        const int t0 = (int)al[21] + sc.num_spheres;
        if (prim == t0 || prim == t0 + 1) {
            const LightGeom g = al_light_geom(al);
            a_hit = g.total;
            cgx = (prim == t0) ? g.n0x : g.n1x;
            cgy = (prim == t0) ? g.n0y : g.n1y;
            cgz = (prim == t0) ? g.n0z : g.n1z;
            hit_light = i;
            hit_first = prim == t0;
        }
    }
    const float cdot = dot3(dx, dy, dz, cgx, cgy, cgz);
    const float cos_l_hit = fabsf(cdot);
    const float den_h = fmaxf(a_hit * cos_l_hit, 1e-12f);
    const float p_l_hit = (t_w * t_w) / den_h;
    float w_emit = 1.0f;
    const bool mis = (pp > 0.0f) && (a_hit > 0.0f);
    const float s_h = pp * pp + p_l_hit * p_l_hit;
    if (mis) w_emit = (pp * pp) / fmaxf(s_h, 1e-20f);
    dir[0] = m[9] * w_emit;
    dir[1] = m[10] * w_emit;
    dir[2] = m[11] * w_emit;
    a_m[9] += gx * w_emit; a_m[10] += gy * w_emit; a_m[11] += gz * w_emit;
    if (mis) {
        float a_A, a_B;
        mis_ratio_vjp(pp * pp, s_h, 1e-20f, gx * m[9] + gy * m[10] + gz * m[11], a_A, a_B);
        a_pp += a_A * 2.0f * pp;
        const float a_plh = a_B * 2.0f * p_l_hit;
        a_t += a_plh * 2.0f * t_w / den_h;
        if (a_hit * cos_l_hit > 1e-12f) {
            const float a_den = -a_plh * p_l_hit / den_h;
            const float a_cl = sgn(cdot) * a_den * a_hit;
            a_d[0] += a_cl * cgx; a_d[1] += a_cl * cgy; a_d[2] += a_cl * cgz;
            if (GEO) {
                LightGeomAdj ag;
                ag.total = a_den * cos_l_hit;
                if (hit_first) {
                    ag.n0x = a_cl * dx; ag.n0y = a_cl * dy; ag.n0z = a_cl * dz;
                } else {
                    ag.n1x = a_cl * dx; ag.n1y = a_cl * dy; ag.n1z = a_cl * dz;
                }
                al_light_geom_vjp(sc.area_lights + hit_light * AL_COLS, ag,
                                  R.row_al0 + R.al_stride * hit_light + 3, acc);
            }
        }
    }
    if (inside) return;  // NEE only from outside

    LobesAdj alb;
    const float sox = px + lb.nux * RAY_BUMP_EPSILON;
    const float soy = py + lb.nuy * RAY_BUMP_EPSILON;
    const float soz = pz + lb.nuz * RAY_BUMP_EPSILON;
    const float gv[3] = {gx, gy, gz};

    for (int i = 0; i < num_pls; ++i) {
        const float* pl = sc.point_lights + i * PL_COLS;
        const float offx = pl[0] - px, offy = pl[1] - py, offz = pl[2] - pz;
        const float d2 = fmaxf(offx * offx + offy * offy + offz * offz, 1e-12f);
        const float dist = sqrtf(d2);
        const float inv_d = 1.0f / dist;
        const float wx = offx * inv_d, wy = offy * inv_d, wz = offz * inv_d;
        float s_d, p_g, s_ct, p_ct, cos_s;
        lobe_terms(lb, m, dx, dy, dz, nx, ny, nz, wx, wy, wz, s_d, p_g, s_ct, p_ct, cos_s);
        if (!lobes_reach(lb, m, dx, dy, dz, wx, wy, wz, cos_s)) continue;
        const bool occ = occlusion_sweep(sc, sox, soy, soz, wx, wy, wz,
                                         dist - 2.0f * RAY_BUMP_EPSILON);
        if (occ_out) occ_out[i] = occ ? 1 : 0;
        if (occ) continue;  // zero, with every derivative
        const float irr = 1.0f / (FOUR_PI * d2);
        dir[0] += pl[3] * irr * (m[0] * s_d + m[3] * (p_g + s_ct));
        dir[1] += pl[4] * irr * (m[1] * s_d + m[4] * (p_g + s_ct));
        dir[2] += pl[5] * irr * (m[2] * s_d + m[5] * (p_g + s_ct));
        // contribution_c = power_c irr (diffuse_c s_d + spec_c (p_g + s_ct))
        const int row = R.row_pl0 + R.pl_stride * i;
        float a_irr = 0.0f, a_sd = 0.0f, a_sp = 0.0f;
        for (int c = 0; c < 3; ++c) {
            const float lc = m[c] * s_d + m[3 + c] * (p_g + s_ct);
            const float gc = gv[c] * pl[3 + c] * irr;
            acc.add(row + 3 + c, gv[c] * irr * lc);
            a_irr += gv[c] * pl[3 + c] * lc;
            a_m[c] += gc * s_d;
            a_m[3 + c] += gc * (p_g + s_ct);
            a_sd += gc * m[c];
            a_sp += gc * m[3 + c];
        }
        float a_w[3] = {0.0f, 0.0f, 0.0f}, a_off[3];
        lobe_terms_vjp(lb, m, dx, dy, dz, nx, ny, nz, wx, wy, wz, a_sd, a_sp, a_sp, 0.0f, 0.0f,
                       alb, a_m, a_d, a_n, a_w);
        light_direction_vjp(offx, offy, offz, d2, dist, a_w, -a_irr * irr / d2, a_off);
        for (int c = 0; c < 3; ++c) {
            acc.add(row + c, a_off[c]);
            a_p[c] -= a_off[c];
        }
    }

    for (int i = 0; i < num_als; ++i) {
        const float* al = sc.area_lights + i * AL_COLS;
        const LightGeom g = al_light_geom(al);
        float u1, u2, u3, upick;
        uniform_pair(seed, pixel, sample, pair0 + 2 + 2 * i, u1, u2);
        uniform_pair(seed, pixel, sample, pair0 + 3 + 2 * i, u3, upick);
        float lx, ly, lz, nlx, nly, nlz;
        al_sample_point(g, al, u1, u2, upick, lx, ly, lz, nlx, nly, nlz);
        const float offx = lx - px, offy = ly - py, offz = lz - pz;
        const float d2 = fmaxf(offx * offx + offy * offy + offz * offz, 1e-12f);
        const float dist = sqrtf(d2);
        const float inv_d = 1.0f / dist;
        const float wx = offx * inv_d, wy = offy * inv_d, wz = offz * inv_d;
        float s_d, p_g, s_ct, p_ct, cos_s;
        lobe_terms(lb, m, dx, dy, dz, nx, ny, nz, wx, wy, wz, s_d, p_g, s_ct, p_ct, cos_s);
        if (!lobes_reach(lb, m, dx, dy, dz, wx, wy, wz, cos_s)) continue;
        const float cl_raw = dot3(nlx, nly, nlz, wx, wy, wz);
        const float cos_l = fabsf(cl_raw);
        const bool occ = occlusion_sweep(sc, sox, soy, soz, wx, wy, wz,
                                         dist - 2.0f * RAY_BUMP_EPSILON);
        if (occ_out) occ_out[num_pls + i] = occ ? 1 : 0;
        if (occ) continue;  // zero, with every derivative
        const float geo = cos_l * g.total / d2;
        const float den_l = fmaxf(g.total * cos_l, 1e-12f);
        const float p_l = d2 / den_l;
        const float p_b = m[14] * cos_s * INV_PI;
        const float s_d2 = p_l * p_l + p_b * p_b;
        const float s_g2 = p_l * p_l + p_g * p_g;
        const float s_c2 = p_l * p_l + p_ct * p_ct;
        const float w_d = (p_l * p_l) / fmaxf(s_d2, 1e-12f);
        const float w_g = (p_l * p_l) / fmaxf(s_g2, 1e-12f);
        const float w_ct = (p_l * p_l) / fmaxf(s_c2, 1e-12f);
        const int lmat = (int)al[22];
        const float* le = sc.materials + lmat * M_COLS + 9;
        dir[0] += le[0] * (m[0] * s_d * geo * w_d + m[3] * (p_g * geo * w_g + s_ct * geo * w_ct));
        dir[1] += le[1] * (m[1] * s_d * geo * w_d + m[4] * (p_g * geo * w_g + s_ct * geo * w_ct));
        dir[2] += le[2] * (m[2] * s_d * geo * w_d + m[5] * (p_g * geo * w_g + s_ct * geo * w_ct));
        // contribution_c = le_c (diffuse_c X_d + spec_c (X_g + X_ct)), X_d = s_d geo w_d, ...
        const float xd = s_d * geo * w_d, xg = p_g * geo * w_g, xc = s_ct * geo * w_ct;
        float a_xd = 0.0f, a_xs = 0.0f;
        for (int c = 0; c < 3; ++c) {
            const float ec = gv[c] * le[c];
            acc.add(lmat * R.pcols + 9 + c, gv[c] * (m[c] * xd + m[3 + c] * (xg + xc)));
            a_m[c] += ec * xd;
            a_m[3 + c] += ec * (xg + xc);
            a_xd += ec * m[c];
            a_xs += ec * m[3 + c];
        }
        float a_sd = a_xd * geo * w_d, a_pg = a_xs * geo * w_g, a_sct = a_xs * geo * w_ct;
        const float a_geo = a_xd * s_d * w_d + a_xs * (p_g * w_g + s_ct * w_ct);
        float a_pl = 0.0f, a_pct = 0.0f, a_A, a_B;
        mis_ratio_vjp(p_l * p_l, s_d2, 1e-12f, a_xd * s_d * geo, a_A, a_B);
        a_pl += a_A * 2.0f * p_l;
        const float a_pb = a_B * 2.0f * p_b;
        mis_ratio_vjp(p_l * p_l, s_g2, 1e-12f, a_xs * p_g * geo, a_A, a_B);
        a_pl += a_A * 2.0f * p_l;
        a_pg += a_B * 2.0f * p_g;
        mis_ratio_vjp(p_l * p_l, s_c2, 1e-12f, a_xs * s_ct * geo, a_A, a_B);
        a_pl += a_A * 2.0f * p_l;
        a_pct += a_B * 2.0f * p_ct;
        // p_b = diff_avg cos_s / pi
        a_m[14] += a_pb * cos_s * INV_PI;
        const float a_cs = a_pb * m[14] * INV_PI;
        // p_l = d2 / max(total cos_l, eps), geo = cos_l total / d2
        float a_d2 = a_pl / den_l - a_geo * geo / d2;
        float a_total = a_geo * cos_l / d2, a_cl = a_geo * g.total / d2;
        if (g.total * cos_l > 1e-12f) {
            const float a_den = -a_pl * p_l / den_l;
            a_total += a_den * cos_l;
            a_cl += a_den * g.total;
        }
        // cos_l = |nl . w|
        const float scl = sgn(cl_raw) * a_cl;
        float a_w[3] = {scl * nlx, scl * nly, scl * nlz}, a_off[3];
        lobe_terms_vjp(lb, m, dx, dy, dz, nx, ny, nz, wx, wy, wz, a_sd, a_pg, a_sct, a_pct, a_cs,
                       alb, a_m, a_d, a_n, a_w);
        light_direction_vjp(offx, offy, offz, d2, dist, a_w, a_d2, a_off);
        for (int c = 0; c < 3; ++c) a_p[c] -= a_off[c];
        if (GEO) {
            LightGeomAdj ag;
            ag.total = a_total;
            const float a_nl[3] = {scl * wx, scl * wy, scl * wz};
            const int row = R.row_al0 + R.al_stride * i + 3;
            al_sample_point_vjp(g, u1, u2, upick, a_off, a_nl, ag, row, acc);
            al_light_geom_vjp(al, ag, row, acc);
        }
        (void)u3;
    }

    float a_cos = 0.0f;
    physical_lobes_vjp(dx, dy, dz, nx, ny, nz, cos_i, m, alb, a_d, a_n, a_cos, a_m);
    // cos_i = -d . n
    a_d[0] -= a_cos * nx; a_d[1] -= a_cos * ny; a_d[2] -= a_cos * nz;
    a_n[0] -= a_cos * dx; a_n[1] -= a_cos * dy; a_n[2] -= a_cos * dz;
}

// ---- one pixel, all samples -------------------------------------------------------

// x rounded to the nearest bfloat16 (ties to even) and widened back: the
// storage precision of the carries under state_bf16.
CPT_HD float round_bf16(float x) {
#if defined(__CUDA_ARCH__)
    return __bfloat162float(__float2bfloat16_rn(x));
#else
    uint32_t u;
    memcpy(&u, &x, sizeof u);
    if ((u & 0x7fffffffu) > 0x7f800000u) return x;  // NaN
    u = (u + 0x7fffu + ((u >> 16) & 1u)) & 0xffff0000u;
    float y;
    memcpy(&y, &u, sizeof y);
    return y;
#endif
}

// Where the TPU kernel stores a carry at the end of a bounce: rounded to
// bfloat16 under state_bf16, unchanged otherwise.
CPT_HD void store_carry(const RenderParams& p, float& x, float& y, float& z) {
    if (p.state_bf16) {
        x = round_bf16(x); y = round_bf16(y); z = round_bf16(z);
    }
}

// Jittered pinhole eye ray (computeEyeRay, CudaTracer.cu:321-343); pair 0:
// the camera-space pixel vector s and the world-space direction v = R s
// before it is normalised.
CPT_HD void eye_ray_raw(const RenderParams& p, int pixel, int sample, float pxi, float pyi,
                        float& sx, float& sy, float& sz, float& dx0, float& dy0, float& dz0) {
    float ju, jv;
    uniform_pair(p.seed, pixel, sample, 0, ju, jv);
    const float tan_half = p.cam[12], z_near = p.cam[13];
    const float jx = pxi + ju;
    const float jy = pyi + jv;
    const float s_fov = -2.0f * tan_half;
    sx = (jx * p.inv_width - 0.5f) * s_fov * z_near;
    sy = (jy * p.inv_height - 0.5f) * s_fov * z_near * p.aspect;
    sz = z_near;
    dx0 = p.cam[0] * sx + p.cam[1] * sy + p.cam[2] * sz;
    dy0 = p.cam[3] * sx + p.cam[4] * sy + p.cam[5] * sz;
    dz0 = p.cam[6] * sx + p.cam[7] * sy + p.cam[8] * sz;
}

CPT_HD void eye_ray(const RenderParams& p, int pixel, int sample, float pxi, float pyi,
                    float& dx, float& dy, float& dz) {
    float sx, sy, sz, dx0, dy0, dz0;
    eye_ray_raw(p, pixel, sample, pxi, pyi, sx, sy, sz, dx0, dy0, dz0);
    normalize3(dx0, dy0, dz0, 1e-20f, dx, dy, dz);
}

// The camera importance dA_img/dOmega = W H / (s^2 aspect cos^3 theta) at
// the angle theta off the optical axis with |cos theta| = cos_abs.
CPT_HD float camera_j_img(float tan_half, float aspect, int width, int height, float cos_abs) {
    const float s_fov = -2.0f * tan_half;
    const float cos_t = fminf(fmaxf(cos_abs, 1e-4f), 1.0f);
    return (float)(width * height) / (s_fov * s_fov * aspect * (cos_t * cos_t * cos_t));
}

// eye_ray plus the camera importance of that ray (the bidirectional carries).
CPT_HD void eye_ray_j(const RenderParams& p, int pixel, int sample, float pxi, float pyi,
                      float& dx, float& dy, float& dz, float& j_img) {
    float sx, sy, sz, dx0, dy0, dz0;
    eye_ray_raw(p, pixel, sample, pxi, pyi, sx, sy, sz, dx0, dy0, dz0);
    const float s_len = sqrtf(fmaxf(sx * sx + sy * sy + sz * sz, 1e-20f));
    j_img = camera_j_img(p.cam[12], p.aspect, p.width, p.height, fabsf(sz) / s_len);
    normalize3(dx0, dy0, dz0, 1e-20f, dx, dy, dz);
}

// The carries of one path between bounces: the TPU kernel's per-lane state.
struct PathState {
    float ox, oy, oz, dx, dy, dz;         // the ray
    float r0x, r0y, r0z;                  // radiance gathered
    float r1x, r1y, r1z;                  // throughput
    float prev_pdf;                       // PHYSICAL: density of the last scatter
    float lt_S, pf_model, pco, j_img;     // BIDIR: the bidirectional carries
    int b;                                // bounces made
};

// A fresh path of sample `sample`: the eye ray, throughput 1, radiance 0,
// prev_pdf 0, and the bidirectional carries lt_S 0, pf_model 0, pco 1 and
// the eye ray's camera importance.
template <bool BIDIR>
CPT_HD void start_path(const RenderParams& p, int pixel, int sample, float pxi, float pyi,
                       PathState& st) {
    st.ox = p.cam[9]; st.oy = p.cam[10]; st.oz = p.cam[11];
    st.prev_pdf = 0.0f;
    st.lt_S = 0.0f; st.pf_model = 0.0f; st.pco = 1.0f; st.j_img = 0.0f;
    if constexpr (BIDIR) {
        eye_ray_j(p, pixel, sample, pxi, pyi, st.dx, st.dy, st.dz, st.j_img);
    } else {
        eye_ray(p, pixel, sample, pxi, pyi, st.dx, st.dy, st.dz);
    }
    st.r0x = 0.0f; st.r0y = 0.0f; st.r0z = 0.0f;
    st.r1x = 1.0f; st.r1y = 1.0f; st.r1z = 1.0f;
    st.b = 0;
}

// One bounce of the path in `st` (sample `sample` of flat pixel `pixel`):
// the sweep, the shading (emission, next-event estimation) and the scatter.
// Returns true when the path ended in it: a miss (background term), a death,
// or still alive after max_bounces bounces (a capped path keeps its
// radiance and gets no background term). Pairs of bounce b start at
// 1 + b*(2 + 2*La): +0 (branch, dir a), +1 (dir b, unused), +2+2i (u1, u2),
// +3+2i (u3, pick).
template <bool PHYSICAL, bool BIDIR, bool TEXTURED>
CPT_HD bool trace_bounce(const SceneTables& sc, const RenderParams& p, int pixel, int sample,
                         PathState& st) {
    const int ppb = 2 + 2 * sc.num_area_lights;
    const int pair0 = 1 + st.b * ppb;
    const float ox = st.ox, oy = st.oy, oz = st.oz, dx = st.dx, dy = st.dy, dz = st.dz;
    const Hit h = intersect_sweep(sc, ox, oy, oz, dx, dy, dz);
    if (!(h.t < INFINITY)) {  // miss: background, path ends
        st.r0x += sc.background[0] * st.r1x;
        st.r0y += sc.background[1] * st.r1y;
        st.r0z += sc.background[2] * st.r1z;
        store_carry(p, st.r0x, st.r0y, st.r0z);
        return true;
    }
    const float px = ox + dx * h.t, py = oy + dy * h.t, pz = oz + dz * h.t;
    float nx = h.nx, ny = h.ny, nz = h.nz;
    const float* m = sc.materials + h.mat * M_COLS;
    float mt[TEXTURED ? M_COLS : 1];
    if constexpr (TEXTURED) {
        // color map on the diffuse albedo, normal map on the shading
        // normal, before the cosine, NEE and the scatter
        for (int k = 0; k < M_COLS; ++k) mt[k] = m[k];
        texture_block<false, false>(sc, ox, oy, oz, dx, dy, dz, h.prim, h.mat, mt,
                                    nx, ny, nz, nullptr);
        m = mt;
    }
    const float cos_i = -dot3(dx, dy, dz, nx, ny, nz);
    const bool inside = cos_i <= 0.0f;

    float dir_r, dir_g, dir_b;
    Lobes lb;
    BidirIn bd;
    float c_a = 0.0f;
    if constexpr (PHYSICAL) {
        lb = physical_lobes(dx, dy, dz, nx, ny, nz, cos_i, m);
        bd.nu = 0.0f; bd.T = 0.0f; bd.pco = 1.0f; bd.t2 = 1.0f; bd.is_primary = (st.b == 0);
        if constexpr (BIDIR) {
            const float cos_arr = fabsf(dot3(dx, dy, dz, lb.nux, lb.nuy, lb.nuz));
            bd.nu = p.cam[15];
            bd.pco = st.pco;
            bd.t2 = fmaxf(h.t * h.t, 1e-12f);
            c_a = st.j_img * cos_arr / bd.t2;
            const float e_prev = st.pf_model * cos_arr / bd.t2;
            bd.T = fminf(bd.is_primary ? 1.0f / fmaxf(c_a, 1e-20f)
                                       : st.lt_S / fmaxf(e_prev, 1e-20f),
                         MIS_RATIO_CLAMP);
        }
        physical_direct<BIDIR>(sc, p.seed, pixel, sample, pair0, px, py, pz, nx, ny, nz,
                               dx, dy, dz, h.t, st.prev_pdf, lb, m, h.prim, bd,
                               dir_r, dir_g, dir_b);
        if (inside) {
            st.r1x = st.r1x * expf(-h.t * m[6]);
            st.r1y = st.r1y * expf(-h.t * m[7]);
            st.r1z = st.r1z * expf(-h.t * m[8]);
        }
    } else {
        // emission always; NEE only from outside
        dir_r = m[9]; dir_g = m[10]; dir_b = m[11];
        if (!inside) {
            for (int i = 0; i < sc.num_point_lights; ++i) {
                const float* pl = sc.point_lights + i * PL_COLS;
                light_contribution(sc, px, py, pz, nx, ny, nz, m, pl[0], pl[1], pl[2],
                                   pl[3], pl[4], pl[5], dir_r, dir_g, dir_b);
            }
            for (int i = 0; i < sc.num_area_lights; ++i) {
                const float* al = sc.area_lights + i * AL_COLS;
                float u1, u2, u3, upick;
                uniform_pair(p.seed, pixel, sample, pair0 + 2 + 2 * i, u1, u2);
                uniform_pair(p.seed, pixel, sample, pair0 + 3 + 2 * i, u3, upick);
                const float inv_tot = 1.0f / fmaxf(u1 + u2 + u3, 1e-12f);
                const float w0 = u1 * inv_tot, w1 = u2 * inv_tot, w2 = u3 * inv_tot;
                const float* a = (upick > 0.5f) ? al : al + 9;
                const float lx = a[0] * w0 + a[3] * w1 + a[6] * w2;
                const float ly = a[1] * w0 + a[4] * w1 + a[7] * w2;
                const float lz = a[2] * w0 + a[5] * w1 + a[8] * w2;
                light_contribution(sc, px, py, pz, nx, ny, nz, m, lx, ly, lz,
                                   al[18], al[19], al[20], dir_r, dir_g, dir_b);
            }
        } else {
            // Beer-Lambert absorption along the segment inside the medium
            st.r1x = st.r1x * expf(-h.t * m[6]);
            st.r1y = st.r1y * expf(-h.t * m[7]);
            st.r1z = st.r1z * expf(-h.t * m[8]);
        }
    }
    st.r0x = st.r0x + st.r1x * dir_r;
    st.r0y = st.r0y + st.r1y * dir_g;
    st.r0z = st.r0z + st.r1z * dir_b;
    store_carry(p, st.r0x, st.r0y, st.r0z);

    float u_branch, u_a, u_b, unused;
    uniform_pair(p.seed, pixel, sample, pair0, u_branch, u_a);
    uniform_pair(p.seed, pixel, sample, pair0 + 1, u_b, unused);
    float nox, noy, noz, ndx, ndy, ndz, wr, wg, wb, ct_w;
    int branch;
    const bool alive = scatter_sample(dx, dy, dz, nx, ny, nz, px, py, pz, cos_i,
                                      u_branch, u_a, u_b, m,
                                      nox, noy, noz, ndx, ndy, ndz, wr, wg, wb,
                                      branch, ct_w);
    ++st.b;
    if (!alive || st.b >= p.max_bounces) return true;
    if constexpr (PHYSICAL) {
        // a path that goes on carries the density of the continuation it took
        st.prev_pdf = inside ? 0.0f
                             : physical_prev_pdf(lb, m, dx, dy, dz, ndx, ndy, ndz, branch);
    }
    if constexpr (BIDIR) {
        // chain-model densities of the taken branch, both directions
        const float pdf_fwd_m = chain_model_taken(dx, dy, dz, nx, ny, nz, cos_i,
                                                  ndx, ndy, ndz, m, branch);
        const float cos_rev = dot3(ndx, ndy, ndz, nx, ny, nz);
        const float pdf_rev_m = chain_model_taken(-ndx, -ndy, -ndz, nx, ny, nz, cos_rev,
                                                  -dx, -dy, -dz, m, branch);
        const float lam_full = pdf_rev_m * st.pco / bd.t2;
        st.lt_S = fminf(bd.is_primary
                            ? (((branch == BRANCH_DIFFUSE) && (cos_i > 0.0f)) ? 1.0f : 0.0f)
                                  / fmaxf(c_a, 1e-20f)
                            : bd.T * lam_full,
                        MIS_RATIO_CLAMP);
        st.pf_model = pdf_fwd_m;
        st.pco = fabsf(dot3(ndx, ndy, ndz, lb.nux, lb.nuy, lb.nuz));
    }
    st.ox = nox; st.oy = noy; st.oz = noz;
    st.dx = ndx; st.dy = ndy; st.dz = ndz;
    st.r1x = st.r1x * wr; st.r1y = st.r1y * wg; st.r1z = st.r1z * wb;
    store_carry(p, st.r1x, st.r1y, st.r1z);
    return false;
}

// A finished path's radiance into the pixel's sums, clamped first when
// cam[14] (the sample clamp) is positive.
CPT_HD void add_sample(const RenderParams& p, const PathState& st,
                       float& sum_r, float& sum_g, float& sum_b) {
    const float clamp_v = p.cam[14];
    float rx = st.r0x, ry = st.r0y, rz = st.r0z;
    if (clamp_v > 0.0f) {
        rx = fminf(rx, clamp_v);
        ry = fminf(ry, clamp_v);
        rz = fminf(rz, clamp_v);
    }
    sum_r += rx; sum_g += ry; sum_b += rz;
}

// Radiance SUM over p.spp samples of flat pixel `pixel` (= y*width + x, row 0
// at the bottom). Every draw is a pure function of (seed, pixel,
// sample_offset + s, pair).
//
// The schedule is the TPU kernel's persistent path regeneration: ONE loop,
// one bounce per iteration. A lane holds its sample index s and its path's
// carries; the iteration in which a path ends adds it to the sums (in sample
// order) and the next iteration starts sample s + 1's eye ray. A warp then
// issues the sweep and the shading for every lane that still has samples
// left, not only for the lanes whose path of the current sample is still
// alive: no lane waits for the warp's longest path of a sample. The eye ray
// is before the sweep and the sum after it, so every live lane reaches the
// sweep at one program point. The per-lane arithmetic, and so the sums, are
// those of a loop over samples around a loop over bounces.
//
// PHYSICAL selects the unbiased MIS estimator (the density of the last
// scatter is carried to weigh an emission hit); BIDIR adds the carries of the
// bidirectional weights — chain ratio lt_S, the last scatter's chain-model
// density pf_model, its outgoing cosine pco and the eye ray's camera
// importance j_img — with the count ratio nu in cam[15]. TEXTURED applies
// the scene's color and normal maps at every hit (on a local copy of the hit
// material's columns). Tables that carry a grid sweep through it (see
// grid_tables); p.state_bf16 stores r0 / r1 as bfloat16 at the end of every
// bounce (a kernel fixes it at compile time, see bf16_params). The default
// instantiation is the reference-parity estimator on an untextured scene with
// linear sweeps.
template <bool PHYSICAL, bool BIDIR, bool TEXTURED>
CPT_HD void render_pixel_t(const SceneTables& sc, const RenderParams& p, int pixel,
                           float& sum_r, float& sum_g, float& sum_b) {
    static_assert(PHYSICAL || !BIDIR, "the bidirectional carries run on the physical estimator");
    sum_r = 0.0f; sum_g = 0.0f; sum_b = 0.0f;
    if (pixel < 0 || pixel >= p.width * p.height) return;
    const float pxi = (float)(pixel % p.width);
    const float pyi = (float)(pixel / p.width);
    PathState st;
    bool fresh = true;  // the lane starts a path in this iteration
    int s = 0;
    while (s < p.spp) {
        const int sample = p.sample_offset + s;
        if (fresh) start_path<BIDIR>(p, pixel, sample, pxi, pyi, st);
        fresh = trace_bounce<PHYSICAL, BIDIR, TEXTURED>(sc, p, pixel, sample, st);
        if (fresh) {
            add_sample(p, st, sum_r, sum_g, sum_b);
            ++s;
        }
    }
}

// The reference-parity estimator on an untextured scene (the default variant).
CPT_HD void render_pixel(const SceneTables& sc, const RenderParams& p, int pixel,
                         float& sum_r, float& sum_g, float& sum_b) {
    render_pixel_t<false, false, false>(sc, p, pixel, sum_r, sum_g, sum_b);
}

}  // namespace cpt
