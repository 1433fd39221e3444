// Test-only host build of the CUDA kernels' device math: the package's
// csrc/megakernel.cuh (forward render, all three estimator variants, linear
// and grid sweeps),
// csrc/megakernel_vjp.cuh (replay VJP) and csrc/lightkernel.cuh (light
// tracing) compiled by a host C++ compiler, one loop iteration per pixel or
// light path, so that
// the kernels' arithmetic can be held against the plain PyTorch version on a
// machine without a GPU. Built by torch_port_helpers.py:
//   g++ -std=c++17 -O2 -ffp-contract=off -shared -fPIC -I <package>/csrc ...
#include <vector>

#include "lightkernel.cuh"
#include "megakernel_vjp.cuh"

namespace {

// The host's row accumulator: double sums, so that what is compared is the
// kernel's per-path arithmetic and not the order of a float summation.
struct HostSink {
    double* rows;
    void add(int row, float v) { rows[row] += (double)v; }
};

cpt::SceneTables make_tables(const float* spheres, int num_spheres,
                             const float* triangles, int num_triangles,
                             const float* materials, int num_materials,
                             const float* point_lights, int num_point_lights,
                             const float* area_lights, int num_area_lights,
                             const float* background, const float* tex_atlas = nullptr,
                             const float* tex_meta = nullptr, const float* tex_triuv = nullptr,
                             const float* tex_matids = nullptr, int num_textures = 0,
                             const int* grid_idx = nullptr, const float* grid_scal = nullptr,
                             const int* grid_meta = nullptr) {
    cpt::SceneTables sc;
    sc.spheres = spheres; sc.num_spheres = num_spheres;
    sc.triangles = triangles; sc.num_triangles = num_triangles;
    sc.materials = materials; sc.num_materials = num_materials;
    sc.point_lights = point_lights; sc.num_point_lights = num_point_lights;
    sc.area_lights = area_lights; sc.num_area_lights = num_area_lights;
    sc.background = background;
    sc.tex_atlas = tex_atlas; sc.tex_meta = tex_meta;
    sc.tex_triuv = tex_triuv; sc.tex_matids = tex_matids; sc.num_textures = num_textures;
    cpt::set_grid(sc, grid_idx, grid_scal, grid_meta);
    return sc;
}

cpt::RenderParams make_params(const float* cam_host, int seed, int pixel_offset, int n_local,
                              int sample_offset, int spp, int max_bounces, int width, int height,
                              int state_bf16 = 0) {
    cpt::RenderParams p;
    p.state_bf16 = state_bf16;
    for (int k = 0; k < cpt::CAM_FLOATS; ++k) p.cam[k] = cam_host[k];
    p.seed = seed; p.pixel_offset = pixel_offset; p.n_local = n_local;
    p.sample_offset = sample_offset; p.spp = spp; p.max_bounces = max_bounces;
    cpt::set_image_size(p, width, height);
    return p;
}

template <bool TEXTURED>
void render_pixels(const cpt::SceneTables& sc, const cpt::RenderParams& p, int variant,
                   float* out) {
    for (int i = 0; i < p.n_local; ++i) {
        float& r = out[3 * i];
        float& g = out[3 * i + 1];
        float& b = out[3 * i + 2];
        if (variant == 0) {
            cpt::render_pixel_t<false, false, TEXTURED>(sc, p, p.pixel_offset + i, r, g, b);
        } else if (variant == 1) {
            cpt::render_pixel_t<true, false, TEXTURED>(sc, p, p.pixel_offset + i, r, g, b);
        } else {
            cpt::render_pixel_t<true, true, TEXTURED>(sc, p, p.pixel_offset + i, r, g, b);
        }
    }
}

}  // namespace

extern "C" {

// Same arguments as cpt_render_megakernel (variant: 0 reference-parity, 1
// physical, 2 physical with the bidirectional carries; a texture count > 0
// picks the textured instantiation, a grid_idx the grid sweeps), every pointer
// a host pointer, without the launch parameters.
int cpt_render_megakernel_host(const float* spheres, int num_spheres,
                               const float* triangles, int num_triangles,
                               const float* materials, int num_materials,
                               const float* point_lights, int num_point_lights,
                               const float* area_lights, int num_area_lights,
                               const float* background,
                               const float* tex_atlas, const float* tex_meta,
                               const float* tex_triuv, const float* tex_matids,
                               int num_textures, const int* grid_idx, const float* grid_scal,
                               const int* grid_meta, const float* cam_host,
                               int seed, int pixel_offset, int n_local, int sample_offset,
                               int spp, int max_bounces, int width, int height, int variant,
                               int state_bf16, float* out) {
    const cpt::SceneTables sc = make_tables(spheres, num_spheres, triangles, num_triangles,
                                            materials, num_materials, point_lights,
                                            num_point_lights, area_lights, num_area_lights,
                                            background, tex_atlas, tex_meta, tex_triuv,
                                            tex_matids, num_textures, grid_idx, grid_scal,
                                            grid_meta);
    const cpt::RenderParams p = make_params(cam_host, seed, pixel_offset, n_local, sample_offset,
                                            spp, max_bounces, width, height, state_bf16);
    if (num_textures > 0) {
        render_pixels<true>(sc, p, variant, out);
    } else {
        render_pixels<false>(sc, p, variant, out);
    }
    return 0;
}

// Same arguments as cpt_light_records, every pointer a host pointer, without
// the stream.
int cpt_light_records_host(const float* spheres, int num_spheres,
                           const float* triangles, int num_triangles,
                           const float* materials, int num_materials,
                           const float* point_lights, int num_point_lights,
                           const float* area_lights, int num_area_lights,
                           const float* cam_host,
                           int seed, int path_offset, int n_local, int sample_idx,
                           int n_paths, int max_bounces, int width, int height, int bidir,
                           int* pix, float* r, float* g, float* b) {
    const cpt::SceneTables sc = make_tables(spheres, num_spheres, triangles, num_triangles,
                                            materials, num_materials, point_lights,
                                            num_point_lights, area_lights, num_area_lights,
                                            nullptr);
    cpt::LightParams p;
    for (int k = 0; k < cpt::CAM_FLOATS; ++k) p.cam[k] = cam_host[k];
    p.seed = seed; p.path_offset = path_offset; p.n_local = n_local;
    p.sample_idx = sample_idx; p.n_paths = n_paths; p.max_bounces = max_bounces;
    cpt::set_light_image_size(p, width, height);
    for (int i = 0; i < n_local; ++i) {
        cpt::RecordOut out;
        out.pix = pix + i; out.r = r + i; out.g = g + i; out.b = b + i;
        out.stride = (size_t)n_local;
        if (bidir) {
            cpt::light_path<true>(sc, p, path_offset + i, out);
        } else {
            cpt::light_path<false>(sc, p, path_offset + i, out);
        }
    }
    return 0;
}

// Same arguments as cpt_backward_megakernel without scratch, launch shape and
// stream; rows[] receives the gradient rows (GradLayout) summed over pixels.
// Returns the number of rows.
int cpt_backward_megakernel_host(const float* spheres, int num_spheres,
                                 const float* triangles, int num_triangles,
                                 const float* materials, int num_materials,
                                 const float* point_lights, int num_point_lights,
                                 const float* area_lights, int num_area_lights,
                                 const float* background,
                                 const float* tex_atlas, const float* tex_meta,
                                 const float* tex_triuv, const float* tex_matids,
                                 int num_textures, const int* grid_idx, const float* grid_scal,
                                 const int* grid_meta, const float* cam_host,
                                 int seed, int pixel_offset, int n_local, int sample_offset,
                                 int spp, int max_bounces, int width, int height,
                                 int full, int texels, int tex_grads, int tex_nmap,
                                 const float* g, double* rows) {
    const cpt::SceneTables sc = make_tables(spheres, num_spheres, triangles, num_triangles,
                                            materials, num_materials, point_lights,
                                            num_point_lights, area_lights, num_area_lights,
                                            background, tex_atlas, tex_meta, tex_triuv,
                                            tex_matids, num_textures, grid_idx, grid_scal,
                                            grid_meta);
    const cpt::RenderParams p = make_params(cam_host, seed, pixel_offset, n_local, sample_offset,
                                            spp, max_bounces, width, height);
    const cpt::TexLayout T = cpt::tex_layout(full != 0, num_textures > 0, tex_grads != 0,
                                             tex_nmap != 0);
    const cpt::GradLayout L = cpt::grad_layout(num_spheres, num_materials, num_point_lights,
                                               num_area_lights, full != 0,
                                               T.grads ? texels : 0);
    std::vector<float> scratch((size_t)(max_bounces > 1 ? max_bounces : 1) * T.planes);
    cpt::CheckpointStore st;
    st.base = scratch.data(); st.stride = 1; st.planes = T.planes;
    HostSink sink;
    sink.rows = rows;
    for (int r = 0; r < L.rows; ++r) rows[r] = 0.0;
    for (int i = 0; i < n_local; ++i) {
        const float gx = g[3 * i], gy = g[3 * i + 1], gz = g[3 * i + 2];
        const int pixel = pixel_offset + i;
        if (full && T.on) {
            cpt::backward_pixel<true, true>(sc, p, L, T, pixel, gx, gy, gz, st, sink);
        } else if (full) {
            cpt::backward_pixel<true, false>(sc, p, L, T, pixel, gx, gy, gz, st, sink);
        } else if (T.on) {
            cpt::backward_pixel<false, true>(sc, p, L, T, pixel, gx, gy, gz, st, sink);
        } else {
            cpt::backward_pixel<false, false>(sc, p, L, T, pixel, gx, gy, gz, st, sink);
        }
    }
    return L.rows;
}

// The two scene sweeps on n rays (o, d: three runs of n floats each; max_d
// per ray), with the grid bundle when grid_idx is non-null, else linear:
// t[n], prim[n] of the nearest hit (intersect_sweep) and occ[n] (0 / 1) of
// occlusion_sweep within max_d.
void cpt_sweeps_host(const float* spheres, int num_spheres, const float* triangles,
                     int num_triangles, const int* grid_idx, const float* grid_scal,
                     const int* grid_meta, int n, const float* o, const float* d,
                     const float* max_d, float* t, int* prim, int* occ) {
    const cpt::SceneTables sc = make_tables(spheres, num_spheres, triangles, num_triangles,
                                            nullptr, 0, nullptr, 0, nullptr, 0, nullptr, nullptr,
                                            nullptr, nullptr, nullptr, 0, grid_idx, grid_scal,
                                            grid_meta);
    for (int i = 0; i < n; ++i) {
        const cpt::Hit h = cpt::intersect_sweep(sc, o[i], o[n + i], o[2 * n + i], d[i],
                                                d[n + i], d[2 * n + i]);
        t[i] = h.t;
        prim[i] = h.prim;
        occ[i] = cpt::occlusion_sweep(sc, o[i], o[n + i], o[2 * n + i], d[i], d[n + i],
                                      d[2 * n + i], max_d[i]) ? 1 : 0;
    }
}

// round_bf16 elementwise: what the state_bf16 carries store.
void cpt_round_bf16_host(int n, const float* x, float* y) {
    for (int i = 0; i < n; ++i) y[i] = cpt::round_bf16(x[i]);
}

// norm3_vjp / rot_y_to_vjp elementwise over n inputs; every array holds its
// three components as three runs of n floats.
void cpt_norm3_vjp_host(int n, const float* v, const float* g, float eps, float* a) {
    for (int i = 0; i < n; ++i) {
        cpt::norm3_vjp(v[i], v[n + i], v[2 * n + i], g[i], g[n + i], g[2 * n + i], eps,
                       a[i], a[n + i], a[2 * n + i]);
    }
}

void cpt_rot_y_to_vjp_host(int n, const float* t, const float* s, const float* g,
                           float* a_t, float* a_s) {
    for (int i = 0; i < n; ++i) {
        cpt::rot_y_to_vjp(t[i], t[n + i], t[2 * n + i], s[i], s[n + i], s[2 * n + i],
                          g[i], g[n + i], g[2 * n + i], a_t[i], a_t[n + i], a_t[2 * n + i],
                          a_s[i], a_s[n + i], a_s[2 * n + i]);
    }
}

// ---- the texture block's device functions, elementwise over n lanes ----------
// Every array holds its components as runs of n values (component k of lane i
// at [k * n + i]).

// out: atan(x), atan2(y, x), asin(x), atan'(x), d atan2/dy, d atan2/dx, asin'(x)
void cpt_poly_host(int n, const float* x, const float* y, float* out) {
    for (int i = 0; i < n; ++i) {
        out[i] = cpt::poly_atan(x[i]);
        out[n + i] = cpt::poly_atan2(y[i], x[i]);
        out[2 * n + i] = cpt::poly_asin(x[i]);
        out[3 * n + i] = cpt::poly_atan_d(x[i]);
        cpt::poly_atan2_d(y[i], x[i], out[4 * n + i], out[5 * n + i]);
        out[6 * n + i] = cpt::poly_asin_d(x[i]);
    }
}

// One bilinear fetch with its adjoint bundle: val[3], idx[4], w[4], du[3], dv[3].
void cpt_tex_fetch_host(const float* tex_atlas, const float* tex_meta, int num_textures, int n,
                        const float* tid, const float* u, const float* v, float* val, int* idx,
                        float* w, float* du, float* dv) {
    cpt::SceneTables sc = make_tables(nullptr, 0, nullptr, 0, nullptr, 0, nullptr, 0, nullptr, 0,
                                      nullptr, tex_atlas, tex_meta, nullptr, nullptr,
                                      num_textures);
    for (int i = 0; i < n; ++i) {
        cpt::TexFetch f;
        cpt::tex_fetch<true>(sc, tid[i], u[i], v[i], f);
        for (int c = 0; c < 3; ++c) {
            val[c * n + i] = f.val[c]; du[c * n + i] = f.du[c]; dv[c * n + i] = f.dv[c];
        }
        for (int k = 0; k < 4; ++k) { idx[k * n + i] = f.idx[k]; w[k * n + i] = f.w[k]; }
    }
}

// texture_block at n hits (ray o, d; primitive; material; raw normal; the
// material's diffuse) -> diffuse', normal' and the UV partials uvg[6].
int cpt_texture_block_host(const float* spheres, int num_spheres,
                           const float* triangles, int num_triangles,
                           const float* materials, int num_materials,
                           const float* tex_atlas, const float* tex_meta,
                           const float* tex_triuv, const float* tex_matids, int num_textures,
                           int n, const float* o, const float* d, const int* prim,
                           const int* mat, const float* nrm, float* diffuse, float* nrm_out,
                           float* uvg) {
    cpt::SceneTables sc = make_tables(spheres, num_spheres, triangles, num_triangles, materials,
                                      num_materials, nullptr, 0, nullptr, 0, nullptr, tex_atlas,
                                      tex_meta, tex_triuv, tex_matids, num_textures);
    for (int i = 0; i < n; ++i) {
        float m[cpt::M_COLS];
        for (int k = 0; k < cpt::M_COLS; ++k) m[k] = materials[mat[i] * cpt::M_COLS + k];
        float nx = nrm[i], ny = nrm[n + i], nz = nrm[2 * n + i];
        cpt::TexAux aux;
        cpt::texture_block<true, true>(sc, o[i], o[n + i], o[2 * n + i], d[i], d[n + i],
                                       d[2 * n + i], prim[i], mat[i], m, nx, ny, nz, &aux);
        for (int c = 0; c < 3; ++c) diffuse[c * n + i] = m[c];
        nrm_out[i] = nx; nrm_out[n + i] = ny; nrm_out[2 * n + i] = nz;
        for (int k = 0; k < 6; ++k) uvg[k * n + i] = aux.uvg[k];
    }
    return 0;
}

// perturb_normal_vjp at n hits on primitive prim[i] (the tangent source as the
// backward kernel takes it): raw normal, texel t, cotangent g -> an, at.
void cpt_perturb_normal_vjp_host(const float* triangles, int num_spheres,
                                 const float* tex_triuv, int n, const int* prim,
                                 const float* raw, const float* t, const float* g, float* an,
                                 float* at) {
    for (int i = 0; i < n; ++i) {
        const bool sphere = prim[i] < num_spheres;
        float tgx = 0.0f, tgy = 0.0f, tgz = 0.0f, a[3], b[3];
        if (!sphere) {
            const int ti = prim[i] - num_spheres;
            cpt::tri_uv_tangent(triangles + ti * cpt::T_COLS, tex_triuv + ti * 6, tgx, tgy, tgz);
        }
        cpt::perturb_normal_vjp(raw[i], raw[n + i], raw[2 * n + i], sphere, tgx, tgy, tgz, t[i],
                                t[n + i], t[2 * n + i], g[i], g[n + i], g[2 * n + i], a, b);
        for (int c = 0; c < 3; ++c) { an[c * n + i] = a[c]; at[c * n + i] = b[c]; }
    }
}

}  // extern "C"
