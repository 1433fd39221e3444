// Test-only host build of the CUDA kernels' device math: the package's
// csrc/megakernel.cuh (forward render, all three estimator variants),
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
                             const float* background) {
    cpt::SceneTables sc;
    sc.spheres = spheres; sc.num_spheres = num_spheres;
    sc.triangles = triangles; sc.num_triangles = num_triangles;
    sc.materials = materials; sc.num_materials = num_materials;
    sc.point_lights = point_lights; sc.num_point_lights = num_point_lights;
    sc.area_lights = area_lights; sc.num_area_lights = num_area_lights;
    sc.background = background;
    return sc;
}

cpt::RenderParams make_params(const float* cam_host, int seed, int pixel_offset, int n_local,
                              int sample_offset, int spp, int max_bounces, int width, int height) {
    cpt::RenderParams p;
    for (int k = 0; k < cpt::CAM_FLOATS; ++k) p.cam[k] = cam_host[k];
    p.seed = seed; p.pixel_offset = pixel_offset; p.n_local = n_local;
    p.sample_offset = sample_offset; p.spp = spp; p.max_bounces = max_bounces;
    cpt::set_image_size(p, width, height);
    return p;
}

}  // namespace

extern "C" {

// Same arguments as cpt_render_megakernel (variant: 0 reference-parity, 1
// physical, 2 physical with the bidirectional carries), every pointer a host
// pointer, without the launch parameters.
int cpt_render_megakernel_host(const float* spheres, int num_spheres,
                               const float* triangles, int num_triangles,
                               const float* materials, int num_materials,
                               const float* point_lights, int num_point_lights,
                               const float* area_lights, int num_area_lights,
                               const float* background, const float* cam_host,
                               int seed, int pixel_offset, int n_local, int sample_offset,
                               int spp, int max_bounces, int width, int height, int variant,
                               float* out) {
    const cpt::SceneTables sc = make_tables(spheres, num_spheres, triangles, num_triangles,
                                            materials, num_materials, point_lights,
                                            num_point_lights, area_lights, num_area_lights,
                                            background);
    const cpt::RenderParams p = make_params(cam_host, seed, pixel_offset, n_local, sample_offset,
                                            spp, max_bounces, width, height);
    for (int i = 0; i < n_local; ++i) {
        float& r = out[3 * i];
        float& g = out[3 * i + 1];
        float& b = out[3 * i + 2];
        if (variant == 0) {
            cpt::render_pixel_t<false, false>(sc, p, pixel_offset + i, r, g, b);
        } else if (variant == 1) {
            cpt::render_pixel_t<true, false>(sc, p, pixel_offset + i, r, g, b);
        } else {
            cpt::render_pixel_t<true, true>(sc, p, pixel_offset + i, r, g, b);
        }
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
                                 const float* background, const float* cam_host,
                                 int seed, int pixel_offset, int n_local, int sample_offset,
                                 int spp, int max_bounces, int width, int height,
                                 int full, const float* g, double* rows) {
    const cpt::SceneTables sc = make_tables(spheres, num_spheres, triangles, num_triangles,
                                            materials, num_materials, point_lights,
                                            num_point_lights, area_lights, num_area_lights,
                                            background);
    const cpt::RenderParams p = make_params(cam_host, seed, pixel_offset, n_local, sample_offset,
                                            spp, max_bounces, width, height);
    const cpt::GradLayout L = cpt::grad_layout(num_spheres, num_materials, num_point_lights,
                                               num_area_lights, full != 0);
    const int planes = full ? cpt::ST_PLANES_FULL : cpt::ST_PLANES;
    std::vector<float> scratch((size_t)(max_bounces > 1 ? max_bounces : 1) * planes);
    cpt::CheckpointStore st;
    st.base = scratch.data(); st.stride = 1; st.planes = planes;
    HostSink sink;
    sink.rows = rows;
    for (int r = 0; r < L.rows; ++r) rows[r] = 0.0;
    for (int i = 0; i < n_local; ++i) {
        if (full) {
            cpt::backward_pixel<true>(sc, p, L, pixel_offset + i, g[3 * i], g[3 * i + 1],
                                      g[3 * i + 2], st, sink);
        } else {
            cpt::backward_pixel<false>(sc, p, L, pixel_offset + i, g[3 * i], g[3 * i + 1],
                                       g[3 * i + 2], st, sink);
        }
    }
    return L.rows;
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

}  // extern "C"
