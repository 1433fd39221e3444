// Test-only host build of the CUDA kernels' device math: the package's
// csrc/megakernel.cuh (forward render, all three estimator variants, linear
// and grid sweeps),
// csrc/megakernel_vjp.cuh (replay VJP, every grad mode, every schedule, and
// the hand-written adjoints it is built from)
// and csrc/lightkernel.cuh (light tracing)
// compiled by a host C++ compiler, one loop iteration per pixel or light
// path, so that
// the kernels' arithmetic can be held against the plain PyTorch version on a
// machine without a GPU. Built by torch_port_helpers.py:
//   g++ -std=c++17 -O2 -ffp-contract=off -shared -fPIC -I <package>/csrc ...
#include <utility>
#include <vector>

#include "lightkernel.cuh"
#include "megakernel_vjp.cuh"

namespace {

// The host's row accumulator: double sums, so that what is compared is the
// kernel's per-path arithmetic and not the order of a float summation. With
// a log it also records every contribution the card's sinks would add (the
// nonzero ones), as (row, value).
struct HostSink {
    double* rows;
    std::vector<std::pair<int, float>>* log = nullptr;
    void add(int row, float v) {
        rows[row] += (double)v;
        if (log != nullptr && v != 0.0f) log->emplace_back(row, v);
    }
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

// The schedule K1 had before per-lane path regeneration: a loop over samples
// around a loop over bounces, on the same per-path functions. The
// regenerating render_pixel_t must give its sums bit for bit.
template <bool PHYSICAL, bool BIDIR, bool TEXTURED>
void render_pixel_nested(const cpt::SceneTables& sc, const cpt::RenderParams& p, int pixel,
                         float& sum_r, float& sum_g, float& sum_b) {
    sum_r = 0.0f; sum_g = 0.0f; sum_b = 0.0f;
    if (pixel < 0 || pixel >= p.width * p.height) return;
    const float pxi = (float)(pixel % p.width);
    const float pyi = (float)(pixel / p.width);
    for (int s = 0; s < p.spp; ++s) {
        const int sample = p.sample_offset + s;
        cpt::PathState st;
        cpt::start_path<BIDIR>(p, pixel, sample, pxi, pyi, st);
        while (!cpt::trace_bounce<PHYSICAL, BIDIR, TEXTURED>(sc, p, pixel, sample, st)) {
        }
        cpt::add_sample(p, st, sum_r, sum_g, sum_b);
    }
}

// schedule 0: render_pixel_t; 1: render_pixel_nested; 2: render_pixel_t on
// a copy of the small tables made by stage_tables (as K1's blocks read them
// from shared memory), copied by two interleaved workers.
template <bool PHYSICAL, bool BIDIR, bool TEXTURED>
void render_pixels_v(const cpt::SceneTables& sc, const cpt::RenderParams& p, int schedule,
                     float* out) {
    cpt::SceneTables s = sc;
    std::vector<float> copy;
    if (schedule == 2) {
        copy.assign(cpt::small_table_floats(sc), -1.0f);
        for (int w = 0; w < 2; ++w) s = cpt::stage_tables(sc, copy.data(), w, 2);
    }
    for (int i = 0; i < p.n_local; ++i) {
        float* o = out + 3 * i;
        if (schedule == 1) {
            render_pixel_nested<PHYSICAL, BIDIR, TEXTURED>(s, p, p.pixel_offset + i, o[0], o[1],
                                                           o[2]);
        } else {
            cpt::render_pixel_t<PHYSICAL, BIDIR, TEXTURED>(s, p, p.pixel_offset + i, o[0], o[1],
                                                           o[2]);
        }
    }
}

template <bool TEXTURED>
void render_pixels(const cpt::SceneTables& sc, const cpt::RenderParams& p, int variant,
                   int schedule, float* out) {
    if (variant == 0) {
        render_pixels_v<false, false, TEXTURED>(sc, p, schedule, out);
    } else if (variant == 1) {
        render_pixels_v<true, false, TEXTURED>(sc, p, schedule, out);
    } else {
        render_pixels_v<true, true, TEXTURED>(sc, p, schedule, out);
    }
}

// The schedule K2 had before its two flat passes: a loop over samples around
// a replay loop and a reverse loop, bounce b in slot b, on the same per-path
// functions. The flat backward_pixel must send the same contributions.
template <bool FULL, bool TEXTURED, bool PHYSICAL, bool GEO, class Store, class Sink>
void backward_pixel_nested(const cpt::SceneTables& sc, const cpt::RenderParams& p,
                           const cpt::GradLayout& L, const cpt::TexLayout& T, int pixel, float gx,
                           float gy, float gz, const Store& st, Sink& acc) {
    if (pixel < 0 || pixel >= p.width * p.height) return;
    const float pxi = (float)(pixel % p.width);
    const float pyi = (float)(pixel / p.width);
    for (int s = 0; s < p.spp; ++s) {
        const int sample = p.sample_offset + s;
        cpt::ReplayState rs;
        cpt::start_replay(p, pixel, sample, pxi, pyi, rs);
        int end;
        do {
            end = cpt::replay_bounce<FULL, TEXTURED, PHYSICAL, GEO>(sc, p, L, T, pixel, sample, gx,
                                                                   gy, gz, rs, st, rs.b, acc);
        } while (end == cpt::REPLAY_GOES_ON);
        cpt::ReverseState rv;
        cpt::start_reverse(sc, gx, gy, gz, end == cpt::REPLAY_MISSED, rv);
        for (int b = rs.b - 1; b >= 0; --b) {
            cpt::reverse_bounce<FULL, TEXTURED, PHYSICAL, GEO>(sc, p, L, T, pixel, sample, b,
                                                              b + 1 == rs.b, gx, gy, gz, rv, st,
                                                              b, acc);
        }
        if (FULL) cpt::eye_vjp(p, pixel, sample, pxi, pyi, rv.ao, rv.ad, L.row_cam0, acc);
    }
}

// Every pixel of the range, one after the other, on stacks of `capacity`
// slots: schedule 0 the flat two passes (backward_pixel), 1 the nested loops,
// 2 the kernel's split schedule (every pixel's replay, each lane's stack and
// slots in use kept, then every pixel's reverse sweep; a stack of one round).
template <bool FULL, bool TEXTURED, bool PHYSICAL, bool GEO>
void backward_pixels_t(const cpt::SceneTables& sc, const cpt::RenderParams& p,
                       const cpt::GradLayout& L, const cpt::TexLayout& T, const float* g,
                       int schedule, int capacity, HostSink& sink) {
    std::vector<float> scratch((size_t)capacity * T.slot_floats * (p.n_local > 0 ? p.n_local : 1),
                               -1.0f);
    if (schedule == 2) {
        std::vector<int> tops(p.n_local > 0 ? p.n_local : 1, 0);
        for (int phase = 0; phase < 2; ++phase) {
            for (int i = 0; i < p.n_local; ++i) {
                cpt::CheckpointStore st;
                st.slot_floats = T.slot_floats;
                st.base = scratch.data() + (size_t)i * capacity * T.slot_floats;
                const float gx = g[3 * i], gy = g[3 * i + 1], gz = g[3 * i + 2];
                const int pixel = p.pixel_offset + i;
                if (phase == 0) {
                    tops[i] = cpt::backward_pixel_replay<FULL, TEXTURED, PHYSICAL, GEO>(
                        sc, p, L, T, pixel, gx, gy, gz, st, capacity, sink);
                } else {
                    cpt::backward_pixel_reverse<FULL, TEXTURED, PHYSICAL, GEO>(
                        sc, p, L, T, pixel, gx, gy, gz, st, tops[i], sink, sink, L.row_cam0);
                }
            }
        }
        return;
    }
    for (int i = 0; i < p.n_local; ++i) {
        cpt::CheckpointStore st;
        st.slot_floats = T.slot_floats;
        st.base = scratch.data() + (size_t)i * capacity * T.slot_floats;
        const float gx = g[3 * i], gy = g[3 * i + 1], gz = g[3 * i + 2];
        const int pixel = p.pixel_offset + i;
        if (schedule == 1) {
            backward_pixel_nested<FULL, TEXTURED, PHYSICAL, GEO>(sc, p, L, T, pixel, gx, gy, gz,
                                                                 st, sink);
        } else {
            cpt::backward_pixel<FULL, TEXTURED, PHYSICAL, GEO>(sc, p, L, T, pixel, gx, gy, gz, st,
                                                               capacity, sink, sink, L.row_cam0);
        }
    }
}

template <bool FULL, bool PHYSICAL, bool GEO>
void backward_pixels(const cpt::SceneTables& sc, const cpt::RenderParams& p,
                     const cpt::GradLayout& L, const cpt::TexLayout& T, const float* g,
                     int schedule, int capacity, HostSink& sink) {
    if (T.on) {
        backward_pixels_t<FULL, true, PHYSICAL, GEO>(sc, p, L, T, g, schedule, capacity, sink);
    } else {
        backward_pixels_t<FULL, false, PHYSICAL, GEO>(sc, p, L, T, g, schedule, capacity, sink);
    }
}

// A float row accumulator (the adjoints' unit tests).
struct ArraySink {
    float* rows;
    void add(int row, float v) { rows[row] += v; }
};

// Lane i's n-run arrays: component k at [k * n + i].
void get3(const float* a, int n, int i, float* v) {
    v[0] = a[i]; v[1] = a[n + i]; v[2] = a[2 * n + i];
}
void put3(float* a, int n, int i, const float* v) {
    a[i] = v[0]; a[n + i] = v[1]; a[2 * n + i] = v[2];
}

// The light kernel's image sink on the host: serial float adds.
struct HostImageSink {
    float* img;
    void splat(int, int, int pixel, float r, float g, float b) const {
        img[3 * pixel] += r;
        img[3 * pixel + 1] += g;
        img[3 * pixel + 2] += b;
    }
};

cpt::LightParams make_light_params(const float* cam_host, int seed, int path_offset,
                                   int n_local, int sample_idx, int n_paths, int max_bounces,
                                   int width, int height) {
    cpt::LightParams p;
    for (int k = 0; k < cpt::CAM_FLOATS; ++k) p.cam[k] = cam_host[k];
    p.seed = seed; p.path_offset = path_offset; p.n_local = n_local;
    p.sample_idx = sample_idx; p.n_paths = n_paths; p.max_bounces = max_bounces;
    cpt::set_light_image_size(p, width, height);
    return p;
}

// A lane of the regenerating schedule the light kernel was measured with
// (k1_turns.py, copy k3_regenerating): its current path and that path's
// carries. Lane l of n_lanes traces paths l, l + n_lanes, ..., one bounce
// per iteration, opening its next path as soon as one ends.
struct LightLane {
    cpt::LightPathState st;
    int local = 0;
    bool fresh = true;  // the lane opens its path in its next step
};

// One iteration of lane `ln`: one bounce of its path, opened first when the
// lane's last path ended (a path that makes no bounce is opened and passed
// over in the same step). False, having done nothing, once the lane has no
// path left.
template <bool BIDIR, class Sink>
bool light_lane_step(const cpt::SceneTables& sc, const cpt::LightParams& p, int n_lanes,
                     LightLane& ln, const Sink& sink) {
    while (ln.local < p.n_local) {
        if (ln.fresh) {
            ln.fresh = false;
            if (!cpt::start_light_path<BIDIR>(sc, p, ln.local, ln.st, sink)) {
                ln.fresh = true;
                ln.local += n_lanes;
                continue;
            }
        }
        if (!cpt::light_bounce<BIDIR>(sc, p, ln.local, ln.st, sink)) {
            ln.fresh = true;
            ln.local += n_lanes;
        }
        return true;
    }
    return false;
}

// The light paths of p in one of two schedules. 0: the kernel's, one path
// per call traced to its end (light_path), in path order. 1: the
// regenerating schedule over n_lanes lanes, stepped lanes in order, one
// bounce per lane per iteration, until no lane has a path left.
template <bool BIDIR, class Sink>
void light_paths_t(const cpt::SceneTables& sc, const cpt::LightParams& p, int schedule,
                   int n_lanes, const Sink& sink) {
    if (schedule == 0) {
        for (int i = 0; i < p.n_local; ++i) cpt::light_path<BIDIR>(sc, p, i, sink);
        return;
    }
    std::vector<LightLane> lanes(n_lanes);
    for (int l = 0; l < n_lanes; ++l) lanes[l].local = l;
    for (bool any = true; any;) {
        any = false;
        for (int l = 0; l < n_lanes; ++l) {
            any = light_lane_step<BIDIR>(sc, p, n_lanes, lanes[l], sink) || any;
        }
    }
}

template <class Sink>
void light_paths(const cpt::SceneTables& sc, const cpt::LightParams& p, bool bidir,
                 int schedule, int n_lanes, const Sink& sink) {
    if (bidir) {
        light_paths_t<true>(sc, p, schedule, n_lanes, sink);
    } else {
        light_paths_t<false>(sc, p, schedule, n_lanes, sink);
    }
}

}  // namespace

extern "C" {

// Same arguments as cpt_render_megakernel (variant: 0 reference-parity, 1
// physical, 2 physical with the bidirectional carries; a texture count > 0
// picks the textured instantiation, a grid_idx the grid sweeps), every pointer
// a host pointer, without the launch parameters; `schedule` as render_pixels_v.
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
                               int state_bf16, int schedule, float* out) {
    const cpt::SceneTables sc = make_tables(spheres, num_spheres, triangles, num_triangles,
                                            materials, num_materials, point_lights,
                                            num_point_lights, area_lights, num_area_lights,
                                            background, tex_atlas, tex_meta, tex_triuv,
                                            tex_matids, num_textures, grid_idx, grid_scal,
                                            grid_meta);
    const cpt::RenderParams p = make_params(cam_host, seed, pixel_offset, n_local, sample_offset,
                                            spp, max_bounces, width, height, state_bf16);
    if (num_textures > 0) {
        render_pixels<true>(sc, p, variant, schedule, out);
    } else {
        render_pixels<false>(sc, p, variant, schedule, out);
    }
    return 0;
}

// Same arguments as cpt_light_records, every pointer a host pointer, into
// zeroed planes, without the stream; `schedule` as light_paths.
int cpt_light_records_host(const float* spheres, int num_spheres,
                           const float* triangles, int num_triangles,
                           const float* materials, int num_materials,
                           const float* point_lights, int num_point_lights,
                           const float* area_lights, int num_area_lights,
                           const float* cam_host,
                           int seed, int path_offset, int n_local, int sample_idx,
                           int n_paths, int max_bounces, int width, int height, int bidir,
                           int schedule, int n_lanes, int* pix, float* r, float* g, float* b) {
    const cpt::RecordSink sink{pix, r, g, b, (size_t)n_local};
    light_paths(make_tables(spheres, num_spheres, triangles, num_triangles, materials,
                            num_materials, point_lights, num_point_lights, area_lights,
                            num_area_lights, nullptr),
                make_light_params(cam_host, seed, path_offset, n_local, sample_idx, n_paths,
                                  max_bounces, width, height),
                bidir != 0, schedule, n_lanes, sink);
    return 0;
}

// The image sink of cpt_light_image on the host: img[width * height][3]
// (zeroed) receives every splat by a serial float add, in the schedule's
// order.
int cpt_light_image_host(const float* spheres, int num_spheres,
                         const float* triangles, int num_triangles,
                         const float* materials, int num_materials,
                         const float* point_lights, int num_point_lights,
                         const float* area_lights, int num_area_lights,
                         const float* cam_host,
                         int seed, int path_offset, int n_local, int sample_idx,
                         int n_paths, int max_bounces, int width, int height, int bidir,
                         int schedule, int n_lanes, float* img) {
    const HostImageSink sink{img};
    light_paths(make_tables(spheres, num_spheres, triangles, num_triangles, materials,
                            num_materials, point_lights, num_point_lights, area_lights,
                            num_area_lights, nullptr),
                make_light_params(cam_host, seed, path_offset, n_local, sample_idx, n_paths,
                                  max_bounces, width, height),
                bidir != 0, schedule, n_lanes, sink);
    return 0;
}

// Same arguments as cpt_backward_megakernel without scratch, launch shape and
// stream; rows[] receives the gradient rows (GradLayout) summed over pixels.
// `schedule` (0 flat, 1 nested, 2 split) and `capacity` (slots per lane) as
// backward_pixels; the split schedule takes a stack of one round
// (capacity >= max(max_bounces, 1) * spp), else -1. With rec_rows non-null
// the nonzero contributions are also recorded, (rec_rows[j], rec_vals[j]) for
// j < min(*n_records, max_records); *n_records receives their number.
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
                                 int full, int physical, int geo, int texels, int tex_grads,
                                 int tex_nmap, const float* g, double* rows, int schedule,
                                 int capacity, long long max_records, int* rec_rows,
                                 float* rec_vals, long long* n_records) {
    const cpt::SceneTables sc = make_tables(spheres, num_spheres, triangles, num_triangles,
                                            materials, num_materials, point_lights,
                                            num_point_lights, area_lights, num_area_lights,
                                            background, tex_atlas, tex_meta, tex_triuv,
                                            tex_matids, num_textures, grid_idx, grid_scal,
                                            grid_meta);
    const cpt::RenderParams p = make_params(cam_host, seed, pixel_offset, n_local, sample_offset,
                                            spp, max_bounces, width, height);
    const bool any_full = full || physical || geo;
    const cpt::TexLayout T = cpt::tex_layout(any_full, num_textures > 0, tex_grads != 0,
                                             tex_nmap != 0, physical != 0);
    const cpt::GradLayout L = cpt::grad_layout(num_spheres, num_triangles, num_materials,
                                               num_point_lights, num_area_lights, any_full,
                                               T.grads ? texels : 0, physical != 0, geo != 0);
    const int span = max_bounces > 1 ? max_bounces : 1;
    if (capacity < span || (schedule == 2 && capacity < span * spp)) return -1;
    std::vector<std::pair<int, float>> log;
    HostSink sink;
    sink.rows = rows;
    if (rec_rows != nullptr) sink.log = &log;
    for (int r = 0; r < L.rows; ++r) rows[r] = 0.0;
    if (physical && geo) {
        backward_pixels<true, true, true>(sc, p, L, T, g, schedule, capacity, sink);
    } else if (physical) {
        backward_pixels<true, true, false>(sc, p, L, T, g, schedule, capacity, sink);
    } else if (geo) {
        backward_pixels<true, false, true>(sc, p, L, T, g, schedule, capacity, sink);
    } else if (full) {
        backward_pixels<true, false, false>(sc, p, L, T, g, schedule, capacity, sink);
    } else {
        backward_pixels<false, false, false>(sc, p, L, T, g, schedule, capacity, sink);
    }
    if (rec_rows != nullptr) {
        *n_records = (long long)log.size();
        for (size_t j = 0; j < log.size() && (long long)j < max_records; ++j) {
            rec_rows[j] = log[j].first;
            rec_vals[j] = log[j].second;
        }
    }
    return L.rows;
}

// tex_layout(...).slot_floats: the floats of one checkpoint slot.
int cpt_slot_floats_host(int full, int physical, int geo, int textured, int tex_grads,
                         int tex_nmap) {
    return cpt::tex_layout(full || physical || geo, textured != 0, tex_grads != 0, tex_nmap != 0,
                           physical != 0)
        .slot_floats;
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

// ---- the hand-written adjoints of the geo and physical modes, lane by lane ----
// Every array holds its components as runs of n values.

// triangle_t_vjp at s = o - v0 -> a_s, a_d, a_e1, a_e2.
void cpt_triangle_t_vjp_host(int n, const float* s, const float* d, const float* e1,
                             const float* e2, const float* t, const float* at, const float* aw1,
                             const float* aw2, float* as, float* ad, float* ae1, float* ae2) {
    for (int i = 0; i < n; ++i) {
        float sv[3], dv[3], tr[9], o_s[3], o_d[3], o_1[3], o_2[3], w1, w2;
        get3(s, n, i, sv); get3(d, n, i, dv);
        get3(e1, n, i, tr + 3); get3(e2, n, i, tr + 6);
        tr[0] = tr[1] = tr[2] = 0.0f;
        cpt::triangle_t_vjp<true>(sv[0], sv[1], sv[2], dv[0], dv[1], dv[2], tr, t[i], at[i],
                                  aw1[i], aw2[i], o_s, o_d, o_1, o_2, w1, w2);
        put3(as, n, i, o_s); put3(ad, n, i, o_d); put3(ae1, n, i, o_1); put3(ae2, n, i, o_2);
    }
}

// uv_vertex_vjp on triangle rows tri[T_COLS n] with UVs triuv[6 n] at hit points
// p -> a9[9 n] (v0, e1, e2).
void cpt_uv_vertex_vjp_host(int n, const float* tri, const float* triuv, const float* p,
                            const float* a_u, const float* a_v, float* a9) {
    for (int i = 0; i < n; ++i) {
        float pv[3], out[9];
        get3(p, n, i, pv);
        cpt::uv_vertex_vjp(tri + i * cpt::T_COLS, triuv + i * 6, pv[0], pv[1], pv[2], a_u[i],
                           a_v[i], out);
        for (int k = 0; k < 9; ++k) a9[k * n + i] = out[k];
    }
}

// The tangent frame's edge terms: perturb_normal_vjp's tangent cotangent on
// triangle rows tri[T_COLS n] (UVs triuv[6 n]) pulled through
// tri_uv_tangent_vjp -> a_e[6 n] (e1, e2).
void cpt_tangent_edges_vjp_host(int n, const float* tri, const float* triuv, const float* raw,
                                const float* t, const float* g, float* a_e) {
    for (int i = 0; i < n; ++i) {
        float r[3], tv[3], gv[3], tg[3], an[3], at[3], atg[3], ae[6] = {};
        get3(raw, n, i, r); get3(t, n, i, tv); get3(g, n, i, gv);
        cpt::tri_uv_tangent(tri + i * cpt::T_COLS, triuv + i * 6, tg[0], tg[1], tg[2]);
        cpt::perturb_normal_vjp(r[0], r[1], r[2], false, tg[0], tg[1], tg[2], tv[0], tv[1], tv[2],
                                gv[0], gv[1], gv[2], an, at, atg);
        cpt::tri_uv_tangent_vjp(tri + i * cpt::T_COLS, triuv + i * 6, atg, ae, ae + 3);
        for (int k = 0; k < 6; ++k) a_e[k * n + i] = ae[k];
    }
}

// physical_lobes_vjp at (d, n, cos_i, m[20]) with the lobes' cotangent a_lb[12]
// (nu 3, gloss axis 3, ct axis 3, prob_g, prob_ct, nv) -> a_d, a_n, a_cos, a_m[20].
void cpt_physical_lobes_vjp_host(int n, const float* d, const float* nrm, const float* cos_i,
                                 const float* m, const float* a_lb, float* a_d, float* a_n,
                                 float* a_cos, float* a_m) {
    for (int i = 0; i < n; ++i) {
        float dv[3], nv[3], mv[cpt::M_COLS], od[3] = {}, on[3] = {}, om[cpt::M_COLS] = {},
              oc = 0.0f;
        get3(d, n, i, dv); get3(nrm, n, i, nv);
        for (int k = 0; k < cpt::M_COLS; ++k) mv[k] = m[k * n + i];
        cpt::LobesAdj a;
        const float* q = a_lb;
        a.nux = q[i]; a.nuy = q[n + i]; a.nuz = q[2 * n + i];
        a.gax = q[3 * n + i]; a.gay = q[4 * n + i]; a.gaz = q[5 * n + i];
        a.cax = q[6 * n + i]; a.cay = q[7 * n + i]; a.caz = q[8 * n + i];
        a.prob_g = q[9 * n + i]; a.prob_ct = q[10 * n + i]; a.nv = q[11 * n + i];
        cpt::physical_lobes_vjp(dv[0], dv[1], dv[2], nv[0], nv[1], nv[2], cos_i[i], mv, a, od, on,
                                oc, om);
        put3(a_d, n, i, od); put3(a_n, n, i, on);
        a_cos[i] = oc;
        for (int k = 0; k < cpt::M_COLS; ++k) a_m[k * n + i] = om[k];
    }
}

// lobe_terms_vjp toward w with the lobes physical_lobes_all(d, n, -d.n, m) and
// the cotangents a5 of (s_d, p_g, s_ct, p_ct, cos_s) -> a_lb[12] (as above),
// a_m[20], a_d, a_n, a_w.
void cpt_lobe_terms_vjp_host(int n, const float* d, const float* nrm, const float* m,
                             const float* w, const float* a5, float* a_lb, float* a_m, float* a_d,
                             float* a_n, float* a_w) {
    for (int i = 0; i < n; ++i) {
        float dv[3], nv[3], wv[3], mv[cpt::M_COLS], om[cpt::M_COLS] = {}, od[3] = {}, on[3] = {},
              ow[3] = {};
        get3(d, n, i, dv); get3(nrm, n, i, nv); get3(w, n, i, wv);
        for (int k = 0; k < cpt::M_COLS; ++k) mv[k] = m[k * n + i];
        const float cos_i = -cpt::dot3(dv[0], dv[1], dv[2], nv[0], nv[1], nv[2]);
        const cpt::Lobes lb = cpt::physical_lobes_all(dv[0], dv[1], dv[2], nv[0], nv[1], nv[2],
                                                      cos_i, mv);
        cpt::LobesAdj a;
        cpt::lobe_terms_vjp(lb, mv, dv[0], dv[1], dv[2], nv[0], nv[1], nv[2], wv[0], wv[1], wv[2],
                            a5[i], a5[n + i], a5[2 * n + i], a5[3 * n + i], a5[4 * n + i], a, om,
                            od, on, ow);
        const float lbv[12] = {a.nux, a.nuy, a.nuz, a.gax, a.gay, a.gaz,
                               a.cax, a.cay, a.caz, a.prob_g, a.prob_ct, a.nv};
        for (int k = 0; k < 12; ++k) a_lb[k * n + i] = lbv[k];
        for (int k = 0; k < cpt::M_COLS; ++k) a_m[k * n + i] = om[k];
        put3(a_d, n, i, od); put3(a_n, n, i, on); put3(a_w, n, i, ow);
    }
}

// al_light_geom_vjp on area-light rows al[AL_COLS n] with the geometry's
// cotangent a9 (area0, area1, total, n0 3, n1 3) -> a_v[18 n].
void cpt_al_light_geom_vjp_host(int n, const float* al, const float* a9, float* a_v) {
    for (int i = 0; i < n; ++i) {
        cpt::LightGeomAdj a;
        a.area0 = a9[i]; a.area1 = a9[n + i]; a.total = a9[2 * n + i];
        a.n0x = a9[3 * n + i]; a.n0y = a9[4 * n + i]; a.n0z = a9[5 * n + i];
        a.n1x = a9[6 * n + i]; a.n1y = a9[7 * n + i]; a.n1z = a9[8 * n + i];
        float out[18] = {};
        ArraySink sink{out};
        cpt::al_light_geom_vjp(al + i * cpt::AL_COLS, a, 0, sink);
        for (int k = 0; k < 18; ++k) a_v[k * n + i] = out[k];
    }
}

// al_sample_point_vjp on area-light rows al[AL_COLS n] at draws (u1, u2,
// upick) with the cotangents of the point and the normal -> a_v[18 n] and the
// two triangles' normal cotangents a_tn[6 n].
void cpt_al_sample_point_vjp_host(int n, const float* al, const float* u1, const float* u2,
                                  const float* upick, const float* a_l, const float* a_nl,
                                  float* a_v, float* a_tn) {
    for (int i = 0; i < n; ++i) {
        const cpt::LightGeom g = cpt::al_light_geom(al + i * cpt::AL_COLS);
        float l[3], nl[3], out[18] = {};
        get3(a_l, n, i, l); get3(a_nl, n, i, nl);
        cpt::LightGeomAdj a;
        ArraySink sink{out};
        cpt::al_sample_point_vjp(g, u1[i], u2[i], upick[i], l, nl, a, 0, sink);
        for (int k = 0; k < 18; ++k) a_v[k * n + i] = out[k];
        const float tn[6] = {a.n0x, a.n0y, a.n0z, a.n1x, a.n1y, a.n1z};
        for (int k = 0; k < 6; ++k) a_tn[k * n + i] = tn[k];
    }
}

// physical_prev_pdf_vjp of branch[i] -> a_d, a_n, a_nd, a_m[20].
void cpt_physical_prev_pdf_vjp_host(int n, const float* d, const float* nrm, const float* nd,
                                    const float* m, const int* branch, const float* a_pdf,
                                    float* a_d, float* a_n, float* a_nd, float* a_m) {
    for (int i = 0; i < n; ++i) {
        float dv[3], nv[3], ndv[3], mv[cpt::M_COLS], om[cpt::M_COLS] = {}, od[3] = {}, on[3] = {},
              ond[3] = {};
        get3(d, n, i, dv); get3(nrm, n, i, nv); get3(nd, n, i, ndv);
        for (int k = 0; k < cpt::M_COLS; ++k) mv[k] = m[k * n + i];
        cpt::physical_prev_pdf_vjp(dv[0], dv[1], dv[2], nv[0], nv[1], nv[2], ndv[0], ndv[1],
                                   ndv[2], mv, branch[i], a_pdf[i], od, on, ond, om);
        put3(a_d, n, i, od); put3(a_n, n, i, on); put3(a_nd, n, i, ond);
        for (int k = 0; k < cpt::M_COLS; ++k) a_m[k * n + i] = om[k];
    }
}

// physical_direct_vjp<geo> at n hits of the scene (seed; pixel, sample, pair0,
// hit point, shading normal, direction, t, pp, material columns m[20 n], hit
// primitive, cotangent g per lane) -> dir, a_p, a_n, a_d, a_t, a_pp, a_m[20 n],
// the rows each lane adds (rows[n * nrows], DirectRows as given) and the
// occlusion flags occ[n * (Lp + La)].
void cpt_physical_direct_vjp_host(const float* spheres, int num_spheres, const float* triangles,
                                  int num_triangles, const float* materials, int num_materials,
                                  const float* point_lights, int num_point_lights,
                                  const float* area_lights, int num_area_lights, int seed, int n,
                                  const int* pixel, const int* sample, const int* pair0,
                                  const float* p, const float* nrm, const float* d,
                                  const float* t, const float* pp, const float* m,
                                  const int* prim, const float* g, int geo, int row_pl0,
                                  int pl_stride, int pcols, int row_al0, int al_stride,
                                  int nrows, float* dir, float* a_p, float* a_n, float* a_d,
                                  float* a_t, float* a_pp, float* a_m, double* rows, int* occ) {
    const cpt::SceneTables sc = make_tables(spheres, num_spheres, triangles, num_triangles,
                                            materials, num_materials, point_lights,
                                            num_point_lights, area_lights, num_area_lights,
                                            nullptr);
    const cpt::DirectRows R = {row_pl0, pl_stride, pcols, row_al0, al_stride};
    const int nl = num_point_lights + num_area_lights;
    for (int i = 0; i < n; ++i) {
        float pv[3], nv[3], dv[3], gv[3], mv[cpt::M_COLS], o_dir[3], o_p[3] = {}, o_n[3] = {},
              o_d[3] = {}, o_m[cpt::M_COLS] = {}, o_t = 0.0f, o_pp = 0.0f;
        get3(p, n, i, pv); get3(nrm, n, i, nv); get3(d, n, i, dv); get3(g, n, i, gv);
        for (int k = 0; k < cpt::M_COLS; ++k) mv[k] = m[k * n + i];
        HostSink sink;
        sink.rows = rows + (size_t)i * nrows;
        for (int r = 0; r < nrows; ++r) sink.rows[r] = 0.0;
        cpt::Lobes lb;
        if (geo) {
            cpt::physical_direct_vjp<true>(sc, seed, pixel[i], sample[i], pair0[i], pv[0], pv[1],
                                           pv[2], nv[0], nv[1], nv[2], dv[0], dv[1], dv[2], t[i],
                                           pp[i], mv, prim[i], R, gv[0], gv[1], gv[2], sink,
                                           o_dir, o_p, o_n, o_d, o_t, o_pp, o_m, lb, occ + i * nl);
        } else {
            cpt::physical_direct_vjp<false>(sc, seed, pixel[i], sample[i], pair0[i], pv[0], pv[1],
                                            pv[2], nv[0], nv[1], nv[2], dv[0], dv[1], dv[2], t[i],
                                            pp[i], mv, prim[i], R, gv[0], gv[1], gv[2], sink,
                                            o_dir, o_p, o_n, o_d, o_t, o_pp, o_m, lb,
                                            occ + i * nl);
        }
        put3(dir, n, i, o_dir); put3(a_p, n, i, o_p); put3(a_n, n, i, o_n); put3(a_d, n, i, o_d);
        a_t[i] = o_t;
        a_pp[i] = o_pp;
        for (int k = 0; k < cpt::M_COLS; ++k) a_m[k * n + i] = o_m[k];
    }
}

}  // extern "C"
