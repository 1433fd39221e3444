// Device math of the light-tracing kernel, split as K1's megakernel.cuh
// splits an eye path: start_light_path() opens one light path — emission
// sample on an area light, the emitter-surface splat, the direction leaving
// the light — and light_bounce() makes one bounce of it — a scene sweep,
// Beer-Lambert absorption, the camera connection with its visibility sweep,
// and the shared scatter cascade — on a LightPathState; light_path() traces
// a path to its end with them. Every gate that passes hands one splat (pixel
// index, weighted rgb) to a sink: the kernel's image sink adds it into the
// image, the record sink writes it into slot k of the path's records (0 the
// emitter, b + 1 bounce b). A failed gate or a dead path hands nothing. The
// arithmetic of a path does not depend on which thread traces it or when: a
// schedule that regenerates paths per lane over the same two functions
// writes the same records bit for bit (tests/test_torch_light_schedule.py).
//
// Replaces the per-lane body of the TPU kernel
// cuda_path_tracer_ss_tpu/ops/pallas/lightkernel.py::_make_light_kernel. What
// that layout did only for its vector unit is gone: the light and the
// material are indexed loads, and a path leaves its bounce loop when it dies.
// The sweeps, scatter_sample, uniform_pair, the light geometry and the chain
// model are megakernel.cuh's, so light paths and eye paths evaluate the same
// functions. The plain PyTorch version in ops/cuda/lightkernel.py states the
// same formulas in the same operation order.
//
// Draws of path i: key (seed, GLOBAL path index), counter (sample_idx, pair);
// pairs 1, 2, 3 pick the light, its side and the point, pair_base(1) the
// emission direction, pair_base(b + 2) and the pair after it bounce b's
// scatter (pair_base(k) = 1 + k * (2 + 2 * La), utils/rng.py).
//
// Like megakernel.cuh this header is valid host C++.
#pragma once

#include "megakernel.cuh"

namespace cpt {

struct LightParams {
    float cam[CAM_FLOATS];  // rot 9, pos 3, tan(fov/2), z_near, spare, bidirectional nu
    int seed, path_offset, n_local, sample_idx, n_paths, max_bounces, width, height;
    float aspect;           // height/width, rounded from the double quotient
};

inline void set_light_image_size(LightParams& p, int width, int height) {
    p.width = width; p.height = height;
    p.aspect = (float)((double)height / (double)width);
}

// The record sink: slot k of local path i lies at q[k * stride + i] in each
// plane q; the caller zeroes the planes, so a slot without a splat stays
// (pixel 0, 0, 0, 0).
struct RecordSink {
    int* pix;
    float* r;
    float* g;
    float* b;
    size_t stride;  // n_local
    CPT_HD void splat(int local, int slot, int pixel, float vr, float vg, float vb) const {
        const size_t k = (size_t)slot * stride + (size_t)local;
        pix[k] = pixel;
        r[k] = vr;
        g[k] = vg;
        b[k] = vb;
    }
};

// The pinhole connection of point p: the pixel it projects to, whether that
// lies on the screen in front of the camera (decided BEFORE the index is
// clipped), the unit direction eye -> p, the squared distance and distance,
// and the camera importance dA_img/dOmega of that direction.
CPT_HD void splat_weights(const LightParams& p, float px, float py, float pz,
                          int& pixel, bool& on, float& ex, float& ey, float& ez,
                          float& r2, float& r, float& j_img) {
    const float tox = px - p.cam[9], toy = py - p.cam[10], toz = pz - p.cam[11];
    r2 = fmaxf(tox * tox + toy * toy + toz * toz, 1e-12f);
    r = sqrtf(r2);
    const float inv_r = 1.0f / r;
    ex = tox * inv_r; ey = toy * inv_r; ez = toz * inv_r;
    const float vx = p.cam[0] * ex + p.cam[3] * ey + p.cam[6] * ez;
    const float vy = p.cam[1] * ex + p.cam[4] * ey + p.cam[7] * ez;
    const float vz = p.cam[2] * ex + p.cam[5] * ey + p.cam[8] * ez;
    const float s = -2.0f * p.cam[12];
    const float z_near = p.cam[13];
    const float width_f = (float)p.width, height_f = (float)p.height;
    const float safe_vz = (fabsf(vz) < 1e-12f) ? 1e-12f : vz;
    const float px_img = (vx / (safe_vz * s) + 0.5f) * width_f;
    const float py_img = (vy / (safe_vz * s * p.aspect) + 0.5f) * height_f;
    const float sign_z = (z_near > 0.0f) ? 1.0f : ((z_near < 0.0f) ? -1.0f : 0.0f);
    const bool front = vz * sign_z > 1e-7f;
    on = front && (px_img >= 0.0f) && (px_img < width_f)
         && (py_img >= 0.0f) && (py_img < height_f);
    const int ix = (int)fminf(fmaxf(floorf(px_img), 0.0f), (float)(p.width - 1));
    const int iy = (int)fminf(fmaxf(floorf(py_img), 0.0f), (float)(p.height - 1));
    pixel = iy * p.width + ix;
    j_img = camera_j_img(p.cam[12], p.aspect, p.width, p.height, fabsf(vz));
}

// Unoccluded segment from p (bumped along e) toward the eye at distance dist.
CPT_HD bool visible_to_eye(const SceneTables& sc, float px, float py, float pz,
                           float ex, float ey, float ez, float dist) {
    return !occlusion_sweep(sc, px + ex * RAY_BUMP_EPSILON, py + ey * RAY_BUMP_EPSILON,
                            pz + ez * RAY_BUMP_EPSILON, ex, ey, ez,
                            dist - 2.0f * RAY_BUMP_EPSILON);
}

// The carries of one light path between bounces.
struct LightPathState {
    float ox, oy, oz, dx, dy, dz;         // the ray
    float beta_r, beta_g, beta_b;         // throughput
    float inv_pl_a;                       // L * area of the picked light
    float U, r0c, pr_carry, nee_ok;       // BIDIR: the U / r0 / pr carries of render/bidir.py
    float pf_pending, prev_cos_out;       // BIDIR: last scatter's density and cosine
    int b;                                // bounces made
};

// Opens light path `local` (global index path_offset + local): the emission
// vertex, its splat as the eye sees the emitter surface (slot 0), and the
// ray leaving the light. Returns whether the path makes a bounce: false for
// a path at or past n_paths (no splat) or when max_bounces is 0. BIDIR
// weights the splat against the eye side's techniques with the count ratio
// nu = cam[15].
template <bool BIDIR, class Sink>
CPT_HD bool start_light_path(const SceneTables& sc, const LightParams& p, int local,
                             LightPathState& st, const Sink& sink) {
    const int path = p.path_offset + local;
    if (path >= p.n_paths || sc.num_area_lights <= 0) return false;
    const int L = sc.num_area_lights;
    const float L_f = (float)L;
    const int ppb = 2 + 2 * L;
    const float nu = p.cam[15];

    // ---- emission vertex ------------------------------------------------
    float u0, u1, u2, u3, unused;
    uniform_pair(p.seed, path, p.sample_idx, 1, u0, u1);
    uniform_pair(p.seed, path, p.sample_idx, 2, u2, unused);
    uniform_pair(p.seed, path, p.sample_idx, 3, u3, unused);
    const int li_raw = (int)(u0 * L_f);
    const int li = li_raw < L - 1 ? li_raw : L - 1;
    const float* al = sc.area_lights + li * AL_COLS;
    const LightGeom geom = al_light_geom(al);
    float ptx, pty, ptz, nlx, nly, nlz;
    al_sample_point(geom, al, u1, u2, u3, ptx, pty, ptz, nlx, nly, nlz);
    const float area = geom.total;
    const float* le = sc.materials + (int)al[22] * M_COLS + 9;
    const float t_emit_r = le[0] * (L_f * area);
    const float t_emit_g = le[1] * (L_f * area);
    const float t_emit_b = le[2] * (L_f * area);

    // ---- slot 0: the emitter surface as the eye sees it -----------------
    {
        int pix0; bool on0; float ex0, ey0, ez0, r2_0, r_0, j0;
        splat_weights(p, ptx, pty, ptz, pix0, on0, ex0, ey0, ez0, r2_0, r_0, j0);
        const float cos_c0 = fabsf(dot3(nlx, nly, nlz, ex0, ey0, ez0));
        float w_splat = 1.0f;
        if constexpr (BIDIR) {
            const float c_a0 = j0 * cos_c0 / r2_0;
            const float ratio = fminf(c_a0 * (L_f * area) / nu, MIS_RATIO_CLAMP);
            w_splat = 1.0f / (1.0f + ratio * ratio);
        }
        if (on0 && visible_to_eye(sc, ptx, pty, ptz, -ex0, -ey0, -ez0, r_0)) {
            const float s0 = w_splat * cos_c0 / r2_0 * j0;
            sink.splat(local, 0, pix0, t_emit_r * s0, t_emit_g * s0, t_emit_b * s0);
        }
    }

    // ---- leave the light: cosine hemisphere, two-sided ------------------
    const float side = (u0 * L_f - (float)li < 0.5f) ? 1.0f : -1.0f;
    const float nex = nlx * side, ney = nly * side, nez = nlz * side;
    float d1a, d1b;
    uniform_pair(p.seed, path, p.sample_idx, 1 + ppb, d1a, d1b);
    const float theta = d1a * TWO_PI;
    const float yy = sqrtf(d1b);
    const float rr = sqrtf(fmaxf(1.0f - yy * yy, 0.0f));
    rotate_y_to(nex, ney, nez, rr * cosf(theta), yy, rr * sinf(theta), st.dx, st.dy, st.dz);
    st.beta_r = t_emit_r * TWO_PI;
    st.beta_g = t_emit_g * TWO_PI;
    st.beta_b = t_emit_b * TWO_PI;
    st.ox = ptx + nex * RAY_BUMP_EPSILON;
    st.oy = pty + ney * RAY_BUMP_EPSILON;
    st.oz = ptz + nez * RAY_BUMP_EPSILON;

    // bidirectional carries
    const float cos0 = fabsf(dot3(nex, ney, nez, st.dx, st.dy, st.dz));
    st.inv_pl_a = L_f * area;
    st.U = 0.0f; st.r0c = 0.0f; st.pr_carry = 1.0f; st.nee_ok = 1.0f;
    st.pf_pending = 0.5f * cos0 * INV_PI;
    st.prev_cos_out = cos0;
    st.b = 0;
    return p.max_bounces > 0;
}

// Bounce st.b of light path `local`: the sweep, Beer-Lambert inside a medium,
// the camera connection of the hit (slot st.b + 1) and the eye paths' scatter
// cascade. Returns whether the path goes on: false when it left the scene,
// died in the cascade, or has made max_bounces bounces.
template <bool BIDIR, class Sink>
CPT_HD bool light_bounce(const SceneTables& sc, const LightParams& p, int local,
                         LightPathState& st, const Sink& sink) {
    const int path = p.path_offset + local;
    const int L = sc.num_area_lights;
    const float L_f = (float)L;
    const int ppb = 2 + 2 * L;
    const float nu = p.cam[15];
    const int b = st.b;
    const float dx = st.dx, dy = st.dy, dz = st.dz;

    const Hit h = intersect_sweep(sc, st.ox, st.oy, st.oz, dx, dy, dz);
    if (!(h.t < INFINITY)) return false;  // the path left the scene
    const float px = st.ox + dx * h.t, py = st.oy + dy * h.t, pz = st.oz + dz * h.t;
    const float nx = h.nx, ny = h.ny, nz = h.nz;
    const float* m = sc.materials + h.mat * M_COLS;

    // Beer-Lambert over the segment inside a medium
    const float cos_i = -dot3(dx, dy, dz, nx, ny, nz);
    if (cos_i <= 0.0f) {
        st.beta_r = st.beta_r * expf(-h.t * m[6]);
        st.beta_g = st.beta_g * expf(-h.t * m[7]);
        st.beta_b = st.beta_b * expf(-h.t * m[8]);
    }

    // ---- camera connection (diffuse lobe, front faces only) -------------
    int pixb; bool onb; float ecx, ecy, ecz, r2b, rb, jb;
    splat_weights(p, px, py, pz, pixb, onb, ecx, ecy, ecz, r2b, rb, jb);
    float nux, nuy, nuz;
    normalize3(nx, ny, nz, 1e-20f, nux, nuy, nuz);
    const float cos_c = fmaxf(-dot3(nux, nuy, nuz, ecx, ecy, ecz), 0.0f);
    const bool front = (cos_c > 0.0f) && (cos_i > 0.0f);
    const float f_scale = m[14] * INV_PI;
    const bool first = b == 0;
    const float t2 = fmaxf(h.t * h.t, 1e-12f);
    float w_conn = 1.0f;
    if constexpr (BIDIR) {
        const float cos_arr = fabsf(dot3(dx, dy, dz, nux, nuy, nuz));
        const float pf_full = fmaxf(st.pf_pending * cos_arr / t2, 1e-20f);
        st.U = fminf(first ? st.inv_pl_a / pf_full : st.U * st.pr_carry / pf_full,
                     MIS_RATIO_CLAMP);
        const float c_a = jb * cos_c / r2b;
        const float prd_sa = m[14] * fmaxf(-dot3(dx, dy, dz, nux, nuy, nuz), 0.0f) * INV_PI;
        const float geo_prev = st.prev_cos_out / t2;
        const float prd_eff = first ? 1.0f : prd_sa * geo_prev;
        const float p_nee_a = L_f / fmaxf(st.inv_pl_a, 1e-20f);
        const float rho_n = (first ? 1.0f : st.nee_ok) * c_a * p_nee_a * prd_eff * st.U;
        const float r0_eff = first ? prd_sa * geo_prev : st.r0c;
        const float rho_b = c_a * prd_eff * st.U * r0_eff;
        const float rn = fminf(rho_n / nu, MIS_RATIO_CLAMP);
        const float rb_ = fminf(rho_b / nu, MIS_RATIO_CLAMP);
        w_conn = 1.0f / (1.0f + rn * rn + rb_ * rb_);
    }
    if (onb && front && visible_to_eye(sc, px, py, pz, -ecx, -ecy, -ecz, rb)) {
        const float sb = w_conn * cos_c / r2b * jb;
        sink.splat(local, b + 1, pixb, st.beta_r * m[0] * f_scale * sb,
                   st.beta_g * m[1] * f_scale * sb, st.beta_b * m[2] * f_scale * sb);
    }

    // ---- continue the path: the eye paths' scatter cascade --------------
    const int base = 1 + (b + 2) * ppb;
    float u_branch, u_a, u_b, unused;
    uniform_pair(p.seed, path, p.sample_idx, base, u_branch, u_a);
    uniform_pair(p.seed, path, p.sample_idx, base + 1, u_b, unused);
    float nox, noy, noz, ndx, ndy, ndz, wr, wg, wb, ct_w;
    int branch;
    const bool alive = scatter_sample(dx, dy, dz, nx, ny, nz, px, py, pz, cos_i,
                                      u_branch, u_a, u_b, m,
                                      nox, noy, noz, ndx, ndy, ndz, wr, wg, wb,
                                      branch, ct_w);
    if (!alive) return false;
    if constexpr (BIDIR) {
        const float pf_new = chain_model_taken(dx, dy, dz, nx, ny, nz, cos_i,
                                               ndx, ndy, ndz, m, branch);
        const float cos_rev = dot3(ndx, ndy, ndz, nx, ny, nz);
        const float pr_sa = chain_model_taken(-ndx, -ndy, -ndz, nx, ny, nz, cos_rev,
                                              -dx, -dy, -dz, m, branch);
        const float pr_full = pr_sa * st.prev_cos_out / t2;
        if (first) {
            st.r0c = pr_full;
            st.pr_carry = 1.0f;
            st.nee_ok = (dot3(ndx, ndy, ndz, nux, nuy, nuz) > 0.0f) ? 1.0f : 0.0f;
        } else {
            st.pr_carry = pr_full;
        }
        st.pf_pending = pf_new;
        st.prev_cos_out = fabsf(dot3(ndx, ndy, ndz, nux, nuy, nuz));
    }
    st.ox = nox; st.oy = noy; st.oz = noz;
    st.dx = ndx; st.dy = ndy; st.dz = ndz;
    st.beta_r = st.beta_r * wr; st.beta_g = st.beta_g * wg; st.beta_b = st.beta_b * wb;
    st.b = b + 1;
    return st.b < p.max_bounces;
}

// Light path `local`, traced to its end.
template <bool BIDIR, class Sink>
CPT_HD void light_path(const SceneTables& sc, const LightParams& p, int local,
                       const Sink& sink) {
    LightPathState st;
    if (!start_light_path<BIDIR>(sc, p, local, st, sink)) return;
    while (light_bounce<BIDIR>(sc, p, local, st, sink)) {
    }
}

}  // namespace cpt
