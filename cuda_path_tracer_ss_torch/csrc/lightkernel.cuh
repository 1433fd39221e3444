// Device math of the light-tracing kernel: one call of light_path() traces
// one light path — emission sample on an area light, the emitter-surface
// splat, then per bounce a scene sweep, Beer-Lambert absorption, the camera
// connection with its visibility sweep, and the shared scatter cascade — and
// writes one splat record (pixel index, weighted rgb) per path vertex.
//
// Replaces the per-lane body of the TPU kernel
// cuda_path_tracer_ss_tpu/ops/pallas/lightkernel.py::_make_light_kernel. What
// that layout did only for its vector unit is gone: the light and the
// material are indexed loads, and a path leaves its bounce loop when it dies
// (its remaining records are written as zeros). The sweeps, scatter_sample,
// uniform_pair, the light geometry and the chain model are megakernel.cuh's,
// so light paths and eye paths evaluate the same functions. The plain PyTorch
// version in ops/cuda/lightkernel.py states the same formulas in the same
// operation order.
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

// The records of one path: slot k of plane q lies at q[k * stride].
struct RecordOut {
    int* pix;
    float* r;
    float* g;
    float* b;
    size_t stride;
};

CPT_HD void put_record(const RecordOut& out, int k, int pixel, float r, float g, float b) {
    out.pix[k * out.stride] = pixel;
    out.r[k * out.stride] = r;
    out.g[k * out.stride] = g;
    out.b[k * out.stride] = b;
}

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

// One light path: max_bounces + 1 records. `path` is the global path index;
// a path at or past n_paths leaves zeros. BIDIR weights every splat against
// the eye side's techniques with the count ratio nu = cam[15] (the U / r0 /
// pr carries of render/bidir.py).
template <bool BIDIR>
CPT_HD void light_path(const SceneTables& sc, const LightParams& p, int path,
                       const RecordOut& out) {
    int slot = 0;  // records written so far
    if (path < p.n_paths && sc.num_area_lights > 0) {
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

        // ---- record 0: the emitter surface as the eye sees it ---------------
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
            const bool ok0 = on0 && visible_to_eye(sc, ptx, pty, ptz, -ex0, -ey0, -ez0, r_0);
            const float s0 = ok0 ? w_splat * cos_c0 / r2_0 * j0 : 0.0f;
            put_record(out, 0, ok0 ? pix0 : 0, t_emit_r * s0, t_emit_g * s0, t_emit_b * s0);
            slot = 1;
        }

        // ---- leave the light: cosine hemisphere, two-sided ------------------
        const float side = (u0 * L_f - (float)li < 0.5f) ? 1.0f : -1.0f;
        const float nex = nlx * side, ney = nly * side, nez = nlz * side;
        float d1a, d1b;
        uniform_pair(p.seed, path, p.sample_idx, 1 + ppb, d1a, d1b);
        const float theta = d1a * TWO_PI;
        const float yy = sqrtf(d1b);
        const float rr = sqrtf(fmaxf(1.0f - yy * yy, 0.0f));
        float dx, dy, dz;
        rotate_y_to(nex, ney, nez, rr * cosf(theta), yy, rr * sinf(theta), dx, dy, dz);
        float beta_r = t_emit_r * TWO_PI, beta_g = t_emit_g * TWO_PI, beta_b = t_emit_b * TWO_PI;
        float ox = ptx + nex * RAY_BUMP_EPSILON;
        float oy = pty + ney * RAY_BUMP_EPSILON;
        float oz = ptz + nez * RAY_BUMP_EPSILON;

        // bidirectional carries
        const float cos0 = fabsf(dot3(nex, ney, nez, dx, dy, dz));
        const float inv_pl_a = L_f * area;
        float U = 0.0f, r0c = 0.0f, pr_carry = 1.0f, nee_ok = 1.0f;
        float pf_pending = 0.5f * cos0 * INV_PI;
        float prev_cos_out = cos0;

        for (int b = 0; b < p.max_bounces; ++b) {
            const Hit h = intersect_sweep(sc, ox, oy, oz, dx, dy, dz);
            if (!(h.t < INFINITY)) break;  // the path left the scene
            const float px = ox + dx * h.t, py = oy + dy * h.t, pz = oz + dz * h.t;
            const float nx = h.nx, ny = h.ny, nz = h.nz;
            const float* m = sc.materials + h.mat * M_COLS;

            // Beer-Lambert over the segment inside a medium
            const float cos_i = -dot3(dx, dy, dz, nx, ny, nz);
            if (cos_i <= 0.0f) {
                beta_r = beta_r * expf(-h.t * m[6]);
                beta_g = beta_g * expf(-h.t * m[7]);
                beta_b = beta_b * expf(-h.t * m[8]);
            }

            // ---- camera connection (diffuse lobe, front faces only) ---------
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
                const float pf_full = fmaxf(pf_pending * cos_arr / t2, 1e-20f);
                U = fminf(first ? inv_pl_a / pf_full : U * pr_carry / pf_full, MIS_RATIO_CLAMP);
                const float c_a = jb * cos_c / r2b;
                const float prd_sa = m[14] * fmaxf(-dot3(dx, dy, dz, nux, nuy, nuz), 0.0f) * INV_PI;
                const float geo_prev = prev_cos_out / t2;
                const float prd_eff = first ? 1.0f : prd_sa * geo_prev;
                const float p_nee_a = L_f / fmaxf(inv_pl_a, 1e-20f);
                const float rho_n = (first ? 1.0f : nee_ok) * c_a * p_nee_a * prd_eff * U;
                const float r0_eff = first ? prd_sa * geo_prev : r0c;
                const float rho_b = c_a * prd_eff * U * r0_eff;
                const float rn = fminf(rho_n / nu, MIS_RATIO_CLAMP);
                const float rb_ = fminf(rho_b / nu, MIS_RATIO_CLAMP);
                w_conn = 1.0f / (1.0f + rn * rn + rb_ * rb_);
            }
            const bool okb = onb && front
                             && visible_to_eye(sc, px, py, pz, -ecx, -ecy, -ecz, rb);
            const float sb = okb ? w_conn * cos_c / r2b * jb : 0.0f;
            put_record(out, slot, okb ? pixb : 0, beta_r * m[0] * f_scale * sb,
                       beta_g * m[1] * f_scale * sb, beta_b * m[2] * f_scale * sb);
            ++slot;

            // ---- continue the path: the eye paths' scatter cascade ----------
            const int base = 1 + (b + 2) * ppb;
            float u_branch, u_a, u_b;
            uniform_pair(p.seed, path, p.sample_idx, base, u_branch, u_a);
            uniform_pair(p.seed, path, p.sample_idx, base + 1, u_b, unused);
            float nox, noy, noz, ndx, ndy, ndz, wr, wg, wb, ct_w;
            int branch;
            const bool alive = scatter_sample(dx, dy, dz, nx, ny, nz, px, py, pz, cos_i,
                                              u_branch, u_a, u_b, m,
                                              nox, noy, noz, ndx, ndy, ndz, wr, wg, wb,
                                              branch, ct_w);
            if (!alive) break;
            if constexpr (BIDIR) {
                const float pf_new = chain_model_taken(dx, dy, dz, nx, ny, nz, cos_i,
                                                       ndx, ndy, ndz, m, branch);
                const float cos_rev = dot3(ndx, ndy, ndz, nx, ny, nz);
                const float pr_sa = chain_model_taken(-ndx, -ndy, -ndz, nx, ny, nz, cos_rev,
                                                      -dx, -dy, -dz, m, branch);
                const float pr_full = pr_sa * prev_cos_out / t2;
                if (first) {
                    r0c = pr_full;
                    pr_carry = 1.0f;
                    nee_ok = (dot3(ndx, ndy, ndz, nux, nuy, nuz) > 0.0f) ? 1.0f : 0.0f;
                } else {
                    pr_carry = pr_full;
                }
                pf_pending = pf_new;
                prev_cos_out = fabsf(dot3(ndx, ndy, ndz, nux, nuy, nuz));
            }
            ox = nox; oy = noy; oz = noz;
            dx = ndx; dy = ndy; dz = ndz;
            beta_r = beta_r * wr; beta_g = beta_g * wg; beta_b = beta_b * wb;
        }
    }
    // a path that ended early leaves zeros in its remaining records
    for (; slot <= p.max_bounces; ++slot) put_record(out, slot, 0, 0.0f, 0.0f, 0.0f);
}

}  // namespace cpt
