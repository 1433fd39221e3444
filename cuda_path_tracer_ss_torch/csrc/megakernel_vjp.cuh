// Device math of the replay-VJP megakernel: one call of backward_pixel()
// takes the cotangent g of one pixel's mean radiance and adds that pixel's
// share of dL/d(scene parameters, camera) into a row accumulator.
//
// Replaces the per-lane body of the TPU kernel
// cuda_path_tracer_ss_tpu/ops/pallas/megakernel_vjp.py::_make_backward_kernel
// in every grad mode: "linear" and "full" on the reference-parity estimator,
// "geo" (full plus the triangle and area-light vertex rows) and the exact
// adjoint of the physical estimator (PHYSICAL, with or without geo), on
// untextured and on textured (color-mapped, normal-mapped) scenes. For every
// path of its pixel the thread
//   1. REPLAYS the path from the counter RNG with the forward kernel's own
//      device functions (megakernel.cuh: sweeps, scatter_sample, uniform_pair,
//      eye ray), so it walks the forward's path hit for hit and branch for
//      branch, and checkpoints every bounce (replay_bounce);
//   2. runs the adjoint recurrence over the stored bounces, last to first
//      (reverse_bounce):
//        A_mid(b) = A_after(b) * w(b) + g * direct(b);  A_in(b) = A_mid(b) * beer(b)
//      and, in full mode, carries dL/d(origin, direction) through the scatter
//      step (scatter_chain) and the hit (hit_chain) of every bounce;
//   3. in full mode pulls the eye ray's cotangent back into the camera rows
//      (eye_vjp).
// backward_pixel schedules these per path as two flat passes with per-lane
// regeneration: all of the pixel's replays, one bounce per loop iteration,
// pushing the bounces onto the lane's checkpoint stack; then all of its
// reverse sweeps, popping it. backward_pixel_replay / backward_pixel_reverse
// are the same two passes as two calls, for the kernel's split schedule.
// Discrete decisions (which primitive is hit, visibility, the scatter branch,
// the clamp of the light cosine, the light draws) carry no gradient; every
// continuous factor does.
//
// PHYSICAL replays the unbiased estimator: at every hit physical_direct_vjp
// (megakernel.cuh) gives the direct radiance with its exact adjoint, whose
// (p, n) cotangents take the NEE planes, and whose (d, t, prev_pdf)
// cotangents take three planes more; the reverse sweep feeds the prev_pdf
// cotangent of bounce b+1 through physical_prev_pdf_vjp of bounce b (the
// emission-MIS pdf chain). GEO adds the rows of every triangle's packed
// (v0, e1, e2, n0, n1, n2): the Moller-Trumbore adjoint of the winning
// triangle (triangle_t_vjp), the corner normals' barycentric weights, on a
// textured scene the UV's fixed-point vertex terms and the tangent frame's
// edge terms; and the rows of every area light's six vertices, through the
// NEE sample point (parity) or through the light geometry (physical).
//
// A thread branches on its own path: only the adjoint of the scatter branch
// that was drawn is evaluated, a miss ends the replay and stores nothing,
// material / sphere / triangle rows are read and written by direct index.
//
// Three seams keep this header usable from a host compiler too (CPT_HD
// collapses to `inline`): the checkpoint stack (CheckpointStore: a lane's own
// slots), the row accumulator and the camera rows' accumulator are template
// parameters; an accumulator has one method, add(row, value).
//
// Row layout of the accumulator (GradLayout): per material `pcols` rows
// (diffuse 3, specular 3, absorption 3, emission 3, diff_avg; full mode adds
// roughness, ior, spec_exp; physical spec_avg), then per point light power 3
// (full: position 3, power 3), per area light power 3 (geo: then its six
// vertices, 18), background 3; full mode appends camera rows (rotation 9
// row-major, position 3, tan_half_fov) and 4 rows per sphere (centre 3,
// radius), geo 18 per triangle (v0, e1, e2, n0, n1, n2); with texel gradients
// 3 rows per atlas texel come last (texel i, channel c at row_tex0 + 3 i + c:
// the atlas's own layout).
//
// A textured scene (TEXTURED) replays the texture block with its adjoint
// bundle (texel multipliers, bilinear corners, UV partials). The cotangent of
// the EFFECTIVE albedo (material diffuse x texel) is summed over the bounce's
// NEE at replay and over its diffuse-branch weight in the reverse sweep, then
// split: material rows get it times the texel, texel rows (one atomicAdd per
// corner and channel) times the material's diffuse and the corner weight, and
// in full mode the UV-swim chain moves it with the hit point (triangles: the
// dual basis of the edges; spheres: the polynomial UVs of the unit normal).
// On a normal-mapped scene in full mode the total cotangent of the perturbed
// normal is pulled back through the tangent-frame perturbation by hand
// (perturb_normal_vjp) into the raw normal and the normal map's texels.
#pragma once

#include <string.h>

#include "megakernel.cuh"

namespace cpt {

constexpr int P_COLS = 13;
constexpr int P_COLS_FULL = 16;
constexpr int P_COLS_PHYS = 17;
constexpr int CAM_ROWS = 13;
constexpr int TRI_ROWS = 18;   // geo: per triangle v0 e1 e2 n0 n1 n2
constexpr int AL_ROWS_GEO = 21; // geo: per area light power 3, six vertices 18

// Checkpoint planes of one bounce. Linear mode stores the first ST_PLANES,
// full and geo mode ST_PLANES_FULL, physical mode ST_PLANES_PHYS. Q_MAT,
// Q_CODE and Q_PRIM hold integers.
constexpr int Q_TM = 0;        // T_mid = T_in * beer (3)
constexpr int Q_W = 3;         // sampled branch weight (3)
constexpr int Q_BEER = 6;      // Beer-Lambert factor (3)
constexpr int Q_DIRECT = 9;    // emission + NEE (3)
constexpr int Q_T_IN = 12;     // hit distance on an inside hit, else 0
constexpr int Q_MAT = 13;      // material index
constexpr int Q_CODE = 14;     // branch taken (BRANCH_*)
constexpr int Q_CT_W = 15;     // Cook-Torrance weight
constexpr int ST_PLANES = 16;
constexpr int Q_O = 16;        // origin of the bounce's ray (3): p = o + t d as the forward has it
constexpr int Q_D = 19;        // incoming direction (3)
constexpr int Q_N = 22;        // surfel normal as the forward used it (3)
constexpr int Q_T = 25;        // hit distance
constexpr int Q_PRIM = 26;     // winning primitive
constexpr int Q_NEE_AP = 27;   // dL/dp of the NEE terms, pre-scaled by g*T_mid (3)
constexpr int Q_NEE_AN = 30;   // dL/dn of the NEE terms, pre-scaled (3)
constexpr int ST_PLANES_FULL = 33;
constexpr int Q_PA_D = 33;     // physical: dL/dd of the direct phase (3)
constexpr int Q_PA_T = 36;     // physical: dL/dt of the direct phase (the emission MIS)
constexpr int Q_PA_PP = 37;    // physical: dL/d prev_pdf, read by the previous bounce
constexpr int ST_PLANES_PHYS = 38;

// Planes a textured replay adds after those (offsets within each block):
// the color block, 6 planes (14 with texel gradients) ...
constexpr int QT_ALB = 0;      // the bounce's NEE cotangent of the effective albedo (3)
constexpr int QT_TEX = 3;      // texel multiplier of the albedo, 1 without a color map (3)
constexpr int QT_CIDX = 6;     // color corners' atlas texel indices (4)  } texel
constexpr int QT_CW = 10;      // their weights, 0 without a color map (4) } gradients
constexpr int TEX_PLANES = 6;
constexpr int TEX_PLANES_GRADS = 14;
// ... in full mode the UV-swim block, 12 planes ...
constexpr int QU_DU = 0;       // d texel / du of the color fetch, 0 without a color map (3)
constexpr int QU_DV = 3;       // d texel / dv (3)
constexpr int QU_G = 6;        // triangle: du/dp, dv/dp; sphere: du/dnux, du/dnuz, dv/dnuy, 0 (6)
constexpr int UVG_PLANES = 12;
// ... and in full mode on a normal-mapped scene the normal-map block, 12
// planes (20 with texel gradients).
constexpr int QN_RAW = 0;      // the normal before the perturbation (3)
constexpr int QN_VAL = 3;      // the normal map's texel sample (3)
constexpr int QN_DU = 6;       // d texel / du, 0 without a normal map (3)
constexpr int QN_DV = 9;       // d texel / dv (3)
constexpr int QN_CIDX = 12;    // corners (4)  } texel
constexpr int QN_CW = 16;      // weights (4)  } gradients
constexpr int NMAP_PLANES = 12;
constexpr int NMAP_PLANES_GRADS = 20;

// Two planes after a slot's checkpoint planes say, in the last slot of a
// path, which sample it was and how it ended: QM_SAMPLE the sample (from
// sample_offset), QM_END 2 * (bounces stored) + 1 if the path ended in a miss.
constexpr int QM_SAMPLE = 0;
constexpr int QM_END = 1;
constexpr int META_PLANES = 2;

// Where a textured replay keeps what; `on` is false on an untextured scene.
struct TexLayout {
    bool on, grads, nmap;   // textured; texel gradients; normal-map block
    int q_tex, q_uvg, q_nm; // first plane of each block
    int planes;             // checkpoint planes per bounce in all
    int q_meta;             // first of the META_PLANES
    int slot_floats;        // floats per slot: the planes and the meta, padded to 4
};

// `full` is true for the geo and physical modes too (they build on the full
// path adjoint).
inline TexLayout tex_layout(bool full, bool textured, bool grads, bool nmap_scene,
                            bool physical = false) {
    TexLayout T;
    T.on = textured;
    T.grads = textured && grads;
    T.nmap = textured && full && nmap_scene;
    T.q_tex = physical ? ST_PLANES_PHYS : (full ? ST_PLANES_FULL : ST_PLANES);
    T.q_uvg = T.q_tex + (textured ? (T.grads ? TEX_PLANES_GRADS : TEX_PLANES) : 0);
    T.q_nm = T.q_uvg + ((textured && full) ? UVG_PLANES : 0);
    T.planes = T.q_nm + (T.nmap ? (T.grads ? NMAP_PLANES_GRADS : NMAP_PLANES) : 0);
    T.q_meta = T.planes;
    T.slot_floats = (T.planes + META_PLANES + 3) / 4 * 4;
    return T;
}

// NEE falloff constant: 1/pi (Lambert) / (4 pi) (point-light falloff)
constexpr float K_NEE = (float)(0.31830988618 / (4.0 * 3.141592653589793));

struct GradLayout {
    int pcols, pl_stride, pl_pow_off, al_stride;
    int row_pl0, row_al0, row_bg0, row_cam0, row_geo0, row_tri0, row_tex0, rows;
};

// `texels`: atlas texels that get gradient rows (0 without texel gradients);
// `full` is true for the geo and physical modes too.
inline GradLayout grad_layout(int num_spheres, int num_triangles, int num_materials,
                              int num_point_lights, int num_area_lights, bool full,
                              int texels = 0, bool physical = false, bool geo = false) {
    GradLayout L;
    L.pcols = physical ? P_COLS_PHYS : (full ? P_COLS_FULL : P_COLS);
    L.pl_stride = full ? 6 : 3;
    L.pl_pow_off = full ? 3 : 0;
    L.al_stride = geo ? AL_ROWS_GEO : 3;
    L.row_pl0 = num_materials * L.pcols;
    L.row_al0 = L.row_pl0 + L.pl_stride * num_point_lights;
    L.row_bg0 = L.row_al0 + L.al_stride * num_area_lights;
    L.row_cam0 = L.row_bg0 + 3;
    L.row_geo0 = L.row_cam0 + CAM_ROWS;
    L.row_tri0 = L.row_geo0 + 4 * num_spheres;
    L.row_tex0 = full ? L.row_tri0 + (geo ? TRI_ROWS * num_triangles : 0) : L.row_cam0;
    L.rows = L.row_tex0 + 3 * texels;
    return L;
}

// Four neighbouring planes of one slot.
struct Quad {
    float x, y, z, w;
};

CPT_HD float int_bits(int i) {
    float f;
    memcpy(&f, &i, sizeof(f));
    return f;
}

CPT_HD int float_bits(float f) {
    int i;
    memcpy(&i, &f, sizeof(i));
    return i;
}

// A lane's checkpoint stack: slot k holds one stored bounce, plane q of it
// at at(k, q). The lane's slots lie together, [thread][slot][plane] with
// slot_floats a multiple of 4 and the lane's first slot 16-byte aligned, so
// put4 / get4 move four planes in one access (on the card a float4), and the
// sectors a lane touches hold its own planes only, whatever the depths of
// the other lanes of its warp.
struct CheckpointStore {
    float* base;
    int slot_floats;
    CPT_HD float* at(int k, int q) const { return base + (size_t)k * slot_floats + q; }
    CPT_HD float get(int k, int q) const { return *at(k, q); }
    CPT_HD void put(int k, int q, float v) const { *at(k, q) = v; }
    CPT_HD int geti(int k, int q) const { return float_bits(get(k, q)); }
    CPT_HD void puti(int k, int q, int i) const { put(k, q, int_bits(i)); }
    CPT_HD void get3(int k, int q, float& x, float& y, float& z) const {
        x = get(k, q); y = get(k, q + 1); z = get(k, q + 2);
    }
    CPT_HD void put3(int k, int q, float x, float y, float z) const {
        put(k, q, x); put(k, q + 1, y); put(k, q + 2, z);
    }
    // planes q .. q+3, q a multiple of 4
    CPT_HD Quad get4(int k, int q) const {
#if defined(__CUDACC__)
        const float4 v = *reinterpret_cast<const float4*>(at(k, q));
        return {v.x, v.y, v.z, v.w};
#else
        return {get(k, q), get(k, q + 1), get(k, q + 2), get(k, q + 3)};
#endif
    }
    CPT_HD void put4(int k, int q, float x, float y, float z, float w) const {
#if defined(__CUDACC__)
        *reinterpret_cast<float4*>(at(k, q)) = make_float4(x, y, z, w);
#else
        put(k, q, x); put(k, q + 1, y); put(k, q + 2, z); put(k, q + 3, w);
#endif
    }
};

// ---- next-event estimation: q and its partials ---------------------------------

// q = NEE scale / diff_avg / power / diffuse of one sampled light point l:
// max(0, n.w) * K / d^2 where the point is visible, else 0. FULL also gives
// dq/dp and dq/dn in the visible, unclamped region (zero elsewhere):
//   dq/dp = K/dist^3 (3 (n.w) w - n),  dq/dn = K/dist^2 w.
// Occlusion and the cosine clamp are discrete: no gradient through them.
template <bool FULL>
CPT_HD float light_q(const SceneTables& sc, float px, float py, float pz,
                     float nx, float ny, float nz, float lx, float ly, float lz,
                     float* dqp, float* dqn) {
    if (FULL) {
        dqp[0] = dqp[1] = dqp[2] = 0.0f;
        dqn[0] = dqn[1] = dqn[2] = 0.0f;
    }
    const float offx = lx - px, offy = ly - py, offz = lz - pz;
    const float d2 = fmaxf(offx * offx + offy * offy + offz * offz, 1e-12f);
    const float dist = sqrtf(d2);
    const float inv_d = 1.0f / dist;
    const float wx = offx * inv_d, wy = offy * inv_d, wz = offz * inv_d;
    const float cl_raw = dot3(nx, ny, nz, wx, wy, wz);
    if (!(cl_raw > 0.0f)) return 0.0f;
    if (occlusion_sweep(sc, px + nx * RAY_BUMP_EPSILON, py + ny * RAY_BUMP_EPSILON,
                        pz + nz * RAY_BUMP_EPSILON, wx, wy, wz,
                        dist - 2.0f * RAY_BUMP_EPSILON)) return 0.0f;
    if (FULL) {
        const float c3 = K_NEE * inv_d / d2;
        dqp[0] = c3 * (3.0f * cl_raw * wx - nx);
        dqp[1] = c3 * (3.0f * cl_raw * wy - ny);
        dqp[2] = c3 * (3.0f * cl_raw * wz - nz);
        const float c2 = K_NEE / d2;
        dqn[0] = c2 * wx; dqn[1] = c2 * wy; dqn[2] = c2 * wz;
    }
    return cl_raw * K_NEE / d2;
}

// One light's NEE partials at an outside hit: the power rows, the hit
// material's diffuse and diff_avg rows and, in full mode, the accumulated
// position/normal adjoints. Adds the light's contribution to `dir` and
// returns A_q = dL/dq of this light. DEFER (a textured scene) sums the
// diffuse cotangent, that of the effective albedo, into `alb` instead of the
// material rows: the reverse sweep splits it.
template <bool FULL, bool DEFER, class Sink>
CPT_HD float nee_partials(const float* m, int mat_row, float q, const float* dqp, const float* dqn,
                          float pwx, float pwy, float pwz, int power_row,
                          float gtx, float gty, float gtz, float* dir, float* nee_ap,
                          float* nee_an, float* alb, Sink& acc) {
    const float m_dr = m[0], m_dg = m[1], m_db = m[2], m_pd = m[14];
    const float s = m_pd * q;
    dir[0] += pwx * m_dr * s;
    dir[1] += pwy * m_dg * s;
    dir[2] += pwz * m_db * s;
    // d power_l += g*T_mid (.) diffuse * diff_avg*q
    acc.add(power_row + 0, gtx * m_dr * s);
    acc.add(power_row + 1, gty * m_dg * s);
    acc.add(power_row + 2, gtz * m_db * s);
    const float gsum = gtx * pwx * m_dr + gty * pwy * m_dg + gtz * pwz * m_db;
    // d diffuse[m] += g*T_mid * diff_avg*q*power;  d diff_avg[m] += sum_ch g*T*q*(power.diffuse)
    if (DEFER) {
        alb[0] += gtx * pwx * m_pd * q;
        alb[1] += gty * pwy * m_pd * q;
        alb[2] += gtz * pwz * m_pd * q;
    } else {
        acc.add(mat_row + 0, gtx * pwx * m_pd * q);
        acc.add(mat_row + 1, gty * pwy * m_pd * q);
        acc.add(mat_row + 2, gtz * pwz * m_pd * q);
    }
    acc.add(mat_row + 12, gsum * q);
    const float aq = gsum * m_pd;
    if (FULL) {
        for (int c = 0; c < 3; ++c) {
            nee_ap[c] += aq * dqp[c];
            nee_an[c] += aq * dqn[c];
        }
    }
    return aq;
}

// ---- adjoint of the scatter step (full mode) -----------------------------------

// Consumes the carried cotangents of bounce b's OUTPUT ray (ao: origin, ad:
// direction) and the weight cotangent dw = A_after * T_mid, re-deriving the
// forward's branch math from the (d, n) stored in slot k and the uniforms of
// bounce b, replayed.
// Gives the cotangents flowing into the hit point (ap), the surfel normal
// (an) and the INCOMING direction (ade), and adds the roughness / ior /
// spec_exp rows. Only the branch that was drawn is evaluated.
template <class Store, class Sink>
CPT_HD void scatter_chain(const SceneTables& sc, const RenderParams& p, const GradLayout& L,
                          int pixel, int sample, int b, const Store& st, int k,
                          int mat, int code, float dwx, float dwy, float dwz,
                          const float* ao, const float* ad, float* ap, float* an, float* ade,
                          Sink& acc) {
    for (int c = 0; c < 3; ++c) { ap[c] = 0.0f; an[c] = 0.0f; ade[c] = 0.0f; }
    if (code == BRANCH_NONE) return;
    const float eps = RAY_BUMP_EPSILON;
    float dx, dy, dz, nx, ny, nz;
    st.get3(k, Q_D, dx, dy, dz);
    st.get3(k, Q_N, nx, ny, nz);
    const float* m = sc.materials + mat * M_COLS;
    const int mat_row = mat * L.pcols;
    const int pair0 = 1 + b * (2 + 2 * sc.num_area_lights);
    float u_branch, u_a, u_b, unused;
    uniform_pair(p.seed, pixel, sample, pair0, u_branch, u_a);
    uniform_pair(p.seed, pixel, sample, pair0 + 1, u_b, unused);

    const float cos_i = -dot3(dx, dy, dz, nx, ny, nz);
    const float cos_pos = fabsf(cos_i);
    const float s_ci = sgn(cos_i);
    const float theta = u_a * TWO_PI;
    const float cth = cosf(theta), sth = sinf(theta);
    const float aopx = ao[0], aopy = ao[1], aopz = ao[2];
    const float adpx = ad[0], adpy = ad[1], adpz = ad[2];
    ap[0] = aopx; ap[1] = aopy; ap[2] = aopz;  // every branch starts at p (+ eps * something)

    if (code == BRANCH_DIFFUSE) {
        // d' = rot(n, cap), o' = p + eps n
        const float yy = sqrtf(u_b);
        const float rr = sqrtf(fmaxf(1.0f - yy * yy, 0.0f));
        float atx, aty, atz, asx, asy, asz;
        rot_y_to_vjp(nx, ny, nz, rr * cth, yy, rr * sth, adpx, adpy, adpz,
                     atx, aty, atz, asx, asy, asz);
        an[0] = atx + eps * aopx;
        an[1] = aty + eps * aopy;
        an[2] = atz + eps * aopz;
        return;
    }
    if (code == BRANCH_COOK_TORRANCE) {
        const float m_sr = m[3], m_sg = m[4], m_sb = m[5], m_rough = m[17];
        const float u_ac = fminf(u_a, (float)(1.0 - 1e-7));
        const float l1p = log1pf(-u_ac);
        const float btan = -(m_rough * m_rough) * l1p;
        const float binv = CPT_RSQRT(1.0f + btan * btan);
        const float bphi = u_b * TWO_PI;
        const float cbp = cosf(bphi), sbp = sinf(bphi);
        const float sb_ = btan * binv;
        const float sbx = sb_ * cbp, sby = binv, sbz = sb_ * sbp;
        float mx, my, mz;
        rotate_y_to(nx, ny, nz, sbx, sby, sbz, mx, my, mz);
        const float cmu = dot3(dx, dy, dz, mx, my, mz);
        const float cos_m = fabsf(cmu);
        const float s_cm = sgn(cmu);
        const float ctx = dx + 2.0f * cos_m * mx;
        const float cty = dy + 2.0f * cos_m * my;
        const float ctz = dz + 2.0f * cos_m * mz;
        const float vhx_ = ctx - dx, vhy_ = cty - dy, vhz_ = ctz - dz;
        const float hn2 = vhx_ * vhx_ + vhy_ * vhy_ + vhz_ * vhz_;
        const float hinv = CPT_RSQRT(fmaxf(hn2, 1e-12f));
        const float hx = vhx_ * hinv, hy = vhy_ * hinv, hz = vhz_ * hinv;
        const float nh_u = dot3(nx, ny, nz, hx, hy, hz);
        const float nl_u = dot3(nx, ny, nz, ctx, cty, ctz);
        const float vh_u = dot3(dx, dy, dz, hx, hy, hz);
        const float nh = fabsf(nh_u), nl = fabsf(nl_u);
        const float vh = fmaxf(fabsf(vh_u), 1e-12f);
        const float nv = fmaxf(cos_pos, 1e-6f);
        const float a1 = 2.0f * nh * nl / vh;
        const float b1 = 2.0f * nh * nv / vh;
        const float inner = fminf(1.0f, a1);
        const float geom = fminf(inner, b1);
        // weight cotangent: w = spec * ct_w, ct_w = geom/nv
        const float act_w = dwx * m_sr + dwy * m_sg + dwz * m_sb;
        const float ageom = act_w / nv;
        float anv = -act_w * geom / (nv * nv);
        const float ab1 = (b1 < inner) ? ageom : 0.0f;
        const float aa1 = ((a1 < 1.0f) && (b1 >= inner)) ? ageom : 0.0f;
        const float anh = (2.0f * nl / vh) * aa1 + (2.0f * nv / vh) * ab1;
        const float anl = (2.0f * nh / vh) * aa1;
        anv = anv + (2.0f * nh / vh) * ab1;
        const float avh = ((-a1 / vh) * aa1 + (-b1 / vh) * ab1)
                          * ((fabsf(vh_u) > 1e-12f) ? 1.0f : 0.0f);
        const float s_nh = sgn(nh_u), s_nl = sgn(nl_u), s_vh = sgn(vh_u);
        float anCx = s_nh * hx * anh + s_nl * ctx * anl;
        float anCy = s_nh * hy * anh + s_nl * cty * anl;
        float anCz = s_nh * hz * anh + s_nl * ctz * anl;
        const float ahx = s_nh * nx * anh + s_vh * dx * avh;
        const float ahy = s_nh * ny * anh + s_vh * dy * avh;
        const float ahz = s_nh * nz * anh + s_vh * dz * avh;
        float adCx = s_vh * hx * avh;
        float adCy = s_vh * hy * avh;
        float adCz = s_vh * hz * avh;
        // total d'(ct) adjoint: carried + nl term, then h's normalize
        float adtx = adpx + s_nl * nx * anl;
        float adty = adpy + s_nl * ny * anl;
        float adtz = adpz + s_nl * nz * anl;
        float avx, avy, avz;
        norm3_vjp(vhx_, vhy_, vhz_, ahx, ahy, ahz, 1e-12f, avx, avy, avz);
        adtx += avx; adty += avy; adtz += avz;
        adCx -= avx; adCy -= avy; adCz -= avz;
        // o' = p + eps m
        float amx = eps * aopx, amy = eps * aopy, amz = eps * aopz;
        // d' = d + 2 cos_m m
        adCx += adtx; adCy += adty; adCz += adtz;
        amx += 2.0f * cos_m * adtx;
        amy += 2.0f * cos_m * adty;
        amz += 2.0f * cos_m * adtz;
        const float acos_m = 2.0f * dot3(mx, my, mz, adtx, adty, adtz);
        adCx += s_cm * mx * acos_m;
        adCy += s_cm * my * acos_m;
        adCz += s_cm * mz * acos_m;
        amx += s_cm * dx * acos_m;
        amy += s_cm * dy * acos_m;
        amz += s_cm * dz * acos_m;
        float atx, aty, atz, asbx, asby, asbz;
        rot_y_to_vjp(nx, ny, nz, sbx, sby, sbz, amx, amy, amz, atx, aty, atz, asbx, asby, asbz);
        anCx += atx; anCy += aty; anCz += atz;
        const float asb_ = cbp * asbx + sbp * asbz;
        const float b3 = binv * binv * binv;
        const float abtan = b3 * asb_ - btan * b3 * asby;
        const float arough = abtan * (-2.0f * m_rough * l1p);
        const float aciC = (cos_pos > 1e-6f) ? s_ci * anv : 0.0f;
        an[0] = anCx - dx * aciC; an[1] = anCy - dy * aciC; an[2] = anCz - dz * aciC;
        ade[0] = adCx - nx * aciC; ade[1] = adCy - ny * aciC; ade[2] = adCz - nz * aciC;
        acc.add(mat_row + 13, arough);
        return;
    }
    if (code == BRANCH_GLOSS) {
        // Phong lobe about the quirk reflection mr = d + 2 |cos_i| n; o' = p + eps n
        const float m_exp = m[12];
        const float mrx = dx + 2.0f * cos_pos * nx;
        const float mry = dy + 2.0f * cos_pos * ny;
        const float mrz = dz + 2.0f * cos_pos * nz;
        float amrx = adpx, amry = adpy, amrz = adpz;  // delta mirror: d' = mr
        if (isfinite(m_exp)) {
            const float pexp = 1.0f / (m_exp + 1.0f);
            const float s_cl = fminf(fmaxf(u_b, 1e-12f), 1.0f);
            const float lg = logf(s_cl);
            const float ph_y = expf(pexp * lg);
            const float ph_r2 = fmaxf(1.0f - ph_y * ph_y, 0.0f);
            const float ph_r = sqrtf(ph_r2);
            float aspx, aspy, aspz;
            rot_y_to_vjp(mrx, mry, mrz, ph_r * cth, ph_y, ph_r * sth, adpx, adpy, adpz,
                         amrx, amry, amrz, aspx, aspy, aspz);
            const float aph_r = cth * aspx + sth * aspz;
            const float aph_y = aspy + ((ph_r2 > 0.0f)
                                            ? aph_r * (-ph_y / fmaxf(ph_r, 1e-6f)) : 0.0f);
            acc.add(mat_row + 15, -pexp * pexp * (ph_y * lg * aph_y));
        }
        const float aciG = s_ci * 2.0f * dot3(nx, ny, nz, amrx, amry, amrz);
        ade[0] = amrx - nx * aciG; ade[1] = amry - ny * aciG; ade[2] = amrz - nz * aciG;
        an[0] = 2.0f * cos_pos * amrx + eps * aopx - dx * aciG;
        an[1] = 2.0f * cos_pos * amry + eps * aopy - dy * aciG;
        an[2] = 2.0f * cos_pos * amrz + eps * aopz - dz * aciG;
        return;
    }
    // BRANCH_REFRACT: d' = normalize(n_ratio d + (n_ratio |cos_i| - cos_t) n), o' = p + eps d'
    const float m_ior = m[13];
    const bool outside = cos_i > 0.0f;
    const float n1 = outside ? 1.0f : m_ior;
    const float n2_ = outside ? m_ior : 1.0f;
    const float n_ratio = n1 / fmaxf(n2_, 1e-12f);
    const float sin_t2 = n_ratio * n_ratio * (1.0f - cos_pos * cos_pos);
    const bool tir = sin_t2 > 1.0f;
    const float cos_t = sqrtf(tir ? 1.0f : fmaxf(1.0f - sin_t2, 0.0f));
    const float coef_n = n_ratio * cos_pos - cos_t;
    const float rf0x = n_ratio * dx + coef_n * nx;
    const float rf0y = n_ratio * dy + coef_n * ny;
    const float rf0z = n_ratio * dz + coef_n * nz;
    float arx, ary, arz;
    norm3_vjp(rf0x, rf0y, rf0z, adpx + eps * aopx, adpy + eps * aopy, adpz + eps * aopz, 1e-12f,
              arx, ary, arz);
    const float n_dot_arf = dot3(nx, ny, nz, arx, ary, arz);
    float anrat = dot3(dx, dy, dz, arx, ary, arz) + cos_pos * n_dot_arf;
    float acpR = n_ratio * n_dot_arf;
    const float acost = -n_dot_arf;
    const float asin2 = tir ? 0.0f : -acost / (2.0f * fmaxf(cos_t, 1e-6f));
    anrat = anrat + 2.0f * n_ratio * (1.0f - cos_pos * cos_pos) * asin2;
    acpR = acpR - 2.0f * n_ratio * n_ratio * cos_pos * asin2;
    const float aior = anrat * (outside ? -1.0f / fmaxf(m_ior * m_ior, 1e-12f) : 1.0f);
    const float aciR = s_ci * acpR;
    ade[0] = n_ratio * arx - nx * aciR;
    ade[1] = n_ratio * ary - ny * aciR;
    ade[2] = n_ratio * arz - nz * aciR;
    an[0] = coef_n * arx - dx * aciR;
    an[1] = coef_n * ary - dy * aciR;
    an[2] = coef_n * arz - dz * aciR;
    acc.add(mat_row + 14, aior);
}

// ---- the normal map's perturbation, pulled back (full mode) ----------------------

// VJP of perturb_normal (megakernel.cuh) at raw normal n and texel t, with the
// tangent source the sphere tangent of the unit normal (`sphere`) or the fixed
// triangle tangent tg: cotangent g of the perturbed normal -> cotangents of
// the raw normal (an) and of the texel values (at). Recomputes the forward;
// every max(x, eps) clamp passes its cotangent only where x > eps. `atg`,
// when given (a triangle's tangent: geo mode), receives the cotangent of tg.
CPT_HD void perturb_normal_vjp(float nx, float ny, float nz, bool sphere,
                               float tgx, float tgy, float tgz, float t0, float t1, float t2,
                               float gx, float gy, float gz, float* an, float* at,
                               float* atg = nullptr) {
    const float n2 = nx * nx + ny * ny + nz * nz;
    const float inv_nl = CPT_RSQRT(fmaxf(n2, 1e-20f));
    const float nux = nx * inv_nl, nuy = ny * inv_nl, nuz = nz * inv_nl;
    const float st2 = nuz * nuz + nux * nux;
    const bool st_live = sphere && !(st2 < 1e-12f);
    const float st_inv = CPT_RSQRT(fmaxf(st2, 1e-20f));
    if (sphere) sphere_tangent(nux, nuz, tgx, tgy, tgz);
    const float tdn = tgx * nux + tgy * nuy + tgz * nuz;
    const float rx = tgx - nux * tdn, ry = tgy - nuy * tdn, rz = tgz - nuz * tdn;
    const float po_inv = CPT_RSQRT(fmaxf(rx * rx + ry * ry + rz * rz, 1e-20f));
    const float pox = rx * po_inv, poy = ry * po_inv, poz = rz * po_inv;
    float bx, by, bz;
    cross3(nux, nuy, nuz, pox, poy, poz, bx, by, bz);
    const float tnx = t0 * 2.0f - 1.0f;
    const float tny = t1 * 2.0f - 1.0f;
    const float tnz_raw = t2 * 2.0f - 1.0f;
    const float tnz = fmaxf(tnz_raw, 1e-3f);
    const float ppx = pox * tnx + bx * tny + nux * tnz;
    const float ppy = poy * tnx + by * tny + nuy * tnz;
    const float ppz = poz * tnx + bz * tny + nuz * tnz;
    const float pp2 = ppx * ppx + ppy * ppy + ppz * ppz;
    const float pp_inv = CPT_RSQRT(fmaxf(pp2, 1e-20f));
    const float n_len = sqrtf(fmaxf(n2, 1e-20f));
    const float s = pp_inv * n_len;
    // out = pp s,  s = pp_inv n_len
    float apx = gx * s, apy = gy * s, apz = gz * s;
    const float as = dot3(gx, gy, gz, ppx, ppy, ppz);
    if (pp2 > 1e-20f) {
        const float app2 = -0.5f * pp_inv * pp_inv * pp_inv * (as * n_len);
        apx += 2.0f * ppx * app2; apy += 2.0f * ppy * app2; apz += 2.0f * ppz * app2;
    }
    const float an2 = (n2 > 1e-20f) ? as * pp_inv * 0.5f / n_len : 0.0f;
    // pp = po tnx + b tny + nu tnz
    float apox = apx * tnx, apoy = apy * tnx, apoz = apz * tnx;
    const float abx = apx * tny, aby = apy * tny, abz = apz * tny;
    float anux = apx * tnz, anuy = apy * tnz, anuz = apz * tnz;
    at[0] = 2.0f * dot3(apx, apy, apz, pox, poy, poz);
    at[1] = 2.0f * dot3(apx, apy, apz, bx, by, bz);
    at[2] = (tnz_raw > 1e-3f) ? 2.0f * dot3(apx, apy, apz, nux, nuy, nuz) : 0.0f;
    // b = nu x po:  A_nu += po x A_b,  A_po += A_b x nu
    float cx, cy, cz;
    cross3(pox, poy, poz, abx, aby, abz, cx, cy, cz);
    anux += cx; anuy += cy; anuz += cz;
    cross3(abx, aby, abz, nux, nuy, nuz, cx, cy, cz);
    apox += cx; apoy += cy; apoz += cz;
    // po = normalize(r),  r = tg - nu tdn,  tdn = tg . nu
    float arx, ary, arz;
    norm3_vjp(rx, ry, rz, apox, apoy, apoz, 1e-20f, arx, ary, arz);
    const float atdn = -dot3(arx, ary, arz, nux, nuy, nuz);
    if (atg) {
        atg[0] = arx + atdn * nux; atg[1] = ary + atdn * nuy; atg[2] = arz + atdn * nuz;
    }
    anux += -arx * tdn + atdn * tgx;
    anuy += -ary * tdn + atdn * tgy;
    anuz += -arz * tdn + atdn * tgz;
    if (st_live) {
        // tg = (-nuz st_inv, 0, nux st_inv),  st_inv = rsqrt(max(nuz^2 + nux^2, eps))
        const float atgx = arx + atdn * nux, atgz = arz + atdn * nuz;
        const float ast_inv = -atgx * nuz + atgz * nux;
        anuz += -atgx * st_inv;
        anux += atgz * st_inv;
        if (st2 > 1e-20f) {
            const float ast2 = -0.5f * st_inv * st_inv * st_inv * ast_inv;
            anux += 2.0f * nux * ast2;
            anuz += 2.0f * nuz * ast2;
        }
    }
    // nu = normalize(n);  n_len = sqrt(max(|n|^2, eps))
    norm3_vjp(nx, ny, nz, anux, anuy, anuz, 1e-20f, an[0], an[1], an[2]);
    an[0] += 2.0f * nx * an2; an[1] += 2.0f * ny * an2; an[2] += 2.0f * nz * an2;
}

// Adjoint of tri_uv_tangent (megakernel.cuh): cotangent a_t of the tangent ->
// the edges' (added to ae1, ae2). The UVs are constants.
CPT_HD void tri_uv_tangent_vjp(const float* tri, const float* uv, const float* a_t, float* ae1,
                               float* ae2) {
    const float e1x = tri[3], e1y = tri[4], e1z = tri[5];
    const float e2x = tri[6], e2y = tri[7], e2z = tri[8];
    const float du1 = uv[2] - uv[0], dv1 = uv[3] - uv[1];
    const float du2 = uv[4] - uv[0], dv2 = uv[5] - uv[1];
    const float det = du1 * dv2 - du2 * dv1;
    const bool det_bad = fabsf(det) < 1e-12f;
    const float inv_det = det_bad ? 0.0f : 1.0f / det;
    const float tx = (e1x * dv2 - e2x * dv1) * inv_det;
    const float ty = (e1y * dv2 - e2y * dv1) * inv_det;
    const float tz = (e1z * dv2 - e2z * dv1) * inv_det;
    if (det_bad || (tx * tx + ty * ty + tz * tz) < 1e-16f) {
        // the unit e1
        float ax, ay, az;
        norm3_vjp(e1x, e1y, e1z, a_t[0], a_t[1], a_t[2], 1e-20f, ax, ay, az);
        ae1[0] += ax; ae1[1] += ay; ae1[2] += az;
        return;
    }
    for (int c = 0; c < 3; ++c) {
        ae1[c] += a_t[c] * dv2 * inv_det;
        ae2[c] -= a_t[c] * dv1 * inv_det;
    }
}

// The texel rows of one fetch: value vals[c] times each stored corner weight
// into the corner texel's channel-c row.
template <class Store, class Sink>
CPT_HD void scatter_texels(const Store& st, int k, int q_idx, int q_w, const float* vals,
                           int row_tex0, Sink& acc) {
    for (int j = 0; j < 4; ++j) {
        const float w = st.get(k, q_w + j);
        if (w == 0.0f) continue;
        const int row = row_tex0 + 3 * st.geti(k, q_idx + j);
        acc.add(row + 0, vals[0] * w);
        acc.add(row + 1, vals[1] * w);
        acc.add(row + 2, vals[2] * w);
    }
}

// ---- adjoint of the hit (full mode) ---------------------------------------------

// Adjoint of the winning triangle's hit distance and barycentrics
// (triangle_t, Moller-Trumbore) at s = o - v0, direction d, edge rows tr[3..8]
// and hit distance t: cotangents (at, aw1, aw2) -> those of s (the origin's;
// v0 gets -a_s) and of d and, with EDGES, of e1 and e2 (set, not added). On
// triple products t = s.A / det, w1 = s.(d x e2) / det, w2 = d.(s x e1) / det
// with A = e1 x e2 and det = -d.A (= e1.(d x e2), as triangle_t has it), A
// reaches t through the numerator and the determinant. Interior hits only: which triangle is hit carries nothing.
// (w1, w2) receive the barycentrics.
template <bool EDGES>
CPT_HD void triangle_t_vjp(float sx, float sy, float sz, float dx, float dy, float dz,
                           const float* tr, float t, float at, float aw1, float aw2,
                           float* as, float* ad, float* ae1, float* ae2, float& w1, float& w2) {
    const float e1x = tr[3], e1y = tr[4], e1z = tr[5];
    const float e2x = tr[6], e2y = tr[7], e2z = tr[8];
    float Ax, Ay, Az, qx, qy, qz, rvx, rvy, rvz, e1dx, e1dy, e1dz, e2sx, e2sy, e2sz;
    cross3(e1x, e1y, e1z, e2x, e2y, e2z, Ax, Ay, Az);
    cross3(dx, dy, dz, e2x, e2y, e2z, qx, qy, qz);
    // det = -d.A, taken as the forward takes it (e1.q): bit for bit the value
    // whose |det| > 1e-7 made this a hit. On a grazing hit the two forms
    // differ by more than det itself, and the reverse sweep divides by it.
    const float det = e1x * qx + e1y * qy + e1z * qz;
    const float idet = 1.0f / (sgn(det) * fmaxf(fabsf(det), 1e-9f));
    cross3(sx, sy, sz, e1x, e1y, e1z, rvx, rvy, rvz);
    w1 = (sx * qx + sy * qy + sz * qz) * idet;
    w2 = (dx * rvx + dy * rvy + dz * rvz) * idet;
    cross3(e1x, e1y, e1z, dx, dy, dz, e1dx, e1dy, e1dz);
    cross3(e2x, e2y, e2z, sx, sy, sz, e2sx, e2sy, e2sz);
    as[0] = (at * Ax + aw1 * qx + aw2 * e1dx) * idet;
    as[1] = (at * Ay + aw1 * qy + aw2 * e1dy) * idet;
    as[2] = (at * Az + aw1 * qz + aw2 * e1dz) * idet;
    ad[0] = (at * t * Ax + aw1 * (e2sx + w1 * Ax) + aw2 * (rvx + w2 * Ax)) * idet;
    ad[1] = (at * t * Ay + aw1 * (e2sy + w1 * Ay) + aw2 * (rvy + w2 * Ay)) * idet;
    ad[2] = (at * t * Az + aw1 * (e2sz + w1 * Az) + aw2 * (rvz + w2 * Az)) * idet;
    if (EDGES) {
        // A_A = (at (s + t d) + (aw1 w1 + aw2 w2) d) / det; A = e1 x e2;
        // w1's d x e2 gives e2 the term aw1 (s x d) / det, w2's s x e1 gives
        // e1 the term aw2 (d x s) / det
        const float kw = aw1 * w1 + aw2 * w2;
        const float aAx = idet * (at * (sx + t * dx) + kw * dx);
        const float aAy = idet * (at * (sy + t * dy) + kw * dy);
        const float aAz = idet * (at * (sz + t * dz) + kw * dz);
        float dsx, dsy, dsz;
        cross3(e2x, e2y, e2z, aAx, aAy, aAz, ae1[0], ae1[1], ae1[2]);
        cross3(aAx, aAy, aAz, e1x, e1y, e1z, ae2[0], ae2[1], ae2[2]);
        cross3(dx, dy, dz, sx, sy, sz, dsx, dsy, dsz);
        ae1[0] += aw2 * idet * dsx; ae1[1] += aw2 * idet * dsy; ae1[2] += aw2 * idet * dsz;
        ae2[0] -= aw1 * idet * dsx; ae2[1] -= aw1 * idet * dsy; ae2[2] -= aw1 * idet * dsz;
    }
}

// normal -> (point | barycentrics), point -> (origin, direction, t), t ->
// (origin, direction) through the winning primitive's analytic intersection
// Jacobian (the bounce stored in slot k), plus the Beer factor's t adjoint (and, PHYSICAL, the direct
// phase's, plane Q_PA_T). amid = A_mid, tm = T_mid of the bounce. Overwrites
// (ao, ad) — the carried cotangent of the bounce's OUTPUT ray — with the
// cotangent of its INPUT ray, and adds the sphere rows (GEO: the triangle
// rows). `an` is the cotangent of the geometric (raw) normal, kept at plane
// `q_normal`; `nee_an_in` says that the NEE normal partials are in it already
// (the normal-map pullback folded them in).
template <bool GEO, bool PHYSICAL, class Store, class Sink>
CPT_HD void hit_chain(const SceneTables& sc, const GradLayout& L, int k, const Store& st,
                      int mat, const float* amid, const float* tm, float t_in,
                      const float* ap, const float* an, const float* ade,
                      float* ao, float* ad, Sink& acc, int q_normal = Q_N,
                      bool nee_an_in = false) {
    float ox, oy, oz, dx, dy, dz, nx, ny, nz, nax, nay, naz, nnx = 0.0f, nny = 0.0f, nnz = 0.0f;
    st.get3(k, Q_O, ox, oy, oz);
    st.get3(k, Q_D, dx, dy, dz);
    st.get3(k, q_normal, nx, ny, nz);
    st.get3(k, Q_NEE_AP, nax, nay, naz);
    if (!nee_an_in) st.get3(k, Q_NEE_AN, nnx, nny, nnz);
    const float t_hit = st.get(k, Q_T);
    const int prim = st.geti(k, Q_PRIM);
    float apx = ap[0] + nax, apy = ap[1] + nay, apz = ap[2] + naz;
    const float anx = an[0] + nnx, any_ = an[1] + nny, anz = an[2] + nnz;

    // Beer-Lambert's t adjoint: dL/dt = sum_c A_mid_c T_mid_c (-a_c), inside hits only
    const float* m = sc.materials + mat * M_COLS;
    float at = 0.0f;
    if (t_in > 0.0f) at = -(amid[0] * tm[0] * m[6] + amid[1] * tm[1] * m[7] + amid[2] * tm[2] * m[8]);
    if (PHYSICAL) at += st.get(k, Q_PA_T);

    float aox, aoy, aoz, adx, ady, adz;
    if (prim < sc.num_spheres) {
        // sphere: n = normalize(p - c) -> A_n feeds A_p (and -A_c); p - c = v + t d
        const float* s = sc.spheres + prim * S_COLS;
        const float vx = ox - s[0], vy = oy - s[1], vz = oz - s[2];
        const float gvx = vx + t_hit * dx, gvy = vy + t_hit * dy, gvz = vz + t_hit * dz;
        const float invg = CPT_RSQRT(fmaxf(gvx * gvx + gvy * gvy + gvz * gvz, 1e-18f));
        const float ndot = nx * anx + ny * any_ + nz * anz;
        const float apnx = (anx - nx * ndot) * invg;
        const float apny = (any_ - ny * ndot) * invg;
        const float apnz = (anz - nz * ndot) * invg;
        apx += apnx; apy += apny; apz += apnz;
        // p = o + t d
        at = at + apx * dx + apy * dy + apz * dz;
        // t chain. sphere_t solves t^2 + b t + c = 0 with b = 2 d.v, c = v.v - r^2,
        // v = o - centre — the intersection for a UNIT direction. The mirror
        // and Cook-Torrance branches hand on an unnormalised direction (reference
        // quirk), so the adjoint is that of this formula, not of the geometric
        // intersection: with k = t + d.v (= d.g for a unit d, = -/+ sqrt(disc) / 2
        // for the root taken)
        //   dt/do = -g/k,  dt/dd = -t v/k,  dt/dcentre = +g/k,  dt/dr = r/k.
        // k is the forward's own sqrt(disc): at a grazing hit it is tiny, and
        // a k rebuilt from t would keep nothing of it. Where disc <= 0 the
        // root -b/2 is all that moves: dt/do = -d, dt/dd = -v.
        const float bq = 2.0f * dot3(dx, dy, dz, vx, vy, vz);
        const float cq = vx * vx + vy * vy + vz * vz - s[3] * s[3];
        const float sq = sqrtf(fmaxf(bq * bq - 4.0f * cq, 0.0f));
        // 1/k of the root taken (t0 = (-b - sq) / 2 unless it is negative);
        // `flat` is 1 where disc <= 0
        const float ik = (sq > 0.0f) ? (((-bq - sq) * 0.5f < 0.0f) ? 2.0f / sq : -2.0f / sq) : 0.0f;
        const float flat = (sq > 0.0f) ? 0.0f : 1.0f;
        aox = -at * (gvx * ik + dx * flat);
        aoy = -at * (gvy * ik + dy * flat);
        aoz = -at * (gvz * ik + dz * flat);
        adx = -at * vx * (t_hit * ik + flat);
        ady = -at * vy * (t_hit * ik + flat);
        adz = -at * vz * (t_hit * ik + flat);
        const float dr = s[3] * ik;
        // sphere rows; the normal's centre-dependence is minus its p-dependence
        const int row = L.row_geo0 + 4 * prim;
        acc.add(row + 0, -apnx - aox);
        acc.add(row + 1, -apny - aoy);
        acc.add(row + 2, -apnz - aoz);
        acc.add(row + 3, at * dr);
    } else {
        // triangle: unnormalised n = n0 + w1 (n1-n0) + w2 (n2-n0); t and the
        // barycentrics on triple products: t = s.(e1 x e2)/det, w1 = s.(d x e2)/det,
        // w2 = s.(e1 x d)/det, det = -d.(e1 x e2), s = o - v0
        const int ti = prim - sc.num_spheres;
        const float* tr = sc.triangles + ti * T_COLS;
        const float aw1 = anx * (tr[12] - tr[9]) + any_ * (tr[13] - tr[10]) + anz * (tr[14] - tr[11]);
        const float aw2 = anx * (tr[15] - tr[9]) + any_ * (tr[16] - tr[10]) + anz * (tr[17] - tr[11]);
        at = at + apx * dx + apy * dy + apz * dz;
        const float sx_ = ox - tr[0];
        const float sy_ = oy - tr[1];
        const float sz_ = oz - tr[2];
        float as[3], adt[3], ae1[3], ae2[3], w1, w2;
        triangle_t_vjp<GEO>(sx_, sy_, sz_, dx, dy, dz, tr, t_hit, at, aw1, aw2, as, adt, ae1, ae2,
                            w1, w2);
        aox = as[0]; aoy = as[1]; aoz = as[2];
        adx = adt[0]; ady = adt[1]; adz = adt[2];
        if (GEO) {
            // v0 (= -a_s), e1, e2, and the corner normals' barycentric weights
            const int row = L.row_tri0 + TRI_ROWS * ti;
            const float w0 = 1.0f - w1 - w2;
            const float anv[3] = {anx, any_, anz};
            for (int c = 0; c < 3; ++c) {
                acc.add(row + c, -as[c]);
                acc.add(row + 3 + c, ae1[c]);
                acc.add(row + 6 + c, ae2[c]);
                acc.add(row + 9 + c, anv[c] * w0);
                acc.add(row + 12 + c, anv[c] * w1);
                acc.add(row + 15 + c, anv[c] * w2);
            }
        }
    }
    ao[0] = apx + aox; ao[1] = apy + aoy; ao[2] = apz + aoz;
    ad[0] = ade[0] + t_hit * apx + adx;
    ad[1] = ade[1] + t_hit * apy + ady;
    ad[2] = ade[2] + t_hit * apz + adz;
}

// ---- the textured scene's share of the path adjoint (full mode) -------------------

// Geo mode: the cotangents (a_u, a_v) of the UVs of triangle row `tr` (corner
// UVs `uv`) at the hit point p, at that FIXED point, pulled into the
// triangle's packed (v0, e1, e2): a9 receives their cotangents. The plane
// barycentrics are (a, b) = M^-1 [e1.q, e2.q], q = p - v0, M = [[e1.e1,
// e1.e2], [e1.e2, e2.e2]], and uv = uv0 + a duv1 + b duv2. The VJP of the
// solve: A_s = M^-1 A_(a,b), A_M = -A_s (a, b)^T (M symmetric).
CPT_HD void uv_vertex_vjp(const float* tr, const float* uv, float px, float py, float pz,
                          float a_u, float a_v, float* a9) {
    const float e1[3] = {tr[3], tr[4], tr[5]}, e2[3] = {tr[6], tr[7], tr[8]};
    const float q[3] = {px - tr[0], py - tr[1], pz - tr[2]};
    const float d11 = dot3(e1[0], e1[1], e1[2], e1[0], e1[1], e1[2]);
    const float d22 = dot3(e2[0], e2[1], e2[2], e2[0], e2[1], e2[2]);
    const float d12 = dot3(e1[0], e1[1], e1[2], e2[0], e2[1], e2[2]);
    const float detm = d11 * d22 - d12 * d12;
    const float inv_m = (fabsf(detm) < 1e-18f) ? 0.0f : 1.0f / detm;
    const float s1 = dot3(e1[0], e1[1], e1[2], q[0], q[1], q[2]);
    const float s2 = dot3(e2[0], e2[1], e2[2], q[0], q[1], q[2]);
    const float ba = (d22 * s1 - d12 * s2) * inv_m;
    const float bb = (d11 * s2 - d12 * s1) * inv_m;
    const float a_a = a_u * (uv[2] - uv[0]) + a_v * (uv[3] - uv[1]);
    const float a_b = a_u * (uv[4] - uv[0]) + a_v * (uv[5] - uv[1]);
    const float a_s1 = (d22 * a_a - d12 * a_b) * inv_m;
    const float a_s2 = (d11 * a_b - d12 * a_a) * inv_m;
    const float a_d11 = -a_s1 * ba, a_d22 = -a_s2 * bb, a_d12 = -(a_s1 * bb + a_s2 * ba);
    for (int c = 0; c < 3; ++c) {
        a9[c] = -(a_s1 * e1[c] + a_s2 * e2[c]);
        a9[3 + c] = a_s1 * q[c] + 2.0f * a_d11 * e1[c] + a_d12 * e2[c];
        a9[6 + c] = a_s2 * q[c] + 2.0f * a_d22 * e2[c] + a_d12 * e1[c];
    }
}

// After scatter_chain: on a normal-mapped scene folds the NEE normal partials
// into `an` (the cotangent of the PERTURBED normal) and pulls the total back
// through the perturbation into the raw normal and the normal map's texels;
// then the UV swim: the effective albedo's texel factor (a_alb x the
// material's diffuse) and the normal map's texels move with the UVs, which
// move with the hit point (triangles: A_p += A_u du/dp + A_v dv/dp) or with
// the unit normal (spheres: into the raw normal through its normalize). GEO
// adds the triangle rows of what moves with the vertices at a fixed hit point:
// the tangent frame (its edges) and the UVs (the VJP of the plane
// barycentrics' metric solve (a, b) = M^-1 [e1.q, e2.q], q = p - v0, M the
// edges' Gram matrix; the hit point's own motion is in A_p already).
template <bool GEO, class Store, class Sink>
CPT_HD void tex_chain(const SceneTables& sc, const GradLayout& L, const TexLayout& T, int k,
                      const Store& st, int mat, const float* a_alb, float* ap,
                      float* an, Sink& acc) {
    const int prim = st.geti(k, Q_PRIM);
    const bool sphere = prim < sc.num_spheres;
    int q_raw = Q_N;
    float a_u = 0.0f, a_v = 0.0f;
    if (T.nmap) {
        const int n = T.q_nm;
        q_raw = n + QN_RAW;
        for (int c = 0; c < 3; ++c) an[c] += st.get(k, Q_NEE_AN + c);
        if (sc.tex_matids[2 * mat + 1] >= 0.0f) {
            float rx, ry, rz, tgx = 0.0f, tgy = 0.0f, tgz = 0.0f, nt[3], an_raw[3];
            st.get3(k, n + QN_RAW, rx, ry, rz);
            if (!sphere) {
                const int ti = prim - sc.num_spheres;
                tri_uv_tangent(sc.triangles + ti * T_COLS, sc.tex_triuv + ti * 6, tgx, tgy, tgz);
            }
            float atg[3];
            perturb_normal_vjp(rx, ry, rz, sphere, tgx, tgy, tgz, st.get(k, n + QN_VAL),
                               st.get(k, n + QN_VAL + 1), st.get(k, n + QN_VAL + 2),
                               an[0], an[1], an[2], an_raw, nt,
                               (GEO && !sphere) ? atg : nullptr);
            if (GEO && !sphere) {
                // the tangent frame moves with the triangle's edges
                const int ti = prim - sc.num_spheres;
                float ae[6] = {};
                tri_uv_tangent_vjp(sc.triangles + ti * T_COLS, sc.tex_triuv + ti * 6, atg, ae,
                                   ae + 3);
                for (int k = 0; k < 6; ++k) acc.add(L.row_tri0 + TRI_ROWS * ti + 3 + k, ae[k]);
            }
            an[0] = an_raw[0]; an[1] = an_raw[1]; an[2] = an_raw[2];
            if (T.grads) scatter_texels(st, k, n + QN_CIDX, n + QN_CW, nt, L.row_tex0, acc);
            for (int c = 0; c < 3; ++c) {
                a_u += nt[c] * st.get(k, n + QN_DU + c);
                a_v += nt[c] * st.get(k, n + QN_DV + c);
            }
        }
    }
    const float* md = sc.materials + mat * M_COLS;
    const int u = T.q_uvg;
    for (int c = 0; c < 3; ++c) {
        a_u += a_alb[c] * md[c] * st.get(k, u + QU_DU + c);
        a_v += a_alb[c] * md[c] * st.get(k, u + QU_DV + c);
    }
    if (a_u == 0.0f && a_v == 0.0f) return;
    float g[6];
    for (int j = 0; j < 6; ++j) g[j] = st.get(k, u + QU_G + j);
    if (!sphere) {
        for (int c = 0; c < 3; ++c) ap[c] += a_u * g[c] + a_v * g[3 + c];
        if (GEO) {
            const int ti = prim - sc.num_spheres;
            float ox, oy, oz, dx, dy, dz, a9[9];
            st.get3(k, Q_O, ox, oy, oz);
            st.get3(k, Q_D, dx, dy, dz);
            const float t = st.get(k, Q_T);
            const float px = ox + dx * t, py = oy + dy * t, pz = oz + dz * t;
            uv_vertex_vjp(sc.triangles + ti * T_COLS, sc.tex_triuv + ti * 6, px, py, pz, a_u, a_v,
                          a9);
            for (int k = 0; k < 9; ++k) acc.add(L.row_tri0 + TRI_ROWS * ti + k, a9[k]);
        }
    } else {
        float rx, ry, rz, anx, any_, anz;
        st.get3(k, q_raw, rx, ry, rz);
        norm3_vjp(rx, ry, rz, a_u * g[0], a_v * g[2], a_u * g[1], 1e-20f, anx, any_, anz);
        an[0] += anx; an[1] += any_; an[2] += anz;
    }
}

// The texture block's checkpoint planes in slot k (all but the albedo
// cotangent's): its texel multipliers, corners, UV partials and normal-map
// bundle.
template <bool FULL, class Store>
CPT_HD void put_tex_aux(const Store& st, const TexLayout& T, int k, const TexAux& ta) {
    const int q = T.q_tex;
    st.put3(k, q + QT_TEX, ta.tex[0], ta.tex[1], ta.tex[2]);
    if (T.grads) {
        for (int j = 0; j < 4; ++j) {
            st.puti(k, q + QT_CIDX + j, ta.has_c ? ta.c.idx[j] : 0);
            st.put(k, q + QT_CW + j, ta.has_c ? ta.c.w[j] : 0.0f);
        }
    }
    if (FULL) {
        const int u = T.q_uvg;
        for (int c = 0; c < 3; ++c) {
            st.put(k, u + QU_DU + c, ta.has_c ? ta.c.du[c] : 0.0f);
            st.put(k, u + QU_DV + c, ta.has_c ? ta.c.dv[c] : 0.0f);
        }
        for (int j = 0; j < 6; ++j) st.put(k, u + QU_G + j, ta.uvg[j]);
    }
    if (T.nmap) {
        const int n = T.q_nm;
        st.put3(k, n + QN_RAW, ta.raw[0], ta.raw[1], ta.raw[2]);
        for (int c = 0; c < 3; ++c) {
            st.put(k, n + QN_VAL + c, ta.has_n ? ta.n.val[c] : 0.0f);
            st.put(k, n + QN_DU + c, ta.has_n ? ta.n.du[c] : 0.0f);
            st.put(k, n + QN_DV + c, ta.has_n ? ta.n.dv[c] : 0.0f);
        }
        if (T.grads) {
            for (int j = 0; j < 4; ++j) {
                st.puti(k, n + QN_CIDX + j, ta.has_n ? ta.n.idx[j] : 0);
                st.put(k, n + QN_CW + j, ta.has_n ? ta.n.w[j] : 0.0f);
            }
        }
    }
}

// Physical mode: adds the cotangent a_m of the 20 material columns (in
// pack_scene's column order) to the hit material's rows from `mat_row`. With
// DEFER (a textured scene) the diffuse columns are the effective albedo's:
// they go to `alb`, for the reverse sweep to split.
template <bool DEFER, class Sink>
CPT_HD void add_material_cols(const float* a_m, int mat_row, float* alb, Sink& acc) {
    for (int c = 0; c < 3; ++c) {
        if (DEFER) {
            alb[c] += a_m[c];
        } else {
            acc.add(mat_row + c, a_m[c]);
        }
    }
    for (int k = 3; k < 12; ++k) acc.add(mat_row + k, a_m[k]);  // specular, absorption, emission
    acc.add(mat_row + 12, a_m[14]);  // diff_avg
    acc.add(mat_row + 13, a_m[17]);  // roughness
    acc.add(mat_row + 14, a_m[13]);  // ior
    acc.add(mat_row + 15, a_m[12]);  // spec_exp
    acc.add(mat_row + 16, a_m[15]);  // spec_avg
}

// ---- one path, bounce by bounce -----------------------------------------------------

// The carries of one path between replayed bounces.
struct ReplayState {
    float ox, oy, oz, dx, dy, dz;  // the ray
    float r1x, r1y, r1z;           // throughput entering the bounce
    float pp;                      // PHYSICAL: density of the last scatter
    int b;                         // bounces stored
};

// A fresh path of sample `sample`: the eye ray, throughput 1, density 0.
CPT_HD void start_replay(const RenderParams& p, int pixel, int sample, float pxi, float pyi,
                         ReplayState& rs) {
    rs.ox = p.cam[9]; rs.oy = p.cam[10]; rs.oz = p.cam[11];
    eye_ray(p, pixel, sample, pxi, pyi, rs.dx, rs.dy, rs.dz);
    rs.r1x = 1.0f; rs.r1y = 1.0f; rs.r1z = 1.0f;
    rs.pp = 0.0f;
    rs.b = 0;
}

// What a replayed bounce did to its path.
constexpr int REPLAY_GOES_ON = 0;  // stored the bounce; the path goes on
constexpr int REPLAY_ENDED = 1;    // stored the bounce; the path died or reached max_bounces
constexpr int REPLAY_MISSED = 2;   // a miss: nothing stored, the path ended

// Bounce rs.b of the path in `rs` (sample `sample` of flat pixel `pixel`),
// replayed with the forward kernel's own device functions: the sweep, the
// shading with the partials that are linear in g * T_mid (the material,
// light and background rows, added here; in full mode the NEE position /
// normal cotangents, stored) and the scatter. A hit is checkpointed in slot
// k. The same streams and the same path termination as the forward's
// trace_bounce.
template <bool FULL, bool TEXTURED, bool PHYSICAL, bool GEO, class Store, class Sink>
CPT_HD int replay_bounce(const SceneTables& sc, const RenderParams& p, const GradLayout& L,
                         const TexLayout& T, int pixel, int sample, float gx, float gy,
                         float gz, ReplayState& rs, const Store& st, int k, Sink& acc) {
    const int pair0 = 1 + rs.b * (2 + 2 * sc.num_area_lights);
    const float ox = rs.ox, oy = rs.oy, oz = rs.oz, dx = rs.dx, dy = rs.dy, dz = rs.dz;
    const Hit h = intersect_sweep(sc, ox, oy, oz, dx, dy, dz);
    if (!(h.t < INFINITY)) {
        // miss: direct = background; nothing stored, the recurrence starts
        // from A = g * background
        acc.add(L.row_bg0 + 0, gx * rs.r1x);
        acc.add(L.row_bg0 + 1, gy * rs.r1y);
        acc.add(L.row_bg0 + 2, gz * rs.r1z);
        return REPLAY_MISSED;
    }
    const float px = ox + dx * h.t, py = oy + dy * h.t, pz = oz + dz * h.t;
    float nx = h.nx, ny = h.ny, nz = h.nz;
    const float* m = sc.materials + h.mat * M_COLS;
    const int mat_row = h.mat * L.pcols;
    // textured: the forward's texture block, with its adjoint bundle
    float mt[TEXTURED ? M_COLS : 1];
    TexAux ta;
    if constexpr (TEXTURED) {
        for (int c = 0; c < M_COLS; ++c) mt[c] = m[c];
        texture_block<true, FULL>(sc, ox, oy, oz, dx, dy, dz, h.prim, h.mat, mt, nx, ny, nz, &ta);
        m = mt;
        // the physical direct phase needs many registers: store the bundle
        // before it
        if (PHYSICAL) put_tex_aux<FULL>(st, T, k, ta);
    }
    const float cos_i = -dot3(dx, dy, dz, nx, ny, nz);
    const bool inside = cos_i <= 0.0f;

    // Beer-Lambert BEFORE the direct add
    float beer_x = 1.0f, beer_y = 1.0f, beer_z = 1.0f;
    if (inside) {
        beer_x = expf(-h.t * m[6]);
        beer_y = expf(-h.t * m[7]);
        beer_z = expf(-h.t * m[8]);
    }
    const float tmx = rs.r1x * beer_x, tmy = rs.r1y * beer_y, tmz = rs.r1z * beer_z;
    // g * T_mid: the adjoint of direct(b); every replay-phase partial is linear in it
    const float gtx = gx * tmx, gty = gy * tmy, gtz = gz * tmz;

    float dir[3];
    float nee_ap[3] = {0.0f, 0.0f, 0.0f}, nee_an[3] = {0.0f, 0.0f, 0.0f};
    float alb[3] = {0.0f, 0.0f, 0.0f};  // textured: NEE cotangent of the albedo
    Lobes lb;                            // PHYSICAL: the hit's lobes ...
    float pa_d[3] = {0.0f, 0.0f, 0.0f}, pa_t = 0.0f, pa_pp = 0.0f;  // ... and cotangents
    if constexpr (PHYSICAL) {
        // the physical direct phase and its exact adjoint
        float a_m[M_COLS] = {};
        const DirectRows R = {L.row_pl0, L.pl_stride, L.pcols, L.row_al0, L.al_stride};
        physical_direct_vjp<GEO>(sc, p.seed, pixel, sample, pair0, px, py, pz, nx, ny, nz,
                                 dx, dy, dz, h.t, rs.pp, m, h.prim, R, gtx, gty, gtz, acc,
                                 dir, nee_ap, nee_an, pa_d, pa_t, pa_pp, a_m, lb);
        add_material_cols<TEXTURED>(a_m, mat_row, alb, acc);
    } else {
        // emission always
        dir[0] = m[9]; dir[1] = m[10]; dir[2] = m[11];
        acc.add(mat_row + 9, gtx);
        acc.add(mat_row + 10, gty);
        acc.add(mat_row + 11, gtz);
        float dqp[3], dqn[3];
        if (!inside) {
            for (int i = 0; i < sc.num_point_lights; ++i) {
                const float* pl = sc.point_lights + i * PL_COLS;
                const float q = light_q<FULL>(sc, px, py, pz, nx, ny, nz, pl[0], pl[1], pl[2],
                                              dqp, dqn);
                if (q == 0.0f) continue;  // invisible or facing away: every partial is 0
                const int row = L.row_pl0 + L.pl_stride * i;
                const float aq = nee_partials<FULL, TEXTURED>(
                    m, mat_row, q, dqp, dqn, pl[3], pl[4], pl[5], row + L.pl_pow_off,
                    gtx, gty, gtz, dir, nee_ap, nee_an, alb, acc);
                if (FULL) {
                    // dq/d(light position) = -dq/dp: q depends on l - p only
                    acc.add(row + 0, -aq * dqp[0]);
                    acc.add(row + 1, -aq * dqp[1]);
                    acc.add(row + 2, -aq * dqp[2]);
                }
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
                const float q = light_q<FULL>(sc, px, py, pz, nx, ny, nz, lx, ly, lz, dqp, dqn);
                if (q == 0.0f) continue;
                const int row = L.row_al0 + (GEO ? AL_ROWS_GEO : 3) * i;
                const float aq = nee_partials<FULL, TEXTURED>(
                    m, mat_row, q, dqp, dqn, al[18], al[19], al[20], row, gtx, gty, gtz,
                    dir, nee_ap, nee_an, alb, acc);
                if (GEO) {
                    // the sample point is barycentric-linear in the picked
                    // triangle's vertices; dq/dl = -dq/dp
                    const int v0 = row + 3 + ((upick > 0.5f) ? 0 : 9);
                    const float w[3] = {w0, w1, w2};
                    for (int j = 0; j < 3; ++j) {
                        for (int c = 0; c < 3; ++c) {
                            acc.add(v0 + 3 * j + c, -aq * dqp[c] * w[j]);
                        }
                    }
                }
            }
        }
    }

    // scatter: the SAME scatter_sample the forward kernel runs
    float u_branch, u_a, u_b, unused;
    uniform_pair(p.seed, pixel, sample, pair0, u_branch, u_a);
    uniform_pair(p.seed, pixel, sample, pair0 + 1, u_b, unused);
    float nox, noy, noz, ndx, ndy, ndz, wr = 1.0f, wg = 1.0f, wb = 1.0f, ct_w;
    int code;
    const bool alive = scatter_sample(dx, dy, dz, nx, ny, nz, px, py, pz, cos_i,
                                      u_branch, u_a, u_b, m,
                                      nox, noy, noz, ndx, ndy, ndz, wr, wg, wb, code, ct_w);

    // checkpoint this bounce, four planes to a store (the Q_* order)
    st.put4(k, 0, tmx, tmy, tmz, wr);
    st.put4(k, 4, wg, wb, beer_x, beer_y);
    st.put4(k, 8, beer_z, dir[0], dir[1], dir[2]);
    st.put4(k, 12, inside ? h.t : 0.0f, int_bits(h.mat), int_bits(code), ct_w);
    if (FULL) {
        st.put4(k, 16, ox, oy, oz, dx);
        st.put4(k, 20, dy, dz, nx, ny);
        st.put4(k, 24, nz, h.t, int_bits(h.prim), nee_ap[0]);
        st.put4(k, 28, nee_ap[1], nee_ap[2], nee_an[0], nee_an[1]);
        if (PHYSICAL) {
            st.put4(k, 32, nee_an[2], pa_d[0], pa_d[1], pa_d[2]);
            st.put(k, Q_PA_T, pa_t);
            st.put(k, Q_PA_PP, pa_pp);
        } else {
            st.put(k, Q_NEE_AN + 2, nee_an[2]);
        }
    }
    if constexpr (TEXTURED) {
        st.put3(k, T.q_tex + QT_ALB, alb[0], alb[1], alb[2]);
        if (!PHYSICAL) put_tex_aux<FULL>(st, T, k, ta);
    }
    ++rs.b;
    if (!alive || rs.b >= p.max_bounces) return REPLAY_ENDED;
    if constexpr (PHYSICAL) {
        // a path that goes on carries the density of the continuation it took
        rs.pp = inside ? 0.0f : physical_prev_pdf(lb, m, dx, dy, dz, ndx, ndy, ndz, code);
    }
    rs.ox = nox; rs.oy = noy; rs.oz = noz;
    rs.dx = ndx; rs.dy = ndy; rs.dz = ndz;
    rs.r1x = tmx * wr; rs.r1y = tmy * wg; rs.r1z = tmz * wb;
    return REPLAY_GOES_ON;
}
static_assert(Q_W == 3 && Q_BEER == 6 && Q_DIRECT == 9 && Q_T_IN == 12 && Q_MAT == 13 &&
                  Q_CODE == 14 && Q_CT_W == 15 && Q_O == 16 && Q_D == 19 && Q_N == 22 &&
                  Q_T == 25 && Q_PRIM == 26 && Q_NEE_AP == 27 && Q_NEE_AN == 30 &&
                  Q_PA_D == 33 && Q_PA_T == 36 && Q_PA_PP == 37,
              "replay_bounce stores the planes four at a time in this order");

// The carries of the reverse sweep between bounces of one path.
struct ReverseState {
    float ax, ay, az;  // A_after of the bounce
    float ao[3];       // FULL: cotangent of the origin of the ray LEAVING it ...
    float ad[3];       // ... and of its direction
};

// A path's reverse sweep before its last stored bounce: A_after = g *
// background after a miss, else 0; nothing carried on the ray.
CPT_HD void start_reverse(const SceneTables& sc, float gx, float gy, float gz, bool missed,
                          ReverseState& rv) {
    rv.ax = missed ? gx * sc.background[0] : 0.0f;
    rv.ay = missed ? gy * sc.background[1] : 0.0f;
    rv.az = missed ? gz * sc.background[2] : 0.0f;
    for (int c = 0; c < 3; ++c) { rv.ao[c] = 0.0f; rv.ad[c] = 0.0f; }
}

// The adjoint recurrence through bounce b of sample `sample`, stored in slot
// k; `last` says that it is the path's last stored bounce (else bounce b + 1
// lies in slot k + 1):
//   A_mid(b) = A_after(b) * w(b) + g * direct(b);  A_in(b) = A_mid(b) * beer(b)
// and, in full mode, the carried dL/d(origin, direction) through the
// scatter step (scatter_chain) and the hit (hit_chain). Leaves A_in(b) and
// the cotangent of the bounce's INPUT ray in `rv`.
template <bool FULL, bool TEXTURED, bool PHYSICAL, bool GEO, class Store, class Sink>
CPT_HD void reverse_bounce(const SceneTables& sc, const RenderParams& p, const GradLayout& L,
                           const TexLayout& T, int pixel, int sample, int b, bool last,
                           float gx, float gy, float gz, ReverseState& rv, const Store& st,
                           int k, Sink& acc) {
    const Quad c0 = st.get4(k, 0), c1 = st.get4(k, 4), c2 = st.get4(k, 8), c3 = st.get4(k, 12);
    const float tm[3] = {c0.x, c0.y, c0.z};
    const float wx = c0.w, wy = c1.x, wz = c1.y;
    const float bx = c1.z, by = c1.w, bz = c2.x;
    const float der = c2.y, deg = c2.z, deb = c2.w;
    const float t_in = c3.x;
    const int mat = float_bits(c3.y);
    const int code = float_bits(c3.z);
    const float ct_w = c3.w;
    const int mat_row = mat * L.pcols;
    const float ax = rv.ax, ay = rv.ay, az = rv.az;

    // scatter factor: d w = A_after * T_mid, routed by the branch taken
    const float dwx = ax * tm[0], dwy = ay * tm[1], dwz = az * tm[2];
    float a_alb[3];  // textured: cotangent of the effective albedo
    if constexpr (TEXTURED) {
        // NEE's share (replay) + the diffuse branch weight's, split into the
        // material rows (x texel) and the texel rows (x the material's
        // diffuse x corner weight)
        const float df = (code == BRANCH_DIFFUSE) ? 1.0f : 0.0f;
        const int q = T.q_tex;
        a_alb[0] = st.get(k, q + QT_ALB + 0) + dwx * df;
        a_alb[1] = st.get(k, q + QT_ALB + 1) + dwy * df;
        a_alb[2] = st.get(k, q + QT_ALB + 2) + dwz * df;
        acc.add(mat_row + 0, a_alb[0] * st.get(k, q + QT_TEX + 0));
        acc.add(mat_row + 1, a_alb[1] * st.get(k, q + QT_TEX + 1));
        acc.add(mat_row + 2, a_alb[2] * st.get(k, q + QT_TEX + 2));
        if (T.grads) {
            const float* md = sc.materials + mat * M_COLS;
            const float v[3] = {a_alb[0] * md[0], a_alb[1] * md[1], a_alb[2] * md[2]};
            scatter_texels(st, k, q + QT_CIDX, q + QT_CW, v, L.row_tex0, acc);
        }
    } else if (code == BRANCH_DIFFUSE) {
        acc.add(mat_row + 0, dwx);
        acc.add(mat_row + 1, dwy);
        acc.add(mat_row + 2, dwz);
    }
    if (code == BRANCH_COOK_TORRANCE || code == BRANCH_GLOSS) {
        const float scale = (code == BRANCH_COOK_TORRANCE) ? ct_w : 1.0f;
        acc.add(mat_row + 3, dwx * scale);
        acc.add(mat_row + 4, dwy * scale);
        acc.add(mat_row + 5, dwz * scale);
    }
    float ap[3], an[3], ade[3];
    int q_normal = Q_N;      // the raw normal's planes
    bool nee_an_in = false;  // the NEE normal partials folded into an
    if (FULL) {
        float pdf_ad[3] = {0.0f, 0.0f, 0.0f}, pdf_an[3] = {0.0f, 0.0f, 0.0f};
        if constexpr (PHYSICAL) {
            // the pdf chain: bounce b's scatter set the density that bounce
            // b+1's emission MIS weighed (an inside hit sets 0)
            const float app = last ? 0.0f : st.get(k + 1, Q_PA_PP);
            float pd[3], pn[3], nd[3];
            st.get3(k, Q_D, pd[0], pd[1], pd[2]);
            st.get3(k, Q_N, pn[0], pn[1], pn[2]);
            if (app != 0.0f && -dot3(pd[0], pd[1], pd[2], pn[0], pn[1], pn[2]) > 0.0f) {
                st.get3(k + 1, Q_D, nd[0], nd[1], nd[2]);
                float a_m[M_COLS] = {}, a_nd[3] = {0.0f, 0.0f, 0.0f};
                physical_prev_pdf_vjp(pd[0], pd[1], pd[2], pn[0], pn[1], pn[2], nd[0], nd[1],
                                      nd[2], sc.materials + mat * M_COLS, code, app, pdf_ad,
                                      pdf_an, a_nd, a_m);
                // the continuation is this bounce's OUTPUT direction
                for (int c = 0; c < 3; ++c) rv.ad[c] += a_nd[c];
                add_material_cols<false>(a_m, mat_row, nullptr, acc);
            }
        }
        scatter_chain(sc, p, L, pixel, sample, b, st, k, mat, code, dwx, dwy, dwz, rv.ao, rv.ad,
                      ap, an, ade, acc);
        if constexpr (PHYSICAL) {
            // the direct phase's direction cotangent, the pdf chain's (d, n)
            for (int c = 0; c < 3; ++c) {
                ade[c] += st.get(k, Q_PA_D + c) + pdf_ad[c];
                an[c] += pdf_an[c];
            }
        }
        if constexpr (TEXTURED) {
            tex_chain<GEO>(sc, L, T, k, st, mat, a_alb, ap, an, acc);
            if (T.nmap) { q_normal = T.q_nm + QN_RAW; nee_an_in = true; }
        }
    }

    // through the multiply, then this bounce's direct add
    float amid[3];
    amid[0] = ax * wx + gx * der;
    amid[1] = ay * wy + gy * deg;
    amid[2] = az * wz + gz * deb;

    // Beer-Lambert: d absorption = A_mid * T_mid * (-t), inside hits only
    if (t_in > 0.0f) {
        acc.add(mat_row + 6, amid[0] * tm[0] * (-t_in));
        acc.add(mat_row + 7, amid[1] * tm[1] * (-t_in));
        acc.add(mat_row + 8, amid[2] * tm[2] * (-t_in));
    }
    if (FULL) {
        hit_chain<GEO, PHYSICAL>(sc, L, k, st, mat, amid, tm, t_in, ap, an, ade, rv.ao, rv.ad,
                                 acc, q_normal, nee_an_in);
    }
    rv.ax = amid[0] * bx; rv.ay = amid[1] * by; rv.az = amid[2] * bz;
}

// Full mode, after bounce 0: the eye ray's VJP into the 13 camera rows from
// `row0` (rotation 9 row-major, position 3, tan_half_fov); (ao, ad) is the
// cotangent of the eye ray. d0 = normalize(R u), u the camera-space pixel
// vector (same jitter draw); o0 = camera position.
template <class CamSink>
CPT_HD void eye_vjp(const RenderParams& p, int pixel, int sample, float pxi, float pyi,
                    const float* ao, const float* ad, int row0, CamSink& cam) {
    float sx_, sy_, sz_, vx, vy, vz, avx, avy, avz;
    eye_ray_raw(p, pixel, sample, pxi, pyi, sx_, sy_, sz_, vx, vy, vz);
    norm3_vjp(vx, vy, vz, ad[0], ad[1], ad[2], 1e-20f, avx, avy, avz);
    const int row = row0;
    cam.add(row + 0, avx * sx_); cam.add(row + 1, avx * sy_); cam.add(row + 2, avx * sz_);
    cam.add(row + 3, avy * sx_); cam.add(row + 4, avy * sy_); cam.add(row + 5, avy * sz_);
    cam.add(row + 6, avz * sx_); cam.add(row + 7, avz * sy_); cam.add(row + 8, avz * sz_);
    cam.add(row + 9, ao[0]); cam.add(row + 10, ao[1]); cam.add(row + 11, ao[2]);
    // sx_, sy_ are both proportional to tan_half; sz_ (= z_near) is not
    const float aux = p.cam[0] * avx + p.cam[3] * avy + p.cam[6] * avz;
    const float auy = p.cam[1] * avx + p.cam[4] * avy + p.cam[7] * avz;
    cam.add(row + 12, (aux * sx_ + auy * sy_) / p.cam[12]);
}

// ---- one pixel, all samples: two flat passes --------------------------------------

// Pass 1 of a round, the forward replay: starts the pixel's samples from
// `next` on, one bounce per iteration, a lane starting its next sample's eye
// ray as soon as its path ends, and pushes every stored bounce onto `st`;
// the path's last slot records its sample and how it ended (QM_SAMPLE,
// QM_END). Starts no path while fewer than max(max_bounces, 1) of the
// `capacity` slots are free. Returns the slots in use.
template <bool FULL, bool TEXTURED, bool PHYSICAL, bool GEO, class Store, class Sink>
CPT_HD int replay_round(const SceneTables& sc, const RenderParams& p, const GradLayout& L,
                        const TexLayout& T, int pixel, float pxi, float pyi, float gx, float gy,
                        float gz, const Store& st, int capacity, int& next, Sink& acc) {
    const int span = p.max_bounces > 1 ? p.max_bounces : 1;  // slots one path may take
    int top = 0;  // slots in use
    int s = 0;    // the sample of the path in rs
    ReplayState rs;
    bool fresh = true;  // the lane starts a path in this iteration
    while (true) {
        if (fresh) {
            if (next >= p.spp || capacity - top < span) break;
            s = next++;
            start_replay(p, pixel, p.sample_offset + s, pxi, pyi, rs);
        }
        const int end = replay_bounce<FULL, TEXTURED, PHYSICAL, GEO>(
            sc, p, L, T, pixel, p.sample_offset + s, gx, gy, gz, rs, st, top, acc);
        if (end != REPLAY_MISSED) ++top;
        fresh = end != REPLAY_GOES_ON;
        if (fresh && rs.b > 0) {
            st.puti(top - 1, T.q_meta + QM_SAMPLE, s);
            st.puti(top - 1, T.q_meta + QM_END, 2 * rs.b + (end == REPLAY_MISSED ? 1 : 0));
        }
    }
    return top;
}

// Pass 2 of a round, the reverse sweep: pops the `top` slots of `st`, last
// slot first: the last sample's bounces come first, from its last bounce
// down to bounce 0, after which the eye-ray VJP runs. A path's first pop
// starts its recurrence from what its last slot recorded.
template <bool FULL, bool TEXTURED, bool PHYSICAL, bool GEO, class Store, class Sink,
          class CamSink>
CPT_HD void reverse_round(const SceneTables& sc, const RenderParams& p, const GradLayout& L,
                          const TexLayout& T, int pixel, float pxi, float pyi, float gx,
                          float gy, float gz, const Store& st, int top, Sink& acc, CamSink& cam,
                          int cam_row0) {
    ReverseState rv;
    int b = -1, nb = 0, sample = 0;  // b < 0: the next pop starts a path
    while (top > 0) {
        const int k = top - 1;
        if (b < 0) {
            const int ended = st.geti(k, T.q_meta + QM_END);
            sample = p.sample_offset + st.geti(k, T.q_meta + QM_SAMPLE);
            nb = ended >> 1;
            b = nb - 1;
            start_reverse(sc, gx, gy, gz, (ended & 1) != 0, rv);
        }
        reverse_bounce<FULL, TEXTURED, PHYSICAL, GEO>(sc, p, L, T, pixel, sample, b,
                                                      b + 1 == nb, gx, gy, gz, rv, st, k, acc);
        if (FULL && b == 0) eye_vjp(p, pixel, sample, pxi, pyi, rv.ao, rv.ad, cam_row0, cam);
        --b;
        --top;
    }
}

// Adds pixel `pixel`'s share of the gradient for the per-SAMPLE cotangent
// (gx, gy, gz) of its radiance (the wrapper divides the image cotangent by
// spp: the forward returns the mean) into `acc`, and in full mode its camera
// rows into `cam` (from row `cam_row0`). `st` is the lane's checkpoint stack
// of `capacity` slots, at least max(max_bounces, 1). Same streams, same path
// termination as render_pixel_t; TEXTURED (a scene with textures) as its
// textured instantiation, PHYSICAL as the physical one, with the planes and
// rows of `T` / `L`. PHYSICAL and GEO build on the full path adjoint.
//
// The schedule is per-lane path regeneration in two flat passes, each ONE
// loop with one bounce per iteration: the forward replay (replay_round) and
// the reverse sweep (reverse_round). The two passes alternate in rounds
// until every sample is done (one round when the stack holds spp paths of
// max_bounces). A warp so runs the replay for every lane that still has
// samples in the round, and the reverse for every lane with bounces on its
// stack: no lane waits for the warp's longest path of a sample. The per-path
// arithmetic (replay_bounce, reverse_bounce, eye_vjp) is that of a loop over
// samples around a replay and a reverse sweep; only the order of the row
// additions differs.
template <bool FULL, bool TEXTURED, bool PHYSICAL = false, bool GEO = false, class Store,
          class Sink, class CamSink>
CPT_HD void backward_pixel(const SceneTables& sc, const RenderParams& p, const GradLayout& L,
                           const TexLayout& T, int pixel, float gx, float gy, float gz,
                           const Store& st, int capacity, Sink& acc, CamSink& cam,
                           int cam_row0) {
    static_assert(FULL || !(PHYSICAL || GEO), "geo and physical build on the full adjoint");
    if (pixel < 0 || pixel >= p.width * p.height) return;
    const float pxi = (float)(pixel % p.width);
    const float pyi = (float)(pixel / p.width);
    int next = 0;  // the next sample to start
    while (next < p.spp) {
        const int top = replay_round<FULL, TEXTURED, PHYSICAL, GEO>(
            sc, p, L, T, pixel, pxi, pyi, gx, gy, gz, st, capacity, next, acc);
        reverse_round<FULL, TEXTURED, PHYSICAL, GEO>(sc, p, L, T, pixel, pxi, pyi, gx, gy, gz,
                                                     st, top, acc, cam, cam_row0);
    }
}

// backward_pixel's two passes as two calls, for a stack that holds every
// path of the pixel (capacity >= max(max_bounces, 1) * spp: one round). The
// replay returns the slots in use, which the reverse sweep takes, on the same
// stack, in a later call (the kernel's split schedule: one launch each).
template <bool FULL, bool TEXTURED, bool PHYSICAL = false, bool GEO = false, class Store,
          class Sink>
CPT_HD int backward_pixel_replay(const SceneTables& sc, const RenderParams& p,
                                 const GradLayout& L, const TexLayout& T, int pixel, float gx,
                                 float gy, float gz, const Store& st, int capacity, Sink& acc) {
    if (pixel < 0 || pixel >= p.width * p.height) return 0;
    int next = 0;
    return replay_round<FULL, TEXTURED, PHYSICAL, GEO>(sc, p, L, T, pixel,
                                                       (float)(pixel % p.width),
                                                       (float)(pixel / p.width), gx, gy, gz, st,
                                                       capacity, next, acc);
}

template <bool FULL, bool TEXTURED, bool PHYSICAL = false, bool GEO = false, class Store,
          class Sink, class CamSink>
CPT_HD void backward_pixel_reverse(const SceneTables& sc, const RenderParams& p,
                                   const GradLayout& L, const TexLayout& T, int pixel, float gx,
                                   float gy, float gz, const Store& st, int top, Sink& acc,
                                   CamSink& cam, int cam_row0) {
    if (pixel < 0 || pixel >= p.width * p.height) return;
    reverse_round<FULL, TEXTURED, PHYSICAL, GEO>(sc, p, L, T, pixel, (float)(pixel % p.width),
                                                 (float)(pixel / p.width), gx, gy, gz, st, top,
                                                 acc, cam, cam_row0);
}

}  // namespace cpt
