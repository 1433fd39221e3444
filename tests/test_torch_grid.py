"""The supercell grid of the port on the CPU: ``ops/grid.py::build_grid`` and
``pack_grid`` bit-equal to the JAX package's; the kernels' grid sweeps
(csrc/megakernel.cuh compiled by the host C++ compiler, torch_port_helpers.py;
needs g++) and the plain version's, ray by ray against the linear sweeps;
images and gradients through the grid against those without it and against
the reference; the entry points that take ``accel="grid"``. The CUDA kernels
themselves run only on a GPU and are held against the plain version there by
chip_smoke.py.

The grid changes which primitives a ray tests, never which one it hits: a
ray's nearest t must be bit-equal and its primitive equal to the linear
sweep's, its occlusion answer equal. Images compare per pixel at the
criterion of tests/test_pallas_cpu.py (>= 99.5 % within rtol 1e-4 / atol
1e-5, channel means rtol 1e-3) where two implementations meet, and at the
reference's own grid tolerance (atol 2e-8, tests/test_grid.py:152) where the
same implementation sweeps two ways.
"""
import json

import numpy as np
import pytest
import torch

from cuda_path_tracer_ss_tpu.models import presets as jpresets
from cuda_path_tracer_ss_tpu.models.camera import Camera as JCamera
from cuda_path_tracer_ss_tpu.ops import grid as jgrid
from cuda_path_tracer_ss_tpu.ops.pallas import megakernel as jmk
from cuda_path_tracer_ss_tpu.render.integrator import camera_arrays as jcamera_arrays
from cuda_path_tracer_ss_tpu.render.integrator import render as jrender
from cuda_path_tracer_ss_torch.cli import main
from cuda_path_tracer_ss_torch.models import presets as tpresets
from cuda_path_tracer_ss_torch.models.camera import Camera, camera_arrays
from cuda_path_tracer_ss_torch.ops import grid as tgrid
from cuda_path_tracer_ss_torch.ops.cuda import megakernel as tmk
from cuda_path_tracer_ss_torch.ops.cuda import megakernel_vjp as tvjp
from cuda_path_tracer_ss_torch.render import inverse as tinverse
from torch_port_helpers import (assert_grads_close, assert_per_pixel_parity,
                                backward_grads_hostbuild, jax_textured_quad, port_scene,
                                port_value_and_grad, render_block_sums_hostbuild,
                                sweeps_hostbuild)

CP = camera_arrays(Camera())
JCP = jcamera_arrays(JCamera())

SCENES = {
    "cornell": (jpresets.cornell, tpresets.cornell),
    "stress": (jpresets.stress, tpresets.stress),
    "mesh_demo": (jpresets.mesh_demo, tpresets.mesh_demo),
    "stress_dense_100": (lambda: jpresets.stress_dense(100),
                         lambda: tpresets.stress_dense(100)),
    "mesh_dense_2": (lambda: jpresets.mesh_dense(2), lambda: tpresets.mesh_dense(2)),
}


def _grids(name):
    jmake, tmake = SCENES[name]
    return jgrid.build_grid(jmake()), tgrid.build_grid(tmake())


def _bit_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(
        a.view(np.uint8), b.view(np.uint8))


# ---- (a) the build ---------------------------------------------------------------

@pytest.mark.parametrize("name", list(SCENES))
def test_build_grid_is_bit_equal_to_the_reference(name):
    want, got = _grids(name)
    assert got.res == want.res
    for field in ("origin", "inv_cell", "cell_size", "sph_list", "tri_list",
                  "sph_count", "tri_count"):
        assert _bit_equal(getattr(got, field).numpy(), getattr(want, field)), field
    assert tgrid.max_steps(got) == sum(got.res) + 1
    # every primitive is binned somewhere
    scene = SCENES[name][1]()
    assert set(range(scene.num_spheres)) <= set(got.sph_list.unique().tolist())
    assert set(range(scene.num_triangles)) <= set(got.tri_list.unique().tolist())


@pytest.mark.parametrize("name", list(SCENES))
def test_pack_grid_is_bit_equal_to_the_reference(name):
    want_grid, got_grid = _grids(name)
    want = jmk.pack_grid(want_grid)
    got = tmk.pack_grid(got_grid, "cpu")
    assert got.meta == tuple(int(v) for v in want.meta)
    assert _bit_equal(got.idx.numpy(), want.idx)
    assert _bit_equal(got.scal.numpy(), want.scal)
    assert got.device == torch.device("cpu")
    if name in ("stress_dense_100", "mesh_dense_2"):
        # the wall triangles are split out as global primitives
        # (tests/test_grid.py:141,169)
        assert got.meta[8] > 0


def test_empty_scene_and_bad_grids_are_refused():
    scene = tpresets.cornell()
    packed = tmk.pack_scene(scene, "cpu")
    empty = scene.replace(sph_center=scene.sph_center[:0], sph_radius=scene.sph_radius[:0],
                          sph_mat=scene.sph_mat[:0], tri_v0=scene.tri_v0[:0],
                          tri_v1=scene.tri_v1[:0], tri_v2=scene.tri_v2[:0],
                          tri_mat=scene.tri_mat[:0])
    with pytest.raises(ValueError, match="empty scene"):
        tgrid.build_grid(empty)
    grid = tmk.pack_grid(tgrid.build_grid(scene), "cpu")
    with pytest.raises(TypeError, match="PackedGrid"):
        tmk.render_megakernel(packed, CP, 0, 4, 4, 1, 1, packed_grid=object())
    with pytest.raises(ValueError, match="meta"):
        tmk.render_megakernel(packed, CP, 0, 4, 4, 1, 1,
                              packed_grid=tmk.PackedGrid(grid.scal, grid.idx, grid.meta[:8]))


# ---- (b) the sweeps, ray by ray ----------------------------------------------------

def _rays(scene, grid, n, seed):
    """n rays: a quarter random (origins inside and outside the grid's box,
    as tests/test_grid.py makes them), a quarter aimed at triangle vertices,
    a quarter at sphere silhouettes (grazing), a quarter at supercell box
    corners and edges. max_d: the distance to the aimed point times 0.5, 1
    or 2 (random rays: a random distance)."""
    g = np.random.default_rng(seed)
    lo = grid.origin.numpy().astype(np.float64)
    hi = lo + grid.cell_size.numpy() * np.asarray(grid.res)
    span = hi - lo
    q = n // 4
    o = lo - 0.5 * span + g.random((n, 3)) * 2.0 * span
    targets = [o[:q] + g.standard_normal((q, 3))]
    if scene.num_triangles:
        corners = np.concatenate([scene.tri_v0.numpy(), scene.tri_v1.numpy(),
                                  scene.tri_v2.numpy()])
        targets.append(corners[g.integers(0, len(corners), q)])
    else:
        targets.append(o[q:2 * q] + g.standard_normal((q, 3)))
    if scene.num_spheres:
        k = g.integers(0, scene.num_spheres, q)
        c = scene.sph_center.numpy()[k].astype(np.float64)
        r = scene.sph_radius.numpy()[k].astype(np.float64)
        axis = c - o[2 * q:3 * q]
        side = np.cross(axis, g.standard_normal((q, 3)))
        side /= np.linalg.norm(side, axis=1, keepdims=True)
        targets.append(c + side * r[:, None])
    else:
        targets.append(o[2 * q:3 * q] + g.standard_normal((q, 3)))
    F = tmk.SUPERCELL_F
    box = g.integers(0, [(r + F - 1) // F + 1 for r in grid.res], (n - 3 * q, 3)) * F
    box = np.minimum(box, np.asarray(grid.res))
    cell = grid.cell_size.numpy().astype(np.float64)
    box_pts = lo + box * cell
    # half of them on a box edge: one coordinate slides along the face
    slide = g.integers(0, 3, len(box_pts))
    half = np.arange(len(box_pts)) % 2 == 1
    box_pts[half, slide[half]] = (lo + g.random((len(box_pts), 3)) * span)[half, slide[half]]
    targets.append(box_pts)
    target = np.concatenate(targets)
    d = target - o
    dist = np.linalg.norm(d, axis=1)
    d /= dist[:, None]
    max_d = dist * g.choice([0.5, 1.0, 2.0], n)
    max_d[:q] = g.random(q) * 20.0
    return o.astype(np.float32), d.astype(np.float32), max_d.astype(np.float32)


@pytest.mark.parametrize("name", list(SCENES))
def test_grid_sweeps_equal_linear_ray_by_ray(name):
    """The kernels' grid sweeps (host build) and the plain version's, on 4096
    rays per scene: every nearest t bit-equal, every primitive and every
    occlusion answer equal to the linear sweeps'."""
    scene = SCENES[name][1]()
    grid = tgrid.build_grid(scene)
    packed = tmk.pack_scene(scene, "cpu")
    pg = tmk.pack_grid(grid, "cpu")
    o, d, max_d = _rays(scene, grid, 4096, seed=len(name))
    t_lin, p_lin, occ_lin = sweeps_hostbuild(packed, o, d, max_d)
    t_grid, p_grid, occ_grid = sweeps_hostbuild(packed, o, d, max_d, pg)
    assert (p_lin >= 0).mean() > 0.2 and occ_lin.mean() > 0.05   # the rays hit things
    bad = np.nonzero((t_lin.view(np.uint32) != t_grid.view(np.uint32))
                     | (p_lin != p_grid) | (occ_lin != occ_grid))[0]
    assert bad.size == 0, (bad[:10], o[bad[:3]], d[bad[:3]])

    ray = [torch.from_numpy(np.ascontiguousarray(a[:, k])) for a in (o, d) for k in range(3)]
    md = torch.from_numpy(max_d)
    plain = [tmk._make_sweep_fns(packed, track_index=True, grid=g) for g in (None, pg)]
    hits = [fns[0](*ray) for fns in plain]
    assert torch.equal(hits[0][0], hits[1][0]) and torch.equal(hits[0][5], hits[1][5])
    occ = [fns[1](*ray, md) for fns in plain]
    assert torch.equal(occ[0], occ[1])
    # the two implementations differ by float op-order noise alone (an
    # ulp of t can flip a near tie)
    assert (hits[1][5].numpy() == p_grid).mean() > 0.999
    assert (occ[1].numpy() == occ_grid).mean() > 0.999


def test_plain_grid_tallies_the_kernel_work():
    """The plain grid sweep's tally: every live ray tests the global lists
    and gates every non-empty box; an occluded ray stops counting at its
    first occluder."""
    scene = tpresets.stress_dense(100)
    packed = tmk.pack_scene(scene, "cpu")
    pg = tmk.pack_grid(tgrid.build_grid(scene), "cpu")
    o, d, max_d = _rays(scene, tgrid.build_grid(scene), 256, seed=3)
    ray = [torch.from_numpy(np.ascontiguousarray(a[:, k])) for a in (o, d) for k in range(3)]
    live = torch.zeros(256, dtype=torch.bool)
    live[::2] = True
    stats = {}
    nearest, occlusion = tmk._make_sweep_fns(packed, grid=pg, stats=stats)
    nearest(*ray, live)
    boxes = len(tmk._grid_boxes(pg))
    n_gt = pg.meta[8]
    assert stats["grid_slab_tests"] == 128 * boxes
    assert stats["grid_triangle_tests"] >= 128 * n_gt
    assert stats["grid_sphere_tests"] > 0
    before = dict(stats)
    occlusion(*ray, torch.from_numpy(max_d), live)
    assert stats["grid_slab_tests"] - before["grid_slab_tests"] <= 128 * boxes
    assert stats["grid_triangle_tests"] > before["grid_triangle_tests"]


# ---- (c) images -------------------------------------------------------------------------

VARIANTS = {"default": {}, "physical": dict(physical=True),
            "bidir": dict(physical=True, bidir_nu=64.0)}


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("name", ["stress_dense_100", "textured"])
def test_host_build_grid_image_matches_plain(name, variant):
    """The kernel's grid instantiations (host build) against the plain grid
    render, per pixel; the plain grid image against the plain linear one at
    the reference's grid tolerance."""
    scene = (tpresets.textured() if name == "textured" else SCENES[name][1]())
    packed = tmk.pack_scene(scene, "cpu")
    pg = tmk.pack_grid(tgrid.build_grid(scene), "cpu")
    kw = VARIANTS[variant]
    w, h, spp, nb = 12, 12, 2, 4
    plain = tmk.render_block_sums_plain(packed, CP, 7, w, h, spp, nb, 0, w * h,
                                        packed_grid=pg, **kw)
    host = render_block_sums_hostbuild(packed, CP, 7, w, h, spp, nb, 0, w * h,
                                       packed_grid=pg, **kw)
    assert_per_pixel_parity(host.numpy() / spp, plain.numpy() / spp)
    linear = tmk.render_block_sums_plain(packed, CP, 7, w, h, spp, nb, 0, w * h, **kw)
    np.testing.assert_allclose(plain.numpy() / spp, linear.numpy() / spp, rtol=0, atol=2e-8)


@pytest.mark.parametrize("name", ["cornell", "mesh_demo", "mesh_dense_2"])
def test_plain_grid_image_matches_jnp_render(name):
    """The plain grid render against the reference's jnp engine per pixel."""
    jmake, tmake = SCENES[name]
    want = np.asarray(jrender(jmake(), JCP, 12, 12, 2, 3, max_bounces=3, live_cutoff=None))
    got = tmk.render_fast2(tmake(), CP, 12, 12, 2, 3, max_bounces=3, device="cpu",
                           grid=tgrid.build_grid(tmake()))
    assert_per_pixel_parity(got.numpy(), want)


def test_plain_grid_image_matches_the_pallas_grid_kernel_in_interpret_mode():
    """Against the TPU kernel's own grid sweeps, as the reference's CPU tests
    run them (interpret mode; cornell, 8x8, 1 spp, 2 bounces: ~10 s), per
    pixel."""
    jscene = jpresets.cornell()
    want = np.asarray(jmk.render_megakernel(
        jmk.pack_scene(jscene), JCP, 7, 8, 8, 1, max_bounces=2, interpret=True,
        packed_grid=jmk.pack_grid(jgrid.build_grid(jscene))))
    scene = tpresets.cornell()
    got = tmk.render_megakernel(tmk.pack_scene(scene, "cpu"), CP, 7, 8, 8, 1, max_bounces=2,
                                packed_grid=tmk.pack_grid(tgrid.build_grid(scene), "cpu"))
    assert_per_pixel_parity(got.numpy(), want)


# ---- (d) gradients ------------------------------------------------------------------

GRAD_CASES = {
    "cornell": (tpresets.cornell, ["materials.diffuse", "materials.emission", "al_power"],
                ["materials.roughness", "materials.ior"]),
    "color+normal quad": (lambda: port_scene(jax_textured_quad(nmap=True)),
                          ["materials.diffuse", "pl_power"], ["pl_pos", "textures"]),
}


@pytest.mark.parametrize("grad_mode", ["linear", "full"])
@pytest.mark.parametrize("name", list(GRAD_CASES))
def test_host_build_backward_through_the_grid(name, grad_mode):
    """K2's replay through the grid (host build) against its replay through
    the linear sweeps: rtol 1e-5, atol 1e-7 max|g| (tests/test_grid.py:
    199-204); and the plain engine's autograd with the grid against without
    it (the same hits: the same gradients)."""
    make, linear_fields, full_fields = GRAD_CASES[name]
    scene = make()
    fields = linear_fields + (full_fields if grad_mode == "full" else [])
    packed = tmk.pack_scene(scene, "cpu")
    pg = tmk.pack_grid(tgrid.build_grid(scene), "cpu")
    g_img = torch.from_numpy(np.random.default_rng(2).random((12, 12, 3), np.float32))
    full = grad_mode == "full"
    tex = packed.textured and full
    got = [backward_grads_hostbuild(packed, CP, 5, 12, 12, 2, 4, g_img, full=full,
                                    tex_grads=tex, packed_grid=g)[0] for g in (None, pg)]
    for table in ("materials", "point_lights", "area_lights", "background", "spheres") + (
            ("tex_atlas",) if tex else ()):
        a, b = getattr(got[0], table).numpy(), getattr(got[1], table).numpy()
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-7 * max(np.abs(a).max(), 1e-3),
                                   err_msg=table)
    assert np.abs(got[0].materials.numpy()).max() > 0
    lin = port_value_and_grad(scene, CP, fields, 12, 12, 2, 4, 5, "plain", grad_mode)
    grid = port_value_and_grad(scene, CP, fields, 12, 12, 2, 4, 5, "plain", grad_mode,
                               packed_grid=pg)
    assert lin[0] == grid[0]
    assert_grads_close(grid[1], lin[1], fields)


# ---- (e) entry points -------------------------------------------------------------------

@pytest.mark.parametrize("kwargs,match", [
    (dict(fields=["sph_center"]), "geometry fields"),
    (dict(fields=["tri_v0"]), "geometry fields"),
    (dict(fields=["materials.diffuse"], silhouette=True), "silhouette"),
    (dict(fields=["materials.emission"], engine="lighttrace", physical=True),
     "does not take accel='grid'"),
])
def test_invert_grid_gates_raise_value_errors(kwargs, match):
    """invert(accel='grid') refuses what would go stale or what has no grid,
    each with the reference's ValueError, before any other check."""
    fields = kwargs.pop("fields")
    kw = dict(engine="plain", accel="grid", steps=1)
    kw.update(kwargs)
    with pytest.raises(ValueError, match=match):
        tinverse.invert(tpresets.cornell(), CP, torch.zeros(8, 8, 3), fields, 8, 8, **kw)
    with pytest.raises(ValueError, match="does not take accel='grid'"):
        tinverse.make_loss(tpresets.cornell(), CP, torch.zeros(8, 8, 3), 8, 8, 1,
                           engine="bidir", accel="grid", physical=True)


def test_invert_with_the_grid_equals_linear():
    """A few Adam steps of the plain engine with the grid take the linear
    steps: the same losses, the same parameters."""
    scene = tpresets.cornell()
    target = tmk.render_megakernel_plain(tmk.pack_scene(scene, "cpu"), CP, 0, 8, 8, 1, 3)
    start = tinverse.with_field(scene, "materials.diffuse", scene.materials.diffuse + 0.1)
    runs = [tinverse.invert(start, CP, target, ["materials.diffuse", "al_power"], 8, 8,
                            spp=1, steps=3, lr=0.05, max_bounces=3, engine="plain",
                            accel=accel) for accel in ("none", "grid")]
    assert runs[0][2] == runs[1][2] and runs[0][2][-1] < runs[0][2][0]
    for k in runs[0][1]:
        assert torch.equal(runs[0][1][k], runs[1][1][k]), k


def test_cli_render_with_the_grid_equals_linear(tmp_path, capsys):
    outs = []
    for accel in ("none", "grid"):
        out = str(tmp_path / f"{accel}.npy")
        main(["render", "--device", "cpu", "--scene", "stress", "--width", "10", "--height",
              "8", "--spp", "2", "--bounces", "3", "--accel", accel, "--out", out])
        outs.append(np.load(out))
    np.testing.assert_array_equal(outs[0], outs[1])
    main(["benchmark", "--device", "cpu", "--scene", "cornell", "--width", "6", "--height",
          "6", "--spp", "1", "--bounces", "2", "--accel", "grid", "--repeats", "1"])
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got["accel"] == "grid" and got["engine"] == "plain"
