"""The eager engine's grid walk (``cuda_path_tracer_ss_torch/ops/grid.py``:
``nearest_hit_grid`` / ``any_hit_grid``, the Amanatides-Woo DDA) on the CPU,
the counterpart of ``tests/test_grid.py``: on the presets, against the
port's linear sweeps and against the JAX package's DDA in both of its
``differentiable`` settings on the same rays (made from a seed with numpy); a
render through the grid is the linear render bit for bit, and its gradient
too. The port's march has one setting (its gradient never passes through the
march), so ``differentiable`` parametrizes the reference only.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cuda_path_tracer_ss_tpu.models import presets as jpresets
from cuda_path_tracer_ss_tpu.ops import grid as jgrid
from cuda_path_tracer_ss_tpu.ops.vec import Vec3 as JVec3
from cuda_path_tracer_ss_torch.models import presets as tpresets
from cuda_path_tracer_ss_torch.models.camera import Camera, camera_arrays
from cuda_path_tracer_ss_torch.ops import grid as tgrid
from cuda_path_tracer_ss_torch.ops import intersect as tint
from cuda_path_tracer_ss_torch.ops.vec import Vec3
from cuda_path_tracer_ss_torch.render import integrator
from torch_port_helpers import port_scene

CP = camera_arrays(Camera())
N = 4096


def _random_rays(grid, n, seed):
    """Origins inside AND outside the grid's box, unit directions (as
    tests/test_grid.py::_random_rays draws them)."""
    r = np.random.RandomState(seed)
    lo = grid.origin.numpy()
    hi = lo + grid.cell_size.numpy() * np.asarray(grid.res)
    span = hi - lo
    o = (lo - 0.5 * span + r.rand(n, 3) * 2.0 * span).astype(np.float32)
    d = r.randn(n, 3)
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return o, d


def _tv(a):
    return Vec3(*(torch.from_numpy(np.ascontiguousarray(a[:, k])) for k in range(3)))


def _jv(a):
    return JVec3(*(jnp.asarray(a[:, k]) for k in range(3)))


@pytest.fixture(scope="module", params=["cornell", "stress", "mesh"])
def case(request):
    js = jpresets.get_scene(request.param)
    ts = port_scene(js)
    grid = tgrid.build_grid(ts)
    o, d = _random_rays(grid, N, seed=1)
    return request.param, js, ts, grid, o, d


@pytest.mark.parametrize("differentiable", [True, False])
def test_nearest_hit_grid(case, differentiable):
    """Hits and primitives equal to the linear sweep's and to JAX's DDA on
    every ray; t bit-equal to the linear sweep's (the same operations) and
    within rtol 1e-5 / atol 1e-6 of JAX's (XLA contracts the discriminant
    b*b - 4c into an FMA, which moves a grazing sphere hit by a few ulp:
    test_torch_eager_ops.py's tolerance)."""
    name, js, ts, grid, o, d = case
    lin = tint.nearest_hit(_tv(o), _tv(d), ts)
    got = tgrid.nearest_hit_grid(_tv(o), _tv(d), ts, grid)
    assert torch.equal(got.hit, lin.hit) and torch.equal(got.prim, lin.prim)
    assert torch.equal(got.t[got.hit], lin.t[lin.hit])
    ref = jgrid.nearest_hit_grid(_jv(o), _jv(d), js, jgrid.build_grid(js),
                                 differentiable=differentiable)
    assert np.array_equal(got.hit.numpy(), np.asarray(ref.hit))
    assert np.array_equal(got.prim.numpy(), np.asarray(ref.prim))
    h = got.hit.numpy()
    np.testing.assert_allclose(got.t.numpy()[h], np.asarray(ref.t)[h], rtol=1e-5, atol=1e-6)
    assert h.mean() > 0.2


@pytest.mark.parametrize("differentiable", [True, False])
def test_any_hit_grid(case, differentiable):
    name, js, ts, grid, o, d = case
    jg = jgrid.build_grid(js)
    for max_d in (0.5, 3.0, 50.0):
        lin = tint.any_hit(_tv(o), _tv(d), max_d, ts)
        got = tgrid.any_hit_grid(_tv(o), _tv(d), max_d, ts, grid)
        assert torch.equal(got, lin)
        ref = jgrid.any_hit_grid(_jv(o), _jv(d), max_d, js, jg,
                                 differentiable=differentiable)
        assert np.array_equal(got.numpy(), np.asarray(ref))


def test_grid_matches_jax_build():
    """The grid the DDA walks is the reference's (also held in
    test_torch_grid.py); its step bound the Manhattan diagonal."""
    for name in ("cornell", "stress", "mesh"):
        js = jpresets.get_scene(name)
        got, want = tgrid.build_grid(port_scene(js)), jgrid.build_grid(js)
        assert got.res == want.res and tgrid.max_steps(got) == jgrid.max_steps(want)
        assert np.array_equal(got.tri_list.numpy(), np.asarray(want.tri_list))


@pytest.mark.parametrize("name,physical", [("cornell", False), ("stress", False),
                                           ("cornell", True)])
def test_render_through_the_grid_is_the_linear_render(name, physical):
    """The grid is invisible: the same image bit for bit, through both
    loops (the scan and the live cutoff's)."""
    scene = tpresets.get_scene(name)
    grid = tgrid.build_grid(scene)
    for cutoff in (None, 0):
        kw = dict(max_bounces=4, live_cutoff=cutoff, physical=physical, device="cpu")
        base = integrator.render(scene, CP, 12, 12, 2, 3, **kw)
        fast = integrator.render(scene, CP, 12, 12, 2, 3, grid=grid, **kw)
        assert torch.equal(base, fast)


def test_gradient_through_the_grid_is_the_linear_one():
    """Autograd through the grid walk gives the linear sweep's gradient (the
    winner's t is evaluated again with a graph in both)."""
    scene = tpresets.get_scene("glass")
    grid = tgrid.build_grid(scene)
    grads = []
    for g in (None, grid):
        diffuse = scene.materials.diffuse.clone().requires_grad_(True)
        centre = scene.sph_center.clone().requires_grad_(True)
        s = scene.replace(sph_center=centre,
                          materials=scene.materials.__class__(**{
                              **scene.materials.__dict__, "diffuse": diffuse}))
        img = integrator.render(s, CP, 10, 10, 2, 5, max_bounces=3, live_cutoff=None,
                                grid=g, device="cpu")
        grads.append(torch.autograd.grad(img.square().mean(), [diffuse, centre]))
    for a, b in zip(*grads):
        assert torch.equal(a, b)
    assert float(grads[0][1].abs().max()) > 0
