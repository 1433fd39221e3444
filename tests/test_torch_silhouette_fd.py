"""The JAX package's slow silhouette tests (tests/test_silhouette.py), ported:
interior + boundary gradients of ``render/silhouette.py`` against central
finite differences of the same estimator, the boundary term's vanishing and
counterfactual cases, the engine comparison, the camera term, the mirror
inversion demo and the detector — at the reference's sizes (32x32, 96 spp)
and with its tolerances, which reflect the FD noise floor.

Each test runs on the CPU (the eager engine in the place of the reference's
jnp engine) and on a card (``engine="cuda"``: K1 + K2 for the interior
gradient and K1 for the FD loss; the boundary terms on the eager engine
there); the ``cuda`` cases skip without one. All are ``slow``, as the
reference's are. This file imports no JAX.
"""
import numpy as np
import pytest
import torch

from cuda_path_tracer_ss_torch.models import scene as tscene_mod
from cuda_path_tracer_ss_torch.models.camera import Camera, camera_arrays
from cuda_path_tracer_ss_torch.render import integrator
from cuda_path_tracer_ss_torch.render import inverse
from cuda_path_tracer_ss_torch.render import silhouette
from torch_port_helpers import silhouette_scene

W = H = 32
SPP = 96
BOUNCES = 2
SEED = 3
CP = camera_arrays(Camera())
DEVICES = ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)]
ENGINE = {"cpu": "eager", "cuda": "cuda"}

pytestmark = pytest.mark.slow


def _device(device):
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return device


def _scene(name):
    return silhouette_scene(name, tscene_mod)


def _setup(scene, fields, device, w=W, h=H, **kw):
    target = torch.zeros((h, w, 3))
    args = dict(max_bounces=BOUNCES, n_sphere=512, n_edge=128, boundary_spp=4)
    args.update(kw)
    vg = silhouette.make_grad_with_boundary(scene, CP, target, fields, w, h, SPP,
                                            engine=ENGINE[device], device=device, **args)
    loss = inverse.make_loss(scene, CP, target, w, h, SPP, max_bounces=args["max_bounces"],
                             physical=args.get("physical", False), engine=ENGINE[device],
                             device=device, field_names=fields)
    return vg, loss, inverse.extract_params(scene, fields)


def _fd(loss, params, name, idx, eps):
    p1 = {k: v.clone() for k, v in params.items()}
    p2 = {k: v.clone() for k, v in params.items()}
    p1[name][idx] += eps
    p2[name][idx] -= eps
    with torch.no_grad():
        return (float(loss(p1, SEED)) - float(loss(p2, SEED))) / (2 * eps)


def _g(g, name):
    return g[name].detach().cpu().numpy()


@pytest.mark.parametrize("device", DEVICES)
def test_sphere_silhouette_grad_matches_fd(device):
    """Coverage of an emissive sphere: interior AD is ~0, the radius and
    depth gradients are pure boundary terms and match FD."""
    fields = ("sph_radius", "sph_center")
    vg, loss, params = _setup(_scene("emissive_sphere"), fields, _device(device))
    _, g = vg(params, SEED)
    g_r = float(_g(g, "sph_radius")[0])
    g_c = _g(g, "sph_center").reshape(3)
    fd_r = _fd(loss, params, "sph_radius", 0, 0.03)
    assert g_r > 0.5
    np.testing.assert_allclose(g_r, fd_r, rtol=0.12)
    fd_cz = _fd(loss, params, "sph_center", (0, 2), 0.04)
    np.testing.assert_allclose(g_c[2], fd_cz, rtol=0.15, atol=0.05 * abs(g_r))
    assert abs(g_c[0]) < 0.05 * abs(g_r)


@pytest.mark.parametrize("device", DEVICES)
def test_triangle_edge_grad_matches_fd(device):
    """A single emissive triangle against black: every vertex gradient is
    an edge term."""
    fields = ("tri_v0", "tri_v1")
    vg, loss, params = _setup(_scene("triangle"), fields, _device(device))
    _, g = vg(params, SEED)
    g0, g1 = _g(g, "tri_v0").reshape(3), _g(g, "tri_v1").reshape(3)
    assert np.abs(g0).max() > 1e-3 and np.abs(g1).max() > 1e-3
    for name, grad in (("tri_v0", g0), ("tri_v1", g1)):
        for axis in (0, 1):
            fd = _fd(loss, params, name, (0, axis), 0.04)
            np.testing.assert_allclose(
                grad[axis], fd, rtol=0.2,
                atol=0.06 * max(np.abs(g0).max(), np.abs(g1).max()),
                err_msg=f"{name}[{axis}]")


@pytest.mark.parametrize("device", DEVICES)
def test_boundary_vanishes_for_materials_and_occluded_curves(device):
    """Exact zeros for non-geometry fields; an occluded silhouette
    contributes ~nothing (the paired rays hit the same occluder)."""
    dev = _device(device)
    fields = ("materials.emission", "sph_radius")
    target = torch.zeros((H, W, 3), device=dev)

    def bnd(scene):
        params = inverse.extract_params(scene, fields)
        img = integrator.render(scene, CP, W, H, SPP, SEED, max_bounces=BOUNCES,
                                live_cutoff=None, device=dev)
        return silhouette.boundary_grad(scene, params, CP, silhouette.mse_adjoint(img, target),
                                        W, H, SEED, n_sphere=128, spp=2, max_bounces=BOUNCES)

    g = bnd(_scene("emissive_sphere"))
    assert float(g["materials.emission"].abs().max()) == 0.0
    base_r = float(g["sph_radius"][0])
    assert base_r > 0.1
    b = tscene_mod.SceneBuilder()
    m = b.add_material(tscene_mod.MaterialSpec(emission=(3.0, 3.0, 3.0)))
    b.add_sphere((0.0, 0.0, -4.0), 1.2, m)
    n = (0.0, 0.0, 1.0)
    b.add_triangle((-9.0, -9.0, -2.0), (9.0, -9.0, -2.0), (0.0, 12.0, -2.0), n, n, n, m)
    b.background = np.zeros(3, np.float32)
    g_o = bnd(b.build())
    assert abs(float(g_o["sph_radius"][0])) < 0.02 * base_r


@pytest.mark.parametrize("device", DEVICES)
def test_boundary_with_kernel_interior_engine(device):
    """The interior gradient by the kernels' route (the plain engine on the
    CPU, K1 + K2 on a card) with the boundary terms against the all-eager
    combination: the same streams and estimator, two differentiation
    routes (the reference's test_boundary_with_pallas_interior_engine)."""
    dev = _device(device)
    scene = _scene("emissive_sphere")
    target = torch.zeros((H, W, 3))
    fields = ("sph_radius", "sph_center")
    params = inverse.extract_params(scene, fields)
    kw = dict(max_bounces=BOUNCES, n_sphere=256, boundary_spp=4, device=dev)
    v1, g1 = silhouette.make_grad_with_boundary(scene, CP, target, fields, W, H, SPP,
                                                engine="eager", **kw)(params, SEED)
    v2, g2 = silhouette.make_grad_with_boundary(
        scene, CP, target, fields, W, H, SPP,
        engine="plain" if dev == "cpu" else "cuda", **kw)(params, SEED)
    np.testing.assert_allclose(float(v2), float(v1), rtol=1e-5)
    for k in fields:
        a, b = _g(g1, k), _g(g2, k)
        np.testing.assert_allclose(b, a, atol=2e-3 * (np.abs(a).max() + 1e-9), rtol=1e-2,
                                   err_msg=k)


@pytest.mark.parametrize("device", DEVICES)
@pytest.mark.parametrize("physical", [True, False])
def test_shadow_silhouette_grad_matches_fd(physical, device):
    """A loss dominated by a cast shadow's position: the shadow boundary
    term closes the gap to FD for both estimators (FD at 256 spp: the
    gradient of the common-random-numbers loss has a 1/spp component the
    boundary theory does not target)."""
    dev = _device(device)
    scene = _scene("shadow")
    fields = ("sph_center", "sph_radius")
    vg, _, params = _setup(scene, fields, dev, n_sphere=256, n_phi=128, physical=physical)
    loss = inverse.make_loss(scene, CP, torch.zeros((H, W, 3)), W, H, 256, max_bounces=2,
                             physical=physical, engine=ENGINE[dev], device=dev,
                             field_names=fields)
    _, g = vg(params, SEED)
    g_c = _g(g, "sph_center").reshape(3)
    g_r = float(_g(g, "sph_radius")[0])
    fd_x = _fd(loss, params, "sph_center", (0, 0), 0.05)
    fd_r = _fd(loss, params, "sph_radius", 0, 0.04)
    assert abs(fd_r) > 1e-4, fd_r
    rtol = 0.2 if physical else 0.3
    np.testing.assert_allclose(g_r, fd_r, rtol=rtol, atol=0.1 * abs(fd_r))
    np.testing.assert_allclose(g_c[0], fd_x, rtol=0.3, atol=0.15 * abs(fd_r))


@pytest.mark.parametrize("device", DEVICES)
def test_shadow_boundary_interior_only_gap(device):
    """Without the shadow term (shadow=False) the gradient misses FD."""
    dev = _device(device)
    scene = _scene("shadow")
    fields = ("sph_radius",)
    loss = inverse.make_loss(scene, CP, torch.zeros((H, W, 3)), W, H, SPP, max_bounces=2,
                             physical=True, engine=ENGINE[dev], device=dev, field_names=fields)
    params = inverse.extract_params(scene, fields)
    fd_r = _fd(loss, params, "sph_radius", 0, 0.04)
    vg_no, _, _ = _setup(scene, fields, dev, n_sphere=256, physical=True, shadow=False)
    _, g_no = vg_no(params, SEED)
    g_no_r = float(_g(g_no, "sph_radius")[0])
    assert abs(g_no_r - fd_r) > 0.5 * abs(fd_r), (g_no_r, fd_r)


@pytest.mark.parametrize("device", DEVICES)
def test_camera_boundary_grad_matches_fd(device):
    """The boundary term with respect to the camera: dollying the camera
    changes an emissive sphere's coverage through silhouette motion alone;
    boundary_grad(with_camera=True) plus the interior term match FD."""
    dev = _device(device)
    scene = _scene("emissive_sphere")
    target = torch.zeros((H, W, 3), device=dev)
    params = inverse.extract_params(scene, ("sph_radius",))
    cam = integrator.camera_tensors(CP, dev)

    def loss_cam(c):
        img = integrator.render(scene, c, W, H, SPP, SEED, max_bounces=BOUNCES,
                                live_cutoff=None, device=dev)
        return torch.mean((img - target) ** 2)

    leaves = tuple(c.clone().requires_grad_(True) for c in cam)
    interior = torch.autograd.grad(loss_cam(leaves), leaves)
    with torch.no_grad():
        img = integrator.render(scene, CP, W, H, SPP, SEED, max_bounces=BOUNCES,
                                live_cutoff=None, device=dev)
    _, bnd_cam = silhouette.boundary_grad(scene, params, CP,
                                          silhouette.mse_adjoint(img, target), W, H, SEED,
                                          n_sphere=512, spp=4, max_bounces=BOUNCES,
                                          with_camera=True)
    g_pos = (interior[1] + bnd_cam[1]).cpu().numpy()
    eps = 0.03
    with torch.no_grad():
        plus = (cam[0], cam[1] + torch.tensor([0.0, 0.0, eps], device=dev), cam[2], cam[3])
        minus = (cam[0], cam[1] - torch.tensor([0.0, 0.0, eps], device=dev), cam[2], cam[3])
        fd_z = (float(loss_cam(plus)) - float(loss_cam(minus))) / (2 * eps)
    assert abs(fd_z) > 0.01
    np.testing.assert_allclose(g_pos[2], fd_z, rtol=0.15)
    assert abs(g_pos[0]) < 0.1 * abs(fd_z)


@pytest.mark.parametrize("device", DEVICES)
def test_triangle_blocker_shadow_grad_matches_fd(device):
    """Triangle blockers' cast-shadow boundary: moving the floating
    triangle's vertex sweeps its shadow; the projected-edge term closes to
    FD."""
    dev = _device(device)
    scene = _scene("tri_blocker")
    fields = ("tri_v0",)
    vg, _, params = _setup(scene, fields, dev, n_sphere=64, n_edge=64, n_phi=128,
                           physical=True)
    loss = inverse.make_loss(scene, CP, torch.zeros((H, W, 3)), W, H, 256, max_bounces=2,
                             physical=True, engine=ENGINE[dev], device=dev, field_names=fields)
    _, g = vg(params, SEED)
    g_v = _g(g, "tri_v0")
    fd_x = _fd(loss, params, "tri_v0", (2, 0), 0.08)
    fd_z = _fd(loss, params, "tri_v0", (2, 2), 0.08)
    fd_big = max(abs(fd_x), abs(fd_z))
    assert fd_big > 2e-5, (fd_x, fd_z)
    np.testing.assert_allclose(g_v[2, 0], fd_x, rtol=0.3, atol=0.25 * fd_big)
    np.testing.assert_allclose(g_v[2, 2], fd_z, rtol=0.3, atol=0.25 * fd_big)


@pytest.mark.parametrize("device", DEVICES)
def test_glossy_receiver_shadow_grad_matches_fd(device):
    """The shadow jump integrand carries the receiver's glossy lobe: the
    loss lives in a glossy wall's shadowed highlight."""
    dev = _device(device)
    scene = _scene("glossy_shadow")
    fields = ("sph_radius",)
    vg, _, params = _setup(scene, fields, dev, n_sphere=256, n_phi=128, physical=True)
    loss = inverse.make_loss(scene, CP, torch.zeros((H, W, 3)), W, H, 256, max_bounces=2,
                             physical=True, engine=ENGINE[dev], device=dev, field_names=fields)
    _, g = vg(params, SEED)
    g_r = float(_g(g, "sph_radius")[0])
    fd_r = _fd(loss, params, "sph_radius", 0, 0.04)
    assert abs(fd_r) > 1e-4, fd_r
    np.testing.assert_allclose(g_r, fd_r, rtol=0.3, atol=0.15 * abs(fd_r))


@pytest.mark.parametrize("device", DEVICES)
def test_sphere_wall_intersection_grad_matches_fd(device):
    """The crease where the sphere pokes through the wall is the only
    visible discontinuity; FD agreement isolates the intersection family,
    and without it the radius gradient collapses."""
    dev = _device(device)
    scene = _scene("buried_sphere")
    fields = ("sph_radius", "sph_center")
    vg, loss, params = _setup(scene, fields, dev)
    _, g = vg(params, SEED)
    g_r = float(_g(g, "sph_radius")[0])
    g_c = _g(g, "sph_center").reshape(3)
    fd_r = _fd(loss, params, "sph_radius", 0, 0.03)
    assert g_r > 0.1
    np.testing.assert_allclose(g_r, fd_r, rtol=0.15)
    fd_cz = _fd(loss, params, "sph_center", (0, 2), 0.04)
    np.testing.assert_allclose(g_c[2], fd_cz, rtol=0.2, atol=0.05 * abs(g_r))
    assert abs(g_c[0]) < 0.07 * abs(g_r)
    vg_off, _, _ = _setup(scene, fields, dev, isect=False)
    _, g_off = vg_off(params, SEED)
    assert abs(float(_g(g_off, "sph_radius")[0])) < 0.3 * abs(fd_r)


@pytest.mark.parametrize("device", DEVICES)
def test_mirror_reflected_silhouette_grad_matches_fd(device):
    """One-specular-bounce visibility: the sphere is seen only in the
    mirror; FD agreement isolates the reflected-silhouette family, and
    without it nothing sees the sphere."""
    dev = _device(device)
    scene = _scene("mirror_sphere")
    assert silhouette.mirror_triangles(scene) == (0, 1)
    fields = ("sph_radius", "sph_center")
    vg, loss, params = _setup(scene, fields, dev, max_bounces=3, n_mirror=256)
    _, g = vg(params, SEED)
    g_r = float(_g(g, "sph_radius")[0])
    g_c = _g(g, "sph_center").reshape(3)
    fd_r = _fd(loss, params, "sph_radius", 0, 0.05)
    assert g_r > 0.02
    np.testing.assert_allclose(g_r, fd_r, rtol=0.2)
    fd_cx = _fd(loss, params, "sph_center", (0, 0), 0.06)
    np.testing.assert_allclose(g_c[0], fd_cx, rtol=0.25, atol=0.06 * abs(g_r))
    vg_off, _, _ = _setup(scene, fields, dev, max_bounces=3, mirrors=False)
    _, g_off = vg_off(params, SEED)
    assert abs(float(_g(g_off, "sph_radius")[0])) < 0.25 * abs(fd_r)


@pytest.mark.parametrize("device", DEVICES)
def test_mirror_reflected_edge_grad_matches_fd(device):
    """Triangle edges seen in a mirror: the off-frustum triangle's only
    image is its reflection."""
    dev = _device(device)
    scene = _scene("mirror_edge")
    assert silhouette.mirror_triangles(scene) == (0, 1)
    fields = ("tri_v0", "tri_v2")
    vg, loss, params = _setup(scene, fields, dev, max_bounces=3, n_mirror=256)
    _, g = vg(params, SEED)
    g0, g2 = _g(g, "tri_v0")[2], _g(g, "tri_v2")[2]
    assert np.abs(g0).max() > 1e-3 and np.abs(g2).max() > 1e-3
    scale = max(np.abs(g0).max(), np.abs(g2).max())
    for name, grad, axes in (("tri_v0", g0, (1, 2)), ("tri_v2", g2, (1,))):
        for axis in axes:
            fd = _fd(loss, params, name, (2, axis), 0.06)
            np.testing.assert_allclose(grad[axis], fd, rtol=0.3, atol=0.1 * scale,
                                       err_msg=f"{name}[{axis}]")
    vg_off, _, _ = _setup(scene, fields, dev, max_bounces=3, mirrors=False)
    _, g_off = vg_off(params, SEED)
    assert np.abs(_g(g_off, "tri_v0")[2]).max() < 0.25 * scale


@pytest.mark.parametrize("device", DEVICES)
def test_invert_sphere_center_through_mirror(device):
    """Gradient descent on sph_center driven by the reflected-silhouette
    term alone recovers the true position."""
    dev = _device(device)
    scene_true = _scene("mirror_sphere")
    bounces = 3
    with torch.no_grad():
        target = integrator.render(scene_true, CP, W, H, SPP, SEED, max_bounces=bounces,
                                   live_cutoff=None, device=dev)
    if dev == "cuda":   # the kernels' engine trains toward K1's own render
        from cuda_path_tracer_ss_torch.ops.cuda.megakernel import pack_scene, render_megakernel
        target = render_megakernel(pack_scene(scene_true, dev), CP, SEED, W, H, SPP, bounces)
    params0 = inverse.extract_params(scene_true, ("sph_center",))
    shifted = params0["sph_center"].clone()
    shifted[0, 0] += 0.45
    scene0 = inverse.merge_params(scene_true, {"sph_center": shifted})
    _, params, losses = inverse.invert(scene0, CP, target, ("sph_center",), W, H, spp=SPP,
                                       steps=25, lr=0.05, seed=SEED, max_bounces=bounces,
                                       silhouette=True, engine=ENGINE[dev], device=dev)
    err = float((params["sph_center"] - params0["sph_center"]).abs().max())
    assert losses[-1] < 0.25 * losses[0]
    assert err < 0.12


@pytest.mark.parametrize("device", DEVICES)
@pytest.mark.parametrize("physical", [True, False])
def test_shadow_in_mirror_grad_matches_fd(physical, device):
    """A cast shadow visible only in a mirror: the shadow term's mirror
    chain gives usable blocker gradients (sign and the captured fraction of
    FD, as the reference asserts at 64x64); without it nothing sees the
    blocker."""
    dev = _device(device)
    scene = _scene("mirror_shadow")
    fields = ("sph_center", "sph_radius")
    ww = hh = 64
    bounces = 3
    vg, _, params = _setup(scene, fields, dev, w=ww, h=hh, max_bounces=bounces,
                           n_sphere=128, n_phi=128, physical=physical)
    loss = inverse.make_loss(scene, CP, torch.zeros((hh, ww, 3)), ww, hh, 256,
                             max_bounces=bounces, physical=physical, engine=ENGINE[dev],
                             device=dev, field_names=fields)
    _, g = vg(params, SEED)
    g_c = _g(g, "sph_center").reshape(3)
    g_r = float(_g(g, "sph_radius")[0])
    fd_r = _fd(loss, params, "sph_radius", 0, 0.08)
    assert fd_r < 0 and g_r < 0
    assert 0.45 * abs(fd_r) < abs(g_r) < 1.15 * abs(fd_r), (g_r, fd_r)
    fd_cx = _fd(loss, params, "sph_center", (0, 0), 0.1)
    assert np.sign(g_c[0]) == np.sign(fd_cx)
    assert 0.35 * abs(fd_cx) < abs(g_c[0]) < 1.3 * abs(fd_cx), (g_c[0], fd_cx)
    vg_off, _, _ = _setup(scene, fields, dev, w=ww, h=hh, max_bounces=bounces, n_sphere=128,
                          physical=physical, shadow=False)
    _, g_off = vg_off(params, SEED)
    assert abs(float(_g(g_off, "sph_radius")[0])) < 0.2 * abs(g_r)


@pytest.mark.parametrize("device", DEVICES)
def test_unsampled_reflection_detector_warns(device):
    """A curved mirror showing the optimized sphere warns; a scene without
    one does not."""
    import warnings

    dev = _device(device)
    target = torch.zeros((24, 24, 3))
    for name, warns in (("curved_mirror", True), ("no_mirror", False)):
        scene = _scene(name)
        vg = silhouette.make_grad_with_boundary(scene, CP, target, ["sph_center"], 24, 24,
                                                spp=2, max_bounces=3, engine=ENGINE[dev],
                                                device=dev)
        params = inverse.extract_params(scene, ["sph_center"])
        if warns:
            with pytest.warns(UserWarning, match="UNSAMPLED"):
                vg(params, 0)
        else:
            with warnings.catch_warnings():
                warnings.simplefilter("error", UserWarning)
                vg(params, 0)
