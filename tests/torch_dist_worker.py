"""Rank bodies of the port's multi-process tests. Spawned ranks import this
module and nothing of the JAX package (the test modules import JAX; a rank
never imports them). Each body runs every scenario of its test file in a
world started once by ``parallel.mesh.spawn_world`` and writes the results
into ``out``: arrays as ``<name>.npy`` (rank 0's, and ``<name>.r<k>.npy``
for each rank where the ranks' agreement is checked), and the errors that
scenarios expect as ``errors.r<k>.json``."""
import contextlib
import dataclasses
import io
import json
import os

import numpy as np
import torch

from cuda_path_tracer_ss_torch.models import presets
from cuda_path_tracer_ss_torch.models.camera import Camera, camera_arrays
from cuda_path_tracer_ss_torch.ops.cuda import lightkernel as lk
from cuda_path_tracer_ss_torch.ops.cuda import megakernel as mk
from cuda_path_tracer_ss_torch.ops.cuda import megakernel_vjp as vjp
from cuda_path_tracer_ss_torch.parallel import mesh as pm
from cuda_path_tracer_ss_torch.parallel import sharding
from cuda_path_tracer_ss_torch.render import bidir, inverse

# the sizes of tests/test_sharding.py
W = H = 16
SPP = 4
BOUNCES = 3
LIGHT_PATHS = 4096
# tests/test_sharding.py::test_fused_bidir_sharded_matches_single_device
FUSED = dict(width=16, height=16, spp=2, n_paths=1024, max_bounces=3, seed=5)
# K1 / K2 sharded: an indivisible image and the reference's
K_SIZES = ((9, 9), (16, 16))
K2_MODES = ("linear", "full", "geo", "physical")
REG = 0.5       # weight of the regulariser on materials.diffuse


def cam():
    return camera_arrays(Camera())


def _save(out, name, rank, x, every_rank=False):
    x = x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    if every_rank:
        np.save(os.path.join(out, f"{name}.r{rank}.npy"), x)
    if rank == 0:
        np.save(os.path.join(out, f"{name}.npy"), x)


def _expect_error(errors, name, fn):
    """Record the error a scenario must raise (the parent asserts it)."""
    try:
        fn()
    except Exception as e:  # recorded, and held by the test
        errors[name] = [type(e).__name__, str(e)]
    else:
        errors[name] = [None, ""]


def toy_loss(p, rank, n_ranks, mesh, reg, skip_rank=None):
    """A toy 'render' over a pixel mesh: rank r's tile of 3 pixels is
    ``p * w_r`` (``w_r`` the tile of ``arange``), written into a zero image
    and summed by ``psum``; the loss adds ``reg * sum(p^2)`` outside the
    render. ``skip_rank``'s tile does not depend on ``p``."""
    q, = pm.replicate([p], mesh)
    w = torch.arange(3 * n_ranks, dtype=torch.float32).reshape(n_ranks, 3, 1) + 1.0
    tile = w[rank] * (torch.ones_like(q) if rank == skip_rank else q)
    img = torch.zeros((n_ranks, 3, p.shape[0]))
    img = torch.cat([img[:rank], tile[None], img[rank + 1:]])
    img = pm.psum(img, mesh, pm.PIXEL_AXIS, keep=[q])
    return (img ** 2).sum() + reg * (p ** 2).sum(), img


def mesh_scenarios(rank, out):
    torch.set_num_threads(1)
    errors = {}
    m = pm.make_mesh(4, device_type="cpu")
    m_all = pm.make_mesh(device_type="cpu")
    m_s = pm.make_mesh(4, axis=pm.SAMPLE_AXIS, device_type="cpu")
    m2 = pm.make_mesh_2d(2, 2, device_type="cpu")
    info = dict(
        shape=list(m.shape), names=list(m.mesh_dim_names),
        default_shape=list(m_all.shape), sample_names=list(m_s.mesh_dim_names),
        index=pm.axis_index(m, pm.PIXEL_AXIS),
        shape_2d=list(m2.shape), names_2d=list(m2.mesh_dim_names),
        pixel_2d=pm.axis_index(m2, pm.PIXEL_AXIS),
        sample_2d=pm.axis_index(m2, pm.SAMPLE_AXIS),
        size_pixels_2d=pm.axis_size(m2, pm.PIXEL_AXIS, "test"),
        size_samples_2d=pm.axis_size(m2, pm.SAMPLE_AXIS, "test"),
        device=str(pm.rank_device("cpu")))
    with open(os.path.join(out, f"mesh.r{rank}.json"), "w") as f:
        json.dump(info, f)

    x = torch.full((2,), float(rank + 1))
    for name, mesh, axis in (("psum_1d", m, pm.PIXEL_AXIS),
                             ("psum_2d_pixels", m2, pm.PIXEL_AXIS),
                             ("psum_2d_samples", m2, pm.SAMPLE_AXIS),
                             ("psum_2d_both", m2, (pm.SAMPLE_AXIS, pm.PIXEL_AXIS))):
        _save(out, name, rank, pm.psum(x, mesh, axis), every_rank=True)

    p0 = torch.tensor([0.5, -1.0, 2.0])
    for name, skip in (("toy", None), ("toy_skip", 3)):
        p = p0.clone().requires_grad_(True)
        loss, img = toy_loss(p, rank, 4, m, REG, skip_rank=skip)
        g, = torch.autograd.grad(loss, p)
        _save(out, name + "_grad", rank, g, every_rank=True)
        _save(out, name + "_img", rank, img, every_rank=True)

    _expect_error(errors, "mesh_of_3", lambda: pm.make_mesh(3, device_type="cpu"))
    _expect_error(errors, "mesh_2d_of_8", lambda: pm.make_mesh_2d(4, 2, device_type="cpu"))
    _expect_error(errors, "mesh_on_tpu", lambda: pm.make_mesh(4, device_type="tpu"))
    _expect_error(errors, "no_sample_axis",
                  lambda: pm.axis_size(m, pm.SAMPLE_AXIS, "render_sample_sharded"))
    _expect_error(errors, "not_a_mesh", lambda: pm.axis_size(None, pm.PIXEL_AXIS, "entry"))
    _expect_error(errors, "tables_on_cuda",
                  lambda: pm.check_device(m, torch.device("cuda", 0), "entry"))
    _expect_error(errors, "reduce_over_unknown_axis",
                  lambda: pm.psum(x, m, pm.PATH_AXIS))
    with open(os.path.join(out, f"errors.r{rank}.json"), "w") as f:
        json.dump(errors, f)


def failing_rank(rank):
    if rank == 1:
        raise RuntimeError("rank 1 fails on purpose")


def _eager(rank, out):
    scene = presets.cornell()
    m = pm.make_mesh(4, device_type="cpu")
    kw = dict(max_bounces=BOUNCES, live_cutoff=None)
    _save(out, "eager_pixel", rank,
          sharding.render_pixel_sharded(scene, cam(), W, H, SPP, 0, m, **kw),
          every_rank=True)
    _save(out, "eager_pixel_physical", rank,
          sharding.render_pixel_sharded(scene, cam(), W, H, SPP, 0, m,
                                        physical=True, **kw))
    _save(out, "eager_jit_pixel", rank,
          sharding.jit_pixel_sharded(scene, cam(), W, H, SPP, 0, m, **kw))
    _save(out, "eager_pixel_resume", rank,
          sharding.render_pixel_sharded(scene, cam(), W, H, SPP // 2, 0, m,
                                        sample_offset=SPP // 2, **kw))
    m_s = pm.make_mesh(4, axis=pm.SAMPLE_AXIS, device_type="cpu")
    _save(out, "eager_sample", rank,
          sharding.render_sample_sharded(scene, cam(), W, H, SPP, 0, m_s, **kw),
          every_rank=True)
    m2 = pm.make_mesh_2d(2, 2, device_type="cpu")
    _save(out, "eager_2d", rank,
          sharding.render_2d_sharded(scene, cam(), W, H, SPP, 0, m2, **kw),
          every_rank=True)
    m_p = pm.make_mesh(4, axis=pm.PATH_AXIS, device_type="cpu")
    _save(out, "eager_light", rank,
          sharding.render_lighttrace_sharded(presets.cornell_lambert(), cam(), W, H,
                                             LIGHT_PATHS, 0, m_p, max_bounces=BOUNCES),
          every_rank=True)
    f = FUSED
    _save(out, "eager_bidir", rank,
          bidir.render_bidir_sharded(presets.caustic(), cam(), f["width"], f["height"],
                                     f["spp"], f["n_paths"], f["seed"], m, m_p,
                                     max_bounces=f["max_bounces"]))

    # the gradient of a sharded loss with a regulariser outside the render
    params = {k: v.detach().clone().requires_grad_(True) for k, v in
              inverse.extract_params(scene, ["materials.diffuse", "al_power"]).items()}
    img = sharding.render_pixel_sharded(inverse.merge_params(scene, params), cam(),
                                        W, H, SPP, 0, m, **kw)
    loss = torch.mean(img ** 2) + REG * (params["materials.diffuse"] ** 2).sum()
    grads = torch.autograd.grad(loss, list(params.values()))
    for k, g in zip(params, grads):
        _save(out, f"eager_grad_{k}", rank, g, every_rank=True)
    _save(out, "eager_grad_loss", rank, loss)

    # the bidirectional loss over two meshes
    params = {k: v.detach().clone().requires_grad_(True) for k, v in
              inverse.extract_params(presets.caustic(),
                                     ["materials.emission", "materials.diffuse"]).items()}
    img = bidir.render_bidir_sharded(inverse.merge_params(presets.caustic(), params),
                                     cam(), f["width"], f["height"], f["spp"],
                                     f["n_paths"], f["seed"], m, m_p,
                                     max_bounces=f["max_bounces"])
    grads = torch.autograd.grad(torch.mean(img ** 2), list(params.values()))
    for k, g in zip(params, grads):
        _save(out, f"eager_bidir_grad_{k}", rank, g)


def k2_leaves(packed, mode):
    """The tensors a K2 case trains: the material table, plus the camera
    position in full mode and the triangle table in geo mode."""
    leaves = {"materials": packed.materials.detach().clone().requires_grad_(True)}
    if mode == "full":
        leaves["cam_pos"] = torch.as_tensor(cam()[1], dtype=torch.float32
                                            ).clone().requires_grad_(True)
    if mode == "geo":
        leaves["triangles"] = packed.triangles.detach().clone().requires_grad_(True)
    return leaves


def k2_inputs(packed, leaves):
    tables = {k: v for k, v in leaves.items() if k in ("materials", "triangles")}
    cp = list(cam())
    if "cam_pos" in leaves:
        cp[1] = leaves["cam_pos"]
    return dataclasses.replace(packed, **tables), tuple(cp)


# grad mode -> render_megakernel_diff keywords
K2_KW = {"linear": dict(grad_mode="linear"), "full": dict(grad_mode="full"),
         "geo": dict(grad_mode="geo"), "physical": dict(physical=True)}


def _kernels(rank, out):
    m = pm.make_mesh(4, device_type="cpu")
    m_p = pm.make_mesh(4, axis=pm.PATH_AXIS, device_type="cpu")
    packed = mk.pack_scene(presets.cornell(), "cpu")
    for w, h in K_SIZES:
        for est in ("default", "physical"):
            _save(out, f"k1_{w}x{h}_{est}", rank,
                  mk.render_megakernel_sharded(packed, cam(), 3, w, h, SPP, m,
                                               max_bounces=BOUNCES,
                                               physical=est == "physical"),
                  every_rank=(w, est) == (9, "default"))
        for mode in K2_MODES:
            leaves = k2_leaves(packed, mode)
            p, cp = k2_inputs(packed, leaves)
            img = vjp.render_megakernel_diff_sharded(p, cp, 7, w, h, SPP, m,
                                                     max_bounces=BOUNCES,
                                                     **K2_KW[mode])
            loss = torch.mean(img ** 2) + REG * (leaves["materials"] ** 2).sum()
            grads = torch.autograd.grad(loss, list(leaves.values()))
            _save(out, f"k2_{w}x{h}_{mode}_img", rank, img)
            for k, g in zip(leaves, grads):
                _save(out, f"k2_{w}x{h}_{mode}_grad_{k}", rank, g,
                      every_rank=(w, mode) == (9, "full"))

    f = FUSED
    caustic = mk.pack_scene(presets.caustic(), "cpu")
    for label, nu in (("plain", None), ("bidir", 4.0)):
        _save(out, f"k3_{label}", rank,
              lk.render_lighttrace_fast_sharded(caustic, cam(), f["seed"], f["width"],
                                                f["height"], f["n_paths"], m_p,
                                                max_bounces=f["max_bounces"],
                                                bidir_nu=nu),
              every_rank=label == "plain")
    _save(out, "bidir_fast", rank,
          bidir.render_bidir_fast_sharded(caustic, cam(), f["width"], f["height"],
                                          f["spp"], f["n_paths"], f["seed"], m, m_p,
                                          max_bounces=f["max_bounces"]))


def _errors(rank, out):
    errors = {}
    scene, packed = presets.cornell(), mk.pack_scene(presets.cornell(), "cpu")
    m = pm.make_mesh(4, device_type="cpu")
    m_s = pm.make_mesh(4, axis=pm.SAMPLE_AXIS, device_type="cpu")
    m_p = pm.make_mesh(4, axis=pm.PATH_AXIS, device_type="cpu")
    dark = presets.cornell_empty()
    dark = dark.replace(al_tri0=dark.al_tri0[:0], al_power=dark.al_power[:0],
                        al_area=dark.al_area[:0])
    dark_packed = dataclasses.replace(packed, counts=packed.counts[:4] + (0,))
    textured = mk.pack_scene(presets.get_scene("textured"), "cpu")
    cases = {
        "pixel_not_divisible": lambda: sharding.render_pixel_sharded(
            scene, cam(), 9, 9, 1, 0, m),
        "sample_on_pixel_mesh": lambda: sharding.render_sample_sharded(
            scene, cam(), W, H, SPP, 0, m),
        "sample_spp_not_divisible": lambda: sharding.render_sample_sharded(
            scene, cam(), W, H, 6, 0, m_s),
        "2d_on_pixel_mesh": lambda: sharding.render_2d_sharded(
            scene, cam(), W, H, SPP, 0, m),
        "light_on_pixel_mesh": lambda: sharding.render_lighttrace_sharded(
            presets.cornell_lambert(), cam(), W, H, LIGHT_PATHS, 0, m),
        "light_without_area_light": lambda: sharding.render_lighttrace_sharded(
            dark, cam(), W, H, LIGHT_PATHS, 0, m_p),
        "light_paths_not_divisible": lambda: sharding.render_lighttrace_sharded(
            scene, cam(), W, H, 4097, 0, m_p),
        "k1_on_path_mesh": lambda: mk.render_megakernel_sharded(
            packed, cam(), 0, W, H, 1, m_p),
        "k1_pixels_too_few": lambda: mk.render_megakernel_sharded(
            packed, cam(), 0, 3, 1, 1, m),
        "k2_mesh_none": lambda: vjp.render_megakernel_diff_sharded(
            packed, cam(), 0, W, H, 1, None),
        "k2_unknown_grad_mode": lambda: vjp.render_megakernel_diff_sharded(
            packed, cam(), 0, W, H, 1, m, grad_mode="all"),
        "k3_on_pixel_mesh": lambda: lk.render_lighttrace_fast_sharded(
            packed, cam(), 0, W, H, 64, m),
        "k3_without_area_light": lambda: lk.render_lighttrace_fast_sharded(
            dark_packed, cam(), 0, W, H, 64, m_p),
        "k3_textured": lambda: lk.render_lighttrace_fast_sharded(
            textured, cam(), 0, W, H, 64, m_p),
        "bidir_fast_without_area_light": lambda: bidir.render_bidir_fast_sharded(
            dark_packed, cam(), W, H, 1, 64, 0, m, m_p),
        "bidir_without_area_light": lambda: bidir.render_bidir_sharded(
            dark, cam(), W, H, 1, 64, 0, m, m_p),
    }
    for name, fn in cases.items():
        _expect_error(errors, name, fn)
    with open(os.path.join(out, f"errors.r{rank}.json"), "w") as f:
        json.dump(errors, f)


def _dryrun(rank, out):
    """The certification run's steps in this world; rank 0 keeps its lines."""
    from cuda_path_tracer_ss_torch.parallel import dryrun

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        dryrun._rank_steps(rank, 4, "cpu")
    if rank == 0:
        with open(os.path.join(out, "dryrun.txt"), "w") as f:
            f.write(buf.getvalue())


def sharding_scenarios(rank, out):
    torch.set_num_threads(1)
    _eager(rank, out)
    _kernels(rank, out)
    _errors(rank, out)


def slow_scenarios(rank, out):
    """The configurations of the reference's slow sharded tests, and the
    certification run's steps."""
    torch.set_num_threads(1)
    _dryrun(rank, out)
    m = pm.make_mesh(4, device_type="cpu")
    m_p = pm.make_mesh(4, axis=pm.PATH_AXIS, device_type="cpu")
    # tests/test_sharding.py::test_megakernel_sharded_covers_indivisible_images
    _save(out, "k1_257x1", rank, mk.render_megakernel_sharded(
        mk.pack_scene(presets.cornell_empty(), "cpu"), cam(), 3, 257, 1, 1, m,
        max_bounces=2))
    # ::test_megakernel_diff_sharded_trains_multi_device
    packed = mk.pack_scene(presets.cornell(), "cpu")
    mats = packed.materials.detach().clone().requires_grad_(True)
    img = vjp.render_megakernel_diff_sharded(dataclasses.replace(packed, materials=mats),
                                             cam(), 7, W, H, 2, m, max_bounces=3)
    loss = torch.mean(img ** 2)
    g, = torch.autograd.grad(loss, mats)
    _save(out, "k2_ref_img", rank, img)
    _save(out, "k2_ref_loss", rank, loss)
    _save(out, "k2_ref_grad", rank, g)
    # ::test_lighttrace_sharded_matches_single
    _save(out, "light_ref", rank, sharding.render_lighttrace_sharded(
        presets.cornell_lambert(), cam(), W, H, LIGHT_PATHS, 0, m_p,
        max_bounces=BOUNCES))
