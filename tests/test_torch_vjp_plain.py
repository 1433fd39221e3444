"""The plain PyTorch version of the differentiable render (autograd through the
plain forward render) against the reference's oracle: ``jax.value_and_grad`` of
the MSE loss over the jnp engine, on the same counter-RNG streams — the cases,
sizes and tolerances of tests/test_pallas_vjp.py. Loss rtol 1e-5; every
gradient rtol 1e-3, atol 1e-4 * max|g_jax| (float op-order noise through
cancellations is all that separates the two).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cuda_path_tracer_ss_tpu.models import presets as jpresets
from cuda_path_tracer_ss_tpu.models.camera import Camera as JCamera
from cuda_path_tracer_ss_tpu.render import inverse as jinverse
from cuda_path_tracer_ss_tpu.render.integrator import camera_arrays as jcamera_arrays
from cuda_path_tracer_ss_tpu.render.integrator import render as jrender
from cuda_path_tracer_ss_torch.models.camera import Camera, camera_arrays
from cuda_path_tracer_ss_torch.ops.cuda import megakernel as tmk
from cuda_path_tracer_ss_torch.ops.cuda import megakernel_vjp as tvjp
from torch_port_helpers import (VJP_BOUNCES, VJP_H, VJP_SEED, VJP_SPP, VJP_W,
                                assert_grads_close, jax_preset_value_and_grad,
                                jax_value_and_grad, port_scene,
                                port_value_and_grad)

CP = camera_arrays(Camera())
NONZERO_EXEMPT = ("materials.roughness", "materials.ior")


@pytest.mark.parametrize("name,grad_mode", [
    ("cornell", "linear"), ("cornell", "full"), ("showcase", "full"),
    ("point_light_spheres", "full")])
def test_plain_matches_jax_autodiff(name, grad_mode):
    jscene, fields, v_jax, g_jax = jax_preset_value_and_grad(name, grad_mode)
    v, g = port_value_and_grad(port_scene(jscene), CP, fields, VJP_W, VJP_H,
                               VJP_SPP, VJP_BOUNCES, VJP_SEED, "plain",
                               grad_mode)
    np.testing.assert_allclose(v, v_jax, rtol=1e-5)
    assert_grads_close(g, g_jax, fields)
    for k in fields:
        if k not in NONZERO_EXEMPT:   # zero on scenes without that branch
            assert np.abs(g_jax[k]).max() > 0, f"no gradient flows to {k}"


def test_full_mode_reaches_direction_sampled_fields():
    """The path adjoint's distinguishing fields receive nonzero gradients
    somewhere: roughness on showcase (Cook-Torrance spheres), pl_pos on the
    point-light scene."""
    _, _, _, g = jax_preset_value_and_grad("showcase", "full")
    assert np.abs(g["materials.roughness"]).max() > 0
    _, fields, _, g = jax_preset_value_and_grad("point_light_spheres", "full")
    assert "pl_pos" in fields and np.abs(g["pl_pos"]).max() > 0


def test_camera_gradients_match_jax():
    """dL/d(camera rotation, position, tan_half_fov); z_near's gradient is
    structurally ~0 (the normalised eye direction is scale-invariant in it)."""
    jscene = jpresets.cornell()
    jcp = jcamera_arrays(JCamera())

    def loss_jnp(cp_, seed):
        img = jrender(jscene, cp_, 8, 8, 1, seed, max_bounces=3, live_cutoff=None)
        return jnp.mean(img ** 2)

    want = jax.device_get(jax.jit(jax.grad(loss_jnp))(jcp, 5))
    cam = [torch.tensor(np.asarray(v, np.float32), requires_grad=True) for v in CP]
    packed = tmk.pack_scene(port_scene(jscene), "cpu")
    img = tvjp.render_megakernel_diff_plain(packed, cam, 5, 8, 8, 1, max_bounces=3)
    got = torch.autograd.grad(torch.mean(img ** 2), cam)
    for name, a, b in zip(("rot", "pos", "tan_half"), want[:3], got[:3]):
        a, b = np.asarray(a), b.numpy()
        scale = np.abs(a).max() + 1e-12
        np.testing.assert_allclose(b, a, atol=1e-4 * scale, rtol=1e-3,
                                   err_msg=f"camera {name}")
        assert np.abs(a).max() > 0, f"no gradient flows to camera {name}"
    assert abs(float(got[3])) <= 1e-4 * np.abs(np.asarray(want[2])).max()


def test_sphere_geometry_gradients_match_jax():
    """dL/d(sphere centre, radius), interior-only (hit / miss detached)."""
    jscene = jpresets.cornell()
    fields = ["sph_center", "sph_radius"]
    _, want = jax_value_and_grad(jscene, fields, 8, 8, 2, 4, 5)
    _, got = port_value_and_grad(port_scene(jscene), CP, fields, 8, 8, 2, 4, 5,
                                 "plain", "full")
    assert_grads_close(got, want, fields)
    for k in fields:
        assert np.abs(want[k]).max() > 0, f"no gradient flows to {k}"


def test_spec_exp_gradient_matches_jax():
    """Finite-exponent Phong lobes: d/d(spec_exp) through the sampled
    direction (the mirror materials made glossy)."""
    jscene = jpresets.cornell()
    exp0 = jinverse.get_field(jscene, "materials.spec_exp")
    jscene = jinverse.with_field(jscene, "materials.spec_exp",
                                 jnp.where(jnp.isinf(exp0), 40.0, exp0))
    fields = ["materials.spec_exp"]
    _, want = jax_value_and_grad(jscene, fields, 8, 8, 2, 3, 5)
    _, got = port_value_and_grad(port_scene(jscene), CP, fields, 8, 8, 2, 3, 5,
                                 "plain", "full")
    assert np.abs(want["materials.spec_exp"]).max() > 1e-12
    assert_grads_close(got, want, fields)


def test_plain_detaches_what_the_kernel_detaches():
    """Triangles and the area lights' vertex columns get no gradient from the
    plain version, as from the kernel (they belong to grad_mode='geo')."""
    packed = tmk.pack_scene(port_scene(jpresets.cornell()), "cpu")
    tables = [t.clone().requires_grad_(True) for t in packed.tables()]
    leaf = tmk.PackedScene(*tables, packed.counts)
    img = tvjp.render_megakernel_diff_plain(leaf, CP, 3, 8, 8, 1, max_bounces=3)
    grads = torch.autograd.grad(torch.mean(img ** 2), tables, allow_unused=True)
    assert grads[1] is None or float(grads[1].abs().max()) == 0.0
    assert float(grads[4][:, :18].abs().max()) == 0.0
    assert float(grads[4][:, 18:21].abs().max()) > 0.0
    assert all(bool(torch.isfinite(g).all()) for g in grads if g is not None)


def test_forward_value_is_the_plain_render():
    """Differentiability costs the forward nothing: the image is bit-equal
    to ``render_megakernel_plain``'s."""
    packed = tmk.pack_scene(port_scene(jpresets.showcase()), "cpu")
    a = tmk.render_megakernel_plain(packed, CP, 9, 10, 10, 2, 4)
    leaf = tmk.PackedScene(*[t.clone().requires_grad_(True) for t in packed.tables()],
                           packed.counts)
    b = tvjp.render_megakernel_diff_plain(leaf, CP, 9, 10, 10, 2, max_bounces=4)
    assert b.requires_grad
    np.testing.assert_array_equal(a.numpy(), b.detach().numpy())
