"""One case through the TPU backward kernel itself, run as the reference's own
CPU tests run it (Pallas interpret mode), at the smallest useful size: the
port's plain version and the host build of its CUDA kernel's math against
``render_megakernel_diff(..., interpret=True, grad_mode="linear")``."""
import numpy as np

import jax
import jax.numpy as jnp

from cuda_path_tracer_ss_tpu.models import presets as jpresets
from cuda_path_tracer_ss_tpu.models.camera import Camera as JCamera
from cuda_path_tracer_ss_tpu.ops.pallas.megakernel import pack_scene as jpack_scene
from cuda_path_tracer_ss_tpu.ops.pallas.megakernel_vjp import (
    render_megakernel_diff as jrender_megakernel_diff)
from cuda_path_tracer_ss_tpu.render import inverse as jinverse
from cuda_path_tracer_ss_tpu.render.integrator import camera_arrays as jcamera_arrays
from cuda_path_tracer_ss_torch.models.camera import Camera, camera_arrays
from torch_port_helpers import (assert_grads_close, port_scene,
                                port_value_and_grad, vjp_case_fields)


def test_port_matches_pallas_backward_kernel_in_interpret_mode():
    jscene = jpresets.cornell()
    fields = vjp_case_fields(jscene, "linear")
    cp = jcamera_arrays(JCamera())

    def loss(params, seed):
        s = jinverse.merge_params(jscene, params)
        img = jrender_megakernel_diff(jpack_scene(s), cp, seed, 8, 8, 1,
                                      max_bounces=2, interpret=True,
                                      grad_mode="linear")
        return jnp.mean(img ** 2)

    v_jax, g_jax = jax.device_get(jax.jit(jax.value_and_grad(loss))(
        jinverse.extract_params(jscene, fields), 5))
    g_jax = {k: np.asarray(a) for k, a in g_jax.items()}
    for engine in ("plain", "host"):
        v, g = port_value_and_grad(port_scene(jscene), camera_arrays(Camera()),
                                   fields, 8, 8, 1, 2, 5, engine, "linear")
        np.testing.assert_allclose(v, float(v_jax), rtol=1e-5)
        assert_grads_close(g, g_jax, fields)
