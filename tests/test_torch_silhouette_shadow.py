"""The shadow (NEE-occlusion) boundary term on the CPU:
``cuda_path_tracer_ss_torch/render/silhouette.py::shadow_boundary_grad``
against the JAX package's on the shadow scenes of tests/test_silhouette.py at
16x16, each field within 1e-3 of its max|g|:

* the sphere blocker over the lit floor (``_shadow_scene``), physical and
  parity (the center-biased area density of the parity integrand), and the
  glossy wall's shadowed highlight (the Phong lobe of the physical one);
* with ``-m slow``: the triangle blocker's three projected edges, and the
  shadow seen only in a flat mirror (the receivers' mirror chain).

The adjoint image is a fixed random image (the term is linear in it), so no
render is compiled; the tests run on one intra-op thread.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cuda_path_tracer_ss_tpu.models import scene as jscene_mod
from cuda_path_tracer_ss_tpu.models.camera import Camera as JCamera
from cuda_path_tracer_ss_tpu.render import inverse as jinverse
from cuda_path_tracer_ss_tpu.render import silhouette as jsil
from cuda_path_tracer_ss_tpu.render.integrator import camera_arrays as jcamera_arrays
from cuda_path_tracer_ss_torch.models.camera import Camera, camera_arrays
from cuda_path_tracer_ss_torch.render import inverse as tinverse
from cuda_path_tracer_ss_torch.render import silhouette as tsil
from torch_port_helpers import port_scene, silhouette_scene

W = H = 16
SEED = 3
N_PHI = 16
CP = camera_arrays(Camera())
JCP = jcamera_arrays(JCamera())


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread (see test_torch_silhouette.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(v):
    if hasattr(v, "x"):
        return np.stack([np.asarray(v.x), np.asarray(v.y), np.asarray(v.z)], -1)
    return np.asarray(v)


# The triangle blocker's 15 curve batches and the mirror chain take the
# reference 35 s and 6 s of XLA compile: they run with -m slow.
@pytest.mark.parametrize("scene,physical,fields,tri_blockers", [
    ("shadow", True, ("sph_center", "sph_radius"), False),
    ("shadow", False, ("sph_center", "sph_radius"), False),
    ("glossy_shadow", True, ("sph_center", "sph_radius"), False),
    pytest.param("tri_blocker", False, ("tri_v0",), True, marks=pytest.mark.slow),
    pytest.param("mirror_shadow", False, ("sph_center", "sph_radius", "tri_v0"), False,
                 marks=pytest.mark.slow),
])
def test_shadow_boundary_grad_matches(scene, physical, fields, tri_blockers):
    """Each field of shadow_boundary_grad within 1e-3 of its max|g|."""
    js = silhouette_scene(scene, jscene_mod)
    ts = port_scene(js)
    dl = np.random.default_rng(0).normal(size=(H, W, 3)).astype(np.float32)
    want = jsil.shadow_boundary_grad(js, jinverse.extract_params(js, fields), JCP,
                                     jnp.asarray(dl), W, H, SEED, n_phi=N_PHI,
                                     physical=physical, tri_blockers=tri_blockers)
    tp = tinverse.extract_params(ts, fields)
    got = tsil.shadow_boundary_grad(ts, tp, CP, torch.from_numpy(dl), W, H, SEED,
                                    n_phi=N_PHI, physical=physical,
                                    tri_blockers=tri_blockers)
    assert set(got) == set(fields)
    for k in fields:
        w = _np(want[k])
        g = got[k].numpy()
        assert g.shape == tuple(tp[k].shape) and np.isfinite(g).all(), k
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-3 * (np.abs(w).max() + 1e-12),
                                   err_msg=k)
    lead = {"tri_blocker": "tri_v0"}.get(scene, "sph_radius")
    assert np.abs(_np(want[lead])).max() > 0, "the blocker casts no sampled shadow"
