"""The port's debugging and profiling tools on the CPU: ``utils/profiling.trace``
(a Chrome trace of an eager render naming its aten operations) and
``utils/debug.py`` (``checked_render`` and ``assert_finite``) beside the JAX
package's ``utils/debug.py`` on the same inputs (tests/test_utils.py:45-55).
"""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cuda_path_tracer_ss_tpu.utils import debug as jdebug
from cuda_path_tracer_ss_torch.models import presets as tpresets
from cuda_path_tracer_ss_torch.models.camera import Camera, camera_arrays
from cuda_path_tracer_ss_torch.render import integrator
from cuda_path_tracer_ss_torch.utils import debug, profiling

CP = camera_arrays(Camera())


def test_trace_writes_a_chrome_trace_of_the_render(tmp_path):
    """A 16x16 eager render inside ``trace``: the profiler is yielded, its
    averages name the render's aten operations, and log_dir/trace.json is a
    Chrome trace holding them (CPU activity here; CUDA too on a card)."""
    log_dir = str(tmp_path / "trace")
    with profiling.trace(log_dir) as prof:
        img = integrator.render(tpresets.cornell(), CP, 16, 16, 1, 0, max_bounces=3,
                                live_cutoff=None, device="cpu")
    assert img.shape == (16, 16, 3)
    names = {e.key for e in prof.key_averages()}
    assert {"aten::mul", "aten::where", "aten::index"} <= names
    with open(os.path.join(log_dir, profiling.TRACE_FILE)) as f:
        events = json.load(f)["traceEvents"]
    traced = {e.get("name") for e in events}
    assert {"aten::mul", "aten::where"} <= traced


def test_checked_render_clean_scene_passes():
    """tests/test_utils.py:45-50 (8x8, 1 spp, 2 bounces): no NaN anywhere,
    the sweeps' +inf slots included, and the image is the unchecked
    render's bit for bit."""
    scene = tpresets.cornell_empty()
    img = debug.checked_render(scene, CP, 8, 8, 1, 0, max_bounces=2, device="cpu")
    assert np.all(np.isfinite(img.numpy()))
    want = integrator.render(scene, CP, 8, 8, 1, 0, max_bounces=2, live_cutoff=None,
                             device="cpu")
    assert torch.equal(img, want)


@pytest.mark.parametrize("name", ["cornell", "caustic", "textured"])
def test_checked_render_passes_on_the_presets(name):
    img = debug.checked_render(tpresets.get_scene(name), CP, 8, 8, 1, 2, max_bounces=3,
                               device="cpu")
    assert np.all(np.isfinite(img.numpy()))


def test_checked_render_names_the_operation_that_made_a_nan():
    scene = tpresets.cornell_empty()
    diffuse = scene.materials.diffuse.clone()
    diffuse[:, 0] = float("nan")
    bad = dataclasses.replace(scene, materials=dataclasses.replace(scene.materials,
                                                                   diffuse=diffuse))
    with pytest.raises(FloatingPointError, match=r"NaN in the output of aten\.\w+"):
        debug.checked_render(bad, CP, 8, 8, 1, 0, max_bounces=2, device="cpu")
    if not torch.cuda.is_available():   # the card by default, no fallback
        with pytest.raises(RuntimeError, match="no CUDA device"):
            debug.checked_render(scene, CP, 8, 8, 1, 0, max_bounces=2)


@pytest.mark.parametrize("tree,bad", [
    ({"x": [1.0, np.nan]}, "['x']"),
    ({"a": [1.0], "b": ([2.0], [np.inf])}, "['b'][1]"),
    ([[0.5], [-np.inf]], "[1]"),
    ({"x": [1.0, 2.0]}, None),
])
def test_assert_finite_raises_where_the_reference_does(tree, bad):
    """tests/test_utils.py:52-55 on both packages' assert_finite, the same
    dict / list / tuple of arrays: the same message (the leaf's path) or no
    raise."""
    def leaves(t, wrap):
        if isinstance(t, dict):
            return {k: leaves(v, wrap) for k, v in t.items()}
        if isinstance(t, tuple):
            return tuple(leaves(v, wrap) for v in t)
        if isinstance(t, list) and t and isinstance(t[0], list):
            return [leaves(v, wrap) for v in t]
        return wrap(np.asarray(t, np.float32))

    if bad is None:
        debug.assert_finite(leaves(tree, torch.from_numpy))
        jdebug.assert_finite(leaves(tree, jnp.asarray))
        return
    with pytest.raises(FloatingPointError) as got:
        debug.assert_finite(leaves(tree, torch.from_numpy), name="bad")
    with pytest.raises(FloatingPointError) as want:
        jdebug.assert_finite(leaves(tree, jnp.asarray), name="bad")
    assert str(got.value) == str(want.value) == f"non-finite values in bad{bad}"
