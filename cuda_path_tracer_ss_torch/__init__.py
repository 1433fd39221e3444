"""cuda_path_tracer_ss_torch — the PyTorch/CUDA port of the path tracer.

The counterpart, for one NVIDIA Hopper GPU, of ``cuda_path_tracer_ss_tpu``:
same scenes, same counter-based random streams, same estimators, with the
fused kernels written by hand in CUDA C++ (``csrc/``) and a plain PyTorch
version of each beside it. This package imports ``torch`` and ``numpy``
only. Ported so far: the forward render — presets, scene packing, the
megakernel, the progressive renderer with exact resume, the ``render`` /
``benchmark`` commands; training — the replay-VJP kernel under
``render_megakernel_diff`` (grad modes linear and full), ``render/inverse.py``
and the ``grad-check`` / ``invert`` commands; and the unbiased estimators —
the megakernel's physical (MIS) variant and its bidirectional carries, the
light-tracing kernel under ``render_lighttrace_fast``, ``render_bidir_fast``
and the ``lighttrace`` / ``bidir`` commands; and textures — color and normal
maps in both kernels (forward render and training, the texels trainable),
the ``textured`` and ``mesh`` presets, the OBJ/MTL loader and ``--obj``;
and the eager engine — the JAX package's jnp engine in plain PyTorch, eye
paths (``render/integrator.py``) and light paths (``render_lighttrace``,
``render_bidir``), differentiable by autograd; and the silhouette
(visibility-boundary) terms of geometry gradients (``render/silhouette.py``,
``invert(silhouette=True)``) on the eager engine; and rendering and training
over several processes (``parallel/``: meshes over ``torch.distributed``,
the eager engine's sharded renders, the kernels' sharded entries and the
multi-device certification run).
"""

from .constants import (
    DEFAULT_DIM,
    DEFAULT_MAX_BOUNCES,
    GAMMA_CORRECTION,
    RAY_BUMP_EPSILON,
)
from .models.camera import Camera, camera_arrays
from .models.presets import PRESETS, get_scene
from .models.scene import (
    MaterialSpec,
    Materials,
    MAT_FLAG_COOK_TORRANCE,
    MAT_FLAG_PURE_REFLECTION,
    Scene,
    SceneBuilder,
    scene_from_numpy,
    scene_to_numpy,
)
from .ops.cuda.lightkernel import (
    light_image,
    light_records,
    render_lighttrace_fast,
    render_lighttrace_fast_sharded,
)
from .ops.cuda.megakernel import (
    PackedScene,
    pack_scene,
    render_fast2,
    render_megakernel,
    render_megakernel_plain,
    render_megakernel_sharded,
)
from .ops.cuda.megakernel_vjp import (
    render_megakernel_diff,
    render_megakernel_diff_plain,
    render_megakernel_diff_sharded,
)
from .parallel.mesh import (
    PATH_AXIS,
    PIXEL_AXIS,
    SAMPLE_AXIS,
    initialize_distributed,
    make_mesh,
    make_mesh_2d,
    spawn_world,
)
from .parallel.sharding import (
    jit_pixel_sharded,
    render_2d_sharded,
    render_lighttrace_sharded,
    render_pixel_sharded,
    render_sample_sharded,
)
from .render.bidir import (
    render_bidir,
    render_bidir_fast,
    render_bidir_fast_sharded,
    render_bidir_sharded,
)
from .render.inverse import (
    TRAINABLE_FIELDS,
    check_engine_fields,
    directional_fd_check,
    extract_params,
    invert,
    make_loss,
    merge_params,
)
from .render.lighttrace import render_lighttrace
from .render.renderer import ProgressiveRenderer, RenderConfig
from .render.silhouette import (
    boundary_grad,
    make_grad_with_boundary,
    shadow_boundary_grad,
)

__version__ = "0.1.0"

__all__ = [
    "Camera",
    "DEFAULT_DIM",
    "DEFAULT_MAX_BOUNCES",
    "GAMMA_CORRECTION",
    "MAT_FLAG_COOK_TORRANCE",
    "MAT_FLAG_PURE_REFLECTION",
    "MaterialSpec",
    "Materials",
    "PATH_AXIS",
    "PIXEL_AXIS",
    "PRESETS",
    "PackedScene",
    "ProgressiveRenderer",
    "RAY_BUMP_EPSILON",
    "RenderConfig",
    "SAMPLE_AXIS",
    "Scene",
    "SceneBuilder",
    "TRAINABLE_FIELDS",
    "boundary_grad",
    "camera_arrays",
    "check_engine_fields",
    "directional_fd_check",
    "extract_params",
    "get_scene",
    "initialize_distributed",
    "invert",
    "jit_pixel_sharded",
    "light_image",
    "light_records",
    "make_grad_with_boundary",
    "make_loss",
    "make_mesh",
    "make_mesh_2d",
    "merge_params",
    "pack_scene",
    "render_2d_sharded",
    "render_bidir",
    "render_bidir_fast",
    "render_bidir_fast_sharded",
    "render_bidir_sharded",
    "render_fast2",
    "render_lighttrace",
    "render_lighttrace_fast",
    "render_lighttrace_fast_sharded",
    "render_lighttrace_sharded",
    "render_megakernel",
    "render_megakernel_diff",
    "render_megakernel_diff_plain",
    "render_megakernel_diff_sharded",
    "render_megakernel_plain",
    "render_megakernel_sharded",
    "render_pixel_sharded",
    "render_sample_sharded",
    "scene_from_numpy",
    "scene_to_numpy",
    "shadow_boundary_grad",
    "spawn_world",
]
