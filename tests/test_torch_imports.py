"""The PyTorch/CUDA package and chip_smoke.py stand apart from the JAX
package: they import neither jax nor cuda_path_tracer_ss_tpu."""
import ast
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "cuda_path_tracer_ss_torch")
FORBIDDEN = ("jax", "jaxlib", "optax", "cuda_path_tracer_ss_tpu")
KERNEL_SOURCES = ("megakernel.cu", "megakernel.cuh", "megakernel_vjp.cu",
                  "megakernel_vjp.cuh", "lightkernel.cu", "lightkernel.cuh")


def _port_files():
    files = [os.path.join(ROOT, "chip_smoke.py"),
             os.path.join(ROOT, "k1_turns.py"),
             # the body of the multi-process tests' ranks
             os.path.join(ROOT, "tests", "torch_dist_worker.py")]
    for base, _, names in os.walk(PORT):
        files += [os.path.join(base, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _imported_modules(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_port_has_its_modules():
    names = {os.path.relpath(p, ROOT) for p in _port_files()}
    for want in ("chip_smoke.py", "cuda_path_tracer_ss_torch/cli.py",
                 "cuda_path_tracer_ss_torch/ops/cuda/megakernel.py",
                 "cuda_path_tracer_ss_torch/ops/cuda/megakernel_vjp.py",
                 "cuda_path_tracer_ss_torch/ops/cuda/lightkernel.py",
                 "cuda_path_tracer_ss_torch/ops/texture.py",
                 "cuda_path_tracer_ss_torch/ops/grid.py",
                 "cuda_path_tracer_ss_torch/utils/obj.py",
                 "cuda_path_tracer_ss_torch/render/bidir.py",
                 "cuda_path_tracer_ss_torch/render/inverse.py",
                 "cuda_path_tracer_ss_torch/render/renderer.py",
                 "cuda_path_tracer_ss_torch/utils/build.py",
                 "cuda_path_tracer_ss_torch/ops/vec.py",
                 "cuda_path_tracer_ss_torch/ops/intersect.py",
                 "cuda_path_tracer_ss_torch/ops/optics.py",
                 "cuda_path_tracer_ss_torch/ops/sampling.py",
                 "cuda_path_tracer_ss_torch/ops/bsdf.py",
                 "cuda_path_tracer_ss_torch/ops/shading.py",
                 "cuda_path_tracer_ss_torch/ops/compaction.py",
                 "cuda_path_tracer_ss_torch/render/integrator.py",
                 "cuda_path_tracer_ss_torch/render/lighttrace.py",
                 "cuda_path_tracer_ss_torch/render/silhouette.py",
                 "cuda_path_tracer_ss_torch/utils/debug.py",
                 "cuda_path_tracer_ss_torch/parallel/__init__.py",
                 "cuda_path_tracer_ss_torch/parallel/mesh.py",
                 "cuda_path_tracer_ss_torch/parallel/sharding.py",
                 "cuda_path_tracer_ss_torch/parallel/dryrun.py"):
        assert want in names
    for src in KERNEL_SOURCES:
        assert os.path.isfile(os.path.join(PORT, "csrc", src))


@pytest.mark.parametrize("path", [os.path.relpath(p, ROOT) for p in _port_files()])
def test_no_jax_import(path):
    for module in _imported_modules(os.path.join(ROOT, path)):
        assert module.split(".")[0] not in FORBIDDEN, (path, module)


def test_importing_the_port_leaves_jax_out():
    code = ("import sys; import cuda_path_tracer_ss_torch, "
            "cuda_path_tracer_ss_torch.cli, cuda_path_tracer_ss_torch.utils.build, "
            "cuda_path_tracer_ss_torch.ops.cuda.megakernel_vjp, "
            "cuda_path_tracer_ss_torch.ops.cuda.lightkernel, "
            "cuda_path_tracer_ss_torch.render.bidir, "
            "cuda_path_tracer_ss_torch.render.inverse, "
            "cuda_path_tracer_ss_torch.ops.texture, "
            "cuda_path_tracer_ss_torch.ops.grid, "
            "cuda_path_tracer_ss_torch.utils.obj, "
            "cuda_path_tracer_ss_torch.render.integrator, "
            "cuda_path_tracer_ss_torch.render.lighttrace, "
            "cuda_path_tracer_ss_torch.render.silhouette, "
            "cuda_path_tracer_ss_torch.utils.debug, "
            "cuda_path_tracer_ss_torch.utils.profiling, "
            "cuda_path_tracer_ss_torch.parallel.mesh, "
            "cuda_path_tracer_ss_torch.parallel.sharding, "
            "cuda_path_tracer_ss_torch.parallel.dryrun; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}]; print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_kernel_sources_avoid_fast_math_and_torch_headers():
    from cuda_path_tracer_ss_torch.utils import build

    flags = " ".join(build.NVCC_FLAGS)
    assert "fast_math" not in flags and "fmad" not in flags  # -fmad is per build
    assert "arch=compute_90a,code=sm_90a" in flags
    assert set(build.CUDA_SOURCES.values()) | set(build.HEADERS) == set(KERNEL_SOURCES)
    for src in KERNEL_SOURCES:
        with open(os.path.join(PORT, "csrc", src)) as f:
            text = f.read()
        assert "torch/" not in text and "ATen" not in text


def test_backward_kernel_replays_with_the_forward_kernel_s_functions():
    """The replay must walk the forward's paths: it includes megakernel.cuh
    and defines none of its device functions anew."""
    with open(os.path.join(PORT, "csrc", "megakernel_vjp.cuh")) as f:
        text = f.read()
    assert '#include "megakernel.cuh"' in text
    for fn in ("intersect_sweep", "occlusion_sweep", "scatter_sample", "uniform_pair",
               "eye_ray_raw", "rotate_y_to", "sphere_t", "triangle_t"):
        assert fn + "(" in text or fn in ("sphere_t", "triangle_t"), fn
        assert "void " + fn + "(" not in text and "bool " + fn + "(" not in text \
            and "Hit " + fn + "(" not in text, fn


def test_light_kernel_traces_with_the_forward_kernel_s_functions():
    """Light paths and eye paths must evaluate the same sweeps, scatter
    cascade, light geometry and chain model: lightkernel.cuh includes
    megakernel.cuh and defines none of those anew."""
    with open(os.path.join(PORT, "csrc", "lightkernel.cuh")) as f:
        text = f.read()
    assert '#include "megakernel.cuh"' in text
    for fn in ("intersect_sweep", "occlusion_sweep", "scatter_sample", "uniform_pair",
               "al_light_geom", "al_sample_point", "chain_model_taken", "camera_j_img"):
        assert fn + "(" in text, fn
        for kind in ("void ", "bool ", "float ", "Hit ", "LightGeom "):
            assert kind + fn + "(" not in text, fn


def test_chip_smoke_drives_both_kernels():
    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        text = f.read()
    for needle in ("mk.LAUNCH_COUNT = 0", "vjp.LAUNCH_COUNT = 0", "megakernel_vjp.cu",
                   "lk.LAUNCH_COUNT = 0", "lightkernel.cu", '"platform": "gpu"'):
        assert needle in text, needle
