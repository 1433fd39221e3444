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


def _port_files():
    files = [os.path.join(ROOT, "chip_smoke.py")]
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
                 "cuda_path_tracer_ss_torch/render/renderer.py",
                 "cuda_path_tracer_ss_torch/utils/build.py"):
        assert want in names
    for src in ("megakernel.cu", "megakernel.cuh"):
        assert os.path.isfile(os.path.join(PORT, "csrc", src))


@pytest.mark.parametrize("path", [os.path.relpath(p, ROOT) for p in _port_files()])
def test_no_jax_import(path):
    for module in _imported_modules(os.path.join(ROOT, path)):
        assert module.split(".")[0] not in FORBIDDEN, (path, module)


def test_importing_the_port_leaves_jax_out():
    code = ("import sys; import cuda_path_tracer_ss_torch, "
            "cuda_path_tracer_ss_torch.cli, cuda_path_tracer_ss_torch.utils.build; "
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
    for src in ("megakernel.cu", "megakernel.cuh"):
        with open(os.path.join(PORT, "csrc", src)) as f:
            text = f.read()
        assert "torch/" not in text and "ATen" not in text
