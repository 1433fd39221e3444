"""The port's build cache (utils/compile_cache.py) with the host compiler on a
tiny source: the key, one compile for concurrent first uses, failed builds,
the directory, and the kernels' builds going through it."""
import ctypes
import os
import shutil
import stat
import subprocess
import sys
import threading

import pytest

from cuda_path_tracer_ss_torch.utils import build, compile_cache

GXX = shutil.which("g++") or shutil.which("c++")
FLAGS = ["-O1", "-shared", "-fPIC"]


def _write(path, text):
    with open(path, "w") as f:
        f.write(text)
    return str(path)


def _wrapper(tmp_path, name, version="wrapped 1", sleep=0.0):
    """A compiler that prints ``version`` for --version and otherwise
    appends a line to ``<name>.count`` and runs the host compiler."""
    count = tmp_path / f"{name}.count"
    script = _write(tmp_path / name, f"""#!/bin/sh
if [ "$1" = "--version" ]; then echo "{version}"; exit 0; fi
echo compile >> "{count}"
sleep {sleep}
exec "{GXX}" "$@"
""")
    os.chmod(script, os.stat(script).st_mode | stat.S_IEXEC)
    return script, count


def _compiles(count):
    return len(count.read_text().splitlines()) if count.exists() else 0


@pytest.fixture
def project(tmp_path, monkeypatch):
    """A source including a header in its directory; the cache under
    tmp_path."""
    src_dir = tmp_path / "src"
    src_dir.mkdir()
    _write(src_dir / "t.h", "#define ANSWER 42\n")
    source = _write(src_dir / "t.cpp", '#include "t.h"\nextern "C" int answer() { return ANSWER; }\n')
    monkeypatch.setenv(compile_cache.ENV_DIR, str(tmp_path / "cache"))
    return tmp_path, source


@pytest.mark.parametrize("change", ["source", "header", "flag", "compiler_version"])
def test_every_input_is_in_the_key(project, change):
    tmp_path, source = project
    compiler, count = _wrapper(tmp_path, "cc1")
    first = compile_cache.cached_library(compiler, FLAGS, [source], "libt")
    assert compile_cache.cached_library(compiler, FLAGS, [source], "libt") == first
    assert _compiles(count) == 1
    flags = FLAGS
    if change == "source":
        _write(source, open(source).read() + "// one more byte\n")
    elif change == "header":
        _write(os.path.join(os.path.dirname(source), "t.h"), "#define ANSWER 43\n")
    elif change == "flag":
        flags = FLAGS + ["-DX"]
    else:
        compiler, count = _wrapper(tmp_path, "cc2", version="wrapped 2")
    second = compile_cache.cached_library(compiler, flags, [source], "libt")
    assert second != first and os.path.isfile(first) and os.path.isfile(second)
    assert _compiles(count) == (1 if change == "compiler_version" else 2)
    want = 43 if change == "header" else 42
    assert ctypes.CDLL(second).answer() == want


_CHILD = """
import importlib.util, sys
spec = importlib.util.spec_from_file_location("cc", sys.argv[1])
cc = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cc)
print(cc.cached_library(sys.argv[2], sys.argv[3].split(","), [sys.argv[4]], "libt"))
"""


def test_concurrent_first_uses_compile_once(project):
    """Eight threads and two processes ask for one library at once; the
    compiler (slowed so that they all arrive during the compile) runs once
    and everyone gets the same file."""
    tmp_path, source = project
    compiler, count = _wrapper(tmp_path, "slow", sleep=1.0)
    procs = [subprocess.Popen(
        [sys.executable, "-c", _CHILD, compile_cache.__file__, compiler,
         ",".join(FLAGS), source], stdout=subprocess.PIPE, text=True,
        env=dict(os.environ)) for _ in range(2)]
    paths, errors = [], []

    def use():
        try:
            paths.append(compile_cache.cached_library(compiler, FLAGS, [source], "libt"))
        except Exception as e:  # read on the main thread below
            errors.append(e)

    threads = [threading.Thread(target=use) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    outs = [p.communicate(timeout=60)[0].strip() for p in procs]
    assert not errors and [p.returncode for p in procs] == [0, 0]
    assert len(set(paths + outs)) == 1 and len(paths) == 8
    assert _compiles(count) == 1
    cache = tmp_path / "cache"
    assert sorted(p.suffix for p in cache.iterdir()) == [".lock", ".log", ".so"]


def test_failed_build_raises_and_leaves_nothing(project):
    tmp_path, source = project
    _write(source, 'extern "C" int answer() { return ; }\n')
    with pytest.raises(RuntimeError, match="error") as e:
        compile_cache.cached_library(GXX, FLAGS, [source], "libt")
    assert "build failed" in str(e.value)
    left = [p.name for p in (tmp_path / "cache").iterdir()]
    assert not [n for n in left if n.endswith((".so", ".tmp", ".log"))], left


def test_the_directory_follows_its_variable_only(project, monkeypatch):
    """CPT_TORCH_BUILD_DIR moves the cache, whatever the reference's
    CPT_NO_COMPILE_CACHE says; unset, the cache is the package's build/."""
    tmp_path, source = project
    monkeypatch.setenv("CPT_NO_COMPILE_CACHE", "1")
    elsewhere = tmp_path / "elsewhere"
    monkeypatch.setenv(compile_cache.ENV_DIR, str(elsewhere))
    path = compile_cache.cached_library(GXX, FLAGS, [source], "libt")
    assert os.path.dirname(path) == str(elsewhere) and os.path.isfile(path)
    monkeypatch.delenv(compile_cache.ENV_DIR)
    package = os.path.dirname(os.path.dirname(os.path.abspath(build.__file__)))
    assert compile_cache.cache_dir() == os.path.join(package, "build")


def test_kernel_libraries_build_through_the_cache(project, monkeypatch):
    """build.load_kernels' path is the cache's, keyed on nvcc's version and
    every csrc/ header; ptxas_report reads the compiler's log beside it. A
    stand-in nvcc (this machine has none) writes the library and prints
    what ptxas -v prints."""
    tmp_path, _ = project
    bin_dir = tmp_path / "cuda" / "bin"
    bin_dir.mkdir(parents=True)
    nvcc = _write(bin_dir / "nvcc", """#!/bin/sh
if [ "$1" = "--version" ]; then echo "nvcc stand-in"; exit 0; fi
while [ "$1" != "-o" ]; do shift; done
echo library > "$2"
echo "ptxas info    : Compiling entry function 'render_kernel' for 'sm_90a'" >&2
echo "ptxas info    : Function properties for render_kernel" >&2
echo "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads" >&2
echo "ptxas info    : Used 90 registers" >&2
""")
    os.chmod(nvcc, os.stat(nvcc).st_mode | stat.S_IEXEC)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    assert build.find_nvcc() == nvcc
    path = build._library_path("megakernel", False)
    assert os.path.dirname(path) == str(tmp_path / "cache")
    assert os.path.basename(path).startswith("libcpt_megakernel_")
    assert path == compile_cache.cached_library(
        nvcc, build.NVCC_FLAGS + ("-fmad=false",),
        [os.path.join(build.CSRC_DIR, "megakernel.cu")], "libcpt_megakernel")
    assert build._library_path("megakernel", True) != path
    assert build.ptxas_report("megakernel") == [{
        "kernel": "render_kernel", "stack": 0, "spill_stores": 0,
        "spill_loads": 0, "registers": 90}]
