"""The package's one build cache for shared libraries built from sources.

The counterpart of the reference's persistent compilation cache: there the
JAX executables outlive the process; here the libraries that ``nvcc`` (the
kernels) and the host C++ compiler (``native.py``; the tests' host build of
the kernel math) make from sources do. Every library the package builds goes
through :func:`cached_library`.

* **The key.** A library lands under ``<stem>_<hash>.so``, the hash a sha256
  over the compiler's ``--version`` output, its flags, and the bytes of every
  source and of every header it may include (the headers in the sources'
  directories and in each ``-I`` directory). Only a library built from the
  same inputs by the same compiler loads; there is no switch to turn the
  cache off, since a stale library cannot match.
* **One compile.** The first use takes an exclusive ``flock`` on
  ``<stem>_<hash>.lock`` beside it: concurrent first uses in other threads
  or processes wait for one compile and load its result. A process that
  dies holding the lock releases it with its descriptor.
* **Atomic writes.** The compiler writes to a temporary name in the same
  directory, which is renamed into place; its messages go to
  ``<library>.log`` (``utils.build.ptxas_report`` reads them). A failed build
  raises with the compiler's output and leaves no library behind; nothing
  falls back.
* **The directory.** ``$CPT_TORCH_BUILD_DIR`` if set, else the package's
  git-ignored ``build/``.
"""
from __future__ import annotations

import fcntl
import hashlib
import os
import subprocess
import tempfile
from typing import Dict, List, Sequence, Tuple

ENV_DIR = "CPT_TORCH_BUILD_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "build")
HEADER_SUFFIXES = (".h", ".hh", ".hpp", ".cuh", ".inc")

_versions: Dict[Tuple[str, int, int], bytes] = {}


def cache_dir() -> str:
    """Where the libraries live: ``$CPT_TORCH_BUILD_DIR`` or the package's
    ``build/``."""
    return os.environ.get(ENV_DIR) or DEFAULT_DIR


def compiler_version(compiler: str) -> bytes:
    """The compiler's ``--version`` output, read once per compiler file."""
    st = os.stat(compiler)
    key = (os.path.realpath(compiler), st.st_mtime_ns, st.st_size)
    if key not in _versions:
        proc = subprocess.run([compiler, "--version"], capture_output=True)
        if proc.returncode != 0:
            raise RuntimeError(f"{compiler} --version failed (exit "
                               f"{proc.returncode}): {proc.stderr.decode()}")
        _versions[key] = proc.stdout
    return _versions[key]


def included_headers(flags: Sequence[str], sources: Sequence[str]) -> List[str]:
    """Every header a build may include: the header files in the sources'
    directories and in the ``-I`` directories of ``flags``, sorted."""
    dirs = {os.path.dirname(os.path.abspath(s)) for s in sources}
    flags = list(flags)
    for i, f in enumerate(flags):
        if f == "-I" and i + 1 < len(flags):
            dirs.add(os.path.abspath(flags[i + 1]))
        elif f.startswith("-I") and len(f) > 2:
            dirs.add(os.path.abspath(f[2:]))
    return sorted(os.path.join(d, n) for d in dirs if os.path.isdir(d)
                  for n in os.listdir(d) if n.endswith(HEADER_SUFFIXES))


def library_key(compiler: str, flags: Sequence[str], sources: Sequence[str]) -> str:
    """The hash that names the library of these inputs."""
    h = hashlib.sha256()
    h.update(compiler_version(compiler) + b"\0")
    h.update("\0".join(flags).encode() + b"\0\0")
    for path in list(sources) + included_headers(flags, sources):
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + b"\0" + f.read() + b"\0")
    return h.hexdigest()[:16]


def cached_library(compiler: str, flags: Sequence[str], sources: Sequence[str],
                   stem: str) -> str:
    """Path of the library that ``compiler flags -o <lib> sources`` makes,
    compiled at its first use (under the lock) and found in the cache ever
    after."""
    directory = cache_dir()
    out = os.path.join(directory, f"{stem}_{library_key(compiler, flags, sources)}.so")
    if os.path.isfile(out):
        return out
    os.makedirs(directory, exist_ok=True)
    with open(out[:-len(".so")] + ".lock", "a") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)    # released when the file closes
        if os.path.isfile(out):             # another process built it
            return out
        fd, tmp = tempfile.mkstemp(suffix=".so.tmp", prefix=stem + "_",
                                   dir=directory)
        os.close(fd)
        cmd = [compiler, *flags, "-o", tmp, *sources]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"build failed (exit {proc.returncode}): {' '.join(cmd)}\n"
                    f"{proc.stdout}\n{proc.stderr}")
            with open(out + ".log", "w") as f:
                f.write(proc.stderr)
            os.replace(tmp, out)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return out
