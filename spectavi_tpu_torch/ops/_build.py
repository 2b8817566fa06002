"""Build and load the hand-written CUDA kernels under ``csrc/``.

Each ``csrc/<name>.cu`` exposes a plain C entry point and is compiled
by ``nvcc`` into its own shared library, loaded with ``ctypes``.  The
library's file name carries a hash of the source and the flags, so an
edited kernel is rebuilt and a stale one is never loaded.  The build
directory is ``build/kernels/`` beside the package (git-ignored), or
``$SPECTAVI_TORCH_BUILD_DIR``.  :func:`build` compiles every source in
parallel, one ``nvcc`` process per file; :func:`load` builds on first
use.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
KERNELS = ("l2nn_top2", "sift_orient", "sift_desc")
# -fmad=false: no contraction of a*b+c into one rounding, so every
# float operation of the sift kernels rounds as its plain-PyTorch
# counterpart (one elementwise op per rounding) does
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_libs = {}


def build_dir():
    env = os.environ.get("SPECTAVI_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return CSRC.parent.parent / "build" / "kernels"


def nvcc_path():
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def lib_path(name):
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return build_dir() / f"{name}-{digest}.so"


def build(names=KERNELS, verbose=False):
    """Compile the named kernels that are not built yet, all ``nvcc``
    processes started together.  Returns ``{name: ptxas report}`` for
    the ones compiled now when ``verbose`` (``-Xptxas -v``)."""
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        target = lib_path(name)
        if target.exists():
            continue
        tmp = target.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        if verbose:
            cmd[1:1] = ["-Xptxas", "-v"]
        procs[name] = (
            subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, target,
        )
    reports, errors = {}, []
    for name, (proc, tmp, target) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu:\n{log}")
            continue
        os.replace(tmp, target)
        reports[name] = log
    if errors:
        raise RuntimeError("\n".join(errors))
    return reports


def load(name):
    """The ``ctypes`` library of kernel ``name``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build((name,))
            lib = ctypes.CDLL(str(lib_path(name)))
            _libs[name] = lib
        return lib


def check(status, name):
    """Raise if a kernel's C entry point reported a CUDA error."""
    if status != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {status}")
