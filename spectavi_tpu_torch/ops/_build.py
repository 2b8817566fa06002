"""Build and load the native code under ``csrc/``.

Each ``csrc/<name>.cu`` (a hand-written CUDA kernel) or
``csrc/<name>.cpp`` (host code, such as the JPEG codec) exposes a plain
C entry point and is compiled into its own shared library, loaded with
``ctypes``: a ``.cu`` by ``nvcc``, a ``.cpp`` by ``$CXX`` or else
``g++``.  The library's file name carries a hash of the source and the
flags, so an edited source is rebuilt and a stale library is never
loaded.  The build directory is ``build/kernels/`` beside the package
(git-ignored), or ``$SPECTAVI_TORCH_BUILD_DIR``.  :func:`build` compiles
every source in parallel, one compiler process per file, each into a
temporary file that is then renamed into place (so that concurrent
processes may build at once); :func:`load` builds on first use.  A
failed build raises with the compiler's log.
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

# host C++ (no CUDA), built with the host compiler
HOST_SOURCES = ("jpeg_host",)
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared")

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


def cxx_path():
    cxx = os.environ.get("CXX") or "g++"
    found = shutil.which(cxx)
    if found is None:
        raise RuntimeError(f"host C++ compiler {cxx!r} not found: set CXX or put g++ on PATH")
    return found


def _source(name):
    return CSRC / (f"{name}.cpp" if name in HOST_SOURCES else f"{name}.cu")


def _flags(name):
    return CXX_FLAGS if name in HOST_SOURCES else NVCC_FLAGS


def lib_path(name):
    src = _source(name).read_bytes()
    digest = hashlib.sha256(src + " ".join(_flags(name)).encode()).hexdigest()[:16]
    return build_dir() / f"{name}-{digest}.so"


def build(names=KERNELS, verbose=False):
    """Compile the named sources that are not built yet, all compiler
    processes started together.  Returns ``{name: compiler log}`` for
    the ones compiled now (with the ptxas report of each kernel when
    ``verbose``: ``-Xptxas -v``)."""
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        target = lib_path(name)
        if target.exists():
            continue
        tmp = target.with_suffix(f".tmp{os.getpid()}.so")
        if name in HOST_SOURCES:
            cmd = [cxx_path(), *CXX_FLAGS, "-o", str(tmp), str(_source(name))]
        else:
            cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(_source(name))]
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
            errors.append(f"{proc.args[0]} failed for {_source(name).name}:\n{log}")
            continue
        os.replace(tmp, target)
        reports[name] = log
    if errors:
        raise RuntimeError("\n".join(errors))
    return reports


def load(name):
    """The ``ctypes`` library of source ``name``, built on first use."""
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
