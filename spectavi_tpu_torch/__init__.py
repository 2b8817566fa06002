"""spectavi_tpu_torch — the PyTorch/CUDA port of ``spectavi_tpu``.

Same layout and function names as the JAX package (``mvg``,
``features``, ``match``, ``ops``, ``sfm``, ``parallel``, ``pipeline``);
plain tensor code is
PyTorch, and every Pallas kernel of the JAX package is a hand-written
CUDA kernel for Hopper (``sm_90a``) under ``csrc/``, built with
``nvcc`` at first use (:mod:`spectavi_tpu_torch.ops._build`).

Entry points take ``device="cuda"`` by default and raise when CUDA is
absent; tests pass ``device="cpu"``, where every kernel wrapper runs
its plain PyTorch version.  Nothing here imports ``jax``.

Subpackages are not imported eagerly: ``import spectavi_tpu_torch``
only pins the matmul precision, and ``spectavi_tpu_torch.mvg`` (or any
other subpackage) is imported on its first access, so the attributes
that ``import spectavi_tpu`` binds are here too without touching CUDA.
"""

__version__ = "0.1.0"

import importlib as _importlib

import torch as _torch

# Full-f32 matmuls and convolutions, the counterpart of the JAX
# package's "highest" matmul precision pin: RANSAC thresholds sit at
# ~1e-4 in normalized coordinates, where TF32's ~3 decimal digits
# destroy the inlier decisions, and the matcher's float32 plain path is
# exact only without TF32.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False


def resolve_device(device="cuda"):
    """``torch.device`` for an entry point's ``device=`` argument.

    Raises ``RuntimeError`` for a CUDA device when CUDA is absent: the
    port never falls back to the CPU on its own."""
    dev = _torch.device(device)
    if dev.type == "cuda" and not _torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return dev


def seeded_generator(generator, device):
    """``generator`` itself, or when it is None a new ``torch.Generator``
    on ``device`` with seed 0: the matchers that draw random objects
    give the same answer on every call unless the caller says otherwise."""
    if generator is None:
        generator = _torch.Generator(device=device)
        generator.manual_seed(0)
    return generator


_SUBPACKAGES = ("features", "match", "mvg", "ops", "parallel", "pipeline", "sfm", "utils")


def __getattr__(name):
    if name in _SUBPACKAGES:
        return _importlib.import_module(f"{__name__}.{name}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(_SUBPACKAGES))
