"""The port's own loader of the native host-ops library
(``spectavi_tpu_torch.utils.hostops``) against the JAX package's
(``spectavi_tpu.utils.hostops``): both call ``native/libspectavi_hostops.so``,
so their outputs must be identical, and the exact L1 top-2 must give
the distances of the port's ``l1_topk2_xla``.  The port's loader is a
copy, not an import of the JAX module."""

import os

import numpy as np
import torch

from spectavi_tpu.utils import hostops as jhost
from spectavi_tpu_torch.utils import hostops as thost

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tie_free(rng, n, d):
    """Random bytes whose first and second L1 neighbours never tie."""
    while True:
        x = rng.integers(0, 256, (n, d)).astype(np.uint8)
        y = rng.integers(0, 256, (n // 4, d)).astype(np.uint8)
        dist = np.abs(y[:, None, :].astype(np.int64) - x[None].astype(np.int64)).sum(-1)
        s = np.sort(dist, 1)
        if (s[:, 0] < s[:, 1]).all() and (s[:, 1] < s[:, 2]).all():
            return x, y


def test_loader_is_the_ports_own():
    assert thost._NATIVE_DIR == os.path.join(ROOT, "native")
    assert "spectavi_tpu." not in open(thost.__file__).read().replace(
        "spectavi_tpu/utils/hostops.py", "")


def test_l1k2_nn_cpu_vs_jax_wrapper(rng):
    from spectavi_tpu_torch.match import l1_topk2_xla

    x, y = _tie_free(rng, 400, 128)
    ti, td = thost.l1k2_nn_cpu(x, y, nthreads=2)
    ji, jd = jhost.l1k2_nn_cpu(x, y, nthreads=2)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(td, jd)
    pi, pd = (t.numpy() for t in l1_topk2_xla(x, y, device="cpu"))
    np.testing.assert_array_equal(td, pd)
    np.testing.assert_array_equal(ti, pi)


def test_l1k2_nn_cpu_scalar_vs_jax_wrapper(rng):
    x, y = _tie_free(rng, 300, 48)
    ti, td = thost.l1k2_nn_cpu_scalar(x.astype(np.float32), y.astype(np.float32), nthreads=2)
    ji, jd = jhost.l1k2_nn_cpu_scalar(x.astype(np.float32), y.astype(np.float32), nthreads=2)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(td, jd)


def test_sift_cpu_vs_jax_wrapper():
    from spectavi_tpu_torch.pipeline.io import imread

    im = imread(os.path.join(ROOT, "artifacts", "round2", "synth_view00.png"), dtype="float32",
                force_grayscale=True)
    rows = thost.sift_cpu(im, nthreads=2)
    assert rows.shape[0] > 100 and rows.shape[1] == 132
    np.testing.assert_array_equal(rows, jhost.sift_cpu(im, nthreads=2))
