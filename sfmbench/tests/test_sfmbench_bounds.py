"""The kernels' bound arithmetic on known shapes."""

import math

import numpy as np
import pytest
import torch

from sfmbench import bounds


def test_k1_is_bound_by_int8_operations_at_the_pair_shape():
    ms, by = bounds.k1_bound_ms(28000, 28000, 144)
    assert by == "operations"
    assert ms == pytest.approx(2.0 * 28000 * 28000 * 144 / 1979e12 * 1e3)
    assert ms == pytest.approx(0.11409, rel=1e-4)


def test_k1_is_bound_by_bytes_when_thin():
    ms, by = bounds.k1_bound_ms(2, 1000, 16)
    assert by == "bytes"
    assert ms == pytest.approx(((2 + 1000) * 16 + 1000 * 16) / 3.35e12 * 1e3)


def test_window_pixels_clip_to_the_octave():
    px = bounds.window_pixels(10, 10, np.array([0.0, 5.0]), np.array([0.0, 5.0]), np.array([2, 2]))
    assert px.tolist() == [9, 25]


def test_k2_counts_each_rows_disc():
    sigma = np.array([1.0, 2.0])
    ms, by = bounds.k2_bound_ms(3, 100, 100, np.zeros(2), np.zeros(2), sigma)
    Wr = np.maximum(np.floor(4.5 * sigma), 1.0)
    px = np.pi * (Wr * Wr + 0.6)
    nbytes = px.sum() * 8 + 2 * (5 * 4 + 36 * 4)
    want = max(nbytes / 3.35e12, 16.0 * px.sum() / 67e12) * 1e3
    assert ms == pytest.approx(want)
    assert by == ("operations" if 16.0 * px.sum() / 67e12 >= nbytes / 3.35e12 else "bytes")


def test_k3_counts_each_rows_box():
    sigma = np.array([1.5])
    ms, _ = bounds.k3_bound_ms(3, 500, 500, np.array([250.0]), np.array([250.0]), sigma, R=39)
    r = min(math.floor(3.0 * 1.5 * 2.5 * math.sqrt(2.0) + 0.5 + 0.5), 39)
    px = (2 * r + 1) ** 2
    want = max((px * 8 + 6 * 4 + 128) / 3.35e12, 57.0 * px / 67e12) * 1e3
    assert ms == pytest.approx(want)


def test_launch_bound_reads_each_wrappers_arguments():
    x = torch.zeros((28000, 144), dtype=torch.uint8)
    assert bounds.launch_bound_ms("K1", (x, x)) == pytest.approx(bounds.k1_bound_ms(28000, 28000, 144)[0])
    mod = torch.zeros((3, 100, 100))
    kx = torch.tensor([10.0, 50.0])
    sig = torch.tensor([1.0, 2.0])
    k2 = bounds.launch_bound_ms("K2", (mod, mod, kx, kx, sig, None, None, 17))
    assert k2 == pytest.approx(bounds.k2_bound_ms(3, 100, 100, kx.numpy(), kx.numpy(), sig.numpy())[0])
    k3 = bounds.launch_bound_ms("K3", (mod, mod, kx, kx, sig, None, None, None, 39, 3.0))
    assert k3 == pytest.approx(bounds.k3_bound_ms(3, 100, 100, kx.numpy(), kx.numpy(), sig.numpy(), 39)[0])


def test_kernel_names_are_the_wrappers_of_the_port():
    import importlib

    for mod, attr, fns in bounds.KERNELS.values():
        assert callable(getattr(importlib.import_module(mod), attr))
        assert fns
