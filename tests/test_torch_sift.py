"""Port parity: ``sift_filter_batch(device="cpu")`` of the port against
the JAX package's ``sift_filter_batch`` on ``artifacts/round2/
synth_view00.png`` (and on the rendered 120x160 pair, in
``test_torch_two_view.py``, which shares the JAX side's compiles).

The agreement is not bit-exact: libm's ``exp``, ``atan2`` and ``sin``/
``cos`` differ from XLA:CPU's own implementations, XLA fuses
multiply-adds and sums in another order, and the float32 Newton
refinement amplifies those last-bit differences on ill-conditioned
extrema.  So each JAX keypoint must have a port keypoint within 0.01 px
and 1e-3 rad for at least 99% of the keypoints, and the matched
descriptors must agree to 1 LSB in at least 99% of their bytes.
"""

import jax
import numpy as np
import pytest
import torch
from PIL import Image
from scipy.spatial import cKDTree

from spectavi_tpu.features.sift import sift_filter_batch as jax_sift_filter_batch
from spectavi_tpu_torch.features.sift import sift_filter, sift_filter_batch

torch.set_num_threads(2)


def _agreement(ref, got):
    """Fraction of ``ref`` rows with a ``got`` row within 0.01 px and
    1e-3 rad, and the fraction of matched descriptor bytes within 1 LSB."""
    tree = cKDTree(got[:, :2])
    near = tree.query_ball_point(ref[:, :2], r=0.01)
    matched, within = 0, []
    for i, cand in enumerate(near):
        if not cand:
            continue
        cand = np.asarray(cand)
        dang = np.abs((got[cand, 3] - ref[i, 3] + np.pi) % (2 * np.pi) - np.pi)
        if dang.min() < 1e-3:
            matched += 1
            within.append(np.abs(got[cand[np.argmin(dang)], 4:] - ref[i, 4:]) <= 1)
    return matched / len(ref), np.mean(within)


def _check(ims):
    refs = jax_sift_filter_batch(ims)
    gots = sift_filter_batch(ims, device="cpu")
    for ref, got in zip(refs, gots):
        assert got.dtype == np.float32 and got.shape[1] == 132
        assert abs(len(got) - len(ref)) <= 0.01 * len(ref)
        kp_frac, byte_frac = _agreement(ref, got)
        assert kp_frac >= 0.99, kp_frac
        assert byte_frac >= 0.99, byte_frac
        assert np.all(got[:, 4:] == np.floor(got[:, 4:])) and got[:, 4:].max() <= 255


def test_sift_synth_view00():
    # two 120x160 tiles of the 480x640 view, one batch: the shapes of the
    # rendered pair in test_torch_two_view.py, so the JAX side compiles
    # its SIFT programs once for both files in one process
    im = np.asarray(Image.open("artifacts/round2/synth_view00.png")).astype(np.float32)
    im = im / im.max()
    _check([im[120:240, 160:320], im[240:360, 320:480]])


def test_sift_rejects_3d_and_blank():
    with pytest.raises(TypeError):
        sift_filter(np.zeros((4, 4, 3)), device="cpu")
    assert sift_filter(np.zeros((64, 64), np.float32), device="cpu").shape == (0, 132)


def _view00_tiles():
    im = np.asarray(Image.open("artifacts/round2/synth_view00.png")).astype(np.float32)
    im = im / im.max()
    return im, [im[120:240, 160:320], im[240:360, 320:480]]


def _host_form_case(name):
    """``(JAX rows, port rows)`` of one host-form SIFT entry point on
    crops of ``synth_view00.png``."""
    from spectavi_tpu.features import sift as jsift
    from spectavi_tpu_torch.features import sift as tsift

    im, tiles = _view00_tiles()
    if name == "sift_filter_striped":
        # 3 bands with 20-row halos over a 160x320 crop
        crop = im[160:320, 160:480]
        return ([jsift.sift_filter_striped(crop, nthread=3)],
                [tsift.sift_filter_striped(crop, nthread=3, device="cpu")])
    # descriptors left on the device, reassembled into host rows
    refs = jsift.sift_filter_batch_device(tiles)
    gots = tsift.sift_filter_batch_device(tiles, device="cpu")
    for r, g in zip(refs, gots):
        assert g["meta"].shape[1] == 4 and g["desc"].dtype == torch.uint8
        assert isinstance(g["desc"], torch.Tensor) and g["desc"].device.type == "cpu"
    join = lambda o, d: np.concatenate([o["meta"], np.asarray(d, np.float32)], axis=1)
    return ([join(r, r["desc"]) for r in refs], [join(g, g["desc"].numpy()) for g in gots])


@pytest.mark.parametrize("name", ["sift_filter_striped", "sift_filter_batch_device"])
def test_host_forms_vs_jax(name):
    refs, gots = _host_form_case(name)
    for ref, got in zip(refs, gots):
        assert len(ref) >= 100
        assert abs(len(got) - len(ref)) <= 0.01 * len(ref)
        kp_frac, byte_frac = _agreement(ref, got)
        assert kp_frac >= 0.99, kp_frac
        assert byte_frac >= 0.99, byte_frac


def test_detect_refine_vs_jax():
    from scipy.ndimage import gaussian_filter

    from spectavi_tpu.features import sift as jsift
    from spectavi_tpu_torch.features import sift as tsift

    # a DoG-like stack (S + 2 = 5 levels) of smoothed noise, with more
    # extrema than max_kp so that the saliency ladder selects
    rng = np.random.default_rng(11)
    dog = gaussian_filter(rng.standard_normal((5, 96, 128)), (0.8, 2.0, 2.0)).astype(np.float32)
    for max_kp in (4096, 64):
        ref = {k: np.asarray(v) for k, v in jsift.detect_refine(
            jax.numpy.asarray(dog), 0.01, 10.0, max_kp).items()}
        got = {k: v.numpy() for k, v in tsift.detect_refine(
            torch.as_tensor(dog), 0.01, 10.0, max_kp).items()}
        assert set(ref) <= set(got)
        v = ref["valid"]
        assert 30 <= v.sum() <= max_kp
        np.testing.assert_array_equal(got["valid"], v)
        np.testing.assert_array_equal(got["is_"][v], ref["is_"][v])
        for k in ("x", "y"):
            np.testing.assert_allclose(got[k][v], ref[k][v], rtol=0, atol=0.01)
        np.testing.assert_allclose(got["s"][v], ref["s"][v], rtol=0, atol=1e-3)
