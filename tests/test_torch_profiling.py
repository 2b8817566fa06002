"""``spectavi_tpu_torch.utils.profiling`` and ex01's ``--trace DIR``,
the port of ``spectavi_tpu/utils/profiling.py`` (``jax.profiler``
becomes ``torch.profiler``, plus NVTX ranges on CUDA)."""

import glob

import torch

torch.set_num_threads(2)


def test_trace_writes_the_annotated_span(tmp_path):
    from spectavi_tpu_torch.utils import annotate, trace

    with trace(str(tmp_path / "prof")):
        with annotate("step"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    files = glob.glob(str(tmp_path / "prof" / "*.pt.trace.json"))
    assert len(files) == 1
    assert '"step"' in open(files[0]).read()


def test_ex01_parses_trace(tmp_path, monkeypatch):
    from spectavi_tpu_torch.pipeline import ex01

    seen = {}

    def fake_run(images, K, **kw):
        seen.update(kw, images=images, profiled=torch.autograd._profiler_enabled())
        torch.arange(10).sum()

    monkeypatch.setattr(ex01, "run_two_view", fake_run)
    logdir = tmp_path / "trace"
    ex01.main(["a.png", "b.png", "K.txt", "--device", "cpu", "--trace", str(logdir)])
    assert seen["images"] == ["a.png", "b.png"] and seen["device"] == "cpu"
    assert seen["profiled"]
    assert len(glob.glob(str(logdir / "*.pt.trace.json"))) == 1
    # without --trace the run is not profiled
    seen.clear()
    ex01.main(["a.png", "b.png", "K.txt", "--device", "cpu"])
    assert seen["images"] == ["a.png", "b.png"] and not seen["profiled"]
