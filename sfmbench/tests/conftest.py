"""Shared fixtures of the benchmark's tests.

``card`` marks a test that needs a CUDA card; the ``card`` fixture
decides at run time, never at import, and skips where there is none.
Run the card's tests on a machine with one:

    python3 -m pytest sfmbench/tests -m card
"""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card on this machine")
    return torch.device("cuda", 0)


@pytest.fixture(autouse=True)
def _few_threads():
    import torch

    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def tiny_bench(tmp_path):
    """``make(overrides)``: the repository's ``BENCHMARK.json`` with each
    configuration's file replaced by a copy under ``tmp_path`` whose
    keys are updated from ``overrides[config name]`` (nested groups
    merged), for small runs on the CPU."""
    import json

    from sfmbench import harness

    def make(overrides):
        bench = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
        for c in bench["configs"]:
            cfg = harness.load_json(os.path.join(ROOT, c["file"]))
            for k, v in overrides.get(c["name"], {}).items():
                if isinstance(v, dict) and isinstance(cfg.get(k), dict):
                    cfg[k] = dict(cfg[k], **v)
                else:
                    cfg[k] = v
            path = tmp_path / (c["name"] + ".json")
            path.write_text(json.dumps(cfg))
            c["file"] = str(path)
        return bench

    return make


@pytest.fixture
def tiny():
    """Sizes at which the CPU runs the cells' paths in seconds.  The
    CPU's "auto" matcher is the cascade hash, so the two-view cell takes
    the exact L2 matcher that "auto" is on the card, and the multi-view
    cell the batched pair step that "auto" is there."""
    return {
        "strecha-castle-3072x2048": {"height": 240, "width": 320, "texture": [50, 70],
                                     "settings": {"matching_method": "l2-mxu"}},
        "tum-rgbd-640x480": {"height": 120, "width": 160, "texture": [25, 35],
                             "settings": {"pair_backend": "batched"}},
    }
