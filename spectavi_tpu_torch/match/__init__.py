"""``spectavi_tpu_torch.match`` — nearest-neighbour descriptor matching.

Only the exact L2 top-2 matcher of the two-view main path is ported so
far (``nn_l2k2``); the other matchers of ``spectavi_tpu.match`` are
listed in ROADMAP.md.
"""
from spectavi_tpu_torch.match.bruteforce import nn_l2k2  # noqa: F401
