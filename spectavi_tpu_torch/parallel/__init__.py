"""``spectavi_tpu_torch.parallel`` — the batched two-view step.

The JAX package's mesh layer (``parallel/mesh.py``, ``hosts.py``, the
sharded matchers) is not ported yet; on one card the pairs are a batch
dimension (:func:`spectavi_tpu_torch.parallel.two_view.make_two_view_step`).
"""
