"""``spectavi_tpu_torch.features`` — keypoint detection and description.

Same public API as ``spectavi_tpu.features``: ``sift_filter``,
``sift_filter_batch``, ``sift_filter_batch_device``,
``sift_filter_striped``, ``normalize_to_ubyte_and_multiple_16_dim``.
"""
from spectavi_tpu_torch.features.normalize import (  # noqa: F401
    normalize_to_ubyte_and_multiple_16_dim,
    normalize_to_ubyte_device,
)
from spectavi_tpu_torch.features.sift import (  # noqa: F401
    sift_filter,
    sift_filter_batch,
    sift_filter_batch_device,
    sift_filter_striped,
)
