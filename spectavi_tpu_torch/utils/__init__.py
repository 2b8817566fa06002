"""``spectavi_tpu_torch.utils`` — profiling and the native host-ops
library."""
from spectavi_tpu_torch.utils.profiling import annotate, trace  # noqa: F401
