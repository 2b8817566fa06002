"""``spectavi_tpu_torch.utils`` — the tracer and the native host-ops
library."""
from spectavi_tpu_torch.utils.profiling import (  # noqa: F401
    annotate,
    count,
    disable,
    enable,
    step,
    take,
    trace,
)
