"""``spectavi_tpu_torch.pipeline`` — the two-view reconstruction pipeline."""
from spectavi_tpu_torch.pipeline.io import Timer, imread, read_ply, read_txt_matrix, rgb_to_gray, write_ply  # noqa: F401
from spectavi_tpu_torch.pipeline.two_view import run_two_view, run_two_view_arrays  # noqa: F401
