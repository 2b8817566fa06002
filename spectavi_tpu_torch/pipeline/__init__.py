"""``spectavi_tpu_torch.pipeline`` — end-to-end reconstruction pipelines."""
from spectavi_tpu_torch.pipeline.io import Timer, imread, read_ply, read_txt_matrix, rgb_to_gray, write_ply  # noqa: F401
from spectavi_tpu_torch.pipeline.two_view import run_two_view, run_two_view_arrays  # noqa: F401
from spectavi_tpu_torch.pipeline.sfm import run_sfm, run_sfm_arrays  # noqa: F401
