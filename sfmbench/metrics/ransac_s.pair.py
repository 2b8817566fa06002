"""ransac_s.pair: seconds a two-view job in step 3 (essential-matrix
RANSAC on the calibrated matches)."""

SPANS = {"ransac": ["spectavi_tpu_torch.pipeline.two_view:step3_estimate_essential"]}


def read(run):
    return run.spans.mean("ransac", run.jobs)
