"""pairs_s.sfm: seconds a multi-view job in the batched pair step
(K1, the ratio test and RANSAC of every pair)."""

SPANS = {"pairs": ["spectavi_tpu_torch.pipeline.sfm:_match_pairs_batched"]}


def read(run):
    return run.spans.mean("pairs", run.jobs)
