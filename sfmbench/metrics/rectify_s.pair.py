"""rectify_s.pair: seconds a two-view job in step 5 (rectification of
the RGB pair on the card)."""

SPANS = {"rectify": ["spectavi_tpu_torch.pipeline.two_view:step5_rectify"]}


def read(run):
    return run.spans.mean("rectify", run.jobs)
