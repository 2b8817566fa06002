"""frontend_s.pair: seconds a two-view job in the fused front end
(SIFT with K2 and K3, quantisation, K1 and the ratio test)."""

SPANS = {"frontend": ["spectavi_tpu_torch.pipeline.two_view:step12_fused_device"]}


def read(run):
    return run.spans.mean("frontend", run.jobs)
