"""sift_s.sfm: seconds a multi-view job in SIFT over its views and the
descriptor quantisation after it."""

SPANS = {"sift": ["spectavi_tpu_torch.features.sift:sift_filter_batch_device",
                  "spectavi_tpu_torch.features.normalize:normalize_to_ubyte_device"]}


def read(run):
    return run.spans.mean("sift", run.jobs)
