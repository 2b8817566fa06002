"""``spectavi_tpu_torch.parallel`` — process meshes, sharded matching
and distributed execution over ``torch.distributed`` (one process per
GPU).  Without a mesh, the two-view step runs on one card with the
pairs as a batch dimension
(:func:`spectavi_tpu_torch.parallel.two_view.make_two_view_step`)."""
from spectavi_tpu_torch.parallel.hosts import initialize, local_device_slice  # noqa: F401
from spectavi_tpu_torch.parallel.mesh import (  # noqa: F401
    BLOCKS,
    PAIRS,
    host_cpu_mesh,
    local_shard,
    make_mesh,
)
from spectavi_tpu_torch.parallel.two_view import (  # noqa: F401
    gather_pairs,
    make_two_view_step,
    sharded_l1_topk2,
    sharded_l2_topk2,
)
