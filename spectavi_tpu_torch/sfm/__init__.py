"""``spectavi_tpu_torch.sfm`` — pose graph, PnP registration and bundle
adjustment, on one card or with the observations sharded over a process
mesh (``make_sharded_ba_step``), with the public names of
``spectavi_tpu.sfm``."""
from spectavi_tpu_torch.sfm.ate import ate_rmse, camera_centers, umeyama  # noqa: F401
from spectavi_tpu_torch.sfm.bundle_adjust import (  # noqa: F401
    ba_cost,
    ba_step,
    bundle_adjust,
    bundle_adjust_device,
    rodrigues,
    rotation_to_rvec,
)
from spectavi_tpu_torch.sfm.checkpoint import load_sfm_state, save_sfm_state  # noqa: F401
from spectavi_tpu_torch.sfm.distributed import (  # noqa: F401
    make_sharded_ba_step,
    pad_observations,
)
from spectavi_tpu_torch.sfm.pose_graph import (  # noqa: F401
    build_tracks,
    chain_poses,
    tracks_to_observations,
    triangulate_nview,
)
from spectavi_tpu_torch.sfm.resection import (  # noqa: F401
    incremental_poses,
    pnp_ransac,
    pnp_ransac_batch,
)
