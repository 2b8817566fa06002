"""``spectavi_tpu_torch.match`` — nearest-neighbour descriptor matching.

Same public names as ``spectavi_tpu.match``: ``nn_bruteforce``,
``nn_bruteforcel1k2``, ``nn_l2k2``, ``nn_cascading_hash``,
``nn_kmedians``, ``nn_ivf`` and ``ann_hnswlib`` (sharded exact L2, as
:func:`ann`).  Every function takes ``device="cuda"`` and raises
without a card; numpy in, numpy out.
"""

from spectavi_tpu_torch.match.ann import ann, ann_hnswlib  # noqa: F401
from spectavi_tpu_torch.match.bruteforce import (  # noqa: F401
    l1_topk2_xla,
    nn_bruteforce,
    nn_bruteforcel1k2,
    nn_l2k2,
)
from spectavi_tpu_torch.match.cascade_hash import nn_cascading_hash  # noqa: F401
from spectavi_tpu_torch.match.ivf import nn_ivf  # noqa: F401
from spectavi_tpu_torch.match.kmedians import kmedians, nn_kmedians  # noqa: F401
