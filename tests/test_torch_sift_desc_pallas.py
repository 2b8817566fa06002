"""Port parity: the plain version of the SIFT descriptor kernel
(``csrc/sift_desc.cu``) against the JAX package's Pallas descriptor
kernel in interpret mode, on the inputs of ``tests/test_sift.py``'s
kernel test (every window inside the Pallas patch).  Tolerance: atol
2e-5 relative to each row's maximum.  Kept in its own file because the
interpret-mode kernel takes most of a minute on the CPU.
"""

import jax.numpy as jnp
import numpy as np
import torch

from spectavi_tpu.ops import sift_desc as jdesc
from spectavi_tpu_torch.features.sift import _r_desc
from spectavi_tpu_torch.ops import sift_desc
from test_torch_sift_kernels import _desc_inputs, _rel_close, _torch_args

torch.set_num_threads(2)


def test_desc_raw_plain_vs_pallas_interpret(rng):
    # 8 rows: one grid step of the interpret-mode kernel
    mod, ang, kx, ky, sig, th0, lvl, val = _desc_inputs(rng, rows=8)
    H, W = mod.shape[1:]
    yi = np.clip((np.round(ky).astype(np.int32) - 48) & ~7, 0, H - jdesc.PATCH_R)
    xi = np.clip((np.round(kx).astype(np.int32) - 44) & ~127, 0, W - jdesc.PATCH_C)
    want = np.asarray(jdesc.sift_descriptors_pallas(
        jnp.asarray(mod), jnp.asarray(ang), jnp.asarray(yi), jnp.asarray(xi),
        jnp.asarray(lvl), jnp.asarray(ky), jnp.asarray(kx), jnp.asarray(sig),
        jnp.asarray(th0), jnp.asarray(val), interpret=True,
    ))
    got = sift_desc.desc_raw_plain(
        *_torch_args(mod, ang, kx, ky, sig, lvl, th0), torch.as_tensor(val > 0), _r_desc(3.0)
    ).numpy()
    _rel_close(got, want, val)
