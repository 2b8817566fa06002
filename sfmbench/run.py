"""Run one cell of the benchmark once and print its result line.

    python3 sfmbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout that holds the port
(``spectavi_tpu_torch``) on a machine with the CUDA cards the cell asks
for; see ``sfmbench/README.md``.
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

if __name__ == "__main__":
    # every build and kernel cache at a fixed path inside the checkout,
    # so that only a checkout's first run builds
    build = os.path.join(ROOT, "build")
    os.environ["SPECTAVI_TORCH_BUILD_DIR"] = os.path.join(build, "kernels")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton")
    os.environ["USE_FLAX"] = "0"
    sys.path.insert(0, ROOT)
    from sfmbench.harness import main

    sys.exit(main())
