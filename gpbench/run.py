#!/usr/bin/env python3
"""Run one cell of the benchmark once and print its result line:

    python3 gpbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the repository's root, on a machine with the CUDA devices the cell
asks for. See gpbench/README.md.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# every build and kernel cache at a fixed place inside the checkout
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = os.path.join(ROOT, "build", "gpbench", "cache", sub)
sys.path.insert(0, ROOT)

from gpbench.harness.bench import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=T_START))
