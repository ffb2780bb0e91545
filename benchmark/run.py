"""Run one cell of the benchmark:

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``.  The last line
of standard output is the result (see ``benchmark/README.md``).
"""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
for path in (ROOT, HERE):
    if path not in sys.path:
        sys.path.insert(0, path)
# Build and kernel caches stay inside the checkout, at fixed paths.
os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(ROOT, "build", "triton"))

if __name__ == "__main__":
    from llpbench.main import main

    sys.exit(main())
