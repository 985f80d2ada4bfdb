"""The benchmark's command: ``python3 benchmark/run.py --workload <cell>
--seed <n> --seconds <s> --trace <0|1>`` from the repository's root (see
``benchmark/harness/main.py``)."""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

if __name__ == "__main__":
    from benchmark.harness.main import main

    sys.exit(main(t_start=T_START))
