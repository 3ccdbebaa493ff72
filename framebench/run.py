"""framebench: the benchmark of rtrt_tpu_torch's Engine.

    python3 framebench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

run from the root of a checkout; prints one JSON result as its last line
(fbench/harness.py says what a run does)."""

import os
import sys

# the checkout's root, where the program under test lives
sys.path.insert(1, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from fbench.harness import main, process_start  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=process_start()))
