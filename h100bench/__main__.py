"""``python -m h100bench --workload <cell> --seed <n> --seconds <s> --trace <0|1>``."""

import time

_T_START = time.monotonic()  # set-up is timed from here

import sys  # noqa: E402

from h100bench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(t_start=_T_START))
