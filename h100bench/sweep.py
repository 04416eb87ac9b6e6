"""Find the highest rate the TCP daemon sustains: run a daemon cell once at
each of a list of offered rates (its mix's other parameters unchanged) and
print each run's summary (completed rate, latency, the first and last
quarter's median, how late the generator ran). The knee is the highest
rate whose completed rate keeps up and whose last quarter waits no longer
than its first. Run once, on the chip; the cell's mix then fixes its rate.

    python -m h100bench.sweep --workload transformnet.daemon-tcp-b8 --seed 7 \
        --seconds 10 --rates 100 150 200 250
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from h100bench import harness


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    a = ap.parse_args(argv)
    harness.set_cache_dirs()
    for rate in a.rates:
        line = harness.execute(a.workload, a.seed, a.seconds, False, "cuda", time.monotonic(),
                               traffic_overrides={"rate": rate})
        print(json.dumps({"rate": rate, **line}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
