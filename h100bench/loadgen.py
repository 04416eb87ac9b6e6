"""Open-loop load generator for a line-protocol daemon over TCP, in a
process of its own. Standard library only: it shares no interpreter lock
with the daemon and imports nothing of the program.

    python -m h100bench.loadgen --port P --seed S --rate R --seconds T \
        --connections C --inputs DIR --count N --outputs DIR --slots K \
        --warm W --stats-at F --result FILE

Connects ``C`` clients and waits for each one's ``READY``, then sends ``W``
warm-up requests and waits for their answers. The window follows: Poisson
arrivals at ``R`` requests per second for ``T`` seconds, drawn from the
seed, each ``INPUT<TAB>OUTPUT`` on the next connection in turn, where the
input is one of the ``N`` files ``DIR/<i>.png`` (drawn from the seed) and
the output slot is the request's number modulo ``K``. Every request is sent
when it is due, whatever is still unanswered. Each is timed from when it
was due to its answer line; the generator records how late it sent each.
One connection asks ``STATS`` once the share ``F`` of the window has
passed (at its end for ``F`` = 1), and ``SHUTDOWN`` once every answer is in
(or a minute past the window). The result is one JSON file.
"""

from __future__ import annotations

import argparse
import json
import random
import socket
import threading
import time
from collections import deque

ANSWER_WAIT_S = 60.0


class Client:
    """One connection: a reader thread pairs each answer line with the
    oldest unanswered request sent on it."""

    def __init__(self, port: int):
        self.sock = socket.create_connection(("127.0.0.1", port))
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self.file = self.sock.makefile("r", encoding="utf-8", newline="\n")
        self.lock = threading.Lock()
        self.owed: deque = deque()
        line = self.file.readline()
        if line.strip() != "READY":
            raise RuntimeError(f"expected READY, got {line!r}")
        self.thread = threading.Thread(target=self._read, daemon=True)
        self.thread.start()

    def send(self, line: str, record: dict) -> None:
        with self.lock:
            self.owed.append(record)
            record["sent"] = time.monotonic()
            self.sock.sendall((line + "\n").encode())

    def _read(self) -> None:
        for line in self.file:
            now = time.monotonic()
            with self.lock:
                record = self.owed.popleft() if self.owed else None
            if record is None:  # a line the engine broadcast
                continue
            record["done"] = now
            record["ok"] = line.startswith("OK")
            record["answer"] = line.rstrip("\n")[:200]


def _wait(records, deadline: float) -> None:
    while time.monotonic() < deadline and any("done" not in r for r in records):
        time.sleep(0.01)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    for name in ("port", "seed", "connections", "count", "slots", "warm"):
        ap.add_argument(f"--{name}", type=int, required=True)
    for name in ("rate", "seconds", "stats-at"):
        ap.add_argument(f"--{name}", type=float, required=True)
    for name in ("inputs", "outputs", "result"):
        ap.add_argument(f"--{name}", required=True)
    a = ap.parse_args(argv)

    clients = [Client(a.port) for _ in range(a.connections)]
    rng = random.Random(a.seed)

    def line(i: int, slot: str) -> str:
        return f"{a.inputs}/{i}.png\t{a.outputs}/{slot}.png"

    warm = [{"input": i % a.count} for i in range(a.warm)]
    for k, r in enumerate(warm):
        clients[k % len(clients)].send(line(r["input"], f"warm{k}"), r)
    _wait(warm, time.monotonic() + ANSWER_WAIT_S)

    # The schedule: every seed gets Poisson arrivals at the same rate.
    due, t = [], rng.expovariate(a.rate)
    while t < a.seconds:
        due.append(t)
        t += rng.expovariate(a.rate)
    records = [{"due": d, "input": rng.randrange(a.count), "slot": k % a.slots}
               for k, d in enumerate(due)]
    start = time.monotonic()
    print(f"WINDOW {start!r}", flush=True)
    stats = {"answer": None}
    stats_due = start + a.stats_at * a.seconds
    for k, r in enumerate(records):
        r["due"] += start
        pause = r["due"] - time.monotonic()
        if pause > 0:
            time.sleep(pause)
        if "sent" not in stats and time.monotonic() >= stats_due:
            clients[0].send("STATS", stats)
        clients[k % len(clients)].send(line(r["input"], str(r["slot"])), r)
    end = start + a.seconds
    _wait(records, max(end, time.monotonic()) + ANSWER_WAIT_S)
    if "sent" not in stats:
        clients[0].send("STATS", stats)
    _wait([stats], time.monotonic() + ANSWER_WAIT_S)
    bye: dict = {}
    clients[0].send("SHUTDOWN", bye)
    _wait([bye], time.monotonic() + ANSWER_WAIT_S)
    for c in clients:
        c.sock.close()
    with open(a.result, "w") as f:
        json.dump({"start": start, "end": end, "warm_ok": sum(bool(r.get("ok")) for r in warm),
                   "stats": stats.get("answer"), "requests": records}, f)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
