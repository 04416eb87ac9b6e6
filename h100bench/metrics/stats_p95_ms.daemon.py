"""The daemon's own 95th percentile of enqueue-to-reply milliseconds
(``engines/daemon.py``'s ``_ServeStats``), from its ``STATS`` answer at the
window's end."""

LAYER = "engine, daemons"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
MOVES = "serve_p95_ms"
WORKLOADS = ("transformnet.daemon-tcp-b8",)


def read(layer, config, traffic):
    return layer.get("stats_p95_ms")
