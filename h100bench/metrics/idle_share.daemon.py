"""Share of the traced stretch of the TCP daemon with nothing running on the
card."""

from h100bench import readers

LAYER = "device"
UNIT = "%"
BETTER = "lower"
SOURCE = "device_trace"
MOVES = "serve_p95_ms"
WORKLOADS = ("transformnet.daemon-tcp-b8",)


def read(layer, config, traffic):
    return readers.idle_share(layer)
