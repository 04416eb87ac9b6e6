"""Share of the traced stretch of the offline forward loop with nothing running
on the card."""

from h100bench import readers

LAYER = "device"
UNIT = "%"
BETTER = "lower"
SOURCE = "device_trace"
MOVES = "stylize_img_per_s"
WORKLOADS = ("transformnet.offline-b64",)


def read(layer, config, traffic):
    return readers.idle_share(layer)
