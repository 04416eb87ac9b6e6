"""Share of the traced stretch of SANet's offline loop with nothing running
on the card."""

from h100bench import readers

LAYER = "device"
UNIT = "%"
BETTER = "lower"
SOURCE = "device_trace"
MOVES = "stylize_img_per_s"
WORKLOADS = ("sanet.offline-b4-1024",)


def read(layer, config, traffic):
    return readers.idle_share(layer)
