"""Share of the traced Gatys image with nothing running on the card."""

from h100bench import readers

LAYER = "device"
UNIT = "%"
BETTER = "lower"
SOURCE = "device_trace"
MOVES = "gatys_evals_per_s"
WORKLOADS = ("vgg19.gatys-lbfgs",)


def read(layer, config, traffic):
    return readers.idle_share(layer)
