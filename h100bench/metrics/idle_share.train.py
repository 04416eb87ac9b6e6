"""Share of the traced stretch of the training loop with nothing running on the
card."""

from h100bench import readers

LAYER = "device"
UNIT = "%"
BETTER = "lower"
SOURCE = "device_trace"
MOVES = "train_img_per_s"
WORKLOADS = ("transformnet.train-b4",)


def read(layer, config, traffic):
    return readers.idle_share(layer)
