"""cuDNN's convolutions' share of the device time of a training step's
kernels in the traced stretch, by the program's kernel-name groups
(``groups``)."""

from h100bench import readers

LAYER = "plain ops (cuDNN)"
UNIT = "%"
BETTER = "lower"
SOURCE = "device_trace"
MOVES = "train_img_per_s"
WORKLOADS = ("transformnet.train-b4",)


def read(layer, config, traffic):
    return readers.group_share(layer, "cudnn_conv")
