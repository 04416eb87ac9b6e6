"""The training step's share of the card's f32 peak: counts.train_image_flops
times images per second over the untraced stretch."""

from h100bench import readers

LAYER = "model step"
UNIT = "%"
BETTER = "higher"
SOURCE = "host_clock"
MOVES = "train_img_per_s"
WORKLOADS = ("transformnet.train-b4",)


def read(layer, config, traffic):
    return readers.mfu(layer)
