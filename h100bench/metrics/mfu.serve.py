"""The serving forward's share of the card's f32 peak: the transform net's
operations (counts.transformnet_forward_flops) times images per second over
the untraced stretch."""

from h100bench import readers

LAYER = "model step"
UNIT = "%"
BETTER = "higher"
SOURCE = "host_clock"
MOVES = "stylize_img_per_s"
WORKLOADS = ("transformnet.offline-b64",)


def read(layer, config, traffic):
    return readers.mfu(layer)
