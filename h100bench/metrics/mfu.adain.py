"""AdaIN's serving forward's share of the card's f32 peak: a pair's
operations (counts_adain.pair_flops, 379.6 GFLOP at 512 px: content and
style encoded, one decode) times pairs per second over the untraced
stretch."""

from h100bench import readers

LAYER = "model step"
UNIT = "%"
BETTER = "higher"
SOURCE = "host_clock"
MOVES = "stylize_img_per_s"
WORKLOADS = ("adain.offline-b16-512",)


def read(layer, config, traffic):
    return readers.mfu(layer)
