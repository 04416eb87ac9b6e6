"""SANet's serving forward's share of the card's f32 peak: a pair's
operations (counts_sanet.pair_flops, 2725.3 GFLOP at 1024 px: content and
style encoded to relu5_1, both attentions, the 1x1 convs, the merge, one
decode) times pairs per second over the untraced stretch."""

from h100bench import readers

LAYER = "model step"
UNIT = "%"
BETTER = "higher"
SOURCE = "host_clock"
MOVES = "stylize_img_per_s"
WORKLOADS = ("sanet.offline-b4-1024",)


def read(layer, config, traffic):
    return readers.mfu(layer)
