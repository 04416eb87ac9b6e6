"""The Gatys closure's share of the card's f32 peak: counts.gatys_eval_flops
times evaluations per second over the untraced stretch."""

from h100bench import readers

LAYER = "model step"
UNIT = "%"
BETTER = "higher"
SOURCE = "host_clock"
MOVES = "gatys_evals_per_s"
WORKLOADS = ("vgg19.gatys-lbfgs",)


def read(layer, config, traffic):
    return readers.mfu(layer)
