"""Device kernels of the traced Gatys image over its closure evaluations
(the program's ``engines.gatys.closure_evals`` counter)."""

LAYER = "optimizer and closure"
UNIT = "kernels/eval"
BETTER = "lower"
SOURCE = "device_trace"
MOVES = "gatys_evals_per_s"
WORKLOADS = ("vgg19.gatys-lbfgs",)


def read(layer, config, traffic):
    tr, evals = layer.get("trace"), layer.get("traced_evals", 0)
    if tr is None or not evals:
        return None
    return tr.kernels / evals
