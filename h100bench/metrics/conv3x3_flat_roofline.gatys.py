"""conv3x3_flat's share of its roofline in a Gatys image: the bound of the
nine flat convs of each closure evaluation and the seven of the image's
targets (``counts``) over the device time of ``conv3x3_flat_*``. Silent
when the traced image launched another number of flat convs."""

from h100bench import counts, readers

LAYER = "kernels"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
MOVES = "gatys_evals_per_s"
WORKLOADS = ("vgg19.gatys-lbfgs",)


def read(layer, config, traffic):
    evals, images = layer.get("traced_evals", 0), layer.get("traced_images", 0)
    if not evals or layer.get("flat_calls") != counts.conv3x3_flat_calls(evals, images):
        return None
    bound = counts.conv3x3_flat_bound_s(layer["side"], evals, images)
    return readers.roofline(layer, "conv3x3_flat", bound)
