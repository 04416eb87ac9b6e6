"""conv3x3_valid's share of its roofline in the serving forward: the bound
of the residual convs the traced stretch launched (``counts``, f32
operations over 67 TFLOP/s or bytes over 3.35 TB/s) over the device time of
the kernels named ``conv3x3_*`` (``groups``)."""

from h100bench import counts, readers

LAYER = "kernels"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
MOVES = "stylize_img_per_s"
WORKLOADS = ("transformnet.offline-b64",)


def read(layer, config, traffic):
    calls = layer.get("conv3x3_valid_calls", 0)
    if not calls:
        return None
    bound = calls * counts.conv3x3_valid_bound_s(layer["batch"], layer["side"])
    return readers.roofline(layer, "conv3x3_valid", bound)
