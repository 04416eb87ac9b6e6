"""The IN-pad kernel's share of its roofline in the serving forward: the
bytes bound of the 15 calls of each forward the traced stretch ran
(``counts``) over the device time of ``in_kernel`` (``groups``)."""

from h100bench import counts, readers

LAYER = "kernels"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
MOVES = "stylize_img_per_s"
WORKLOADS = ("transformnet.offline-b64",)


def read(layer, config, traffic):
    forwards = layer.get("in_pad_forwards", 0)
    if not forwards:
        return None
    bound = forwards * counts.in_pad_forward_bound_s(layer["batch"], layer["side"])
    return readers.roofline(layer, "instance_norm", bound)
