"""conv3x3_valid's share of its roofline in SANet's forward: the bound of
the traced forwards' convs on it (``counts_sanet.conv3x3_valid_bound_s``:
the encoder's twelve 3x3 convs after conv1_1 to conv5_1 over content and
style, the merge, the decoder's five plain 3x3 convs; each conv's f32
operations over 67 TFLOP/s or its bytes over 3.35 TB/s) over the device
time of the kernels named ``conv3x3_*`` (``groups``), which holds neither
the reflect pads nor the pools. None unless the kernel's ``launches``
counter read as many calls a forward as
``counts_sanet.conv3x3_valid_calls``."""

from h100bench import counts_sanet, readers

LAYER = "kernels"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
MOVES = "stylize_img_per_s"
WORKLOADS = ("sanet.offline-b4-1024",)


def read(layer, config, traffic):
    forwards = layer.get("forwards", 0)
    if not forwards:
        return None
    side, style_side = layer["side"], layer["style_side"]
    if layer.get("conv3x3_valid_calls") != forwards * counts_sanet.conv3x3_valid_calls(
            side, style_side):
        return None
    bound = forwards * counts_sanet.conv3x3_valid_bound_s(layer["batch"], side, style_side)
    return readers.roofline(layer, "conv3x3_valid", bound)
