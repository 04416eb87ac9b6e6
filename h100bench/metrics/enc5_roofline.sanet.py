"""SANet's encoder convs past relu4_1 (conv4_2 .. conv5_1, 512 -> 512 on
conv3x3_valid) and their share of their roofline: the bound of the traced
forwards' calls (``counts_sanet.enc5_bound_s``: content and style, each
conv's f32 operations over 67 TFLOP/s or its bytes over 3.35 TB/s) over the
device time that the join of spans and trace (``spans.py``) puts in their
``sanet.enc.<conv>`` spans (the convs with their input pads, as
``encoder_roofline.adain`` reads; pool4 has a span of its own)."""

from h100bench import counts_sanet

LAYER = "kernels"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
MOVES = "stylize_img_per_s"
WORKLOADS = ("sanet.offline-b4-1024",)
SPANS = tuple(f"sanet.enc.{name}" for name, *_ in counts_sanet.ENCODER5_CONVS)


def read(layer, config, traffic):
    by = layer.get("span_s")
    forwards = layer.get("forwards", 0)
    if not by or not forwards:
        return None
    spent = sum(by.get(name, 0.0) for name in SPANS)
    if spent <= 0:
        return None
    bound = forwards * counts_sanet.enc5_bound_s(layer["batch"], layer["side"],
                                                 layer["style_side"])
    return 100.0 * bound / spent
