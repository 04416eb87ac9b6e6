"""AdaIN's encoder convs' share of their roofline: the bound of the traced
forwards' encoder convs (``counts_adain.encoder_bound_s``: content and style,
each conv's f32 operations over 67 TFLOP/s or its bytes over 3.35 TB/s)
over the device time that the join of spans and trace (``spans.py``) puts
in the ``adain.enc.conv*`` spans (the convs with their input pads; the
pools have spans of their own)."""

from h100bench import counts_adain

LAYER = "kernels"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
MOVES = "stylize_img_per_s"
WORKLOADS = ("adain.offline-b16-512",)


def read(layer, config, traffic):
    by = layer.get("span_s")
    forwards = layer.get("forwards", 0)
    if not by or not forwards:
        return None
    spent = sum(v for k, v in by.items() if k.startswith("adain.enc.conv"))
    if spent <= 0:
        return None
    bound = forwards * counts_adain.encoder_bound_s(layer["batch"], layer["side"],
                                                    layer["style_side"])
    return 100.0 * bound / spent
