"""upconv_phase's share of its roofline in SANet's decoder (AdaIN's, at the
content's side): the bound of the traced forwards' three phase-form upsample
convs (``counts_adain.upconv_phase_bound_s``: 16 C O multiply-adds a
small-grid pixel over 67 TFLOP/s, 6.15 ms at 4 pairs of 1024 px) over the
device time that the join of spans and trace (``spans.py``) puts in the
spans ``sanet.dec.up1`` .. ``up3`` (the kernel, its input's edge pad and the
taps' einsum). None unless the kernel's ``launches`` counter read three a
forward."""

from h100bench import counts_adain

LAYER = "kernels"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
MOVES = "stylize_img_per_s"
WORKLOADS = ("sanet.offline-b4-1024",)
SPANS = tuple(f"sanet.dec.{name}" for name in counts_adain.UPCONVS)


def read(layer, config, traffic):
    by = layer.get("span_s")
    forwards = layer.get("forwards", 0)
    if not by or not forwards or layer.get("upconv_phase_calls") != 3 * forwards:
        return None
    spent = sum(by.get(name, 0.0) for name in SPANS)
    if spent <= 0:
        return None
    return 100.0 * forwards * counts_adain.upconv_phase_bound_s(layer["batch"], layer["side"]) / spent
