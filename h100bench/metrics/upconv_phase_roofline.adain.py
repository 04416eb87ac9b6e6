"""upconv_phase's share of its roofline in AdaIN's decoder: the bound of the
traced forwards' three phase-form upsample convs
(``counts_adain.upconv_phase_bound_s``: 16 C O multiply-adds a small-grid
pixel over 67 TFLOP/s) over the device time that the join of spans and trace
(``spans.py``) puts in the spans ``adain.dec.up1`` .. ``up3`` (the kernel,
its input's edge pad and the taps' einsum). None unless the kernel's
``launches`` counter read three a forward."""

from h100bench import counts_adain

LAYER = "kernels"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
MOVES = "stylize_img_per_s"
WORKLOADS = ("adain.offline-b16-512",)
SPANS = tuple(f"adain.dec.{name}" for name in counts_adain.UPCONVS)


def read(layer, config, traffic):
    by = layer.get("span_s")
    forwards = layer.get("forwards", 0)
    if not by or not forwards or layer.get("upconv_phase_calls") != 3 * forwards:
        return None
    spent = sum(by.get(name, 0.0) for name in SPANS)
    if spent <= 0:
        return None
    return 100.0 * forwards * counts_adain.upconv_phase_bound_s(layer["batch"], layer["side"]) / spent
