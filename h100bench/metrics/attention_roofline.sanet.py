"""The attention kernel's share of its roofline in SANet's forward: the
bound of the traced forwards' two attention calls
(``counts_sanet.attention_bound_s``: each call's 4 Nq Nk D f32 operations
over 67 TFLOP/s or its bytes over 3.35 TB/s, the larger; 8.21 ms and 0.51
ms a pair at 1024 px) over the device time that the join of spans and trace
(``spans.py``) puts in the spans ``sanet.r4_1.attn`` and ``sanet.r5_1.attn``
(the kernel alone). None unless the kernel's ``launches`` counter read two a
forward."""

from h100bench import counts_sanet

LAYER = "kernels"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
MOVES = "stylize_img_per_s"
WORKLOADS = ("sanet.offline-b4-1024",)
SPANS = tuple(f"sanet.{tap}.attn" for tap, _ in counts_sanet.BLOCKS)


def read(layer, config, traffic):
    by = layer.get("span_s")
    forwards = layer.get("forwards", 0)
    if (not by or not forwards
            or layer.get("attention_calls") != counts_sanet.ATTENTION_CALLS * forwards):
        return None
    spent = sum(by.get(name, 0.0) for name in SPANS)
    if spent <= 0:
        return None
    bound = forwards * counts_sanet.attention_bound_s(layer["batch"], layer["side"],
                                                      layer["style_side"])
    return 100.0 * bound / spent
