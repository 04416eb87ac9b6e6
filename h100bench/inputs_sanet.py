"""SANet's weights from ``--seed``, in the released files' layout
(``vgg_normalised.pth`` to index 42, ``decoder_iter_500000.pth``: OIHW
kernels under the ``nn.Sequential`` indices of ``reference/sanet.py``;
``transformer_iter_500000.pth``: ``sanet4_1.*``, ``sanet5_1.*``,
``merge_conv``), made on the run's device in two draws of its own stream.
Images come from ``inputs.images``.

The rule (``configs/park2019-sanet-vgg19.json``, ``assumed``): the encoder
and decoder by ``inputs_adain``'s (every 3x3 conv before a ReLU He-normal,
the 1x1 input conv normal with std sqrt(1/3), the decoder's last conv
He-normal times ``OUT_GAIN`` with biases ``OUT_BIAS``); per block ``f`` and
``g`` fan-in normal times ``LOGIT_GAIN``, ``h`` and ``out_conv`` fan-in
normal; the merge conv fan-in normal; every other bias U(-0.1, 0.1).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from h100bench import inputs
from h100bench.inputs_adain import OUT_BIAS, OUT_GAIN
from h100bench.reference import sanet as ref

SANET_WEIGHTS = 6  # the seed's stream for these weights (inputs.py has 1-4, inputs_adain 5)
LOGIT_GAIN = 0.5

# (file, key, in, out, kernel, std before the gain, gain, last of the decoder)
Layer = Tuple[str, str, int, int, int, float, float, bool]


def layers(config) -> List[Layer]:
    """Every conv of the configuration, in draw order."""
    out: List[Layer] = []
    cin = config["in_channels"]
    widths = [config["input_conv"][2]] + list(config["encoder_widths"])
    for (idx, k, _, _), cout in zip(ref.ENCODER, widths):
        std = (2.0 / (k * k * cin)) ** 0.5 if k == 3 else (1.0 / cin) ** 0.5
        out.append(("vgg", str(idx), cin, cout, k, std, 1.0, False))
        cin = cout
    for i, ((idx, _), cout) in enumerate(zip(ref.DECODER, config["decoder_widths"])):
        last = i == len(ref.DECODER) - 1
        out.append(("decoder", str(idx), cin, cout, 3, (2.0 / (9 * cin)) ** 0.5,
                    OUT_GAIN if last else 1.0, last))
        cin = cout
    c = config["features"]
    for block in ref.BLOCKS:
        for conv in config["block_convs"]:
            out.append(("transformer", f"{block}.{conv}", c, c, 1, (1.0 / c) ** 0.5,
                        LOGIT_GAIN if conv in ("f", "g") else 1.0, False))
    k = config["merge_conv"][0]
    out.append(("transformer", "merge_conv", c, c, k, (1.0 / (k * k * c)) ** 0.5, 1.0, False))
    return out


def weights(seed: int, device, config) -> Tuple[Dict[str, torch.Tensor], ...]:
    """(vgg, decoder, transformer) state dicts of the seed's weights on
    ``device``."""
    convs = layers(config)
    shapes = [(cout, cin, k, k) for _, _, cin, cout, k, *_ in convs]
    g = inputs.generator(device, seed, SANET_WEIGHTS)
    sizes = [int(torch.Size(s).numel()) for s in shapes]
    normal = torch.randn(sum(sizes), generator=g, device=device).split(sizes)
    bias_sizes = [s[0] for s in shapes]
    uniform = (torch.rand(sum(bias_sizes), generator=g, device=device) * 0.2 - 0.1).split(
        bias_sizes)
    sds: Dict[str, Dict[str, torch.Tensor]] = {"vgg": {}, "decoder": {}, "transformer": {}}
    for (which, key, _, _, _, std, gain, last), shape, n, u in zip(convs, shapes, normal,
                                                                   uniform):
        sds[which][f"{key}.weight"] = n.reshape(shape) * (std * gain)
        sds[which][f"{key}.bias"] = torch.full_like(u, OUT_BIAS) if last else u.clone()
    return sds["vgg"], sds["decoder"], sds["transformer"]
