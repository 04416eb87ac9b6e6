"""AdaIN's weights from ``--seed``, in the released files' layout
(``vgg_normalised.pth`` and ``decoder.pth``: OIHW kernels under the
``nn.Sequential`` indices of ``reference/adain.py``), made on the run's
device in two draws of its own stream. Images come from ``inputs.images``.

The rule (``configs/huang2017-adain-vgg19.json``, ``assumed``): every 3x3
conv before a ReLU He-normal, the 1x1 conv normal with std sqrt(1/3),
biases U(-0.1, 0.1); the last conv He-normal times ``OUT_GAIN`` with biases
``OUT_BIAS``, so that the output lies about [0, 1] and few levels clamp.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from h100bench import inputs
from h100bench.reference import adain as ref

ADAIN_WEIGHTS = 5  # the seed's stream for these weights (inputs.py has 1-4)
OUT_GAIN = 0.1
OUT_BIAS = 0.5

Layer = Tuple[str, int, int, int, bool]  # (which, index, in, out, last)


def layers(config) -> List[Layer]:
    """Every conv of the configuration: ("vgg" or "decoder", index, in,
    out, whether it is the decoder's last)."""
    out: List[Layer] = []
    cin = config["in_channels"]
    widths = [config["input_conv"][2]] + list(config["encoder_widths"])
    for (idx, _, _), cout in zip(ref.ENCODER, widths):
        out.append(("vgg", idx, cin, cout, False))
        cin = cout
    for i, ((idx, _), cout) in enumerate(zip(ref.DECODER, config["decoder_widths"])):
        out.append(("decoder", idx, cin, cout, i == len(ref.DECODER) - 1))
        cin = cout
    return out


def weights(seed: int, device, config) -> Tuple[Dict[str, torch.Tensor],
                                                Dict[str, torch.Tensor]]:
    """(vgg, decoder) state dicts of the seed's weights on ``device``."""
    convs = layers(config)
    ks = [config["input_conv"][0]] + [config["conv_kernel"]] * (len(convs) - 1)
    shapes = [(cout, cin, k, k) for (_, _, cin, cout, _), k in zip(convs, ks)]
    g = inputs.generator(device, seed, ADAIN_WEIGHTS)
    sizes = [int(torch.Size(s).numel()) for s in shapes]
    normal = torch.randn(sum(sizes), generator=g, device=device).split(sizes)
    bias_sizes = [s[0] for s in shapes]
    uniform = (torch.rand(sum(bias_sizes), generator=g, device=device) * 0.2 - 0.1).split(
        bias_sizes)
    sds: Dict[str, Dict[str, torch.Tensor]] = {"vgg": {}, "decoder": {}}
    for (which, idx, cin, _, last), shape, n, u in zip(convs, shapes, normal, uniform):
        k = shape[2]
        std = (2.0 / (k * k * cin)) ** 0.5 if k == 3 else (1.0 / cin) ** 0.5
        kernel = n.reshape(shape) * std * (OUT_GAIN if last else 1.0)
        sds[which][f"{idx}.weight"] = kernel
        sds[which][f"{idx}.bias"] = torch.full_like(u, OUT_BIAS) if last else u.clone()
    return sds["vgg"], sds["decoder"]
