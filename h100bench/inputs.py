"""Weights and images made from ``--seed`` on the device, in a few large
calls of a ``torch.Generator`` on the run's device.

Every seed gives the same sizes; only the numbers differ. Images are smooth
seeded fields (a few octaves of upsampled noise), not white noise, so that
PNG sizes and the losses look like a photograph's more than static's.
"""

from __future__ import annotations

import hashlib
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from h100bench.reference import nets

# Streams of one seed: each purpose draws from its own generator.
WEIGHTS, VGG, IMAGES, STYLE = 1, 2, 3, 4


def generator(device, seed: int, stream: int, index: int = 0) -> torch.Generator:
    """The generator of one (seed, stream, index), seeded by a hash of the
    three (the CPU's generator keeps only a seed's low 32 bits)."""
    digest = hashlib.sha256(f"{seed}/{stream}/{index}".encode()).digest()
    g = torch.Generator(device=device)
    g.manual_seed(int.from_bytes(digest[:8], "little") >> 1)
    return g


def _uniform_leaves(shapes: Dict[str, Tuple[int, ...]], g: torch.Generator,
                    device) -> Dict[str, torch.Tensor]:
    """One draw of U(-1, 1) for every leaf, cut into leaves of their own."""
    sizes = [int(torch.Size(s).numel()) for s in shapes.values()]
    flat = torch.rand(sum(sizes), generator=g, device=device) * 2 - 1
    return {k: part.reshape(s).clone()
            for (k, s), part in zip(shapes.items(), flat.split(sizes))}


def transformnet_weights(seed: int, device) -> Dict[str, torch.Tensor]:
    """Kernels and biases U(-b, b), b = 1 / sqrt(fan-in) (torch's conv
    init); IN scales in [0.75, 1.25] and biases in [-0.25, 0.25]."""
    shapes = nets.transformnet_shapes()
    u = _uniform_leaves(shapes, generator(device, seed, WEIGHTS), device)
    fan_in = {f"{n}.": k * k * cin for n, k, cin, _, _ in nets.TRANSFORMNET_CONVS}
    out = {}
    for key, t in u.items():
        prefix = key.rsplit(".", 1)[0] + "."
        if prefix in fan_in:
            out[key] = t / fan_in[prefix] ** 0.5
        elif key.endswith(".scale"):
            out[key] = 1.0 + 0.25 * t
        else:
            out[key] = 0.25 * t
    return out


def vgg_weights(seed: int, device) -> Dict[str, torch.Tensor]:
    """He-normal kernels (as the program's seeded stand-in for the
    pretrained file) and biases U(-0.1, 0.1)."""
    shapes = nets.vgg_shapes()
    g = generator(device, seed, VGG)
    sizes = [int(torch.Size(s).numel()) for s in shapes.values()]
    flat = torch.randn(sum(sizes), generator=g, device=device)
    out = {}
    for (key, shape), part in zip(shapes.items(), flat.split(sizes)):
        if key.endswith(".kernel"):
            out[key] = part.reshape(shape) * (2.0 / (9 * shape[2])) ** 0.5
        else:
            out[key] = 0.1 * (2 * torch.rand(shape, generator=g, device=device) - 1)
    return out


def images(n: int, side: int, g: torch.Generator, device) -> torch.Tensor:
    """``n`` smooth seeded images, uint8 [n, side, side, 3] (NHWC)."""
    field = torch.zeros(n, 3, side, side, device=device)
    for cells, amp in ((4, 1.0), (16, 0.5), (64, 0.25)):
        noise = torch.rand(n, 3, cells, cells, generator=g, device=device)
        field += amp * F.interpolate(noise, size=(side, side), mode="bicubic",
                                     align_corners=False)
    field += 0.05 * torch.rand(n, 3, side, side, generator=g, device=device)
    lo = field.amin(dim=(1, 2, 3), keepdim=True)
    hi = field.amax(dim=(1, 2, 3), keepdim=True)
    u8 = ((field - lo) / (hi - lo) * 255.0).round().to(torch.uint8)
    return u8.permute(0, 2, 3, 1).contiguous()
