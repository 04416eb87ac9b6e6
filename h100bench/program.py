"""The program's state built from the benchmark's weights: the one place
that knows the port's parameter containers. Every leaf is a copy, so the
program's updates never reach the weights the reference is handed."""

from __future__ import annotations

from typing import Dict

import torch


def transformnet(w: Dict[str, torch.Tensor]):
    """A ``models.transformer.TransformerNet`` holding copies of ``w``."""
    from styletransfer_tpu_torch.models import transformer as T

    def conv(name):
        return T.Conv(w[f"{name}.kernel"].clone(), w[f"{name}.bias"].clone())

    def norm(name):
        return T.InstanceNorm(w[f"{name}.scale"].clone(), w[f"{name}.bias"].clone())

    convs = {n: conv(n) for n in ("conv1", "conv2", "conv3", "up1_conv", "up2_conv",
                                   "conv_out")}
    norms = {n: norm(n) for n in ("in1", "in2", "in3", "up1_in", "up2_in")}
    blocks = {f"res{i}": T.ResidualBlock(conv(f"res{i}.conv1"), norm(f"res{i}.in1"),
                                         conv(f"res{i}.conv2"), norm(f"res{i}.in2"))
              for i in range(1, 6)}
    return T.TransformerNet(convs, norms, blocks)


def vgg(v: Dict[str, torch.Tensor]) -> Dict[str, Dict[str, torch.Tensor]]:
    """The port's VGG parameter dict (``{"Conv2d_i": {"kernel", "bias"}}``)."""
    names = sorted({k.split(".")[0] for k in v})
    return {n: {"kernel": v[f"{n}.kernel"].clone(), "bias": v[f"{n}.bias"].clone()}
            for n in names}
