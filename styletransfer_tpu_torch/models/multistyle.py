"""Multi-style transform net by conditional instance normalization.

The port of ``styletransfer_tpu/models/multistyle.py`` (Dumoulin et al.,
"A Learned Representation for Artistic Style"): the convs are shared across
S styles and only the instance norms' affines are per style, ``scale`` and
``bias`` [S, C] in place of [C]. Choosing a style gathers its row; blending
styles mixes rows. Either way each image of a batch gets its own [B, C]
affines, which the forward's IN-pad kernel takes as they are
(``ops/cuda/instance_norm.py``): one call serves any mix of styles.

Parameters are a :class:`~styletransfer_tpu_torch.models.transformer.TransformerNet`
whose norms hold [S, C] tensors; its JAX tree (``transformer.params_to_tree``)
is the JAX package's multi-style tree, leaf for leaf, and
:func:`params_from_jax` carries a JAX tree (or a ``train-multi`` checkpoint)
across.
"""

from __future__ import annotations

from typing import Any, Callable, Mapping, Optional

import torch

from styletransfer_tpu_torch import constants
from styletransfer_tpu_torch.models import transformer


def _map_norms(params: transformer.TransformerNet,
               fn: Callable[[torch.Tensor], torch.Tensor]) -> transformer.TransformerNet:
    """A net that shares ``params``' convs, each norm's scale and bias
    replaced by ``fn`` of them."""
    def norm(m):
        return transformer.InstanceNorm(fn(m.scale.detach()), fn(m.bias.detach()))

    convs = {n: getattr(params, n) for n, *_ in transformer._CONVS}
    norms = {n: norm(getattr(params, n)) for n, _ in transformer._NORMS}
    blocks = {}
    for i in range(transformer.NUM_RESIDUAL_BLOCKS):
        r = getattr(params, f"res{i + 1}")
        blocks[f"res{i + 1}"] = transformer.ResidualBlock(r.conv1, norm(r.in1), r.conv2,
                                                          norm(r.in2))
    return transformer.TransformerNet(convs, norms, blocks)


def _norms(params: transformer.TransformerNet):
    return [m for m in params.modules() if isinstance(m, transformer.InstanceNorm)]


def init_params(seed: int, num_styles: int, in_channels: int = 3,
                device=constants.DEFAULT_DEVICE) -> transformer.TransformerNet:
    """The single-style init (``transformer.init_params``) with every
    affine repeated over ``num_styles`` rows."""
    base = transformer.init_params(seed, in_channels, device)
    return _map_norms(base, lambda t: t.expand(num_styles, *t.shape).clone())


def num_styles(params: transformer.TransformerNet) -> int:
    return params.in1.scale.shape[0]


def params_from_jax(tree: Mapping[str, Any],
                    device=constants.DEFAULT_DEVICE) -> transformer.TransformerNet:
    """The port's multi-style parameters from a JAX multi-style tree (nested
    dicts of numpy arrays; every affine [S, C]). Raises unless every norm
    has [S, C] affines of one S."""
    params = transformer.params_from_jax(tree, device=device)
    shapes = {(tuple(m.scale.shape), tuple(m.bias.shape)) for m in _norms(params)}
    styles = {s[0][0] if len(s[0]) == 2 else None for s in shapes}
    if len(styles) != 1 or None in styles or any(a != b for a, b in shapes):
        raise ValueError(f"not a multi-style tree: instance-norm affines {sorted(shapes)}")
    return params


@torch.no_grad()
def select_styles(params: transformer.TransformerNet,
                  style_idx: torch.Tensor) -> transformer.TransformerNet:
    """Per-image affines by index: every [S, C] affine becomes [B, C] (row
    ``style_idx[b]``), the convs shared. ``style_idx`` [B] integers."""
    idx = torch.as_tensor(style_idx, dtype=torch.long, device=params.in1.scale.device)
    return _map_norms(params, lambda t: t[idx].contiguous())


@torch.no_grad()
def blend_styles(params: transformer.TransformerNet,
                 weights: torch.Tensor) -> transformer.TransformerNet:
    """Per-image affines as convex mixes of the styles': ``weights`` [B, S]
    (rows summing to 1) times every [S, C] affine, in f32."""
    w = torch.as_tensor(weights, dtype=torch.float32, device=params.in1.scale.device)
    return _map_norms(params, lambda t: (w @ t).contiguous())


def apply(params: transformer.TransformerNet, x: torch.Tensor, style_idx: torch.Tensor,
          compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The forward (``transformer.apply``, on the serving kernels) with a
    style index per image [B]."""
    return transformer.apply(select_styles(params, style_idx), x, compute_dtype=compute_dtype)


def apply_blend(params: transformer.TransformerNet, x: torch.Tensor, weights: torch.Tensor,
                compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The forward with per-image style blend weights [B, S]."""
    return transformer.apply(blend_styles(params, weights), x, compute_dtype=compute_dtype)
