"""Multi-style transform net by conditional instance normalization.

The port of ``styletransfer_tpu/models/multistyle.py`` (Dumoulin et al.,
"A Learned Representation for Artistic Style"): the convs are shared across
S styles and only the instance norms' affines are per style, ``scale`` and
``bias`` [S, C] in place of [C]. Choosing a style gathers its row; blending
styles mixes rows. Either way each image of a batch gets its own [B, C]
affines, which the instance-norm kernels take as they are (IN-pad in
serving, the fused-IN forward and backward in training): one call serves
any mix of styles.

Choosing and blending are one gather (:func:`styled`): per-image weights
[B, S] (one-hot rows for a choice) times each [S, C] table, for all 30
affines of the 15 norms in three batched products (one per channel width),
so that a forward costs six small launches for its styles. The gather is
differentiable: a style's gradient is ``W^T @ d``, the sum over the images
that drew it in the product's fixed order (f32, TF32 off), and a style no
image drew gets exactly 0.

Parameters are a :class:`~styletransfer_tpu_torch.models.transformer.TransformerNet`
whose norms hold [S, C] tensors; its JAX tree (``transformer.params_to_tree``)
is the JAX package's multi-style tree, leaf for leaf, and
:func:`params_from_jax` carries a JAX tree (or a ``train-multi`` checkpoint)
across.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import torch

from styletransfer_tpu_torch import constants
from styletransfer_tpu_torch.models import transformer


# The 15 norms' attribute paths in the net, in the forward's order.
NORM_PATHS: List[Tuple[str, ...]] = (
    [(n,) for n, _ in transformer._NORMS[:3]]
    + [(f"res{i + 1}", leaf) for i in range(transformer.NUM_RESIDUAL_BLOCKS)
       for leaf in ("in1", "in2")]
    + [(n,) for n, _ in transformer._NORMS[3:]])


def _norm_at(params, path: Tuple[str, ...]):
    for part in path:
        params = getattr(params, part)
    return params


def _assemble(params, norm: Callable[[Tuple[str, ...]], Any], module: bool = True):
    """``params``' convs with ``norm(path)`` at each norm's place: a
    TransformerNet (``module``), or a plain namespace of the same attributes
    whose norms may hold tensors with a gradient graph."""
    if module:
        cls, block = transformer.TransformerNet, transformer.ResidualBlock
    else:
        def cls(convs, norms, blocks):
            return SimpleNamespace(**convs, **norms, **blocks)
        block = SimpleNamespace
    blocks = {}
    for i in range(transformer.NUM_RESIDUAL_BLOCKS):
        name = f"res{i + 1}"
        r = getattr(params, name)
        blocks[name] = block(conv1=r.conv1, in1=norm((name, "in1")), conv2=r.conv2,
                             in2=norm((name, "in2")))
    return cls({n: getattr(params, n) for n, *_ in transformer._CONVS},
               {n: norm((n,)) for n, _ in transformer._NORMS}, blocks)


def styled(params: transformer.TransformerNet, weights: torch.Tensor) -> SimpleNamespace:
    """The net that the forward runs for per-image style weights ``weights``
    [B, S] (f32, on the params' device): ``params``' convs, and every norm's
    affines ``weights @ table`` [B, C], each a contiguous row block.

    The one gather of serving and training: the 30 [S, C] tables are stacked
    by channel width (three groups) and each group is one batched product
    ``[K, B, S] @ [K, S, C]``. Differentiable in the tables; a one-hot row
    picks its style's row exactly."""
    groups: Dict[int, List[Tuple[Tuple[str, ...], str]]] = {}
    for path in NORM_PATHS:
        for leaf in ("scale", "bias"):
            width = getattr(_norm_at(params, path), leaf).shape[-1]
            groups.setdefault(width, []).append((path, leaf))
    affines: Dict[Tuple[str, ...], Dict[str, torch.Tensor]] = {}
    for members in groups.values():
        table = torch.stack([getattr(_norm_at(params, p), leaf) for p, leaf in members])
        rows = torch.bmm(weights.expand(len(members), *weights.shape), table).unbind(0)
        for (path, leaf), row in zip(members, rows):
            affines.setdefault(path, {})[leaf] = row
    return _assemble(params, lambda path: SimpleNamespace(**affines[path]), module=False)


def style_index(style_idx, device) -> torch.Tensor:
    """[B] style indices as a long tensor on ``device``. Host indices reach a
    CUDA device by a copy from pinned memory that does not wait: a plain
    copy from pageable memory would hold the host until the device has run
    everything queued before it, every training step."""
    idx = torch.as_tensor(style_idx, dtype=torch.long)
    dev = torch.device(device)
    if dev.type == "cuda" and idx.device.type == "cpu":
        return idx.pin_memory().to(dev, non_blocking=True)
    return idx.to(dev)


def one_hot(style_idx, num: int, device) -> torch.Tensor:
    """[B] style indices as [B, num] f32 one-hot weights on ``device``."""
    return torch.nn.functional.one_hot(style_index(style_idx, device), num).float()


def _map_norms(params, fn: Callable[[torch.Tensor], torch.Tensor]) -> transformer.TransformerNet:
    """A TransformerNet that shares ``params``' convs, each norm's scale and
    bias replaced by ``fn`` of them, detached."""
    def norm(path):
        m = _norm_at(params, path)
        return transformer.InstanceNorm(fn(m.scale.detach()), fn(m.bias.detach()))

    return _assemble(params, norm)


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


def _weights(params: transformer.TransformerNet, weights) -> torch.Tensor:
    return torch.as_tensor(weights, dtype=torch.float32, device=params.in1.scale.device)


@torch.no_grad()
def select_styles(params: transformer.TransformerNet,
                  style_idx: torch.Tensor) -> transformer.TransformerNet:
    """Per-image affines by index: every [S, C] affine becomes [B, C] (row
    ``style_idx[b]``), the convs shared. ``style_idx`` [B] integers."""
    w = one_hot(style_idx, num_styles(params), params.in1.scale.device)
    return _map_norms(styled(params, w), lambda t: t)


@torch.no_grad()
def blend_styles(params: transformer.TransformerNet,
                 weights: torch.Tensor) -> transformer.TransformerNet:
    """Per-image affines as convex mixes of the styles': ``weights`` [B, S]
    (rows summing to 1) times every [S, C] affine, in f32."""
    return _map_norms(styled(params, _weights(params, weights)), lambda t: t)


@torch.no_grad()
def apply(params: transformer.TransformerNet, x: torch.Tensor, style_idx: torch.Tensor,
          compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The forward (``transformer.apply``, on the serving kernels) with a
    style index per image [B]."""
    w = one_hot(style_idx, num_styles(params), params.in1.scale.device)
    return transformer.apply(styled(params, w), x, compute_dtype=compute_dtype)


@torch.no_grad()
def apply_blend(params: transformer.TransformerNet, x: torch.Tensor, weights: torch.Tensor,
                compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The forward with per-image style blend weights [B, S]."""
    return transformer.apply(styled(params, _weights(params, weights)), x,
                             compute_dtype=compute_dtype)


def apply_stacked(params: transformer.TransformerNet, x: torch.Tensor, style_idx,
                  compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The training forward (``transformer.apply_stacked``: the fused-IN
    kernels with [B, C] affines and their backward), differentiable in every
    parameter, with a style index per image [B]."""
    w = one_hot(style_idx, num_styles(params), params.in1.scale.device)
    return transformer.apply_stacked(styled(params, w), x, compute_dtype)
