"""VGG19 feature extractor with loss taps, on NHWC tensors.

The port of ``styletransfer_tpu/models/vgg.py``: one pass of the conv tower
up to the deepest tap returns every tapped activation. Tap names follow the
reference's ``{LayerType}_{conv_counter}`` scheme:
- content tap ``Conv2d_4`` (VGG19 conv2_2, before its ReLU);
- style taps ``Conv2d_1`` .. ``Conv2d_5`` (conv1_1 .. conv3_1, before ReLU);
- feature tap ``ReLU_4`` (relu2_2).

Parameters are a dict ``{"Conv2d_i": {"kernel": [3, 3, Cin, Cout] HWIO,
"bias": [Cout]}}`` of tensors. Pretrained torchvision VGG19 weights load
from a ``.npz`` or ``.pth`` file (:func:`load_params`); without one a seeded
He initialization stands in (the loss arithmetic is the same either way).
Its numbers differ from the JAX package's for the same seed (another
generator); :func:`params_from_jax` carries JAX parameters across.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from styletransfer_tpu_torch import constants
from styletransfer_tpu_torch.ops import layers, losses
from styletransfer_tpu_torch.utils.logging import get_logger

Params = Dict[str, Dict[str, torch.Tensor]]

# VGG19 `features` configuration: conv output channels, 'M' = 2x2 max pool.
VGG19_CFG: Tuple = (
    64, 64, "M",
    128, 128, "M",
    256, 256, 256, 256, "M",
    512, 512, 512, 512, "M",
    512, 512, 512, 512, "M",
)

CONTENT_LAYERS = ("Conv2d_4",)
STYLE_LAYERS = ("Conv2d_1", "Conv2d_2", "Conv2d_3", "Conv2d_4", "Conv2d_5")
FEATURE_LOSS_LAYERS = ("ReLU_4",)

DEFAULT_TAPS = tuple(sorted(set(CONTENT_LAYERS + STYLE_LAYERS + FEATURE_LOSS_LAYERS)))


def _plan(taps: Sequence[str]):
    """Steps ``(kind, name, cin, cout)`` up to the last tap. An unknown tap
    name raises here, not as a missing key (or a zero loss) at the caller."""
    taps = set(taps)
    steps = []
    cin, conv_i = 3, 0
    for item in VGG19_CFG:
        if item == "M":
            steps.append(("pool", f"MaxPool2d_{conv_i}", None, None))
        else:
            conv_i += 1
            steps.append(("conv", f"Conv2d_{conv_i}", cin, item))
            steps.append(("relu", f"ReLU_{conv_i}", None, None))
            cin = item
    unknown = taps - {name for _, name, _, _ in steps}
    if unknown:
        raise ValueError(
            f"unknown VGG tap name(s) {sorted(unknown)}; valid names look "
            f"like Conv2d_1..Conv2d_{conv_i} / ReLU_i / MaxPool2d_i"
        )
    last = max(i for i, (_, name, _, _) in enumerate(steps) if name in taps) if taps else 0
    return steps[: last + 1]


def num_convs(taps: Sequence[str] = DEFAULT_TAPS) -> int:
    return sum(1 for kind, *_ in _plan(taps) if kind == "conv")


def init_params(
    seed: int = 0,
    taps: Sequence[str] = DEFAULT_TAPS,
    device=constants.DEFAULT_DEVICE,
) -> Params:
    """Seeded He-normal init of the convs up to the last tap (zero biases)."""
    dev = constants.resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    params: Params = {}
    for kind, name, cin, cout in _plan(taps):
        if kind != "conv":
            continue
        kernel = torch.randn((3, 3, cin, cout), generator=gen) * float(np.sqrt(2.0 / (9 * cin)))
        params[name] = {"kernel": kernel.to(dev), "bias": torch.zeros(cout, device=dev)}
    return params


def params_from_jax(tree: Mapping[str, Any], device=constants.DEFAULT_DEVICE) -> Params:
    """The port's VGG parameters from a JAX parameter tree (dicts of arrays)."""
    dev = constants.resolve_device(device)
    return {
        name: {leaf: torch.as_tensor(np.array(v, dtype=np.float32)).to(dev)
               for leaf, v in p.items()}
        for name, p in tree.items()
    }


def extract_features(
    params: Params,
    x: torch.Tensor,
    taps: Sequence[str] = DEFAULT_TAPS,
    compute_dtype: Optional[torch.dtype] = None,
) -> Dict[str, torch.Tensor]:
    """Run NHWC images through VGG19 features, returning the tapped
    activations. The convs zero-pad by 1 (torch's default), not reflect."""
    want = set(taps)
    out: Dict[str, torch.Tensor] = {}
    for kind, name, _, _ in _plan(taps):
        if kind == "conv":
            p = params[name]
            x = layers.conv2d(x, p["kernel"], p["bias"], 1, compute_dtype=compute_dtype,
                              padding="zeros")
        elif kind == "relu":
            x = torch.relu(x)
        else:
            x = layers.max_pool(x, 2, 2)
        if name in want:
            out[name] = x
    return out


def style_gram_targets(
    params: Params,
    style_image: torch.Tensor,
    style_layers: Sequence[str] = STYLE_LAYERS,
    compute_dtype: Optional[torch.dtype] = None,
) -> Dict[str, torch.Tensor]:
    """The per-tap Gram targets [1, C, C] of a style image [1, H, W, 3],
    computed once and held constant."""
    with torch.no_grad():
        feats = extract_features(params, style_image, style_layers, compute_dtype)
        return {name: losses.gram_matrix(feats[name]) for name in style_layers}


def perceptual_loss(
    params: Params,
    input_image: torch.Tensor,
    content_image: torch.Tensor,
    style_grams: Mapping[str, torch.Tensor],
    style_weight: float = 100_000.0,
    content_weight: float = 1.0,
    content_layers: Sequence[str] = CONTENT_LAYERS,
    compute_dtype: Optional[torch.dtype] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Weighted style + content objective, one VGG pass per image. Content
    targets come from ``content_image`` with no gradient; style targets are
    the precomputed ``style_grams``. Returns ``(total, {"style", "content"})``
    with the unweighted sums."""
    taps = tuple(sorted(set(tuple(style_grams) + tuple(content_layers))))
    in_feats = extract_features(params, input_image, taps, compute_dtype)
    with torch.no_grad():
        content_feats = extract_features(params, content_image, content_layers, compute_dtype)
    s_loss = sum(losses.style_loss(in_feats[name], tgt.detach())
                 for name, tgt in style_grams.items())
    c_loss = sum(losses.content_loss(in_feats[name], content_feats[name])
                 for name in content_layers)
    total = style_weight * s_loss + content_weight * c_loss
    return total, {"style": s_loss, "content": c_loss}


def feature_loss(
    params: Params,
    input_image: torch.Tensor,
    content_image: torch.Tensor,
    feature_layers: Sequence[str] = FEATURE_LOSS_LAYERS,
    compute_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Feature-reconstruction loss at the ReLU_4 tap (the eval loss)."""
    in_feats = extract_features(params, input_image, feature_layers, compute_dtype)
    with torch.no_grad():
        tgt_feats = extract_features(params, content_image, feature_layers, compute_dtype)
    return sum(losses.feature_reconstruction_loss(in_feats[name], tgt_feats[name])
               for name in feature_layers)


# torchvision vgg19().features module indices of each conv, in order.
_TORCHVISION_CONV_IDX = (0, 2, 5, 7, 10, 12, 14, 16, 19, 21, 23, 25, 28, 30, 32, 34)


def import_torch_state_dict(
    state_dict: Mapping[str, Any],
    taps: Sequence[str] = DEFAULT_TAPS,
    device=constants.DEFAULT_DEVICE,
) -> Params:
    """Convert a torchvision VGG19 state dict (OIHW kernels; keys ``0.weight``
    or ``features.0.weight``) to the port's HWIO parameters."""
    dev = constants.resolve_device(device)

    def get(idx: int, leaf: str) -> torch.Tensor:
        for k in (f"{idx}.{leaf}", f"features.{idx}.{leaf}"):
            if k in state_dict:
                return torch.as_tensor(np.asarray(state_dict[k], dtype=np.float32))
        raise KeyError(f"VGG19 state dict missing features.{idx}.{leaf}")

    params: Params = {}
    for conv_i in range(1, num_convs(taps) + 1):
        idx = _TORCHVISION_CONV_IDX[conv_i - 1]
        params[f"Conv2d_{conv_i}"] = {
            "kernel": get(idx, "weight").permute(2, 3, 1, 0).contiguous().to(dev),
            "bias": get(idx, "bias").to(dev),
        }
    return params


def find_weights(weights_path: Optional[str] = None) -> Optional[str]:
    """The first existing pretrained VGG19 weights file, or None: an explicit
    path (which must exist), then ``$STX_VGG19_WEIGHTS``, then
    ``data/models/vgg19.npz`` / ``vgg19.pth`` / ``vgg19-dcbb9e9d.pth`` under
    the project root."""
    candidates = []
    if weights_path:
        if not os.path.isfile(weights_path):
            raise FileNotFoundError(f"VGG19 weights file not found: {weights_path!r}")
        candidates.append(weights_path)
    env = os.environ.get("STX_VGG19_WEIGHTS")
    if env:
        candidates.append(env)
    for name in ("vgg19.npz", "vgg19.pth", "vgg19-dcbb9e9d.pth"):
        candidates.append(os.path.join(constants.PROJECT_ROOT_PATH, "data", "models", name))
    for path in candidates:
        if path and os.path.isfile(path):
            return path
    return None


def load_params(
    weights_path: Optional[str] = None,
    taps: Sequence[str] = DEFAULT_TAPS,
    seed: int = 0,
    device=constants.DEFAULT_DEVICE,
) -> Params:
    """VGG19 tap parameters: pretrained if a weights file is found
    (:func:`find_weights`), else the seeded init (with a warning)."""
    path = find_weights(weights_path)
    if path:
        if path.endswith(".npz"):
            with np.load(path) as data:
                return import_torch_state_dict(dict(data), taps, device)
        sd = torch.load(path, map_location="cpu", weights_only=True)
        return import_torch_state_dict({k: v.numpy() for k, v in sd.items()}, taps, device)
    get_logger().warning(
        "No pretrained VGG19 weights found (searched explicit path, "
        "$STX_VGG19_WEIGHTS, data/models/vgg19.{npz,pth}); using "
        "deterministic seeded initialization. Set STX_VGG19_WEIGHTS for "
        "pretrained features.",
    )
    return init_params(seed, taps, device)
