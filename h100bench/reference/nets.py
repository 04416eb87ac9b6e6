"""The plain reference: the two configurations, their losses and optimizers
in plain PyTorch (``torch.nn.functional`` on NCHW tensors), f32 with TF32
off.

Written from the published descriptions, not from the program, and
importing nothing of it:

- the ImageTransformNet of Johnson et al. (arXiv:1603.08155, supplementary
  Table 1) with instance norm (Ulyanov et al., arXiv:1607.08022): reflection
  padding of k // 2 before every conv, IN (biased variance, eps 1e-5) with an
  affine scale and bias, five residual blocks ``IN(conv(relu(IN(conv(x))))
  + x)``, nearest x2 upsampling before the two decoder convs;
- VGG19 (arXiv:1409.1556) up to conv3_1, zero padding 1, 2x2 max pools; the
  style taps are the conv outputs conv1_1 .. conv3_1 before their ReLU, the
  content tap conv2_2's (the repository's taps, after tupini07/StyleTransfer);
- Gram matrices ``F^T F / (C H W)``, the style loss the mean squared Gram
  gap summed over the taps, the content loss the mean squared feature gap,
  total variation ``1e-6`` times the L1 sum of neighbour differences;
- Adam as ``torch.optim.Adam`` computes it; L-BFGS is ``torch.optim.LBFGS``.

Weights and images come from the benchmark in the program's layout (NHWC
images, HWIO kernels); this module converts them itself.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator, List, Mapping, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
IN_EPS = 1e-5
TV_WEIGHT = 1e-6

Weights = Mapping[str, torch.Tensor]
# Adam's first and second moments by parameter name, and its step count.
AdamState = Tuple[Weights, Weights, int]

# (name, kernel, in, out, stride) of the transform net's convs, in order.
TRANSFORMNET_CONVS = (
    ("conv1", 9, 3, 32, 1), ("conv2", 3, 32, 64, 2), ("conv3", 3, 64, 128, 2),
    *((f"res{i // 2 + 1}.conv{i % 2 + 1}", 3, 128, 128, 1) for i in range(10)),
    ("up1_conv", 3, 128, 64, 1), ("up2_conv", 3, 64, 32, 1), ("conv_out", 9, 32, 3, 1),
)
TRANSFORMNET_NORMS = (
    ("in1", 32), ("in2", 64), ("in3", 128),
    *((f"res{i // 2 + 1}.in{i % 2 + 1}", 128) for i in range(10)),
    ("up1_in", 64), ("up2_in", 32),
)
# (name, in, out) of VGG19's convs up to conv3_1, the repository's names
# (Conv2d_1 .. Conv2d_5); a 2x2 max pool follows the 2nd and the 4th.
VGG_CONVS = (("Conv2d_1", 3, 64), ("Conv2d_2", 64, 64), ("Conv2d_3", 64, 128),
             ("Conv2d_4", 128, 128), ("Conv2d_5", 128, 256))
CONTENT_TAP = 3  # Conv2d_4


@contextlib.contextmanager
def precision(tf32: bool = False) -> Iterator[None]:
    """f32 convolutions and matmuls with TF32 off (or on), restored after."""
    old = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = old


def transformnet_shapes() -> Dict[str, Tuple[int, ...]]:
    """Every leaf of the transform net: HWIO kernels, biases, IN scales."""
    shapes: Dict[str, Tuple[int, ...]] = {}
    for name, k, cin, cout, _ in TRANSFORMNET_CONVS:
        shapes[f"{name}.kernel"] = (k, k, cin, cout)
        shapes[f"{name}.bias"] = (cout,)
    for name, c in TRANSFORMNET_NORMS:
        shapes[f"{name}.scale"] = (c,)
        shapes[f"{name}.bias"] = (c,)
    return shapes


def vgg_shapes() -> Dict[str, Tuple[int, ...]]:
    shapes: Dict[str, Tuple[int, ...]] = {}
    for name, cin, cout in VGG_CONVS:
        shapes[f"{name}.kernel"] = (3, 3, cin, cout)
        shapes[f"{name}.bias"] = (cout,)
    return shapes


def _stats(device) -> Tuple[torch.Tensor, torch.Tensor]:
    mean = torch.tensor(IMAGENET_MEAN, device=device).view(1, 1, 1, 3)
    std = torch.tensor(IMAGENET_STD, device=device).view(1, 1, 1, 3)
    return mean, std


def normalize_u8(batch_u8: torch.Tensor) -> torch.Tensor:
    """uint8 NHWC -> ImageNet-normalized f32 NHWC."""
    mean, std = _stats(batch_u8.device)
    return (batch_u8.float() / 255.0 - mean) / std


def to_levels(image: torch.Tensor) -> torch.Tensor:
    """A normalized f32 NHWC image as unrounded 8-bit levels in [0, 255]."""
    mean, std = _stats(image.device)
    return torch.clamp(image.float() * std + mean, 0.0, 1.0) * 255.0


def _conv(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor, stride: int = 1,
          reflect: bool = True) -> torch.Tensor:
    pad = kernel.shape[0] // 2
    w = kernel.permute(3, 2, 0, 1)
    if reflect:
        return F.conv2d(F.pad(x, (pad,) * 4, mode="reflect"), w, bias, stride=stride)
    return F.conv2d(x, w, bias, stride=stride, padding=pad)


def _instance_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    mean = x.mean(dim=(2, 3), keepdim=True)
    var = (x - mean).square().mean(dim=(2, 3), keepdim=True)
    return (x - mean) * torch.rsqrt(var + IN_EPS) * scale.view(1, -1, 1, 1) + \
        bias.view(1, -1, 1, 1)


def transformnet(w: Weights, x: torch.Tensor) -> torch.Tensor:
    """The transform net on normalized NHWC images; normalized NHWC out."""
    def conv(h, name, stride=1):
        return _conv(h, w[f"{name}.kernel"], w[f"{name}.bias"], stride)

    def norm(h, name):
        return _instance_norm(h, w[f"{name}.scale"], w[f"{name}.bias"])

    h = x.permute(0, 3, 1, 2)
    h = torch.relu(norm(conv(h, "conv1"), "in1"))
    h = torch.relu(norm(conv(h, "conv2", 2), "in2"))
    h = torch.relu(norm(conv(h, "conv3", 2), "in3"))
    for i in range(1, 6):
        r = torch.relu(norm(conv(h, f"res{i}.conv1"), f"res{i}.in1"))
        h = norm(conv(r, f"res{i}.conv2") + h, f"res{i}.in2")
    for up in ("up1", "up2"):
        h = F.interpolate(h, scale_factor=2, mode="nearest")
        h = torch.relu(norm(conv(h, f"{up}_conv"), f"{up}_in"))
    return conv(h, "conv_out").permute(0, 2, 3, 1)


def transformnet_levels(w: Weights, batch_u8: torch.Tensor, block: int = 16) -> torch.Tensor:
    """Unrounded output levels of a uint8 batch, ``block`` images at a time."""
    with torch.no_grad():
        return torch.cat([to_levels(transformnet(w, normalize_u8(batch_u8[i:i + block])))
                          for i in range(0, batch_u8.shape[0], block)])


def vgg_taps(v: Weights, x: torch.Tensor, depth: int = len(VGG_CONVS)) -> List[torch.Tensor]:
    """The conv outputs (before ReLU, NCHW) of VGG19's first ``depth`` convs
    on normalized NHWC images."""
    h = x.permute(0, 3, 1, 2)
    taps = []
    for i, (name, _, _) in enumerate(VGG_CONVS[:depth]):
        if i in (2, 4):
            h = F.max_pool2d(h, 2, 2)
        h = _conv(h, v[f"{name}.kernel"], v[f"{name}.bias"], reflect=False)
        taps.append(h)
        h = torch.relu(h)
    return taps


def gram(f: torch.Tensor) -> torch.Tensor:
    b, c, hh, ww = f.shape
    m = f.reshape(b, c, hh * ww)
    return torch.bmm(m, m.transpose(1, 2)) / (c * hh * ww)


def style_grams(v: Weights, style: torch.Tensor) -> List[torch.Tensor]:
    with torch.no_grad():
        return [gram(f) for f in vgg_taps(v, style)]


def total_variation(y: torch.Tensor) -> torch.Tensor:
    return TV_WEIGHT * ((y[:, :, :-1, :] - y[:, :, 1:, :]).abs().sum()
                        + (y[:, :-1, :, :] - y[:, 1:, :, :]).abs().sum())


def perceptual(v: Weights, y: torch.Tensor, content: torch.Tensor,
               grams: Sequence[torch.Tensor], style_weight: float,
               content_weight: float) -> torch.Tensor:
    """Weighted style and content loss of images ``y`` against the Grams and
    the content images' conv2_2 features."""
    taps = vgg_taps(v, y)
    with torch.no_grad():
        target = vgg_taps(v, content, CONTENT_TAP + 1)[CONTENT_TAP]
    style = sum((gram(f) - g).square().mean() for f, g in zip(taps, grams))
    content_loss = (taps[CONTENT_TAP] - target).square().mean()
    return style_weight * style + content_weight * content_loss


def train_loss(w: Weights, v: Weights, grams: Sequence[torch.Tensor], batch_u8: torch.Tensor,
               style_weight: float, content_weight: float) -> torch.Tensor:
    """The fast_st training objective of a uint8 batch."""
    x = normalize_u8(batch_u8)
    y = transformnet(w, x)
    return perceptual(v, y, x, grams, style_weight, content_weight) + total_variation(y)


class Adam:
    """``torch.optim.Adam``'s arithmetic (no weight decay, no amsgrad)."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float = 1e-3,
                 betas: Tuple[float, float] = (0.9, 0.999), eps: float = 1e-8,
                 state: Optional[AdamState] = None):
        self.params, self.lr, self.betas, self.eps = params, lr, betas, eps
        if state is None:
            self.m = {k: torch.zeros_like(p) for k, p in params.items()}
            self.v = {k: torch.zeros_like(p) for k, p in params.items()}
            self.t = 0
        else:
            m, v, self.t = state
            self.m = {k: m[k].clone() for k in params}
            self.v = {k: v[k].clone() for k in params}

    @torch.no_grad()
    def step(self, grads: Mapping[str, torch.Tensor]) -> None:
        self.t += 1
        b1, b2 = self.betas
        c1, c2 = 1 - b1 ** self.t, 1 - b2 ** self.t
        for k, p in self.params.items():
            g = grads[k]
            self.m[k].mul_(b1).add_(g, alpha=1 - b1)
            self.v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
            denom = (self.v[k].sqrt() / c2 ** 0.5).add_(self.eps)
            p.addcdiv_(self.m[k], denom, value=-self.lr / c1)


def train_steps(w0: Weights, v: Weights, style: torch.Tensor, batches: Sequence[torch.Tensor],
                style_weight: float, content_weight: float, lr: float = 1e-3,
                state: Optional[AdamState] = None
                ) -> Tuple[List[float], Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """Adam steps from ``w0`` on each uint8 batch, from Adam's ``state``
    where they continue a run. Returns each step's loss, the first step's
    gradient, and the parameters after the last step."""
    params = {k: t.detach().clone().requires_grad_() for k, t in w0.items()}
    grams = style_grams(v, style)
    opt = Adam(params, lr, state=state)
    losses, first_grad = [], None
    for batch in batches:
        loss = train_loss(params, v, grams, batch, style_weight, content_weight)
        grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
        if first_grad is None:
            first_grad = {k: g.detach().clone() for k, g in grads.items()}
        opt.step(grads)
        losses.append(float(loss.detach()))
    return losses, first_grad, {k: p.detach() for k, p in params.items()}


def gatys_objective(v: Weights, content: torch.Tensor, style: torch.Tensor,
                    style_weight: float, content_weight: float):
    """The Gatys loss of normalized NHWC pixels against one content image
    and one style image (no total variation)."""
    grams = style_grams(v, style)
    with torch.no_grad():
        target = vgg_taps(v, content, CONTENT_TAP + 1)[CONTENT_TAP]

    def loss(pixels: torch.Tensor) -> torch.Tensor:
        taps = vgg_taps(v, pixels)
        return (style_weight * sum((gram(f) - g).square().mean() for f, g in zip(taps, grams))
                + content_weight * (taps[CONTENT_TAP] - target).square().mean())

    return loss


def gatys_lbfgs(objective, content: torch.Tensor, steps: int, history_size: int = 100
                ) -> Tuple[List[float], torch.Tensor]:
    """``steps`` calls of ``torch.optim.LBFGS.step`` on ``objective`` from
    the content image (lr 1, up to 20 iterations, no line search). Returns
    the loss at the start of each step and the final pixels."""
    x = content.detach().clone().requires_grad_()
    opt = torch.optim.LBFGS([x], lr=1, max_iter=20, history_size=history_size,
                            tolerance_grad=1e-7, tolerance_change=1e-9)

    def closure():
        opt.zero_grad()
        loss = objective(x)
        loss.backward()
        return loss

    losses = [float(opt.step(closure).detach()) for _ in range(steps)]
    return losses, x.detach()
