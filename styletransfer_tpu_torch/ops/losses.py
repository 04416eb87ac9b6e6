"""Loss functions: Gram/style, content, feature reconstruction and total
variation, on NHWC tensors.

The port of ``styletransfer_tpu/ops/losses.py``. Normalizations are the
reference's:
- Gram matrices are normalized by C*H*W (not the batch);
- the style loss is the MSE between the input Grams and the style Gram
  broadcast over the batch;
- the content loss is a plain MSE over features;
- the feature-reconstruction loss is MSE^2 / (B*C*H*W);
- total variation is the anisotropic L1 sum scaled by 1e-6;
- the temporal loss is ||s_t - s_{t-1}|| / (||c_t - c_{t-1}|| + 1), times its
  weight, with Frobenius norms over the whole batch tensor.

Every loss reduces in f32, whatever the features' dtype.
"""

from __future__ import annotations

import torch


class _Gram(torch.autograd.Function):
    """Gram matrix with the closed-form backward: one product against the
    small symmetrized factor, dF = F (M + M^T) / (C*H*W), instead of
    autograd's two [B, H*W, C] products."""

    @staticmethod
    def forward(ctx, features):
        b, h, w, c = features.shape
        f = features.reshape(b, h * w, c)
        # f32 accumulation and an f32 (or wider) result whatever the
        # features' dtype: a bf16 bmm would round its output to bf16.
        fw = f.to(torch.promote_types(f.dtype, torch.float32))
        g = torch.bmm(fw.transpose(1, 2), fw) / (c * h * w)
        ctx.save_for_backward(features)
        return g

    @staticmethod
    def backward(ctx, m):
        (features,) = ctx.saved_tensors
        b, h, w, c = features.shape
        f = features.reshape(b, h * w, c)
        s = ((m + m.transpose(1, 2)) / (c * h * w)).to(f.dtype)
        return torch.bmm(f, s).reshape(features.shape)


def gram_matrix(features: torch.Tensor) -> torch.Tensor:
    """[B, H, W, C] -> [B, C, C] f32: G[b] = F_b^T F_b / (C*H*W), with F_b the
    [H*W, C] feature matrix of image b."""
    return _Gram.apply(features)


def style_loss(features: torch.Tensor, target_gram: torch.Tensor) -> torch.Tensor:
    """MSE between the features' Gram and a target Gram ([1, C, C] or
    [C, C]), broadcast over the batch."""
    g = gram_matrix(features)
    tgt = target_gram.float()
    if tgt.dim() == 2:
        tgt = tgt[None]
    return (g - tgt).square().mean()


def content_loss(features: torch.Tensor, target_features: torch.Tensor) -> torch.Tensor:
    """Plain MSE between features and target features. The caller detaches
    the target."""
    return (features.float() - target_features.float()).square().mean()


def feature_reconstruction_loss(
    features: torch.Tensor, target_features: torch.Tensor, shards=None
) -> torch.Tensor:
    """MSE squared over B*C*H*W (the reference's FeatureReconstructionLoss).

    With ``shards`` (a ``parallel.distributed.GlobalBatch``) the batch is
    one rank's share of a global batch, and the result is the global
    batch's, the same on every rank."""
    mse = content_loss(features, target_features)
    if shards is None:
        return mse.square() / features.numel()
    return shards.mean(mse).square() / (features.numel() * shards.world)


def total_variation_loss(image: torch.Tensor, regularization_factor: float = 1e-6) -> torch.Tensor:
    """Anisotropic total-variation L1 loss (sum-reduced) on NHWC images."""
    x = image.float()
    dw = (x[:, :, :-1, :] - x[:, :, 1:, :]).abs().sum()
    dh = (x[:, :-1, :, :] - x[:, 1:, :, :]).abs().sum()
    return regularization_factor * (dw + dh)


def temporal_loss(
    old_content: torch.Tensor,
    old_stylized: torch.Tensor,
    current_content: torch.Tensor,
    current_stylized: torch.Tensor,
    temporal_weight: float = 1.0,
    shards=None,
) -> torch.Tensor:
    """Temporal consistency: the change of the stylized stream relative to
    the change of the content stream, ``||s_t - s_{t-1}||_F /
    (||c_t - c_{t-1}||_F + 1) * w``, norms over the full batch tensor (as
    ``torch.Tensor.norm()``). With ``shards`` (a
    ``parallel.distributed.GlobalBatch``) the norms are the global batch's,
    from the ranks' summed squares, and the result is the same on every
    rank."""
    ds = current_stylized.float() - old_stylized.float()
    dc = current_content.float() - old_content.float()
    if shards is None:
        return ds.norm() / (dc.norm() + 1.0) * temporal_weight
    squares = shards.sum(torch.stack([ds.square().sum(), dc.square().sum()]))
    return squares[0].sqrt() / (squares[1].sqrt() + 1.0) * temporal_weight
