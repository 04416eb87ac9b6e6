"""The port's CUDA kernels on the GPU, against their plain versions, and the
forward on the kernels against the forward on the CPU.

Needs an NVIDIA GPU and nvcc (the kernels are built at first use); every
test here skips without them. Run on the GPU machine with
``python -m pytest tests/test_torch_cuda.py -m cuda``.
"""

import os
import shutil

import numpy as np
import pytest
import torch

from styletransfer_tpu_torch.models import transformer
from styletransfer_tpu_torch.ops import layers
from styletransfer_tpu_torch.ops.cuda import conv3x3, fused_instance_norm, instance_norm

pytestmark = pytest.mark.cuda

# (rtol, atol): f32 is the same arithmetic in another summation order; in
# bf16 both sides round the same f32 value, so the last of 8 bits can flip.
TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2 ** -7, 1e-3)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    if shutil.which("nvcc") is None and not os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("needs nvcc to build the kernels")
    layers.disable_tf32()
    return torch.device("cuda")


def _close(a, b, dtype):
    rtol, atol = TOL[dtype]
    torch.testing.assert_close(a.float(), b.float(), rtol=rtol, atol=atol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 16, 16, 128, 128), (3, 9, 7, 64, 136)])
@pytest.mark.parametrize("relu", [False, True])
def test_conv3x3_kernel_matches_plain(cuda, dtype, shape, relu):
    B, H, W, C, O = shape
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(B, H + 2, W + 2, C, device=cuda, generator=g).to(dtype)
    w = (torch.randn(3, 3, C, O, device=cuda, generator=g) * 0.05).to(dtype)
    b = torch.randn(O, device=cuda, generator=g)
    before = conv3x3.launches
    out, s, ss = conv3x3.conv3x3_valid(x, w, b, relu)
    torch.cuda.synchronize()
    assert conv3x3.launches == before + 1
    pout, ps, pss = conv3x3.conv3x3_valid_plain(x, w, b, relu)
    _close(out, pout, dtype)
    torch.testing.assert_close(s, ps, rtol=1e-4, atol=1e-2)
    torch.testing.assert_close(ss, pss, rtol=1e-4, atol=1e-2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [
    ((2, 16, 16, 32), 1, True, None, "reflect", False),
    ((2, 16, 16, 32), 4, True, None, "reflect", False),
    ((2, 16, 16, 128), 1, False, 1, "reflect", False),
    ((2, 9, 7, 128), 1, False, 1, "edge", False),
    ((2, 16, 16, 64), 0, False, 0, "reflect", False),
    ((2, 12, 12, 128), 1, True, None, "reflect", True),
    ((1, 300, 5, 4), 2, True, None, "edge", False),
])
def test_instance_norm_kernel_matches_plain(cuda, dtype, case):
    (N, H, W, C), pad, relu, rp, mode, with_stats = case
    g = torch.Generator(device=cuda).manual_seed(1)
    x = (torch.randn(N, H, W, C, device=cuda, generator=g) * 3 + 1).to(dtype)
    scale = torch.rand(C, device=cuda, generator=g) + 0.5
    bias = torch.randn(C, device=cuda, generator=g)
    res = None
    if rp is not None:
        res = torch.randn(N, H + 2 * rp, W + 2 * rp, C, device=cuda, generator=g).to(dtype)
    stats = None
    if with_stats:
        stats = (x.float().sum(dim=(1, 2)), (x.float() ** 2).sum(dim=(1, 2)))
    args = (x, scale, bias, res, rp or 0, relu, pad, mode, stats)
    before = instance_norm.launches
    out = instance_norm.instance_norm_pad(*args)
    torch.cuda.synchronize()
    assert instance_norm.launches == before + 1
    _close(out, instance_norm.instance_norm_pad_plain(*args), dtype)


# (shape, residual, relu): every combination the training forward uses, plus
# ragged shapes (a chunk that does not divide H*W, four channels).
_FUSED_CASES = [
    ((2, 16, 16, 32), False, True),
    ((2, 9, 7, 128), True, False),
    ((2, 12, 12, 64), True, True),
    ((1, 300, 5, 4), False, False),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", _FUSED_CASES)
def test_fused_instance_norm_kernels_match_plain(cuda, dtype, case):
    (N, H, W, C), with_res, relu = case
    g = torch.Generator(device=cuda).manual_seed(3)
    x = (torch.randn(N, H, W, C, device=cuda, generator=g) * 3 + 1).to(dtype)
    res = torch.randn(N, H, W, C, device=cuda, generator=g).to(dtype) if with_res else None
    scale = torch.rand(C, device=cuda, generator=g) + 0.5
    bias = torch.randn(C, device=cuda, generator=g)
    gy = torch.randn(N, H, W, C, device=cuda, generator=g).to(dtype)
    before = fused_instance_norm.fwd_launches, fused_instance_norm.bwd_launches
    out, mean, inv = fused_instance_norm.forward(x, scale, bias, res, relu)
    dx, dscale, dbias = fused_instance_norm.backward(gy, x, res, mean, inv, scale, bias, relu)
    torch.cuda.synchronize()
    assert (fused_instance_norm.fwd_launches, fused_instance_norm.bwd_launches) == \
        (before[0] + 1, before[1] + 1)
    pout, pmean, pinv = fused_instance_norm.forward_plain(x, scale, bias, res, relu)
    torch.testing.assert_close(mean, pmean, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(inv, pinv, rtol=1e-5, atol=1e-5)
    _close(out, pout, dtype)
    # The backward from the same statistics: the mask is bit-equal, the sums
    # over H*W (up to 1,500 pixels here) differ in order only.
    pdx, pdscale, pdbias = fused_instance_norm.backward_plain(gy, x, res, mean, inv, scale, bias,
                                                              relu)
    _close(dx, pdx, dtype)
    torch.testing.assert_close(dscale, pdscale, rtol=1e-4, atol=1e-2)
    torch.testing.assert_close(dbias, pdbias, rtol=1e-4, atol=1e-2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_instance_norm_gradients_on_the_card_match_the_cpu(cuda, dtype):
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((2, 8, 8, 16)).astype(np.float32)).to(dtype)
    res = torch.from_numpy(rng.standard_normal((2, 8, 8, 16)).astype(np.float32)).to(dtype)
    scale = torch.from_numpy((rng.random(16) + 0.5).astype(np.float32))
    bias = torch.from_numpy(rng.standard_normal(16).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((2, 8, 8, 16)).astype(np.float32))

    def grads(device):
        leaves = [t.to(device).requires_grad_() for t in (x, res, scale, bias)]
        out = fused_instance_norm.fused_instance_norm(leaves[0], leaves[2], leaves[3],
                                                      residual=leaves[1], relu=True)
        (out.float() * w.to(device)).sum().backward()
        return [t.grad.cpu() for t in leaves]

    before = fused_instance_norm.bwd_launches
    got = grads(cuda)
    assert fused_instance_norm.bwd_launches == before + 1
    for a, b in zip(got, grads("cpu")):
        _close(a, b, dtype)


def test_wrappers_raise_on_cuda_tensors_they_cannot_take(cuda):
    x = torch.zeros(1, 6, 6, 32, device=cuda)
    w = torch.zeros(3, 3, 32, 8, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        conv3x3.conv3x3_valid(x.transpose(1, 2), w, torch.zeros(8, device=cuda))
    with pytest.raises(ValueError, match="on"):
        conv3x3.conv3x3_valid(x, w, torch.zeros(8))
    with pytest.raises(ValueError, match="on"):
        instance_norm.instance_norm_pad(x, torch.ones(32), torch.zeros(32, device=cuda))


@pytest.mark.parametrize("precision,steps", [("f32", 1), ("bf16", 16)])
def test_serve_on_the_kernels_matches_the_cpu(cuda, precision, steps):
    from styletransfer_tpu_torch.engines import fast

    params = transformer.init_params(seed=0, device="cpu")
    params_gpu = transformer.params_from_jax(transformer.params_to_tree(params), device=cuda)
    batch = torch.from_numpy(
        np.random.default_rng(0).integers(0, 256, size=(2, 64, 64, 3), dtype=np.uint8))
    serve = fast.make_serve_fn(precision)
    before = conv3x3.launches, instance_norm.launches
    got = serve(params_gpu, batch.to(cuda)).cpu()
    assert (conv3x3.launches - before[0], instance_norm.launches - before[1]) == (10, 15)
    want = serve(params, batch)
    assert int((got.int() - want.int()).abs().max()) <= steps
