"""The port's training instance norm (ops/cuda/fused_instance_norm.py) on
the CPU: its plain forward against the Pallas kernel it replaces (interpret
mode, as tests/test_pallas.py runs it), its autograd gradients against
``jax.grad`` through the kernel's custom VJP, and a float64 gradcheck of the
closed-form backward. The CUDA kernels are held against these plain versions
on the GPU (tests/test_torch_cuda.py, chip_smoke.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from styletransfer_tpu.ops.pallas import instance_norm as pin
from styletransfer_tpu_torch.ops.cuda import fused_instance_norm as fin

# f32: the same arithmetic, summed in another order (the Pallas kernel sums
# through a selection-matrix product).
F32_TOL = dict(rtol=1e-5, atol=1e-5)
# bf16 outputs: both round nearly the same f32 value, so the last of the 8
# mantissa bits may flip (2**-7 relative).
BF16_TOL = dict(rtol=2 ** -7, atol=1e-3)
# Gradients: the closed form against JAX's autodiff of the reference, the
# tolerance of tests/test_pallas.py::test_custom_vjp_matches_xla_grads.
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)


def _data(seed, shape=(3, 8, 16, 32)):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * 2 + 0.5).astype(np.float32)
    res = rng.standard_normal(shape).astype(np.float32)
    scale = (rng.random(shape[-1]) + 0.5).astype(np.float32)
    bias = rng.standard_normal(shape[-1]).astype(np.float32)
    return x, res, scale, bias


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("relu,with_res,bf16", [
    (False, False, False),
    (True, False, False),
    (False, True, False),
    (True, True, False),
    (True, False, True),
    (False, True, True),
])
def test_plain_forward_matches_pallas(relu, with_res, bf16):
    x, res, scale, bias = _data(0)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if bf16 else (jnp.float32, torch.float32)
    want = pin._pallas_forward(
        jnp.asarray(x, jdt), jnp.asarray(scale), jnp.asarray(bias),
        jnp.asarray(res, jdt) if with_res else None, relu=relu, eps=1e-5, interpret=True)
    out, mean, inv = fin.forward_plain(_t(x).to(tdt), _t(scale), _t(bias),
                                       _t(res).to(tdt) if with_res else None, relu)
    assert out.dtype == tdt and mean.dtype == inv.dtype == torch.float32
    np.testing.assert_allclose(out.float().numpy(), np.asarray(want, np.float32),
                               **(BF16_TOL if bf16 else F32_TOL))
    # The statistics handed to the backward: of x + residual, added in f32.
    s = _t(x).to(tdt).double() + (_t(res).to(tdt).double() if with_res else 0)
    np.testing.assert_allclose(mean.numpy(), s.mean(dim=(1, 2)).numpy(), rtol=1e-5, atol=1e-6)
    var = s.var(dim=(1, 2), unbiased=False)
    np.testing.assert_allclose(inv.numpy(), (1 / (var + 1e-5).sqrt()).numpy(), rtol=1e-5)


def test_residual_is_added_in_f32_not_rounded():
    """bf16 x + residual is not rounded to bf16 before the statistics, as the
    Pallas kernel adds them (the IN-pad kernel of the serving path rounds)."""
    rng = np.random.default_rng(1)
    x = _t(rng.standard_normal((1, 4, 4, 8)).astype(np.float32)).bfloat16()
    r = _t(rng.standard_normal((1, 4, 4, 8)).astype(np.float32) * 1e-3).bfloat16()
    one, zero = torch.ones(8), torch.zeros(8)
    _, mean, _ = fin.forward_plain(x, one, zero, r)
    torch.testing.assert_close(mean, (x.float() + r.float()).mean(dim=(1, 2)))
    assert not torch.equal(mean, (x + r).float().mean(dim=(1, 2)))


@pytest.mark.parametrize("relu,with_res,bf16", [
    (False, False, False),
    (True, False, False),
    (False, True, False),
    (True, True, False),
    (True, True, True),
])
def test_gradients_match_jax_grad_through_the_custom_vjp(relu, with_res, bf16):
    x, res, scale, bias = _data(2)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if bf16 else (jnp.float32, torch.float32)

    def jax_loss(x_, s_, b_, r_):
        out = pin._fused(x_, s_, b_, r_ if with_res else None, relu, 1e-5, True)
        return jnp.sum(out.astype(jnp.float32) ** 2)

    jargs = (jnp.asarray(x, jdt), jnp.asarray(scale), jnp.asarray(bias), jnp.asarray(res, jdt))
    want = jax.grad(jax_loss, argnums=(0, 1, 2, 3))(*jargs)

    leaves = [_t(x).to(tdt), _t(scale), _t(bias), _t(res).to(tdt)]
    for t in leaves:
        t.requires_grad_()
    out = fin.fused_instance_norm(leaves[0], leaves[1], leaves[2],
                                  residual=leaves[3] if with_res else None, relu=relu)
    (out.float() ** 2).sum().backward()
    names = ("x", "scale", "bias", "residual")
    for name, t, w in zip(names, leaves, want):
        if name == "residual" and not with_res:
            assert t.grad is None
            continue
        assert t.grad.dtype == t.dtype, name
        tol = BF16_TOL if (bf16 and name in ("x", "residual")) else GRAD_TOL
        np.testing.assert_allclose(t.grad.float().numpy(), np.asarray(w, np.float32),
                                   err_msg=name, **tol)


class _Plain(torch.autograd.Function):
    """The plain forward and the closed-form backward, as one op."""

    @staticmethod
    def forward(ctx, x, scale, bias, residual, relu):
        out, mean, inv = fin.forward_plain(x, scale, bias, residual, relu)
        ctx.save_for_backward(x, scale, bias, residual, mean, inv)
        ctx.relu = relu
        return out

    @staticmethod
    def backward(ctx, g):
        x, scale, bias, residual, mean, inv = ctx.saved_tensors
        dx, dscale, dbias = fin.backward_plain(g, x, residual, mean, inv, scale, bias, ctx.relu)
        return dx, dscale, dbias, (dx if residual is not None else None), None


@pytest.mark.parametrize("relu,with_res", [(False, False), (True, True)])
def test_closed_form_backward_passes_gradcheck(relu, with_res):
    x, res, scale, bias = (torch.from_numpy(a).double() for a in _data(3, (2, 3, 4, 4)))
    args = [x.requires_grad_(), scale.requires_grad_(), bias.requires_grad_(),
            res.requires_grad_() if with_res else None, relu]
    assert torch.autograd.gradcheck(_Plain.apply, args, eps=1e-6, atol=1e-5)


def test_cpu_tensors_launch_no_kernel():
    x, res, scale, bias = (_t(a) for a in _data(4, (2, 4, 4, 8)))
    before = fin.fwd_launches, fin.bwd_launches
    x.requires_grad_()
    fin.fused_instance_norm(x, scale, bias, residual=res, relu=True).sum().backward()
    assert x.grad is not None
    assert (fin.fwd_launches, fin.bwd_launches) == before


def test_backward_respects_needs_input_grad():
    """Only the affine wants a gradient: no dx is computed or returned."""
    x, _, scale, bias = (_t(a) for a in _data(5, (2, 4, 4, 8)))
    scale.requires_grad_()
    fin.fused_instance_norm(x, scale, bias, relu=True).sum().backward()
    assert x.grad is None and bias.grad is None and scale.grad is not None
    _, mean, inv = fin.forward_plain(x, scale, bias, None, True)
    dx, dscale, _ = fin.backward(torch.ones_like(x), x, None, mean, inv, scale.detach(), bias,
                                 relu=True, need_dx=False)
    assert dx is None
    torch.testing.assert_close(dscale, scale.grad)


@pytest.mark.parametrize("bad", ["g_shape", "g_dtype", "mean_shape", "mean_dtype", "channels"])
def test_backward_rejects_what_the_kernel_does_not_take(bad):
    x, scale, bias = torch.zeros(1, 4, 4, 8), torch.ones(8), torch.zeros(8)
    g, mean, inv = torch.zeros(1, 4, 4, 8), torch.zeros(1, 8), torch.ones(1, 8)
    if bad == "g_shape":
        g = torch.zeros(1, 4, 5, 8)
    elif bad == "g_dtype":
        g = g.bfloat16()
    elif bad == "mean_shape":
        mean = torch.zeros(8)
    elif bad == "mean_dtype":
        mean = mean.double()
    else:
        x, scale, bias, g = torch.zeros(1, 4, 4, 6), torch.ones(6), torch.zeros(6), \
            torch.zeros(1, 4, 4, 6)
        mean, inv = torch.zeros(1, 6), torch.ones(1, 6)
    with pytest.raises((ValueError, TypeError)):
        fin.backward(g, x, None, mean, inv, scale, bias)


# The fifteen instance norms of a batch-4 train step at 256 px: (name, x
# shape, calls per step). res.in1 and res.in2 are five calls each.
_TRAIN_CALLS = [
    ("in1", (4, 256, 256, 32), 1), ("in2", (4, 128, 128, 64), 1), ("in3", (4, 64, 64, 128), 1),
    ("res.in1", (4, 64, 64, 128), 5), ("res.in2", (4, 64, 64, 128), 5),
    ("up1_in", (4, 128, 128, 64), 1), ("up2_in", (4, 256, 256, 32), 1),
]


@pytest.mark.parametrize("resident", [132, 264, 528])
@pytest.mark.parametrize("call", _TRAIN_CALLS, ids=[c[0] for c in _TRAIN_CALLS])
def test_backward_plan_at_the_training_shapes(call, resident):
    _, (N, H, W, C), _ = call
    plan = fin.bwd_plan(N, H, W, C, resident)
    G, chunk = plan.image_chunks, plan.chunk
    # Every pixel in exactly one chunk, no chunk empty.
    assert G * chunk >= H * W > (G - 1) * chunk
    # One worker block per chunk and the block that adds dscale and dbias,
    # all resident at once (one launch, one grid-wide barrier).
    assert plan.blocks == N * G + 1 <= resident
    assert plan.scratch == (N, G, 2, C)
    # Chunks of at least BWD_MIN_ELEMS elements, unless the device's blocks
    # run out first.
    assert chunk * C >= fin.BWD_MIN_ELEMS or G == (resident - 1) // N
    assert fin.bwd_plan(N, H, W, C, resident) is plan  # cached


def test_backward_plan_at_the_training_step():
    # At two blocks an SM of an H100 (132 SMs): the 64 x 64 x 128 calls (11
    # of 15) on 128 workers of 128 pixels, the wider ones on 256 or 260.
    plans = {name: fin.bwd_plan(*shape, 264) for name, shape, _ in _TRAIN_CALLS}
    assert {name: (p.blocks - 1, p.chunk) for name, p in plans.items()} == {
        "in1": (260, 1009), "in2": (256, 256), "in3": (128, 128), "res.in1": (128, 128),
        "res.in2": (128, 128), "up1_in": (256, 256), "up2_in": (260, 1009)}


@pytest.mark.parametrize("N,H,W,C,resident", [(300, 4, 4, 8, 264), (2, 1, 1, 4, 528),
                                              (1, 300, 5, 4, 132), (3, 7, 9, 1024, 2)])
def test_backward_plan_at_odd_shapes(N, H, W, C, resident):
    # More images than workers: each takes several chunks; one pixel; one
    # image of 1,500 pixels; wide channels on one worker.
    plan = fin.bwd_plan(N, H, W, C, resident)
    G, chunk = plan.image_chunks, plan.chunk
    assert G * chunk >= H * W > (G - 1) * chunk and plan.scratch == (N, G, 2, C)
    assert plan.blocks == min(N * G, resident - 1) + 1 <= resident
    with pytest.raises(ValueError):
        fin.bwd_plan(N, H, W, C, 1)


def test_backward_constants_are_the_kernels():
    import os

    src = open(os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                            "styletransfer_tpu_torch", "csrc", "instance_norm_bwd.cu")).read()
    assert f"constexpr int NT = {fin.BWD_THREADS};" in src
