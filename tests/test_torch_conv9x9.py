"""conv_out's direct 9x9 conv (ops/cuda/conv9x9.py) on the CPU: the plain
version of both instances against ``F.conv2d``; ``Conv9x9Function`` under
``gradcheck`` and against autograd of ``layers.conv2d`` on reflect- and
zero-padded inputs; the transform net's forwards and conv_out's gradients
against the JAX package's; the wrapper's checks, its plan and the kernel
source's constants. On the card (the ``cuda`` marker; they skip here) the
kernel against the plain version at the cells' shapes and a ragged photo,
bit-for-bit repeats and batch invariance. JAX is imported only by the tests
that use it, so that the card's machine, which has none, collects the
file."""

import os
import re

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from styletransfer_tpu_torch.models import transformer as tt
from styletransfer_tpu_torch.ops import layers
from styletransfer_tpu_torch.ops.cuda import conv9x9 as c9

# Of the transform net: f32 forward and gradients against JAX, the
# tolerances of tests/test_torch_transformer.py and test_torch_training.py.
F32_TOL = dict(rtol=1e-4, atol=1e-4)
GRAD_REL_L2 = 5e-5


def _inputs(B, Hp, Wp, C, O, seed=0, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    xp = torch.randn(B, Hp, Wp, C, generator=g, dtype=dtype)
    w = torch.randn(9, 9, C, O, generator=g, dtype=dtype) / (81 * C) ** 0.5
    b = torch.randn(O, generator=g, dtype=dtype) * 0.1
    return xp, w, b


def _torch_conv(xp, w, b=None):
    out = F.conv2d(xp.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1)).permute(0, 2, 3, 1)
    return out if b is None else out + b


@pytest.mark.parametrize("C,O", c9.PAIRS)
@pytest.mark.parametrize("B,Hp,Wp", [(1, 9, 9), (2, 13, 17), (3, 20, 11)])
@pytest.mark.parametrize("with_bias", [False, True])
def test_plain_is_the_9x9_conv(C, O, B, Hp, Wp, with_bias):
    xp, w, b = _inputs(B, Hp, Wp, C, O, seed=Hp + C)
    b = b if with_bias else None
    got = c9.conv9x9_valid(xp, w, b)
    assert got.shape == (B, Hp - 8, Wp - 8, O)
    torch.testing.assert_close(got, _torch_conv(xp, w, b), rtol=1e-5, atol=1e-5)


def test_the_input_gradient_is_the_rotated_conv_of_the_padded_gradient():
    """dxp = conv9x9(zero_pad(dy, 8), rotated(w)), from the definition."""
    xp, w, _ = _inputs(2, 14, 12, 32, 3, seed=3, dtype=torch.float64)
    xp.requires_grad_()
    dy = torch.randn(2, 6, 4, 3, dtype=torch.float64)
    (want,) = torch.autograd.grad(_torch_conv(xp, w), xp, dy)
    got = c9.conv9x9_valid(layers.zero_pad(dy, 8), c9.rotated(w))
    assert c9.rotated(w).shape == (9, 9, 3, 32)
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("with_bias", [False, True])
def test_function_passes_gradcheck_in_float64(with_bias):
    xp, w, b = _inputs(1, 10, 11, 32, 3, seed=5, dtype=torch.float64)
    args = (xp.requires_grad_(), w.requires_grad_(), b.requires_grad_() if with_bias else None)
    assert torch.autograd.gradcheck(c9.Conv9x9Function.apply, args, eps=1e-6, atol=1e-6)


@pytest.mark.parametrize("pad", ["reflect", "zeros"])
def test_function_gradients_match_autograd_of_the_plain_conv(pad):
    g = torch.Generator().manual_seed(7)
    x = torch.randn(2, 12, 13, 32, generator=g)
    w = torch.randn(9, 9, 32, 3, generator=g) / 50
    b = torch.randn(3, generator=g)
    dy = torch.randn(2, 12, 13, 3, generator=g)
    padded = layers.reflect_pad if pad == "reflect" else layers.zero_pad

    def grads(conv):
        leaves = [t.clone().requires_grad_() for t in (x, w, b)]
        out = conv(padded(leaves[0], 4), leaves[1], leaves[2])
        return (out, *torch.autograd.grad(out, leaves, dy))

    got = grads(c9.Conv9x9Function.apply)
    want = grads(layers.conv2d)
    for name, a, e in zip(("out", "dx", "dw", "db"), got, want):
        assert a.shape == e.shape, name
        torch.testing.assert_close(a, e, rtol=1e-5, atol=1e-5, msg=name)


def test_function_takes_the_input_gradient_only_when_asked(monkeypatch):
    """The backward runs the (3, 32) conv only for an input that wants it."""
    calls = []
    real = c9.conv9x9_valid
    monkeypatch.setattr(c9, "conv9x9_valid", lambda *a: calls.append(a[1].shape) or real(*a))
    xp, w, b = _inputs(1, 11, 10, 32, 3, seed=9)
    (dw,) = torch.autograd.grad(c9.Conv9x9Function.apply(xp, w.requires_grad_(), b).sum(), [w])
    assert dw.shape == w.shape and calls == [w.shape]
    calls.clear()
    c9.Conv9x9Function.apply(xp.requires_grad_(), w, b).sum().backward()
    assert calls == [w.shape, (9, 9, 3, 32)]


@pytest.fixture(scope="module")
def jx():
    """(jax, jax.numpy, the JAX package's transformer module)."""
    jax = pytest.importorskip("jax")
    from styletransfer_tpu.models import transformer as jt

    return jax, jax.numpy, jt


@pytest.fixture(scope="module")
def jax_params(jx):
    jax, _, jt = jx
    return jax.device_get(jt.init_params(jax.random.PRNGKey(3)))


@pytest.fixture(scope="module")
def port_params(jax_params):
    return tt.params_from_jax(jax_params, device="cpu")


@pytest.mark.parametrize("size", [24, 30])
def test_the_serving_forward_matches_jax(jx, jax_params, port_params, size):
    _, jnp, jt = jx
    x = np.random.default_rng(size).standard_normal((2, size, size, 3)).astype(np.float32)
    want = np.asarray(jt.apply(jax_params, jnp.asarray(x)))
    before = c9.launches
    got = tt.apply(port_params, torch.from_numpy(x))
    assert c9.launches == before  # the CPU computes the plain version
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)


@pytest.mark.parametrize("pad_mode", ["reflect", "zeros"])
def test_the_stacked_forward_and_conv_out_s_gradients_match_jax(jx, jax_params, port_params,
                                                                pad_mode):
    jax, jnp, jt = jx
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 24, 24, 3)).astype(np.float32)
    r = rng.standard_normal((2, 24, 24, 3)).astype(np.float32)
    reflect = pad_mode == "reflect"

    def loss(params, x):
        out = jt._apply_stacked(params, x, None, use_pallas=False, reflect=reflect)
        return jnp.sum(out * r), out

    (_, want), (jgrads, jdx) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        jax_params, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    out = tt.apply_stacked(port_params, xt, pad_mode=pad_mode)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), **F32_TOL)
    p = port_params.conv_out
    dw, db, dx = torch.autograd.grad((out * torch.from_numpy(r)).sum(), [p.kernel, p.bias, xt])
    for name, got, exp in (("kernel", dw, jgrads["conv_out"]["kernel"]),
                           ("bias", db, jgrads["conv_out"]["bias"]), ("x", dx, jdx)):
        exp = np.asarray(exp)
        assert np.linalg.norm(got.numpy() - exp) / np.linalg.norm(exp) < GRAD_REL_L2, name


@pytest.mark.parametrize("xp,w,bias,error,match", [
    ((1, 12, 12, 16), (9, 9, 16, 3), (3,), ValueError, "w must be"),
    ((1, 12, 12, 32), (9, 9, 32, 4), (4,), ValueError, "w must be"),
    ((1, 12, 12, 32), (3, 3, 32, 3), (3,), ValueError, "w must be"),
    ((1, 12, 12, 3), (9, 9, 32, 3), (3,), ValueError, "w must be"),
    ((1, 12, 12, 32), (9, 9, 32, 3), (32,), ValueError, "bias must be"),
    ((1, 8, 12, 32), (9, 9, 32, 3), (3,), ValueError, "H, W >= 1"),
    ((12, 12, 32), (9, 9, 32, 3), (3,), ValueError, "xp must be"),
])
def test_the_wrapper_refuses_shapes_it_cannot_take(xp, w, bias, error, match):
    with pytest.raises(error, match=match):
        c9.conv9x9_valid(torch.zeros(xp), torch.zeros(w), torch.zeros(bias))


@pytest.mark.parametrize("which", ["xp", "w", "bias"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_the_wrapper_refuses_other_dtypes(which, dtype):
    args = {"xp": torch.zeros(1, 10, 10, 32), "w": torch.zeros(9, 9, 32, 3),
            "bias": torch.zeros(3)}
    args[which] = args[which].to(dtype)
    with pytest.raises(TypeError, match=f"{which} must be float32"):
        c9.conv9x9_valid(**args)


def test_the_wrapper_has_no_backward():
    xp, w, b = _inputs(1, 10, 10, 32, 3)
    with pytest.raises(NotImplementedError, match="Conv9x9Function"):
        c9.conv9x9_valid(xp, w.requires_grad_(), b)


@pytest.mark.parametrize("B,H,W,C,O,run,blocks", [
    (64, 256, 256, 32, 3, 16, 1024),   # the offline cell: about 8 waves of one block an SM
    (33, 256, 256, 32, 3, 16, 528),    # 4 waves
    (32, 256, 256, 32, 3, 8, 2048),
    (4, 256, 256, 32, 3, 8, 256),      # the training cell: about two blocks an SM
    (1, 756, 1012, 32, 3, 8, 768),     # a ragged photo
    (4, 264, 264, 3, 32, 8, 612),      # the training cell's input gradient
])
def test_the_plan_follows_the_shape(B, H, W, C, O, run, blocks):
    got = c9.plan(B, H, W, C, O)
    assert got["run"] == run and got["blocks"] == blocks
    assert got["tile"] == c9.TILES[(C, O, run)]


def test_the_tiles_match_the_kernel_source():
    src = open(os.path.join(os.path.dirname(c9.__file__), "..", "..", "csrc",
                            "conv9x9.cu")).read()
    tiles = {name: tuple(int(v) for v in args.split(","))
             for name, args in re.findall(r"using (\w+) = Tile<([\d, ]+)>;", src)}
    # (C, O, RUN, OCT, TR, TCR, CK, MINB): a block owns TR rows of TCR * RUN
    # pixels; RUN = 16 is planned at one block an SM.
    assert {(C, O, run): (tr, tcr * run) for C, O, run, _, tr, tcr, _, _ in tiles.values()} \
        == c9.TILES
    assert tiles["Fwd16"][7] == 1
    # The kernel's name stays out of the benchmark's conv3x3_valid and IN
    # groups (h100bench/groups.py).
    names = re.findall(r"__global__ void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\(", src)
    assert names == ["conv9x9_f32_kernel"]
    assert not any(n.startswith("conv3x3_") or "tile_sums_kernel" in n or n == "in_kernel"
                   for n in names)


# (B, Hp, Wp, C, O): the offline cell's forward, the training cell's forward
# and input gradient, and a 756 x 1012 photo (sides no multiple of a tile).
_CELL_SHAPES = [(64, 264, 264, 32, 3), (4, 264, 264, 32, 3), (4, 272, 272, 3, 32),
                (1, 764, 1020, 32, 3)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the kernel has no CPU form")
    layers.disable_tf32()
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", _CELL_SHAPES)
def test_the_kernel_matches_plain_at_the_cells_shapes(cuda, shape):
    """The kernel against the plain version (cuDNN, TF32 off): the largest
    gap at most 1e-5 of the largest output; a repeat bit for bit; one launch
    a call; image 0 of the batch bit for bit image 0 alone."""
    B, Hp, Wp, C, O = shape
    g = torch.Generator(device=cuda).manual_seed(Hp + C)
    xp = torch.randn(B, Hp, Wp, C, device=cuda, generator=g)
    w = torch.randn(9, 9, C, O, device=cuda, generator=g) / (81 * C) ** 0.5
    b = torch.randn(O, device=cuda, generator=g) * 0.1 if O == 3 else None
    before = c9.launches
    out = c9.conv9x9_valid(xp, w, b)
    again = c9.conv9x9_valid(xp, w, b)
    alone = c9.conv9x9_valid(xp[:1].contiguous(), w, b)
    torch.cuda.synchronize()
    assert c9.launches == before + 3
    want = c9.conv9x9_plain(xp, w, b)
    assert out.shape == want.shape == (B, Hp - 8, Wp - 8, O)
    assert float((out - want).abs().max()) <= 1e-5 * float(want.abs().max())
    assert torch.equal(out, again)
    assert torch.equal(out[:1], alone)


@pytest.mark.cuda
@pytest.mark.parametrize("pad", ["reflect", "zeros"])
def test_the_function_s_gradients_match_autograd_on_the_card(cuda, pad):
    """At the training cell's shape: the forward and the input gradient on
    the kernel, two launches; dx, dw and db against autograd of the plain
    conv."""
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn(4, 256, 256, 32, device=cuda, generator=g)
    w = torch.randn(9, 9, 32, 3, device=cuda, generator=g) / 50
    b = torch.randn(3, device=cuda, generator=g)
    dy = torch.randn(4, 256, 256, 3, device=cuda, generator=g)
    padded = layers.reflect_pad if pad == "reflect" else layers.zero_pad

    def grads(conv):
        leaves = [t.clone().requires_grad_() for t in (x, w, b)]
        out = conv(padded(leaves[0], 4), leaves[1], leaves[2])
        return (out, *torch.autograd.grad(out, leaves, dy))

    before = c9.launches
    got = grads(c9.Conv9x9Function.apply)
    torch.cuda.synchronize()
    assert c9.launches == before + 2
    want = grads(layers.conv2d)
    for name, a, e in zip(("out", "dx", "dw", "db"), got, want):
        rel = float((a - e).norm() / e.norm())
        assert rel < 1e-5, (name, rel)
