"""The plain versions of the port's two kernels against the Pallas kernels
they replace (interpret mode, as tests/test_pallas*.py run them), and the
wrappers' CPU behaviour. The CUDA kernels themselves are held against these
plain versions on the GPU (tests/test_torch_cuda.py, chip_smoke.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from styletransfer_tpu.models import transformer as jt
from styletransfer_tpu.ops.pallas import instance_norm as pin
from styletransfer_tpu.ops.pallas.conv3x3 import conv3x3_valid as jax_conv3x3
from styletransfer_tpu_torch.ops.cuda import conv3x3, instance_norm


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("relu", [False, True])
def test_conv3x3_plain_matches_pallas(relu):
    rng = np.random.default_rng(0)
    B, H, W, C, O = 2, 16, 16, 128, 128
    x = rng.standard_normal((B, H + 2, W + 2, C)).astype(np.float32)
    w = (rng.standard_normal((3, 3, C, O)) * 0.05).astype(np.float32)
    b = rng.standard_normal(O).astype(np.float32)
    out, s, ss = conv3x3.conv3x3_valid_plain(_t(x), _t(w), _t(b), relu)
    jout, js, jss = jax_conv3x3(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                                relu=relu, interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=2e-5)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(ss.numpy(), np.asarray(jss), rtol=1e-4, atol=1e-4)


def test_conv3x3_plain_bf16_rounds_the_f32_result(rng):
    x = rng.standard_normal((1, 6, 6, 32)).astype(np.float32)
    w = (rng.standard_normal((3, 3, 32, 8)) * 0.1).astype(np.float32)
    b = rng.standard_normal(8).astype(np.float32)
    xb, wb = _t(x).bfloat16(), _t(w).bfloat16()
    out, s, ss = conv3x3.conv3x3_valid_plain(xb, wb, _t(b))
    ref, rs, rss = conv3x3.conv3x3_valid_plain(xb.float(), wb.float(), _t(b))
    assert out.dtype == torch.bfloat16 and s.dtype == torch.float32
    assert torch.equal(out, ref.bfloat16())
    assert torch.equal(s, rs) and torch.equal(ss, rss)


# The cases of tests/test_pallas.py::test_fused_in_padded_matches_pad_of_reference.
@pytest.mark.parametrize("shape,pad,relu,respad", [
    ((2, 16, 16, 32), 1, True, None),
    ((2, 16, 16, 32), 4, True, None),
    ((2, 16, 16, 128), 1, False, 1),
    ((2, 16, 16, 64), 0, False, 0),
])
def test_instance_norm_pad_plain_matches_pallas(rng, shape, pad, relu, respad):
    b, h, w, c = shape
    x = rng.standard_normal(shape).astype(np.float32)
    s = rng.standard_normal(c).astype(np.float32)
    bb = rng.standard_normal(c).astype(np.float32)
    residual = None
    if respad is not None:
        residual = rng.standard_normal((b, h + 2 * respad, w + 2 * respad, c)).astype(np.float32)
    want = pin.fused_instance_norm_padded(
        jnp.asarray(x), jnp.asarray(s), jnp.asarray(bb),
        residual=None if residual is None else jnp.asarray(residual),
        relu=relu, pad=pad, res_is_padded=respad or 0, interpret=True,
    )
    got = instance_norm.instance_norm_pad_plain(
        _t(x), _t(s), _t(bb), None if residual is None else _t(residual),
        respad or 0, relu, pad,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def _jax_in_pad(x, scale, bias, pad, relu, residual, mode):
    return jt._in_pad(jnp.asarray(x), {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
                      pad=pad, relu=relu,
                      residual=None if residual is None else jnp.asarray(residual),
                      mode=mode)


@pytest.mark.parametrize("relu,with_res", [(True, False), (False, True)])
def test_instance_norm_pad_edge_mode_matches_jax_in_pad(rng, relu, with_res):
    x = rng.standard_normal((2, 5, 6, 16)).astype(np.float32)
    scale = rng.standard_normal(16).astype(np.float32)
    bias = rng.standard_normal(16).astype(np.float32)
    res = rng.standard_normal((2, 7, 8, 16)).astype(np.float32) if with_res else None
    got = instance_norm.instance_norm_pad_plain(
        _t(x), _t(scale), _t(bias), None if res is None else _t(res), 1, relu, 1, "edge")
    want = _jax_in_pad(x, scale, bias, 1, relu,
                       None if res is None else res[:, 1:-1, 1:-1, :], "edge")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_instance_norm_pad_precomputed_stats_match_jax_in_pad(rng):
    """stats=(sums, sumsqs) takes the one-pass clamped form, which is what
    the JAX pad-early forward uses for every instance norm."""
    x = (rng.standard_normal((2, 8, 8, 32)) * 3 + 2).astype(np.float32)
    scale = rng.standard_normal(32).astype(np.float32)
    bias = rng.standard_normal(32).astype(np.float32)
    xt = _t(x)
    stats = (xt.sum(dim=(1, 2)), (xt * xt).sum(dim=(1, 2)))
    got = instance_norm.instance_norm_pad_plain(xt, _t(scale), _t(bias), relu=True, pad=1,
                                                stats=stats)
    want = _jax_in_pad(x, scale, bias, 1, True, None, "reflect")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_instance_norm_pad_bf16_adds_the_residual_in_bf16(rng):
    x = _t(rng.standard_normal((1, 4, 4, 8)).astype(np.float32)).bfloat16()
    r = _t(rng.standard_normal((1, 4, 4, 8)).astype(np.float32)).bfloat16()
    one, zero = torch.ones(8), torch.zeros(8)
    got = instance_norm.instance_norm_pad_plain(x, one, zero, residual=r)
    want = instance_norm.instance_norm_pad_plain(x + r, one, zero)  # bf16 add, then IN
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want)


def test_conv3x3_wrapper_on_cpu_uses_plain_version(rng):
    x = _t(rng.standard_normal((2, 6, 5, 32)).astype(np.float32))
    w = _t((rng.standard_normal((3, 3, 32, 16)) * 0.1).astype(np.float32))
    b = _t(rng.standard_normal(16).astype(np.float32))
    before = conv3x3.launches
    got = conv3x3.conv3x3_valid(x, w, b, relu=True)
    want = conv3x3.conv3x3_valid_plain(x, w, b, relu=True)
    assert conv3x3.launches == before  # no kernel launched
    for g, wt in zip(got, want):
        assert torch.equal(g, wt)


def test_instance_norm_wrapper_on_cpu_uses_plain_version(rng):
    x = _t(rng.standard_normal((2, 6, 5, 8)).astype(np.float32))
    res = _t(rng.standard_normal((2, 8, 7, 8)).astype(np.float32))
    scale, bias = torch.rand(8) + 0.5, torch.randn(8)
    before = instance_norm.launches
    got = instance_norm.instance_norm_pad(x, scale, bias, res, 1, False, 1, "edge")
    want = instance_norm.instance_norm_pad_plain(x, scale, bias, res, 1, False, 1, "edge")
    assert instance_norm.launches == before
    assert torch.equal(got, want)


@pytest.mark.parametrize("bad", ["rank", "dtype", "w_shape", "w_dtype", "bias", "channels"])
def test_conv3x3_wrapper_rejects_what_the_kernel_does_not_take(bad):
    x, w, b = torch.zeros(1, 4, 4, 32), torch.zeros(3, 3, 32, 8), torch.zeros(8)
    if bad == "rank":
        x = x[0]
    elif bad == "dtype":
        x, w = x.double(), w.double()
    elif bad == "w_shape":
        w = torch.zeros(5, 5, 32, 8)
    elif bad == "w_dtype":
        w = w.bfloat16()
    elif bad == "bias":
        b = torch.zeros(4)
    else:
        x, w = torch.zeros(1, 4, 4, 12), torch.zeros(3, 3, 12, 8)
    with pytest.raises((ValueError, TypeError)):
        conv3x3.conv3x3_valid(x, w, b)


@pytest.mark.parametrize("bad", ["scale", "residual", "mode", "pad", "stats", "channels"])
def test_instance_norm_wrapper_rejects_what_the_kernel_does_not_take(bad):
    x, s, b = torch.zeros(1, 4, 4, 8), torch.ones(8), torch.zeros(8)
    kw = {}
    if bad == "scale":
        s = s.double()
    elif bad == "residual":
        kw = {"residual": torch.zeros(1, 4, 4, 8), "res_pad": 1}
    elif bad == "mode":
        kw = {"mode": "zeros"}
    elif bad == "pad":
        kw = {"pad": 4}
    elif bad == "stats":
        kw = {"stats": (torch.zeros(8), torch.zeros(8))}
    else:
        x, s, b = torch.zeros(1, 4, 4, 6), torch.ones(6), torch.zeros(6)
    with pytest.raises((ValueError, TypeError)):
        instance_norm.instance_norm_pad(x, s, b, **kw)
