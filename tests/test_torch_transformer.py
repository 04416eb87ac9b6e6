"""The port's transform net (styletransfer_tpu_torch/models/transformer.py)
against the JAX forward, on the same parameters carried across with
``params_from_jax``. On CPU tensors the kernels' wrappers compute their
plain versions, so this holds the port's algorithm against JAX."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from styletransfer_tpu.models import transformer as jt
from styletransfer_tpu_torch.models import transformer as tt
from styletransfer_tpu_torch.ops.cuda import conv3x3, instance_norm, upconv_phase

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "golden.npz")

# f32: the port's instance norms take the exact two-pass variance (or the
# conv's one-pass sums), JAX's the one-pass form: about 1e-6 apart
# (styletransfer_tpu/ops/layers.py:141-146), compounded over 15 norms.
F32_TOL = dict(rtol=1e-4, atol=1e-4)
# bf16: both keep activations in bf16 (8-bit mantissa, 2**-8 relative per
# rounding) but round at different places (the port adds conv biases and
# takes IN statistics in f32 before rounding); each is about 0.03 from the
# f32 output at these sizes, so they may be up to about twice that apart.
BF16_ATOL = 0.06


@pytest.fixture(scope="module")
def jax_params():
    return jax.device_get(jt.init_params(jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def port_params(jax_params):
    return tt.params_from_jax(jax_params, device="cpu")


@pytest.fixture(scope="module")
def jax_apply():
    return jax.jit(jt.apply, static_argnames=("compute_dtype",))


@pytest.mark.parametrize("size", [32, 34])
def test_forward_matches_jax_f32(jax_params, port_params, jax_apply, size):
    x = np.random.default_rng(size).standard_normal((2, size, size, 3)).astype(np.float32)
    want = np.asarray(jax_apply(jax_params, jnp.asarray(x)))
    got = tt.apply(port_params, torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)


def test_forward_matches_jax_bf16(jax_params, port_params, jax_apply):
    x = np.random.default_rng(1).standard_normal((2, 32, 32, 3)).astype(np.float32)
    want = np.asarray(jax_apply(jax_params, jnp.asarray(x), compute_dtype=jnp.bfloat16))
    got = tt.apply(port_params, torch.from_numpy(x), compute_dtype=torch.bfloat16)
    assert got.dtype == torch.float32  # the output keeps the input's dtype
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=BF16_ATOL)


def test_golden_transformer_out(port_params):
    """tests/golden/golden.npz: the JAX init_params(PRNGKey(0)) forward of
    `input` (1x16x16x3), at the JAX golden test's tolerance."""
    d = np.load(GOLDEN)
    got = tt.apply(port_params, torch.from_numpy(d["input"]))
    np.testing.assert_allclose(got.numpy(), d["transformer_out"], rtol=1e-4, atol=1e-5)


def test_forward_on_cpu_launches_no_kernel(port_params):
    before = conv3x3.launches, instance_norm.launches, upconv_phase.launches
    tt.apply(port_params, torch.zeros(1, 16, 16, 3))
    assert (conv3x3.launches, instance_norm.launches, upconv_phase.launches) == before


@pytest.mark.parametrize("in_channels", [3, 6])
def test_init_params_shapes_match_jax(in_channels):
    want = jax.device_get(jt.init_params(jax.random.PRNGKey(0), in_channels=in_channels))
    got = tt.params_to_tree(tt.init_params(seed=0, in_channels=in_channels, device="cpu"))
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    for g, w in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        assert g.shape == w.shape and g.dtype == w.dtype
    assert tt.num_params(tt.init_params(in_channels=in_channels, device="cpu")) == \
        jt.num_params(want)


def test_init_params_is_seeded():
    a = tt.params_to_tree(tt.init_params(seed=3, device="cpu"))
    b = tt.params_to_tree(tt.init_params(seed=3, device="cpu"))
    c = tt.params_to_tree(tt.init_params(seed=4, device="cpu"))
    np.testing.assert_array_equal(a["res2"]["conv1"]["kernel"], b["res2"]["conv1"]["kernel"])
    assert not np.array_equal(a["res2"]["conv1"]["kernel"], c["res2"]["conv1"]["kernel"])


def test_params_from_jax_round_trips(jax_params, port_params):
    """Module names follow the JAX keys, so the tree comes back unchanged."""
    assert "res3.in2.scale" in dict(port_params.named_parameters())
    back = tt.params_to_tree(port_params)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(jax_params)
    for g, w in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(jax_params)):
        np.testing.assert_array_equal(g, w)


def test_module_forward_is_apply(port_params):
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((1, 16, 16, 3))
                         .astype(np.float32))
    assert torch.equal(port_params(x), tt.apply(port_params, x))


def test_zeros_pad_mode_waits_for_a_later_slice(jax_params, port_params):
    """pad_mode="zeros" runs the stacked forward, without autograd, against
    the JAX apply(pad_mode="zeros"). (The name predates the stacked form.)"""
    x = np.random.default_rng(3).standard_normal((2, 32, 32, 3)).astype(np.float32)
    want = np.asarray(jt.apply(jax_params, jnp.asarray(x), pad_mode="zeros"))
    before = conv3x3.launches, instance_norm.launches
    got = tt.apply(port_params, torch.from_numpy(x), pad_mode="zeros")
    assert (conv3x3.launches, instance_norm.launches) == before
    assert not got.requires_grad
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)
    with pytest.raises(ValueError, match="pad_mode"):
        tt.apply(port_params, torch.zeros(1, 16, 16, 3), pad_mode="circular")


@pytest.mark.parametrize("in_channels", [3, 6])
def test_torch_state_dict_round_trips_and_matches_the_jax_importer(tmp_path, in_channels):
    """export -> torch.save -> torch.load -> import gives the parameters
    back; the file holds the reference's keys and OIHW shapes, and the JAX
    importer reads the same tree from it."""
    want = jax.device_get(jt.init_params(jax.random.PRNGKey(4), in_channels=in_channels))
    sd = tt.export_torch_state_dict(tt.params_from_jax(want, device="cpu"))
    jsd = jt.export_torch_state_dict(want)
    assert set(sd) == set(jsd) and "9.insn1.weight" in sd and "13.insn2.bias" in sd
    for k, v in jsd.items():
        np.testing.assert_array_equal(sd[k].numpy(), v, err_msg=k)
    assert tuple(sd["0.weight"].shape) == (32, in_channels, 9, 9)
    path = str(tmp_path / "net.pth")
    torch.save(sd, path)
    loaded = torch.load(path, weights_only=True)
    got = tt.import_torch_state_dict(loaded)
    jgot = jax.device_get(jt.import_torch_state_dict(loaded))
    for tree in (got, jgot):
        assert jax.tree_util.tree_structure(tree) == jax.tree_util.tree_structure(want)
    for g, j, w in zip(*(jax.tree_util.tree_leaves(t) for t in (got, jgot, want))):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(j, w)
    assert tt.export_torch_state_dict(got).keys() == sd.keys()


@pytest.mark.parametrize("bf16", [False, True])
def test_zeros_forward_on_pth_weights_matches_jax(tmp_path, monkeypatch, bf16):
    """A reference .pth through each package's importer, then apply with
    pad_mode="zeros": the port's residual convs go through conv3x3_same
    (its plain version here)."""
    tree = jax.device_get(jt.init_params(jax.random.PRNGKey(6)))
    path = str(tmp_path / "fast_st_ref_epoch0.pth")
    torch.save({k: torch.from_numpy(np.array(v))
                for k, v in jt.export_torch_state_dict(tree).items()}, path)
    loaded = torch.load(path, weights_only=True)
    jparams = jt.import_torch_state_dict(loaded)
    params = tt.params_from_jax(tt.import_torch_state_dict(loaded), device="cpu")
    x = np.random.default_rng(7).standard_normal((2, 32, 32, 3)).astype(np.float32)
    jcd, tcd = (jnp.bfloat16, torch.bfloat16) if bf16 else (None, None)
    want = np.asarray(jt.apply(jparams, jnp.asarray(x), compute_dtype=jcd, pad_mode="zeros"))
    calls = []
    same = tt.conv3x3_same
    monkeypatch.setattr(tt, "conv3x3_same", lambda *a: calls.append(a[0].shape) or same(*a))
    got = tt.apply(params, torch.from_numpy(x), compute_dtype=tcd, pad_mode="zeros")
    assert len(calls) == 10 and all(c == (2, 8, 8, 128) for c in calls)
    if bf16:
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=BF16_ATOL)
    else:
        np.testing.assert_allclose(got.numpy(), want, **F32_TOL)


def test_zeros_training_forward_keeps_the_weight_gradient(port_params):
    """With gradients on, the zero-padded residual convs stay on F.conv2d:
    conv3x3_same has no weight gradient."""
    x = torch.from_numpy(np.random.default_rng(8).standard_normal((1, 16, 16, 3))
                         .astype(np.float32))
    params = tt.params_from_jax(tt.params_to_tree(port_params), device="cpu")
    tt.apply_stacked(params, x, pad_mode="zeros").square().mean().backward()
    assert float(params.res3.conv2.kernel.grad.abs().sum()) > 0
    with torch.no_grad():
        served = tt.apply_stacked(params, x, pad_mode="zeros")
    np.testing.assert_allclose(served.numpy(), tt.apply(params, x, pad_mode="zeros").numpy())


@pytest.mark.parametrize("pad_mode", ["reflect", "zeros"])
@pytest.mark.parametrize("stacked", [False, True])
def test_fixed_order_forward_matches_jax(jax_params, port_params, jax_apply, pad_mode, stacked):
    """``fixed_order=True`` (the video stylizer) runs the library convs on
    conv_direct: the same forward, held to JAX as the default forward is,
    in both forms; forward only."""
    x = np.random.default_rng(9).standard_normal((2, 32, 32, 3)).astype(np.float32)
    want = np.asarray(jt.apply(jax_params, jnp.asarray(x), pad_mode=pad_mode))
    fn = tt.apply_stacked if stacked else tt.apply
    with torch.no_grad():
        got = fn(port_params, torch.from_numpy(x), pad_mode=pad_mode, fixed_order=True)
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)
    if stacked:
        with pytest.raises(NotImplementedError, match="no backward"):
            fn(port_params, torch.from_numpy(x), pad_mode=pad_mode, fixed_order=True)
