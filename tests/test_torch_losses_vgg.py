"""The port's losses and VGG tower (ops/losses.py, models/vgg.py) against
the JAX functions they copy, on the same numpy inputs and, for VGG, the same
parameters carried across with ``vgg.params_from_jax``."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from styletransfer_tpu.models import vgg as jv
from styletransfer_tpu.ops import losses as jl
from styletransfer_tpu_torch.models import vgg as tv
from styletransfer_tpu_torch.ops import losses as tl

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "golden.npz")
# f32 losses and features: the same arithmetic in another summation order.
TOL = dict(rtol=1e-5, atol=1e-6)
# Through the VGG tower (up to five 3x3 convs deep): the tolerance of the
# JAX package's own golden tests.
VGG_TOL = dict(rtol=1e-4, atol=1e-6)


def _x(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.fixture(scope="module")
def jax_vgg():
    return jax.device_get(jv.init_params(jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def port_vgg(jax_vgg):
    return tv.params_from_jax(jax_vgg, device="cpu")


def test_gram_matches_jax_and_the_golden_value():
    x = _x(0, (2, 6, 5, 7))
    np.testing.assert_allclose(tl.gram_matrix(torch.from_numpy(x)).numpy(),
                               np.asarray(jl.gram_matrix(jnp.asarray(x))), **TOL)
    d = np.load(GOLDEN)
    np.testing.assert_allclose(tl.gram_matrix(torch.from_numpy(d["input"])).numpy(), d["gram"],
                               rtol=1e-5, atol=1e-7)


def test_gram_bf16_accumulates_and_returns_f32():
    x = torch.from_numpy(_x(1, (1, 16, 16, 8))).bfloat16()
    g = tl.gram_matrix(x)
    assert g.dtype == torch.float32
    want = x.float().reshape(1, 256, 8).transpose(1, 2) @ x.float().reshape(1, 256, 8) / 2048
    torch.testing.assert_close(g, want, rtol=1e-6, atol=1e-7)


def test_gram_closed_form_backward_matches_autograd():
    x = torch.from_numpy(_x(2, (2, 5, 4, 6))).double().requires_grad_()
    m = torch.from_numpy(_x(3, (2, 6, 6))).double()
    (tl.gram_matrix(x) * m).sum().backward()
    xr = x.detach().clone().requires_grad_()
    f = xr.reshape(2, 20, 6)
    ((f.transpose(1, 2) @ f / 120) * m).sum().backward()
    torch.testing.assert_close(x.grad, xr.grad, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("name", ["style", "content", "feature", "tv"])
def test_losses_and_their_gradients_match_jax(name):
    f, t = _x(4, (2, 6, 5, 7)), _x(5, (2, 6, 5, 7))
    jfn = {"style": lambda a: jl.style_loss(a, jl.gram_matrix(jnp.asarray(t[:1]))),
           "content": lambda a: jl.content_loss(a, jnp.asarray(t)),
           "feature": lambda a: jl.feature_reconstruction_loss(a, jnp.asarray(t)),
           "tv": lambda a: jl.total_variation_loss(a)}[name]
    tfn = {"style": lambda a: tl.style_loss(a, tl.gram_matrix(torch.from_numpy(t[:1]))),
           "content": lambda a: tl.content_loss(a, torch.from_numpy(t)),
           "feature": lambda a: tl.feature_reconstruction_loss(a, torch.from_numpy(t)),
           "tv": lambda a: tl.total_variation_loss(a)}[name]
    want, jg = jax.value_and_grad(jfn)(jnp.asarray(f))
    ft = torch.from_numpy(f).requires_grad_()
    got = tfn(ft)
    got.backward()
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    np.testing.assert_allclose(ft.grad.numpy(), np.asarray(jg), rtol=1e-4, atol=1e-9)


def test_extract_features_matches_jax_at_32px(jax_vgg, port_vgg):
    x = _x(6, (2, 32, 32, 3))
    want = jv.extract_features(jax_vgg, jnp.asarray(x))
    got = tv.extract_features(port_vgg, torch.from_numpy(x))
    assert sorted(got) == sorted(want) == sorted(tv.DEFAULT_TAPS)
    for name in want:
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]), err_msg=name,
                                   rtol=1e-4, atol=1e-4)


def test_perceptual_and_feature_loss_match_jax_at_32px(jax_vgg, port_vgg):
    x, c, s = _x(7, (2, 32, 32, 3)), _x(8, (2, 32, 32, 3)), _x(9, (1, 32, 32, 3))
    jg = jv.style_gram_targets(jax_vgg, jnp.asarray(s))
    tg = tv.style_gram_targets(port_vgg, torch.from_numpy(s))
    for name in jg:
        np.testing.assert_allclose(tg[name].numpy(), np.asarray(jg[name]), **VGG_TOL)
    want, wc = jv.perceptual_loss(jax_vgg, jnp.asarray(x), jnp.asarray(c), jg)
    got, gc = tv.perceptual_loss(port_vgg, torch.from_numpy(x), torch.from_numpy(c), tg)
    np.testing.assert_allclose(float(got), float(want), **VGG_TOL)
    for k in ("style", "content"):
        np.testing.assert_allclose(float(gc[k]), float(wc[k]), **VGG_TOL)
    np.testing.assert_allclose(
        float(tv.feature_loss(port_vgg, torch.from_numpy(x), torch.from_numpy(c))),
        float(jv.feature_loss(jax_vgg, jnp.asarray(x), jnp.asarray(c))), **VGG_TOL)


def test_perceptual_loss_content_target_gets_no_gradient(port_vgg):
    x = torch.from_numpy(_x(10, (1, 16, 16, 3))).requires_grad_()
    c = torch.from_numpy(_x(11, (1, 16, 16, 3))).requires_grad_()
    tg = tv.style_gram_targets(port_vgg, torch.from_numpy(_x(12, (1, 16, 16, 3))))
    total, _ = tv.perceptual_loss(port_vgg, x, c, tg)
    total.backward()
    assert x.grad is not None and c.grad is None


def test_golden_tap_means_and_perceptual_loss(port_vgg):
    """tests/golden/golden.npz (16 px), at the JAX golden tests' tolerances."""
    d = np.load(GOLDEN)
    feats = tv.extract_features(port_vgg, torch.from_numpy(d["input"]))
    for name, f in feats.items():
        np.testing.assert_allclose(float(f.mean()), float(d[f"tapmean_{name}"]),
                                   rtol=1e-4, atol=1e-6)
    rng = np.random.default_rng(42)
    _ = rng.standard_normal((1, 16, 16, 3))  # the input draw
    style = rng.standard_normal((1, 16, 16, 3)).astype(np.float32) * 0.5
    grams = tv.style_gram_targets(port_vgg, torch.from_numpy(style))
    total, comps = tv.perceptual_loss(port_vgg, torch.from_numpy(d["input"]),
                                      torch.from_numpy(style), grams)
    np.testing.assert_allclose(float(total), float(d["perceptual_total"]), rtol=1e-4)
    np.testing.assert_allclose(float(comps["style"]), float(d["perceptual_style"]), rtol=1e-4)
    np.testing.assert_allclose(float(comps["content"]), float(d["perceptual_content"]),
                               rtol=1e-4)


@pytest.mark.parametrize("taps", [("Conv2d_99",), ("ReLU_4", "conv2_2")])
def test_unknown_tap_raises(port_vgg, taps):
    with pytest.raises(ValueError, match="unknown VGG tap"):
        tv.extract_features(port_vgg, torch.zeros(1, 8, 8, 3), taps)
    with pytest.raises(ValueError, match="unknown VGG tap"):
        tv.num_convs(taps)


def test_num_convs_and_init_match_jax_shapes(jax_vgg):
    assert tv.num_convs() == jv.num_convs() == 5
    got = tv.init_params(seed=0, device="cpu")
    assert sorted(got) == sorted(jax_vgg)
    for name, p in got.items():
        for leaf in ("kernel", "bias"):
            assert tuple(p[leaf].shape) == jax_vgg[name][leaf].shape


def _torchvision_state_dict(seed, key_prefix=""):
    """A torchvision-layout VGG19 ``features`` state dict (OIHW) with
    random weights, for the first five convs."""
    rng = np.random.default_rng(seed)
    sd, cin = {}, 3
    for idx, cout in zip((0, 2, 5, 7, 10), (64, 64, 128, 128, 256)):
        sd[f"{key_prefix}{idx}.weight"] = rng.standard_normal((cout, cin, 3, 3)).astype(
            np.float32)
        sd[f"{key_prefix}{idx}.bias"] = rng.standard_normal(cout).astype(np.float32)
        cin = cout
    return sd


@pytest.mark.parametrize("prefix", ["", "features."])
def test_npz_state_dict_imports_like_jax(tmp_path, prefix):
    sd = _torchvision_state_dict(13, prefix)
    path = str(tmp_path / "vgg19.npz")
    np.savez(path, **sd)
    got = tv.load_params(path, device="cpu")
    want = jv.load_params(path)
    assert sorted(got) == sorted(want)
    for name in want:
        for leaf in ("kernel", "bias"):
            np.testing.assert_array_equal(got[name][leaf].numpy(), np.asarray(want[name][leaf]))


def test_pth_state_dict_imports(tmp_path):
    sd = _torchvision_state_dict(14)
    path = str(tmp_path / "vgg19.pth")
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
    got = tv.load_params(path, device="cpu")
    np.testing.assert_array_equal(got["Conv2d_3"]["kernel"].numpy(),
                                  np.transpose(sd["5.weight"], (2, 3, 1, 0)))


def test_missing_explicit_weights_raise_and_no_file_falls_back_to_seeded(tmp_path, monkeypatch):
    with pytest.raises(FileNotFoundError, match="not found"):
        tv.load_params(str(tmp_path / "missing.npz"), device="cpu")
    monkeypatch.delenv("STX_VGG19_WEIGHTS", raising=False)
    monkeypatch.setattr(tv.constants, "PROJECT_ROOT_PATH", str(tmp_path))
    got = tv.load_params(seed=3, device="cpu")
    want = tv.init_params(seed=3, device="cpu")
    assert torch.equal(got["Conv2d_5"]["kernel"], want["Conv2d_5"]["kernel"])
