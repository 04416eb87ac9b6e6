"""Multi-style inference in the port (models/multistyle.py,
engines/multistyle.py, ``fast_st convert-image-multi``, the IN-pad plain
version with per-image affines) against the JAX package, on the CPU. One
seeded JAX multi-style tree of S = 3 styles, each style's affines drawn
apart, is carried across with ``multistyle.params_from_jax``."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from click.testing import CliRunner
from PIL import Image

from styletransfer_tpu import ckpt as jckpt
from styletransfer_tpu import constants as jconstants
from styletransfer_tpu.clis import cli as jcli
from styletransfer_tpu.engines import multistyle as jengine
from styletransfer_tpu.models import multistyle as jms
from styletransfer_tpu_torch import constants as tconstants
from styletransfer_tpu_torch.clis import cli as tcli
from styletransfer_tpu_torch.engines import multistyle as engine
from styletransfer_tpu_torch.models import multistyle as ms
from styletransfer_tpu_torch.models import transformer as tt
from styletransfer_tpu_torch.ops.cuda import fused_instance_norm, instance_norm

SIZE = 32
S = 3
# The forward against JAX's in f32, as tests/test_torch_transformer.py holds
# the single-style forward: the port's instance norms take the exact
# two-pass variance, JAX's the one-pass form (about 1e-6 apart, compounded
# over 15 norms).
F32_TOL = dict(rtol=1e-4, atol=1e-4)
# bf16, as there: both round activations to bf16 at different places.
BF16_ATOL = 0.06
# The selected and blended affines: a gather is exact; a blend is a
# product of depth S in f32 (JAX's einsum and torch's matmul).
BLEND_TOL = dict(rtol=1e-6, atol=1e-6)
# PNGs of the two commands from one checkpoint: one step of 255.
U8_STEPS = 1


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The CPU ops here are small: one thread each, so that test processes
    running side by side do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jax_tree():
    """A JAX multi-style tree whose styles differ: every [S, C] affine gets
    seeded per-style offsets."""
    tree = jax.device_get(jms.init_params(jax.random.PRNGKey(7), num_styles=S))
    rng = np.random.default_rng(7)

    def perturb(path, leaf):
        if jms._is_affine_path(path):
            return (np.asarray(leaf) + rng.normal(0, 0.3, leaf.shape)).astype(np.float32)
        return np.asarray(leaf)
    return jax.tree_util.tree_map_with_path(perturb, tree)


@pytest.fixture(scope="module")
def port_params(jax_tree):
    return ms.params_from_jax(jax_tree, device="cpu")


def _x(seed, n=3):
    return np.random.default_rng(seed).standard_normal((n, SIZE, SIZE, 3)).astype(np.float32)


def _flat(tree):
    return {".".join(str(k.key) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(tree)}


def test_params_carry_across_with_their_style_axis(jax_tree, port_params):
    assert ms.num_styles(port_params) == jms.num_styles(jax_tree) == S
    assert port_params.in1.scale.shape == (S, 32) and port_params.res2.in2.bias.shape == (S, 128)
    want = _flat(jax_tree)
    got = tt.params_to_tree(port_params)
    assert _flat(got).keys() == want.keys()
    for k, v in _flat(got).items():
        np.testing.assert_array_equal(v, want[k])
    single = jax.device_get(jms.transformer.init_params(jax.random.PRNGKey(0)))
    with pytest.raises(ValueError, match="multi-style"):
        ms.params_from_jax(single, device="cpu")


def test_init_params_repeats_the_single_style_affines():
    params = ms.init_params(3, num_styles=4, device="cpu")
    single = tt.init_params(3, device="cpu")
    assert ms.num_styles(params) == 4
    for s in range(4):
        assert torch.equal(params.up2_in.bias[s], single.up2_in.bias)
        assert torch.equal(params.res5.in1.scale[s], single.res5.in1.scale)
    assert torch.equal(params.conv1.kernel, single.conv1.kernel)


def test_select_and_blend_styles_match_jax(jax_tree, port_params):
    idx = np.array([2, 0, 2, 1], np.int32)
    weights = np.random.default_rng(1).dirichlet(np.ones(S), size=4).astype(np.float32)
    for jfn, tfn, arg in ((jms.select_styles, ms.select_styles, idx),
                          (jms.blend_styles, ms.blend_styles, weights)):
        want = _flat(jax.device_get(jfn(jax_tree, jnp.asarray(arg))))
        got = _flat(tt.params_to_tree(tfn(port_params, torch.from_numpy(arg))))
        assert got.keys() == want.keys()
        for k, v in got.items():
            np.testing.assert_allclose(v, want[k], **BLEND_TOL)
            if k.endswith(("scale", "bias")) and "conv" not in k.split(".")[-2]:
                assert v.shape[0] == 4


@pytest.mark.parametrize("idx", [[0, 1, 2], [2, 2, 0], [1, 0, 1]])
def test_apply_matches_jax_on_mixed_indices(jax_tree, port_params, idx):
    x = _x(sum(idx))
    want = np.asarray(jms.apply(jax_tree, jnp.asarray(x), jnp.asarray(idx, jnp.int32)))
    got = ms.apply(port_params, torch.from_numpy(x), torch.tensor(idx))
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)


def test_apply_blend_matches_jax(jax_tree, port_params):
    x = _x(11)
    w = np.array([[0.5, 0.5, 0.0], [0.2, 0.3, 0.5], [0.0, 0.0, 1.0]], np.float32)
    want = np.asarray(jms.apply_blend(jax_tree, jnp.asarray(x), jnp.asarray(w)))
    got = ms.apply_blend(port_params, torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)


def test_apply_matches_jax_bf16(jax_tree, port_params):
    x = _x(12)
    idx = [1, 2, 0]
    want = np.asarray(jms.apply(jax_tree, jnp.asarray(x), jnp.asarray(idx, jnp.int32),
                                compute_dtype=jnp.bfloat16))
    got = ms.apply(port_params, torch.from_numpy(x), torch.tensor(idx), torch.bfloat16)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=BF16_ATOL)


def test_a_mixed_batch_is_each_image_alone_and_one_hot_is_the_index(port_params):
    # Each image alone: the serving forward's six library convs may sum in
    # another order at another batch size (about 1e-6 in f32), the rest is
    # per image.
    x = torch.from_numpy(_x(13))
    idx = torch.tensor([2, 0, 1])
    mixed = engine.stylize(port_params, x, idx)
    for i in range(3):
        torch.testing.assert_close(mixed[i:i + 1],
                                   engine.stylize(port_params, x[i:i + 1], idx[i:i + 1]),
                                   rtol=1e-5, atol=1e-5)
    onehot = torch.nn.functional.one_hot(idx, S).float()
    assert torch.equal(engine.stylize_blend(port_params, x, onehot), mixed)
    # Style 1 for every image is the single-style net of style 1's affines.
    single = ms.select_styles(port_params, [1])
    for m in single.modules():
        if isinstance(m, tt.InstanceNorm):
            m.scale.data, m.bias.data = m.scale.data[0], m.bias.data[0]
    assert torch.equal(engine.stylize(port_params, x, torch.tensor([1, 1, 1])),
                       tt.apply(single, x))


@pytest.mark.parametrize("spec", ["0", "2", "0.3,0.7,0", "1,1,2", "0,0,5", None, ""])
def test_style_parser_accepts_what_jax_accepts(spec):
    w, tag = engine._make_style_parser(S)(spec)
    jw, jtag = jengine._make_style_parser(S)(spec)
    np.testing.assert_allclose(w, jw, rtol=1e-7)
    assert tag == jtag and w.dtype == np.float32


@pytest.mark.parametrize("spec,match", [
    ("nan,1,1", "finite"), ("inf,0,0", "finite"), ("-0.5,1,0.5", "non-negative"),
    ("0,0,0", "positive sum"), ("0.5,0.5", "expected 3"), ("1,1,1,1", "expected 3"),
    ("3", "out of range"), ("-1", "out of range"), ("abc", "invalid literal"),
])
def test_style_parser_rejects_what_jax_rejects(spec, match):
    with pytest.raises(ValueError, match=match):
        engine._make_style_parser(S)(spec)
    with pytest.raises(ValueError):
        jengine._make_style_parser(S)(spec)


@pytest.mark.parametrize("mode,pad,stats", [("reflect", 1, False), ("edge", 1, True),
                                            ("reflect", 0, False)])
def test_instance_norm_pad_plain_per_image_affines_are_each_image_alone(mode, pad, stats):
    rng = np.random.default_rng(21)
    x = torch.from_numpy(rng.standard_normal((3, 6, 5, 8)).astype(np.float32))
    res = torch.from_numpy(rng.standard_normal((3, 8, 7, 8)).astype(np.float32))
    scale = torch.from_numpy(rng.uniform(0.5, 1.5, (3, 8)).astype(np.float32))
    bias = torch.from_numpy(rng.standard_normal((3, 8)).astype(np.float32))
    sums = (x.sum(dim=(1, 2)), (x * x).sum(dim=(1, 2))) if stats else None
    got = instance_norm.instance_norm_pad(x, scale, bias, res, 1, True, pad, mode, sums)
    for i in range(3):
        one = None if sums is None else (sums[0][i:i + 1], sums[1][i:i + 1])
        want = instance_norm.instance_norm_pad_plain(x[i:i + 1], scale[i], bias[i],
                                                     res[i:i + 1], 1, True, pad, mode, one)
        assert torch.equal(got[i:i + 1], want)


def test_per_image_affines_are_checked_and_refused_by_the_training_kernels():
    x = torch.randn(2, 4, 4, 8)
    for bad in (torch.ones(3, 8), torch.ones(2, 4), torch.ones(8, 2)):
        with pytest.raises(ValueError, match="scale must be"):
            instance_norm.instance_norm_pad(x, bad, bad.clone())
    with pytest.raises(ValueError, match="differ"):
        instance_norm.instance_norm_pad(x, torch.ones(2, 8), torch.zeros(8))
    scale = torch.ones(2, 8, requires_grad=True)
    with pytest.raises(NotImplementedError, match=r"\[N, C\] dscale"):
        fused_instance_norm.fused_instance_norm(x, scale, torch.zeros(2, 8))
    mean_inv = torch.zeros(2, 8)
    with pytest.raises(NotImplementedError, match="multi-style training"):
        fused_instance_norm.backward(x, x, None, mean_inv, mean_inv, scale.detach(),
                                     torch.zeros(2, 8))


@pytest.fixture
def project(tmp_path, monkeypatch, jax_tree):
    """A project directory holding a JAX-written multi-style checkpoint
    (``train-multi``'s msgpack) and a photo, for both packages' CLIs."""
    jckpt.save_epoch(jax_tree, jengine.MODEL_NAME, "trio", 0,
                     str(tmp_path / "data" / "models"))
    Image.fromarray(np.random.default_rng(3).integers(0, 256, (48, 40, 3), dtype=np.uint8)).save(
        tmp_path / "photo.png")
    monkeypatch.setattr(jconstants, "PROJECT_ROOT_PATH", str(tmp_path))
    monkeypatch.setattr(tconstants, "PROJECT_ROOT_PATH", str(tmp_path))
    return tmp_path


def _read(path):
    return np.asarray(Image.open(path)).astype(np.int32)


@pytest.mark.parametrize("args,tag", [(["--style-index", "2"], "style2"),
                                      (["--blend", "0.3,0,0.7"], "blend")])
def test_convert_image_multi_cli_matches_the_jax_command(project, args, tag):
    common = ["fast_st", "convert-image-multi", "photo.png", "trio", "--num-styles", str(S)]
    r = CliRunner().invoke(jcli, common + args + ["-o", "jax/"])
    assert r.exit_code == 0, r.output + repr(r.exception)
    r = CliRunner().invoke(tcli, common + args + ["-o", "port/", "--device", "cpu"])
    assert r.exit_code == 0, r.output + repr(r.exception)
    name = f"converted_fast_multi_st_trio_{tag}.png"
    assert os.listdir(project / "port") == [name]
    got, want = _read(project / "port" / name), _read(project / "jax" / name)
    assert got.shape == want.shape == (256, 256, 3)
    assert np.abs(got - want).max() <= U8_STEPS


@pytest.mark.parametrize("args,match", [
    (["--num-styles", "2"], "does not match the template"),
    (["--num-styles", "3", "--style-index", "3"], "out of range"),
    (["--num-styles", "3", "--blend", "1,nan,0"], "finite"),
])
def test_convert_image_multi_cli_refuses_bad_requests(project, args, match):
    r = CliRunner().invoke(tcli, ["fast_st", "convert-image-multi", "photo.png", "trio",
                                  "--device", "cpu", *args])
    assert r.exit_code != 0 and match in str(r.exception)
    assert not (project / "results").exists() or not os.listdir(project / "results")
