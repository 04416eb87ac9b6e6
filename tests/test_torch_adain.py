"""AdaIN (models/adain.py, engines/adain.py, ``fast_st convert-adain``) on
the CPU, at the published widths: the forward on the kernels' plain versions
against the plain reference (tests/plain_adain.py), the alpha blend, pairs
taken apart, the folded 1x1 conv, the released layout's import, the spans,
the command, and the benchmark's copy of the reference."""

import importlib.util
import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from click.testing import CliRunner
from PIL import Image

import plain_adain as plain
from styletransfer_tpu_torch import constants as tconstants
from styletransfer_tpu_torch.clis import cli as tcli
from styletransfer_tpu_torch.engines import adain as engine
from styletransfer_tpu_torch.models import adain
from styletransfer_tpu_torch.ops import layers
from styletransfer_tpu_torch.ops.cuda import conv3x3_flat
from styletransfer_tpu_torch.utils import profiling

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The program and the reference compute the same f32 function in another
# order (the 1x1 conv folded into conv1_1, each phase's 2x2 taps summed
# before the products, the statistics of the IN kernel's plain version):
# outputs of about 0.5 differ by about 1e-6 through 19 convs, 1e-4 of one
# output level.
ATOL = 2e-5


@pytest.fixture(scope="module")
def params():
    return adain.init_params(seed=3, device="cpu")


def _pairs(b, side, seed, style_side=None):
    g = torch.Generator().manual_seed(seed)
    content = torch.rand(b, side, side, 3, generator=g)
    s = style_side or side
    style = torch.rand(b, s, s, 3, generator=g)
    return content, style


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _reference(params, content, style, alpha=1.0):
    vgg, dec = adain.export_torch_state_dict(params)
    out = plain.stylize(vgg, dec, _nchw(content), _nchw(style), alpha)
    return out.permute(0, 2, 3, 1)


@pytest.mark.parametrize("side", [32, 48])
def test_apply_matches_the_plain_reference(params, side):
    content, style = _pairs(2, side, seed=side)
    got = adain.apply(params, content, style)
    want = _reference(params, content, style)
    assert got.shape == (2, side, side, 3)
    assert float((got - want).abs().max()) <= ATOL
    # The two pairs have different styles, and so different outputs.
    assert float((got[0] - got[1]).abs().max()) > 1e-2


def test_a_style_of_another_size_and_one_style_for_all(params):
    content, style = _pairs(2, 32, seed=5, style_side=48)
    got = adain.apply(params, content, style)
    assert float((got - _reference(params, content, style)).abs().max()) <= ATOL
    one = adain.apply(params, content, style[:1])
    want = _reference(params, content, style[:1].expand(2, -1, -1, -1))
    assert float((one - want).abs().max()) <= ATOL


def test_alpha_zero_is_the_decoder_of_the_content_s_features(params):
    content, style = _pairs(2, 32, seed=7)
    vgg, dec = adain.export_torch_state_dict(params)
    want = plain.decoder(dec, plain.encoder(vgg, _nchw(content))).permute(0, 2, 3, 1)
    got = adain.apply(params, content, style, alpha=0.0)
    assert float((got - want).abs().max()) <= ATOL


@pytest.mark.parametrize("alpha", [0.0, 0.3, 1.0])
def test_the_norm_blends_the_features_linearly(params, alpha):
    content, style = _pairs(2, 32, seed=11)
    x = adain.encode(params, content)
    y = adain.encode(params, style)
    scale, bias = adain.adain_affine(x, y, alpha)
    from styletransfer_tpu_torch.ops.cuda.instance_norm import instance_norm_pad

    t = instance_norm_pad(x, scale, bias, pad=1)[:, 1:-1, 1:-1, :]
    want = (alpha * plain.adain(_nchw(x), _nchw(y)) + (1 - alpha) * _nchw(x)).permute(0, 2, 3, 1)
    assert float((t - want).abs().max()) <= 1e-5 * float(want.abs().max())
    assert float((adain.apply(params, content, style, alpha)
                  - _reference(params, content, style, alpha)).abs().max()) <= ATOL


def test_permuting_the_pairs_permutes_the_outputs(params):
    content, style = _pairs(3, 32, seed=13)
    perm = torch.tensor([2, 0, 1])
    out = adain.apply(params, content, style)
    permuted = adain.apply(params, content[perm], style[perm])
    assert float((permuted - out[perm]).abs().max()) <= 1e-6


def test_the_folded_input_conv_matches_the_unfolded_one(params):
    x = _pairs(2, 32, seed=17)[0]
    enc = params.enc
    kernel, bias = adain._fold_input_conv(enc.conv0, enc.conv1_1)
    got = conv3x3_flat.conv3x3_im2col(layers.reflect_pad(x, 1), kernel, bias, relu=True)
    z = F.conv2d(_nchw(x), enc.conv0.kernel.permute(3, 2, 0, 1), enc.conv0.bias)
    want = F.relu(F.conv2d(F.pad(z, (1, 1, 1, 1), mode="reflect"),
                           enc.conv1_1.kernel.permute(3, 2, 0, 1), enc.conv1_1.bias))
    torch.testing.assert_close(got, want.permute(0, 2, 3, 1), rtol=1e-5, atol=1e-5)


def test_the_released_layout_round_trips(params, tmp_path):
    vgg, dec = adain.export_torch_state_dict(params)
    assert sorted(int(k.split(".")[0]) for k in vgg if k.endswith(".weight")) == [
        0, 2, 5, 9, 12, 16, 19, 22, 25, 29]
    assert sorted(int(k.split(".")[0]) for k in dec if k.endswith(".weight")) == [
        1, 5, 8, 11, 14, 18, 21, 25, 28]
    assert tuple(vgg["29.weight"].shape) == (512, 256, 3, 3)
    assert tuple(dec["28.weight"].shape) == (3, 64, 3, 3)
    # The released VGG goes on past relu4_1; those layers are ignored.
    vgg_full = {**vgg, "32.weight": torch.zeros(512, 512, 3, 3), "32.bias": torch.zeros(512)}
    torch.save(vgg_full, tmp_path / engine.VGG_FILE)
    torch.save(dec, tmp_path / engine.DECODER_FILE)
    back = engine.load_params(str(tmp_path), device="cpu")
    for (name, a), (name_b, b) in zip(params.state_dict().items(), back.state_dict().items()):
        assert name == name_b and torch.equal(a, b), name
    with pytest.raises(FileNotFoundError, match="vgg_normalised.pth"):
        engine.load_params(str(tmp_path / "missing"), device="cpu")


def test_the_spans_open_once_each_in_order(params):
    content, style = _pairs(1, 32, seed=19)
    serve = engine.make_serve_fn()
    with profiling.record_spans() as rec:
        serve(params, (content * 255).to(torch.uint8), (style * 255).to(torch.uint8))
    names = [s.name for s in sorted(rec.spans, key=lambda s: s.start_ns)]
    enc = ["conv1_1", "conv1_2", "pool1", "conv2_1", "conv2_2", "pool2", "conv3_1", "conv3_2",
           "conv3_3", "conv3_4", "pool3", "conv4_1"]
    dec = ["conv1", "up1", "conv2", "conv3", "conv4", "up2", "conv5", "up3", "conv_out"]
    assert names == (["adain.forward"] + [f"adain.enc.{n}" for n in enc] + ["adain.norm"]
                     + [f"adain.dec.{n}" for n in dec])


def test_the_serving_forward_rounds_the_clamped_output(params):
    content, style = _pairs(2, 32, seed=23)
    c8, s8 = (content * 255).round().to(torch.uint8), (style * 255).round().to(torch.uint8)
    got = engine.make_serve_fn("f32")(params, c8, s8)
    y = adain.apply(params, c8.float() / 255, s8.float() / 255)
    assert got.dtype == torch.uint8
    assert torch.equal(got, torch.round(torch.clamp(y, 0, 1) * 255).to(torch.uint8))


@pytest.mark.parametrize("bad, match", [
    ((2, 36, 32, 3), "multiples of 8"), ((2, 8, 8, 3), "at least 16"),
    ((2, 32, 32, 4), "must be"),
])
def test_apply_refuses_sides_it_cannot_take(params, bad, match):
    with pytest.raises(ValueError, match=match):
        adain.apply(params, torch.zeros(bad), torch.zeros(2, 32, 32, 3))


def test_bf16_is_not_implemented():
    with pytest.raises(NotImplementedError, match="f32 only"):
        engine.make_serve_fn("bf16")


def test_convert_adain_writes_one_png_per_input(params, tmp_path, monkeypatch):
    vgg, dec = adain.export_torch_state_dict(params)
    (tmp_path / "w").mkdir()
    torch.save(vgg, tmp_path / "w" / engine.VGG_FILE)
    torch.save(dec, tmp_path / "w" / engine.DECODER_FILE)
    rng = np.random.default_rng(29)
    (tmp_path / "in").mkdir()
    for i in range(3):
        Image.fromarray(rng.integers(0, 256, (40, 36, 3), dtype=np.uint8)).save(
            tmp_path / "in" / f"pic{i}.png")
    (tmp_path / "in" / "notes.txt").write_text("not an image")
    Image.fromarray(rng.integers(0, 256, (50, 60, 3), dtype=np.uint8)).save(tmp_path / "sty.png")
    monkeypatch.setattr(tconstants, "PROJECT_ROOT_PATH", str(tmp_path))
    args = ["fast_st", "convert-adain", "in", "--style-image", "sty.png", "--weights", "w",
            "--size", "32", "-b", "2", "--alpha", "0.5", "--device", "cpu"]
    result = CliRunner().invoke(tcli, args)
    assert result.exit_code == 0, result.output
    outs = sorted(os.listdir(tmp_path / "results"))
    assert outs == [f"converted_adain_sty_pic{i}.png" for i in range(3)]
    got = np.asarray(Image.open(tmp_path / "results" / outs[1]))
    assert got.shape == (32, 32, 3) and got.dtype == np.uint8


def test_the_benchmark_s_copy_of_the_reference_agrees_bit_for_bit(params):
    path = os.path.join(ROOT, "h100bench", "reference", "adain.py")
    spec = importlib.util.spec_from_file_location("bench_adain_reference", path)
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    vgg, dec = adain.export_torch_state_dict(params)
    content, style = _pairs(2, 32, seed=31)
    for alpha in (1.0, 0.4):
        a = plain.stylize(vgg, dec, _nchw(content), _nchw(style), alpha)
        b = bench.stylize(vgg, dec, _nchw(content), _nchw(style), alpha)
        assert torch.equal(a, b)
