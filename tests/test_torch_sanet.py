"""SANet (models/sanet.py, engines/sanet.py, ops/cuda/attention.py,
``fast_st convert-sanet``) on the CPU, at the published widths: the forward
on the kernels' plain versions against the plain reference
(tests/plain_sanet.py) at equal and unequal sides, a style batch of one,
each block and the relu5_1 merge, the attention's plain form, the released
layout's round trip, the sides refused, the calls of each kernel's wrapper
(AdaIN's unchanged by the shared encoder), the seeded logits' spread, the
command, and the benchmark's copy of the reference. The ``cuda`` cases (the
attention kernel and the forward on the card) skip here."""

import importlib.util
import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from click.testing import CliRunner
from PIL import Image

import plain_adain
import plain_sanet as plain
from styletransfer_tpu_torch import constants as tconstants
from styletransfer_tpu_torch.clis import cli as tcli
from styletransfer_tpu_torch.engines import sanet as engine
from styletransfer_tpu_torch.models import adain, sanet
from styletransfer_tpu_torch.ops import layers
from styletransfer_tpu_torch.ops.cuda import attention as attn

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The program and the reference compute the same f32 function in another
# order (the 1x1 conv folded into conv1_1, the 1x1 convs as matmuls, each
# phase's 2x2 taps summed before the products): outputs of about 0.5 differ
# by a few 1e-6 through 26 convs and two attentions, 1e-3 of an output level.
ATOL = 2e-5


@pytest.fixture(scope="module")
def params():
    return sanet.init_params(seed=3, device="cpu")


@pytest.fixture(scope="module")
def released(params):
    return sanet.export_torch_state_dict(params)


def _images(b, h, w, seed):
    return torch.rand(b, h, w, 3, generator=torch.Generator().manual_seed(seed))


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _reference(released, content, style):
    if style.shape[0] != content.shape[0]:
        style = style.expand(content.shape[0], -1, -1, -1)
    return plain.stylize(*released, _nchw(content), _nchw(style)).permute(0, 2, 3, 1)


@pytest.mark.parametrize("content_hw, style_hw", [
    ((64, 64), (64, 64)),
    # Nq != Nk, neither a multiple of the kernel's 64 rows or 128 keys.
    ((96, 64), (64, 80)),
])
def test_apply_matches_the_plain_reference(params, released, content_hw, style_hw):
    content = _images(2, *content_hw, seed=content_hw[0])
    style = _images(2, *style_hw, seed=style_hw[1] + 1)
    got = sanet.apply(params, content, style)
    want = _reference(released, content, style)
    assert got.shape == (2, *content_hw, 3)
    assert float((got - want).abs().max()) <= ATOL
    # The two pairs have different styles, and so different outputs.
    assert float((got[0] - got[1]).abs().max()) > 1e-3


def test_one_style_serves_every_pair(params, released):
    content, style = _images(3, 64, 64, seed=5), _images(1, 64, 64, seed=6)
    got = sanet.apply(params, content, style)
    assert float((got - _reference(released, content, style)).abs().max()) <= ATOL
    alone = sanet.apply(params, content[1:2], style)
    assert float((got[1:2] - alone).abs().max()) <= 1e-6


def test_permuting_the_pairs_permutes_the_outputs(params):
    content, style = _images(3, 64, 64, seed=7), _images(3, 64, 64, seed=8)
    perm = torch.tensor([2, 0, 1])
    out = sanet.apply(params, content, style)
    permuted = sanet.apply(params, content[perm], style[perm])
    assert float((permuted - out[perm]).abs().max()) <= 1e-6


@pytest.mark.parametrize("tap, block, which", [("r4_1", "sanet4_1", 0), ("r5_1", "sanet5_1", 1)])
def test_each_block_matches_the_reference_s(params, released, tap, block, which):
    content, style = _images(2, 96, 64, seed=9), _images(2, 64, 80, seed=10)
    vgg, _, tr = released
    c = adain.encode(params, content, "relu5_1", "sanet")[which]
    s = adain.encode(params, style, "relu5_1", "sanet")[which]
    ref_c = plain.encoder(vgg, _nchw(content))[which]
    ref_s = plain.encoder(vgg, _nchw(style))[which]
    assert float((_nchw(c) - ref_c).abs().max()) <= 1e-4 * float(ref_c.abs().max())
    got = sanet.block(getattr(params.transform, block), c, s, tap)
    want = plain.sanet(tr, block, _nchw(c), _nchw(s)).permute(0, 2, 3, 1)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


def test_the_merge_adds_relu5_1_upsampled_to_relu4_1(params, released):
    """The relu5_1 branch reaches the output: upsampled by 2 (nearest) and
    added before the merge conv, as the reference's transform."""
    content, style = _images(1, 64, 96, seed=11), _images(1, 64, 64, seed=12)
    vgg, _, tr = released
    c4, c5 = plain.encoder(vgg, _nchw(content))
    s4, s5 = plain.encoder(vgg, _nchw(style))
    o4 = plain.sanet(tr, "sanet4_1", c4, s4)
    o5 = plain.sanet(tr, "sanet5_1", c5, s5)
    up = layers.upsample_nearest(o5.permute(0, 2, 3, 1), 2)
    torch.testing.assert_close(up, F.interpolate(o5, scale_factor=2).permute(0, 2, 3, 1))
    want = plain.transform(tr, c4, s4, c5, s5)
    alone4 = plain._conv(o4, tr, "merge_conv")
    assert float((want - alone4).abs().max()) > 1e-2  # relu5_1 moves the merge
    merge = params.transform.merge
    x = layers.reflect_pad(o4.permute(0, 2, 3, 1) + up, 1)
    with torch.no_grad():
        got = F.conv2d(_nchw(x), merge.kernel.permute(3, 2, 0, 1), merge.bias)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


@pytest.mark.parametrize("B, kb, nq, nk", [(2, 2, 64, 128), (2, 2, 70, 45), (3, 1, 129, 257),
                                           (1, 1, 1, 1), (2, 2, 5, 300)])
def test_attention_plain_is_the_softmax_of_the_scores_times_v(B, kb, nq, nk):
    g = torch.Generator().manual_seed(nq * 1000 + nk)
    q = torch.randn(B, nq, 512, generator=g) * 0.1
    k = torch.randn(kb, nk, 512, generator=g) * 0.1
    v = torch.randn(kb, nk, 512, generator=g)
    want = torch.stack([torch.softmax(q[i] @ k[i % kb].T, dim=-1) @ v[i % kb]
                        for i in range(B)])
    for fn in (attn.attention_plain, attn.attention):
        got = fn(q, k, v)
        assert got.shape == (B, nq, 512)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("shapes, match", [
    (((2, 8, 512), (2, 8, 500), (2, 8, 500)), "k and v"),
    (((2, 8, 500), (2, 8, 500), (2, 8, 500)), "multiple of 32"),
    (((2, 8, 512), (3, 8, 512), (3, 8, 512)), "k and v"),
    (((2, 8, 512), (2, 8, 512), (2, 9, 512)), "k and v"),
])
def test_attention_refuses_shapes_it_cannot_take(shapes, match):
    with pytest.raises(ValueError, match=match):
        attn.attention(*(torch.zeros(s) for s in shapes))


def test_the_released_layout_round_trips(params, released, tmp_path):
    vgg, dec, tr = released
    assert sorted(int(k.split(".")[0]) for k in vgg if k.endswith(".weight")) == [
        0, 2, 5, 9, 12, 16, 19, 22, 25, 29, 32, 35, 38, 42]
    assert tuple(vgg["42.weight"].shape) == (512, 512, 3, 3)
    assert sorted(k for k in tr if k.endswith(".weight")) == sorted(
        [f"sanet{t}_1.{c}.weight" for t in (4, 5) for c in ("f", "g", "h", "out_conv")]
        + ["merge_conv.weight"])
    assert tuple(tr["sanet4_1.f.weight"].shape) == (512, 512, 1, 1)
    assert tuple(tr["merge_conv.weight"].shape) == (512, 512, 3, 3)
    torch.save(vgg, tmp_path / engine.VGG_FILE)
    torch.save(dec, tmp_path / engine.DECODER_FILE)
    torch.save(tr, tmp_path / engine.TRANSFORMER_FILE)
    back = engine.load_params(str(tmp_path), device="cpu")
    mine, theirs = params.state_dict(), back.state_dict()
    assert list(mine) == list(theirs)
    assert all(torch.equal(mine[k], theirs[k]) for k in mine)
    # AdaIN's import reads the same VGG file to relu4_1 alone.
    theirs = adain.import_torch_state_dict(vgg, dec, "cpu")
    assert torch.equal(theirs.enc.conv4_1.kernel, params.enc.conv4_1.kernel)
    assert not any(hasattr(theirs.enc, name) for name, *_ in adain.ENCODER5)
    short = {k: v for k, v in vgg.items() if not k.startswith("42.")}
    with pytest.raises(KeyError, match="42.weight"):
        sanet.import_torch_state_dict(short, dec, tr, device="cpu")
    os.remove(tmp_path / engine.TRANSFORMER_FILE)
    with pytest.raises(FileNotFoundError, match="transformer_iter_500000.pth"):
        engine.load_params(str(tmp_path), device="cpu")


@pytest.mark.parametrize("content, style, match", [
    ((2, 72, 64, 3), (2, 64, 64, 3), "multiples of 16"),
    ((2, 64, 64, 3), (2, 64, 40, 3), "multiples of 16"),
    ((2, 16, 16, 3), (2, 64, 64, 3), "at least 32"),
    ((2, 64, 64, 4), (2, 64, 64, 3), "must be"),
    ((2, 64, 64, 3), (3, 64, 64, 3), "style batch"),
])
def test_apply_refuses_sides_it_cannot_take(params, content, style, match):
    with pytest.raises(ValueError, match=match):
        sanet.apply(params, torch.zeros(content), torch.zeros(style))


def _counting(monkeypatch, module, name, calls):
    fn = getattr(module, name)

    def counted(*args, **kwargs):
        calls[name] = calls.get(name, 0) + 1
        return fn(*args, **kwargs)

    monkeypatch.setattr(module, name, counted)


def test_each_kernel_wrapper_is_called_as_often_as_on_the_card(params, monkeypatch):
    """A SANet forward at equal sides: 18 conv3x3_valid calls (the encoder's
    12 after conv1_1, the merge, the decoder's 5), 1 im2col, 1 flat, 3
    upconv_phase, 2 attentions; an AdaIN forward its 13 conv3x3_valid calls
    and no attention, as before the encoder went on to relu5_1."""
    from styletransfer_tpu_torch.models import adain as adain_model

    calls = {}
    for module, name in ((adain_model, "conv3x3_valid"), (adain_model, "conv3x3_im2col"),
                         (adain_model, "conv3x3_flat"), (adain_model, "upconv_phase"),
                         (adain_model, "instance_norm_pad"), (sanet, "conv3x3_valid"),
                         (sanet, "attention")):
        _counting(monkeypatch, module, name, calls)
    content, style = _images(2, 64, 64, seed=13), _images(2, 64, 64, seed=14)
    sanet.apply(params, content, style)
    assert calls == {"conv3x3_valid": 18, "conv3x3_im2col": 1, "conv3x3_flat": 1,
                     "upconv_phase": 3, "attention": 2}
    calls.clear()
    small = adain.init_params(seed=3, device="cpu")
    out = adain.apply(small, content[:, :32, :32], style[:, :32, :32])
    assert calls == {"conv3x3_valid": 13, "conv3x3_im2col": 1, "conv3x3_flat": 1,
                     "upconv_phase": 3, "instance_norm_pad": 1}
    vgg, dec = adain.export_torch_state_dict(small)
    want = plain_adain.stylize(vgg, dec, _nchw(content[:, :32, :32]), _nchw(style[:, :32, :32]))
    assert float((out - want.permute(0, 2, 3, 1)).abs().max()) <= ATOL


def test_adain_s_params_and_encoder_stop_at_relu4_1():
    small = adain.init_params(seed=3, device="cpu")
    assert not hasattr(small.enc, "conv4_2")
    vgg, _ = adain.export_torch_state_dict(small)
    assert max(int(k.split(".")[0]) for k in vgg) == 29
    x = _images(1, 32, 32, seed=15)
    assert adain.encode(small, x).shape == (1, 4, 4, 512)
    with pytest.raises(ValueError, match="tap"):
        adain.encode(small, x, "relu3_1")


def test_the_seeded_logits_spread_by_a_few_units(params, released):
    """init_params' rule (LOGIT_GAIN): over smooth seeded images the scores
    Q K^T of each block spread by 2-4 a row, so that the softmax is neither
    near uniform nor near one-hot."""
    from h100bench import inputs

    g = inputs.generator("cpu", 17, inputs.IMAGES)
    content = inputs.images(1, 128, g, "cpu").float() / 255
    style = inputs.images(1, 128, g, "cpu").float() / 255
    vgg, _, tr = released
    for which, block in enumerate(("sanet4_1", "sanet5_1")):
        c = plain.encoder(vgg, _nchw(content))[which]
        s = plain.encoder(vgg, _nchw(style))[which]
        f = plain._conv(plain.mean_variance_norm(c), tr, f"{block}.f").flatten(2)
        gg = plain._conv(plain.mean_variance_norm(s), tr, f"{block}.g").flatten(2)
        scores = torch.bmm(f.transpose(1, 2), gg)
        assert 2.0 <= float(scores.std(dim=-1).mean()) <= 4.0, block


def test_the_spans_open_once_each_in_order(params):
    from styletransfer_tpu_torch.utils import profiling

    content, style = _images(1, 64, 64, seed=19), _images(1, 64, 64, seed=20)
    with profiling.record_spans() as rec:
        engine.make_serve_fn()(params, (content * 255).to(torch.uint8),
                               (style * 255).to(torch.uint8))
    names = [s.name for s in sorted(rec.spans, key=lambda s: s.start_ns)]
    enc = ["conv1_1", "conv1_2", "pool1", "conv2_1", "conv2_2", "pool2", "conv3_1", "conv3_2",
           "conv3_3", "conv3_4", "pool3", "conv4_1", "conv4_2", "conv4_3", "conv4_4", "pool4",
           "conv5_1"]
    blocks = [f"sanet.{tap}.{part}" for tap in ("r4_1", "r5_1")
              for part in ("norm", "proj", "attn", "out")]
    dec = ["conv1", "up1", "conv2", "conv3", "conv4", "up2", "conv5", "up3", "conv_out"]
    assert names == (["sanet.forward"] + [f"sanet.enc.{n}" for n in enc] + blocks
                     + ["sanet.merge"] + [f"sanet.dec.{n}" for n in dec])


def test_the_serving_forward_rounds_the_clamped_output(params):
    content, style = _images(2, 64, 64, seed=23), _images(2, 64, 64, seed=24)
    c8, s8 = (content * 255).round().to(torch.uint8), (style * 255).round().to(torch.uint8)
    got = engine.make_serve_fn("f32")(params, c8, s8)
    y = sanet.apply(params, c8.float() / 255, s8.float() / 255)
    assert got.dtype == torch.uint8
    assert torch.equal(got, torch.round(torch.clamp(y, 0, 1) * 255).to(torch.uint8))


def test_bf16_is_not_implemented():
    with pytest.raises(NotImplementedError, match="f32 only"):
        engine.make_serve_fn("bf16")


def test_convert_sanet_writes_one_png_per_input(released, tmp_path, monkeypatch):
    (tmp_path / "w").mkdir()
    for sd, name in zip(released, (engine.VGG_FILE, engine.DECODER_FILE,
                                   engine.TRANSFORMER_FILE)):
        torch.save(sd, tmp_path / "w" / name)
    rng = np.random.default_rng(29)
    (tmp_path / "in").mkdir()
    for i in range(3):
        Image.fromarray(rng.integers(0, 256, (40, 36, 3), dtype=np.uint8)).save(
            tmp_path / "in" / f"pic{i}.png")
    (tmp_path / "in" / "notes.txt").write_text("not an image")
    Image.fromarray(rng.integers(0, 256, (50, 60, 3), dtype=np.uint8)).save(tmp_path / "sty.png")
    monkeypatch.setattr(tconstants, "PROJECT_ROOT_PATH", str(tmp_path))
    args = ["fast_st", "convert-sanet", "in", "--style-image", "sty.png", "--weights", "w",
            "--size", "32", "-b", "2", "--device", "cpu"]
    result = CliRunner().invoke(tcli, args)
    assert result.exit_code == 0, result.output
    outs = sorted(os.listdir(tmp_path / "results"))
    assert outs == [f"converted_sanet_sty_pic{i}.png" for i in range(3)]
    got = np.asarray(Image.open(tmp_path / "results" / outs[1]))
    assert got.shape == (32, 32, 3) and got.dtype == np.uint8


def test_the_benchmark_s_copy_of_the_reference_agrees_bit_for_bit(released):
    path = os.path.join(ROOT, "h100bench", "reference", "sanet.py")
    spec = importlib.util.spec_from_file_location("bench_sanet_reference", path)
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    content, style = _images(2, 64, 64, seed=31), _images(2, 64, 80, seed=32)
    a = plain.stylize(*released, _nchw(content), _nchw(style))
    b = bench.stylize(*released, _nchw(content), _nchw(style))
    assert torch.equal(a, b)


# --- on the card ---------------------------------------------------------------------

# (B, key batch, Nq, Nk): SANet's relu5_1 block at 512 px and relu4_1's at
# 256 px, a ragged photo's relu4_1 against a 512 px style (126 x 94 = 11,844
# queries), ragged tails in both, one query, one key.
_KERNEL_SHAPES = [(2, 2, 1024, 1024), (2, 2, 1024, 4096), (1, 1, 11844, 4096),
                  (3, 1, 70, 45), (2, 2, 1, 300), (1, 1, 129, 1)]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the attention kernel has no CPU form")
    layers.disable_tf32()
    return torch.device("cuda")


def _qkv(B, kb, nq, nk, dev):
    """Scores that spread by 3 a row, as SANet's seeded ones."""
    g = torch.Generator(device=dev).manual_seed(nq + 7 * nk)
    q = torch.randn(B, nq, 512, device=dev, generator=g)
    k = torch.randn(kb, nk, 512, device=dev, generator=g) * 3 / 512 ** 0.5
    v = torch.randn(kb, nk, 512, device=dev, generator=g)
    return q, k, v


@pytest.mark.cuda
@pytest.mark.parametrize("shape", _KERNEL_SHAPES)
def test_the_attention_kernel_matches_plain_on_the_card(shape):
    """The kernel against attention_plain (cuBLAS f32, TF32 off): the largest
    gap at most 2e-5 of the largest output; a repeat bit for bit; image 0
    bit for bit image 0 alone; one launch a call."""
    dev = _card()
    B, kb, nq, nk = shape
    q, k, v = _qkv(B, kb, nq, nk, dev)
    before = attn.launches
    out = attn.attention(q, k, v)
    again = attn.attention(q, k, v)
    alone = attn.attention(q[:1].contiguous(), k[:1].contiguous(), v[:1].contiguous())
    torch.cuda.synchronize()
    assert attn.launches == before + 3
    want = attn.attention_plain(q, k, v)
    assert out.shape == want.shape == (B, nq, 512)
    assert float((out - want).abs().max()) <= 2e-5 * float(want.abs().max())
    assert torch.equal(out, again)
    assert torch.equal(out[:1], alone)


@pytest.mark.cuda
def test_the_forward_on_the_card_matches_the_reference():
    """SANet's forward on the card's kernels against the plain reference on
    the card (f32, TF32 off) at 128 px and at unequal sides: within one
    rounding of the output's levels; two attention launches a forward."""
    dev = _card()
    params = sanet.init_params(seed=3, device=dev)
    released = [{k: v.to(dev) for k, v in sd.items()} for sd in
                sanet.export_torch_state_dict(params)]
    for (h, w), (hs, ws) in (((128, 128), (128, 128)), ((96, 160), (128, 64))):
        content = _images(2, h, w, seed=h).to(dev)
        style = _images(2, hs, ws, seed=hs + 1).to(dev)
        before = attn.launches
        got = sanet.apply(params, content, style)
        torch.cuda.synchronize()
        assert attn.launches == before + 2
        want = _reference(released, content, style)
        assert float((got - want).abs().max()) <= 1e-4
