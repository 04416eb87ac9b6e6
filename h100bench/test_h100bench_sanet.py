"""The SANet cell (``sanet.offline-b4-1024``, kind ``offline_pairs_sanet``)
on the CPU at a small size: a sound run is correct and every fault of
``faults_sanet.py`` is not; a traced run reads its per-layer metrics; the
counts match the hand-worked numbers; the roofline readers read whole
forwards only (and their own spans); the weights follow the released layout and agree with the
program's seeded rule; the reference, the weights and the counts import
nothing of the program."""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import pytest
import torch

from h100bench import counts_sanet, faults_sanet, harness, inputs_sanet

CELL = "sanet.offline-b4-1024"
ROOT = os.path.dirname(harness.HERE)
SEED = 2**31 + 31
SMALL = ({"batch": 2, "pool": 2, "sample": 2, "traced_calls": 1, "block": 1},
         {"image_side": 64, "style_side": 64})


def _small(trace=False):
    return harness.execute(CELL, SEED, 1.0, trace, "cpu", time.monotonic(), *SMALL)


@pytest.mark.parametrize("fault", (None,) + faults_sanet.FAULTS)
def test_a_sound_run_is_correct_and_each_fault_is_not(fault):
    if fault is None:
        line = _small()
        assert line["correct"], line["checks"]
        assert set(line["metrics"]) == {"setup_s", "stylize_img_per_s"}
        return
    with faults_sanet.planted(fault):
        line = _small()
    assert not line["correct"], line["checks"]


def test_the_parent_s_program_fails_the_cell_at_once(monkeypatch):
    """A checkout without models/sanet.py cannot import the traffic kind:
    the run raises before any set-up, and the command exits 1."""
    import builtins

    real = builtins.__import__

    def no_sanet(name, *args, **kwargs):
        if name.startswith("styletransfer_tpu_torch.engines") and "sanet" in str(args[2:3]):
            raise ImportError("cannot import name 'sanet'")
        return real(name, *args, **kwargs)

    monkeypatch.delitem(sys.modules, "h100bench.traffic.offline_pairs_sanet", raising=False)
    monkeypatch.setattr(builtins, "__import__", no_sanet)
    with pytest.raises(ImportError):
        harness.kind_module("offline_pairs_sanet")


def test_a_traced_run_reads_the_layer_metrics_it_can_on_the_cpu():
    line = _small(trace=True)
    assert line["correct"], line["checks"]
    # The CPU has no device trace and no kernel launches: the model step's
    # share alone reads a number here.
    assert "mfu.sanet" in line["metrics"]
    for name in ("attention_roofline.sanet", "enc5_roofline.sanet", "idle_share.sanet",
                 "conv3x3_valid_roofline.sanet", "upconv_phase_roofline.sanet"):
        assert name not in line["metrics"]


def test_flop_counts_match_the_hand_worked_numbers():
    # At 1024 px: the encoder to relu4_1 506.15 GFLOP an image (AdaIN's 126.54
    # at 512 px, times 4), conv4_2 .. conv4_4 77.31 each and conv5_1 19.33;
    # attention 4 Nq Nk D: 549.76 at relu4_1 (16,384 positions), 34.36 at
    # relu5_1 (4,096); the eight 1x1 convs 42.95; the merge 77.31; the decoder
    # 506.14. A pair: 2725.3 GFLOP; 4 pairs at 67 TFLOP/s: 162.7 ms.
    assert counts_sanet.encoder_flops(1024) / 1e9 == pytest.approx(757.4095, abs=1e-4)
    assert counts_sanet.attention_flops(1024, 1024, 8) / 1e9 == pytest.approx(549.7558, abs=1e-4)
    assert counts_sanet.attention_flops(1024, 1024, 16) / 1e9 == pytest.approx(34.3597, abs=1e-4)
    assert counts_sanet.pointwise_flops(1024, 1024) / 1e9 == pytest.approx(42.9497, abs=1e-4)
    assert counts_sanet.merge_flops(1024) / 1e9 == pytest.approx(77.3094, abs=1e-4)
    assert counts_sanet.pair_flops(1024, 1024) / 1e9 == pytest.approx(2725.3287, abs=1e-4)
    assert 4 * counts_sanet.pair_flops(1024, 1024) / 67e12 * 1e3 == pytest.approx(162.706,
                                                                                abs=1e-3)


def test_the_bounds_match_the_hand_worked_numbers():
    # Attention, operations-bound: 549.76 / 67e12 = 8.205 ms and 34.36 / 67e12
    # = 0.513 ms a pair. conv4_2 .. conv5_1 over 8 images: 251.26 GFLOP an
    # image, 30.0 ms.
    assert counts_sanet.attention_bound_s(1, 1024, 1024) * 1e3 == pytest.approx(8.7181, abs=1e-4)
    assert counts_sanet.attention_bound_s(4, 1024, 1024) * 1e3 == pytest.approx(34.8726,
                                                                                abs=1e-4)
    assert counts_sanet.enc5_bound_s(4, 1024, 1024) * 1e3 == pytest.approx(30.0007, abs=1e-4)


def test_the_attention_roofline_reads_whole_forwards_only():
    metric = harness.metric_modules()["attention_roofline.sanet"]
    layer = {"span_s": {"sanet.r4_1.attn": 0.12, "sanet.r5_1.attn": 0.01, "sanet.merge": 1.0},
             "forwards": 2, "batch": 4, "side": 1024, "style_side": 1024,
             "attention_calls": 4}
    want = 100.0 * 2 * counts_sanet.attention_bound_s(4, 1024, 1024) / 0.13
    assert metric.read(layer, {}, {}) == pytest.approx(want)
    assert 53.0 < want < 54.0
    for missing in ({"attention_calls": 3}, {"forwards": 0}, {"span_s": {}},
                    {"span_s": {"sanet.merge": 1.0}}):
        assert metric.read({**layer, **missing}, {}, {}) is None


def test_the_enc5_roofline_reads_its_four_convs_spans():
    metric = harness.metric_modules()["enc5_roofline.sanet"]
    spans = {f"sanet.enc.{n}": 0.025 for n in ("conv4_2", "conv4_3", "conv4_4", "conv5_1")}
    layer = {"span_s": {**spans, "sanet.enc.pool4": 1.0, "sanet.enc.conv4_1": 1.0},
             "forwards": 2, "batch": 4, "side": 1024, "style_side": 1024}
    assert metric.read(layer, {}, {}) == pytest.approx(
        100.0 * 2 * counts_sanet.enc5_bound_s(4, 1024, 1024) / 0.1)
    assert metric.read({**layer, "span_s": {}}, {}, {}) is None


def test_conv3x3_valid_s_bound_matches_the_hand_worked_numbers():
    # Its 18 convs a forward at 4 pairs of 1024 px, all bound by operations:
    # AdaIN's thirteen (at 1024 px four times their 318.90 GFLOP a pair at
    # 512 px), conv4_2 .. conv5_1 over both images (502.52) and the merge
    # (77.31): 1855.43 GFLOP a pair, 110.77 ms at 67 TFLOP/s. A style of
    # another side is encoded apart.
    assert counts_sanet.conv3x3_valid_calls(1024, 1024) == 18
    assert counts_sanet.conv3x3_valid_calls(1024, 512) == 30
    assert counts_sanet.conv3x3_valid_bound_s(4, 1024, 1024) * 67e12 / 1e9 == pytest.approx(
        4 * (4 * 318.9013 + 2 * 251.2555 + 77.3094), abs=0.1)
    assert counts_sanet.conv3x3_valid_bound_s(4, 1024, 1024) * 1e3 == pytest.approx(110.7717,
                                                                                    abs=1e-4)


class _Trace:
    """A device trace that spent ``conv_s`` in the conv3x3_valid group."""

    def __init__(self, conv_s):
        self.conv_s = conv_s

    def group_s(self, group):
        return self.conv_s if group == "conv3x3_valid" else 0.0


def test_the_conv3x3_valid_roofline_reads_whole_forwards_only():
    metric = harness.metric_modules()["conv3x3_valid_roofline.sanet"]
    layer = {"trace": _Trace(0.4), "forwards": 2, "batch": 4, "side": 1024,
             "style_side": 1024, "conv3x3_valid_calls": 36}
    want = 100.0 * 2 * counts_sanet.conv3x3_valid_bound_s(4, 1024, 1024) / 0.4
    assert metric.read(layer, {}, {}) == pytest.approx(want)
    assert 55.0 < want < 56.0
    for missing in ({"conv3x3_valid_calls": 26}, {"forwards": 0}, {"trace": None},
                    {"trace": _Trace(0.0)}):
        assert metric.read({**layer, **missing}, {}, {}) is None


def test_the_upconv_phase_roofline_reads_its_three_spans():
    metric = harness.metric_modules()["upconv_phase_roofline.sanet"]
    spans = {f"sanet.dec.{n}": 0.006 for n in ("up1", "up2", "up3")}
    layer = {"span_s": {**spans, "sanet.dec.conv1": 1.0, "adain.dec.up1": 1.0},
             "forwards": 2, "batch": 4, "side": 1024, "style_side": 1024,
             "upconv_phase_calls": 6}
    # 6.154 ms of bound a forward at 4 pairs of 1024 px (AdaIN's three at
    # batch 16 and 512 px hold as many operations, 2.05 ms each).
    want = 100.0 * 2 * 6.15398e-3 / 0.018
    assert metric.read(layer, {}, {}) == pytest.approx(want, rel=1e-5)
    for missing in ({"upconv_phase_calls": 5}, {"forwards": 0}, {"span_s": {}},
                    {"span_s": {"sanet.dec.conv1": 1.0}}):
        assert metric.read({**layer, **missing}, {}, {}) is None


def test_the_weights_follow_the_released_layout_and_the_program_s_rule():
    cfg = harness.load_json("configs", "park2019-sanet-vgg19")
    vgg, dec, tr = inputs_sanet.weights(SEED, "cpu", cfg)
    assert sorted(int(k.split(".")[0]) for k in vgg if k.endswith(".weight")) == [
        0, 2, 5, 9, 12, 16, 19, 22, 25, 29, 32, 35, 38, 42]
    assert tuple(vgg["42.weight"].shape) == (512, 512, 3, 3)
    assert tuple(dec["28.weight"].shape) == (3, 64, 3, 3)
    assert tuple(tr["sanet5_1.out_conv.weight"].shape) == (512, 512, 1, 1)
    assert tuple(tr["merge_conv.weight"].shape) == (512, 512, 3, 3)
    # f and g at LOGIT_GAIN times fan-in normal (the program's LOGIT_GAIN too).
    std = float(tr["sanet4_1.f.weight"].std()) * 512 ** 0.5
    assert std == pytest.approx(inputs_sanet.LOGIT_GAIN, rel=0.02)
    assert float(tr["sanet4_1.h.weight"].std()) * 512 ** 0.5 == pytest.approx(1.0, rel=0.02)
    again = inputs_sanet.weights(SEED, "cpu", cfg)[2]
    assert all(torch.equal(tr[k], again[k]) for k in tr)


def test_the_reference_weights_and_counts_import_nothing_of_jax_or_the_program():
    code = ("import sys; import h100bench.reference.sanet, h100bench.inputs_sanet, "
            "h100bench.counts_sanet; print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, check=True).stdout
    tops = set(json.loads(out.replace("'", '"')))
    assert not tops & {"jax", "jaxlib", "flax", "optax", "orbax", "styletransfer_tpu",
                       "styletransfer_tpu_torch"}
