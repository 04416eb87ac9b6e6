"""The AdaIN cell (``adain.offline-b16-512``, kind ``offline_pairs``) on the
CPU at a tiny size: a sound run is correct and every fault of
``faults_pairs.py`` is not; a traced run reads its per-layer metrics; the
pairing covers every pair of batches; the counts match the hand-worked
numbers; the reference and the weights import nothing of the program."""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import pytest
import torch

from h100bench import counts_adain, faults_pairs, harness, inputs_adain
from h100bench.traffic import offline_pairs

CELL = "adain.offline-b16-512"
ROOT = os.path.dirname(harness.HERE)
SEED = 2**31 + 29
TINY = ({"batch": 2, "pool": 2, "sample": 2, "traced_calls": 1, "block": 1},
        {"image_side": 32, "style_side": 32})


def _tiny(trace=False):
    return harness.execute(CELL, SEED, 1.0, trace, "cpu", time.monotonic(), *TINY)


@pytest.mark.parametrize("fault", (None,) + faults_pairs.FAULTS)
def test_a_sound_run_is_correct_and_each_fault_is_not(fault):
    if fault is None:
        line = _tiny()
        assert line["correct"], line["checks"]
        assert set(line["metrics"]) == {"setup_s", "stylize_img_per_s"}
        return
    with faults_pairs.planted(fault):
        line = _tiny()
    assert not line["correct"], line["checks"]


def test_a_traced_run_reads_the_layer_metrics_it_can_on_the_cpu():
    line = _tiny(trace=True)
    assert line["correct"], line["checks"]
    # The CPU has no device trace and no kernel launches: the model step's
    # share alone reads a number here.
    assert "mfu.adain" in line["metrics"]
    assert "upconv_phase_roofline.adain" not in line["metrics"]
    assert "conv3x3_valid_roofline.adain" not in line["metrics"]


@pytest.mark.parametrize("pool", [2, 4])
def test_no_pairing_of_batches_repeats_within_pool_squared_calls(pool):
    for seed in (SEED, SEED + 1, 7):
        style_of = offline_pairs.pairing(seed, pool)
        for start in (0, 3, 11):
            pairs = {(n % pool, style_of(n)) for n in range(start, start + pool * pool)}
            assert len(pairs) == pool * pool


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2**-10, 1.0 + 2**-11 + 2**-12, -3.0 - 2**-12, 0.0])
    r = faults_pairs.round_tf32(x)
    assert r.tolist() == [1.0 + 2**-10, 1.0 + 2**-10, -3.0, 0.0]


def test_flop_counts_match_the_hand_worked_numbers():
    # Encoder to relu4_1 at 512 px: conv1_1 0.906 GFLOP, conv1_2, conv2_2 and
    # conv3_2..3_4 19.33 each, conv2_1, conv3_1, conv4_1 9.66 each, the 1x1
    # 4.7 MFLOP. Decoder: up1, conv2, conv3, up2, up3 19.33 each, conv1,
    # conv4, conv5 9.66 each, conv_out 0.906. The three phase convs, 16 C O
    # multiply-adds a small-grid pixel at batch 16: 2.05 ms at 67 TFLOP/s.
    assert counts_adain.encoder_flops(512) / 1e9 == pytest.approx(126.5385, abs=1e-4)
    assert counts_adain.decoder_flops(512) / 1e9 == pytest.approx(126.5338, abs=1e-4)
    assert counts_adain.pair_flops(512, 512) / 1e9 == pytest.approx(379.6107, abs=1e-4)
    assert counts_adain.upconv_phase_bound_s(16, 512) * 1e3 == pytest.approx(
        3 * 2.0513, abs=1e-3)


def test_conv3x3_valid_s_bound_matches_the_hand_worked_numbers():
    # Its 13 convs a forward at batch 16 and 512 px, all bound by operations:
    # conv1_2, conv2_2, conv3_2..3_4 19.33 GFLOP an image and conv2_1,
    # conv3_1, conv4_1 9.66, over 32 images (125.63 each); conv2, conv3
    # 19.33 and conv1, conv4, conv5 9.66 over 16 (67.65 each): 5102.4 GFLOP,
    # 76.16 ms at 67 TFLOP/s. A style of another side is encoded apart.
    assert counts_adain.conv3x3_valid_calls(512, 512) == 13
    assert counts_adain.conv3x3_valid_calls(512, 256) == 21
    assert counts_adain.conv3x3_valid_bound_s(16, 512, 512) * 67e12 / 1e9 == pytest.approx(
        16 * (2 * 125.6278 + 67.6457), abs=0.1)


class _Trace:
    """A device trace that spent ``conv_s`` in the conv3x3_valid group."""

    def __init__(self, conv_s):
        self.conv_s = conv_s

    def group_s(self, group):
        return self.conv_s if group == "conv3x3_valid" else 0.0


def test_the_conv3x3_valid_roofline_reads_whole_forwards_only():
    metric = harness.metric_modules()["conv3x3_valid_roofline.adain"]
    layer = {"trace": _Trace(0.3), "forwards": 2, "batch": 16, "side": 512,
             "style_side": 512, "conv3x3_valid_calls": 26}
    want = 100.0 * 2 * counts_adain.conv3x3_valid_bound_s(16, 512, 512) / 0.3
    assert metric.read(layer, {}, {}) == pytest.approx(want)
    assert 50.0 < want < 51.0
    for missing in ({"conv3x3_valid_calls": 25}, {"forwards": 0}, {"trace": None},
                    {"trace": _Trace(0.0)}):
        assert metric.read({**layer, **missing}, {}, {}) is None


def test_the_weights_follow_the_released_layout():
    cfg = harness.load_json("configs", "huang2017-adain-vgg19")
    vgg, dec = inputs_adain.weights(SEED, "cpu", cfg)
    assert tuple(vgg["0.weight"].shape) == (3, 3, 1, 1)
    assert tuple(vgg["29.weight"].shape) == (512, 256, 3, 3)
    assert tuple(dec["1.weight"].shape) == (256, 512, 3, 3)
    assert tuple(dec["28.weight"].shape) == (3, 64, 3, 3)
    assert torch.equal(dec["28.bias"], torch.full((3,), inputs_adain.OUT_BIAS))
    again = inputs_adain.weights(SEED, "cpu", cfg)[0]
    assert all(torch.equal(vgg[k], again[k]) for k in vgg)


def test_the_reference_and_the_weights_import_nothing_of_jax_or_the_program():
    code = ("import sys; import h100bench.reference.adain, h100bench.inputs_adain, "
            "h100bench.counts_adain; print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, check=True).stdout
    tops = set(json.loads(out.replace("'", '"')))
    assert not tops & {"jax", "jaxlib", "flax", "optax", "orbax", "styletransfer_tpu",
                       "styletransfer_tpu_torch"}
