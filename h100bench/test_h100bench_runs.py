"""Runs of the harness: on the CPU at a tiny size, past the harness's look
for a chip, a sound run comes out correct and every fault a cell can have
comes out not correct; the result line has its keys; nothing of JAX or of
the program reaches the reference. On the card (the ``cuda`` marker), the
TF32 control of each cell at its own size comes out not correct.

    python -m pytest h100bench -q                       # here
    python -m pytest h100bench -q -m cuda --noconftest  # on the GPU machine
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import pytest

from h100bench import faults, harness

ROOT = os.path.dirname(harness.HERE)
SEED = 2**31 + 17
# Each cell shrunk to what the CPU runs in a few seconds: (mix overrides,
# configuration overrides).
TINY = {
    "transformnet.offline-b64": ({"batch": 2, "pool": 2, "sample": 2, "traced_calls": 2},
                                 {"image_side": 32}),
    "transformnet.train-b4": ({"batch": 2, "crops": 24, "traced_steps": 2,
                               "stretch_from": [1, 3]},
                              {"image_side": 32}),
    "vgg19.gatys-lbfgs": ({"sample": 1}, {"image_side": 32, "steps": 2}),
    "transformnet.daemon-tcp-b8": ({"rate": 100.0, "count": 8, "slots": 512, "warm": 4,
                                    "connections": 4}, {"image_side": 32}),
}


def _kind(cell):
    return harness.load_json("cells", cell)["kind"]


CASES = [(cell, fault) for cell in TINY for fault in (None,) + faults.FAULTS[_kind(cell)]]


def _tiny(cell, trace=False, seconds=1.0):
    mix, config = TINY[cell]
    return harness.execute(cell, SEED, seconds, trace, "cpu", time.monotonic(), mix, config)


@pytest.mark.parametrize("cell, fault", CASES)
def test_a_sound_run_is_correct_and_each_fault_is_not(cell, fault):
    if fault is None:
        line = _tiny(cell)
        assert line["correct"], line["checks"]
        return
    with faults.planted(_kind(cell), fault):
        line = _tiny(cell)
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("epoch_steps", [5, 11, 72])
def test_the_window_s_training_stretch_lies_in_one_pass_over_the_file(epoch_steps):
    from h100bench.traffic import train

    mix = harness.load_json("cells", "transformnet.train-b4")["mix"]
    for seed in range(SEED, SEED + 200):
        first = train._stretch_start(seed, mix, epoch_steps)
        into = (mix["checked_steps"] + first) % epoch_steps
        assert first >= mix["stretch_from"][0] and into + mix["stretch_steps"] <= epoch_steps


@pytest.mark.parametrize("trace", [False, True])
def test_the_result_line_has_its_keys_with_the_checks_last(trace):
    line = _tiny("transformnet.offline-b64", trace)
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}
    if trace:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert "mfu.serve" in line["metrics"]
    else:
        assert set(line["metrics"]) == {"setup_s", "stylize_img_per_s"}


def test_the_reference_and_the_generator_import_nothing_of_jax_or_the_program():
    code = ("import sys; import h100bench.reference.nets, h100bench.loadgen; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, check=True).stdout
    tops = set(json.loads(out.replace("'", '"')))
    assert not tops & {"jax", "jaxlib", "flax", "optax", "orbax", "styletransfer_tpu",
                       "styletransfer_tpu_torch"}


def test_a_module_of_the_jax_stack_is_found_by_its_whole_top_level_name(monkeypatch):
    monkeypatch.setitem(sys.modules, "styletransfer_tpu_torch_like", sys)
    assert harness.forbidden_loaded() == []
    monkeypatch.setitem(sys.modules, "jaxlib.fake", sys)
    assert harness.forbidden_loaded() == ["jaxlib"]


def test_without_a_card_the_command_fails_and_prints_no_result():
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    proc = subprocess.run([sys.executable, "-m", "h100bench", "--workload",
                           "transformnet.offline-b64", "--seed", "1", "--seconds", "1"],
                          cwd=ROOT, capture_output=True, text=True, env=env)
    assert proc.returncode != 0 and proc.stdout == ""


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the control runs each cell at its own size")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(TINY))
def test_the_tf32_control_is_not_correct_on_three_seeds(card, cell):
    env = {**os.environ, "STX_MATMUL_PRECISION": "high"}
    for seed in (2**31 + 101, 2**31 + 102, 2**31 + 103):
        proc = subprocess.run([sys.executable, "-m", "h100bench", "--workload", cell, "--seed",
                               str(seed), "--seconds", "5"], cwd=ROOT, capture_output=True,
                              text=True, env=env, timeout=600)
        assert proc.returncode == 0, proc.stderr[-2000:]
        assert json.loads(proc.stdout.splitlines()[-1])["correct"] is False
