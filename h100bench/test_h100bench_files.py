"""The benchmark's files: every cell, configuration and per-layer
metric loads by name, keeps to the allowed names and units, and agrees with
``BENCHMARK.json``; the counts match hand-worked numbers."""

from __future__ import annotations

import json
import os
import re

import pytest

from h100bench import counts, harness

ROOT = os.path.dirname(harness.HERE)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _names(folder, ext=".json"):
    return sorted(f[: -len(ext)] for f in os.listdir(os.path.join(harness.HERE, folder))
                  if f.endswith(ext) and f != "__init__.py")


@pytest.mark.parametrize("cell", _names("cells"))
def test_a_cell_loads_by_name_with_its_config_mix_and_kind(cell):
    c = harness.load_json("cells", cell)
    assert NAME.match(cell) and NAME.match(c["config"]) and NAME.match(c["traffic"])
    assert c["chips"] in (1, 4)
    assert 1 <= len(c["why"]) <= 200 and "\n" not in c["why"] and "\t" not in c["why"]
    harness.load_json("configs", c["config"])
    assert isinstance(c["mix"], dict)
    assert hasattr(harness.kind_module(c["kind"]), "run")
    assert c["limits"] and all(v >= 0 for v in c["limits"].values())


def test_benchmark_json_lists_the_files_as_they_are():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert b["paths"] == ["h100bench"] and b["command"][:3] == ["python3", "-m", "h100bench"]
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    cells = {w["name"]: w for w in b["workloads"]}
    # A cell's files may wait here for a later PR to prove and list it.
    assert set(cells) <= set(_names("cells"))
    for name, w in cells.items():
        c = harness.load_json("cells", name)
        assert (w["config"], w["traffic"], w["chips"], w["why"]) == (
            c["config"], c["traffic"], c["chips"], c["why"])
    for cfg in b["configs"]:
        data = harness.load_json("configs", cfg["name"])
        assert cfg["file"] == f"h100bench/configs/{cfg['name']}.json"
        assert (cfg["source"], cfg["reduced"]) == (data["source"], data["reduced"])
        assert all(NAME.match(k) for k in cfg["reduced"])
        assert any(w["config"] == cfg["name"] for w in b["workloads"])


def test_every_cell_reports_setup_another_end_to_end_metric_and_a_layer_metric():
    b = _bench()
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for w in b["workloads"]:
        mine = [n for n, m in e2e.items() if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in mine and len(mine) >= 2
        kind = harness.kind_module(harness.load_json("cells", w["name"])["kind"])
        assert set(mine) - {"setup_s"} == set(kind.UNITS)
        assert any(w["name"] in m["workloads"] for m in b["per_layer"])


def test_each_per_layer_metric_is_a_module_that_agrees_with_benchmark_json():
    b = _bench()
    modules = harness.metric_modules()
    cells = {w["name"] for w in b["workloads"]}
    assert sorted(n for n, mod in modules.items() if set(mod.WORKLOADS) & cells) == sorted(
        m["name"] for m in b["per_layer"])
    e2e = {m["name"]: m for m in b["end_to_end"]}
    for m in b["per_layer"]:
        mod = modules[m["name"]]
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert (m["unit"], m["better"], m["source"], m["layer"], m["moves"]) == (
            mod.UNIT, mod.BETTER, mod.SOURCE, mod.LAYER, mod.MOVES)
        assert sorted(m["workloads"]) == sorted(mod.WORKLOADS)
        assert m["source"] in SOURCES and m["moves"] in e2e
        for cell in m["workloads"]:
            assert cell in e2e[m["moves"]].get("workloads", [cell])


def test_a_name_that_would_leave_the_folder_is_refused():
    with pytest.raises(ValueError):
        harness.load_json("cells", "../BENCHMARK")


@pytest.mark.parametrize("side, what, gflop", [
    (256, "transformnet_forward", 20.1578),
    (256, "gatys_eval", 34.8127),
    (256, "train_image", 106.5731),
])
def test_flop_counts_match_the_hand_worked_numbers(side, what, gflop):
    # The forward: conv1 81*3*32 MACs a pixel at the full side, conv2 9*32*64
    # at a half, conv3 9*64*128 and ten residual 9*128*128 at a quarter, the
    # upsample convs 9*128*64 at a half and 9*64*32 at the full side, conv_out
    # 81*32*3 at the full side: 10.08 G MACs. An evaluation: VGG to conv3_1
    # (7.36 G MACs) forward and input gradient, five Grams (2*HW*C^2 = 0.537
    # GFLOP each) forward and backward. A training image: the net's forward,
    # weight and input gradient less conv1's, an evaluation, VGG to conv2_2
    # on the content image (6.15 G MACs).
    assert counts.summary(side)[what] / 1e9 == pytest.approx(gflop, abs=1e-4)


def test_kernel_bounds_match_the_repository_s_table():
    # PERF.md's kernel table (chip_smoke.py's arithmetic): conv3x3_valid f32
    # 1.1539 ms a call at batch 64, the 15 IN-pad calls 2.0891 ms. The nine
    # flat convs of a closure: the sum of their own bounds, 0.4380 ms.
    assert counts.conv3x3_valid_bound_s(64, 256) * 1e3 == pytest.approx(1.1539, abs=1e-4)
    assert counts.in_pad_forward_bound_s(64, 256) * 1e3 == pytest.approx(2.0891, abs=1e-4)
    assert counts.conv3x3_flat_bound_s(256, 1, 0) * 1e3 == pytest.approx(0.4380, abs=1e-4)
    assert counts.conv3x3_flat_calls(400, 1) == 3607
