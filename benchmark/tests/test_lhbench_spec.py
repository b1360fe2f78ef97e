"""BENCHMARK.json and the files it names: found by name, valid, and open to
a new configuration, cell and metric made of new files only."""

from __future__ import annotations

import json
import shutil

import pytest
import torch

from lhbench import spec


def test_every_file_is_found_and_valid():
    bench = spec.load_benchmark()
    assert spec.problems(bench) == []
    for w in bench["workloads"]:
        cell = spec.cell(bench, w["name"])
        assert spec.kind(cell.mix["kind"]).setup
        assert set(cell.limits) and all(v >= 0 for v in cell.limits.values())
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer
    for m in bench["per_layer"]:
        assert callable(spec.reader(m["name"]).read)


def test_contract_keys_and_limits():
    bench = spec.load_benchmark()
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["benchmark"]
    assert 1 <= bench["run_seconds"] <= 51
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["layer"] and "\n" not in m["layer"]
    for group in ("configs", "workloads"):
        for e in bench[group]:
            assert 1 <= len(e["why"]) <= 200


@pytest.mark.parametrize("name,ok", [
    ("w32.train.b128", True), ("mfu.train", True), ("_x-1", True),
    ("a b", False), ("a/b", False), ("a,b", False), ("", False),
    ("µs", False), ("x" * 65, False)])
def test_names(name, ok):
    assert bool(spec.NAME.fullmatch(name)) is ok


@pytest.mark.parametrize("unit,ok", [
    ("img/s", True), ("%", True), ("GiB", True), ("ms", True),
    ("tokens per s", False), ("µs", False), ("", False)])
def test_units(unit, ok):
    assert bool(spec.UNIT.fullmatch(unit)) is ok


def test_a_problem_is_reported():
    bench = spec.load_benchmark()
    bench["workloads"] = bench["workloads"] + [dict(bench["workloads"][0],
                                                    name="copy")]
    found = spec.problems(bench)
    assert any("repeated" in p for p in found)
    assert any("no limits file" in p for p in found)


def test_new_files_add_a_config_cell_and_metric(tmp_path, monkeypatch):
    """A later change adds a configuration, a traffic mix, a cell and a
    per-layer metric as new files and entries; no file of the harness
    changes, and the yardstick's checks take the new configuration as
    they take the others."""
    import test_lhbench_yardstick as yardstick_checks
    from reference import models

    bench = spec.load_benchmark()
    bench_dir = tmp_path / "benchmark"
    for sub in ("configs", "traffic", "workloads", "metrics"):
        shutil.copytree(spec.BENCH_DIR / sub, bench_dir / sub)
    monkeypatch.setattr(spec, "BENCH_DIR", bench_dir)
    monkeypatch.setattr(spec, "ROOT", tmp_path)

    w18 = dict(spec.read_json(bench_dir / "configs" / "hrnet_w48_256.json"),
               model="hrnet_w18", widths=[18, 36, 72, 144], image_size=128,
               heatmap_size=32)
    with torch.device("meta"):
        ref = models.build(w18)
    w18["forward_flops"] = 2 * models.forward_macs(ref, w18["image_size"])
    w18["parameters"] = sum(p.numel() for p in ref.parameters())
    (bench_dir / "configs" / "hrnet_w18_128.json").write_text(json.dumps(w18))
    (bench_dir / "traffic" / "train_b16_k2.json").write_text(json.dumps(
        dict(spec.read_json(bench_dir / "traffic" / "train_b32_k4.json"),
             batch=16, scan_steps=2)))
    (bench_dir / "workloads" / "w18.train.b16.json").write_text(json.dumps(
        spec.read_json(bench_dir / "workloads" / "w48.train.b32.json")))
    (bench_dir / "metrics" / "steps.train.py").write_text(
        "def read(run):\n    return float(run.attempted)\n")

    bench["configs"].append({"name": "hrnet_w18_128", "source": "x",
                             "file": "benchmark/configs/hrnet_w18_128.json",
                             "reduced": [], "why": "narrower"})
    bench["workloads"].append({"name": "w18.train.b16",
                               "config": "hrnet_w18_128",
                               "traffic": "train_b16_k2", "chips": 1,
                               "why": "a narrower HRNet at bs16"})
    for m in bench["end_to_end"]:
        if m["name"] == "train_img_s":
            m["workloads"].append("w18.train.b16")
    bench["per_layer"].append({"name": "steps.train", "unit": "1",
                               "better": "higher", "source": "host_clock",
                               "layer": "Steps", "moves": "train_img_s",
                               "workloads": ["w18.train.b16"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    assert spec.problems(spec.load_benchmark()) == []
    cell = spec.cell(spec.load_benchmark(), "w18.train.b16")
    assert cell.config["widths"] == [18, 36, 72, 144]
    assert cell.mix["batch"] == 16
    assert [m["name"] for m in cell.per_layer][-1] == "steps.train"

    class Done:
        attempted = 7
    assert spec.reader("steps.train").read(Done()) == 7.0

    for check in ("test_forward_flops_frozen_from_the_reference",
                  "test_forward_flops_counted_on_the_program",
                  "test_reference_names_match_the_program"):
        getattr(yardstick_checks, check)("hrnet_w18_128")
