"""BENCHMARK.json and the files it names: found by name, valid, and open to
a new configuration, cell and metric made of new files only."""

from __future__ import annotations

import json
import shutil

import pytest
import torch

from lhbench import spec, yardstick


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


# the benchmark's folders that a new configuration, cell, metric or
# architecture adds files to
DATA = ("configs", "traffic", "workloads", "metrics", "reference",
        "tests/tiny")
REHEARSAL = spec.BENCH_DIR / "tests" / "rehearsal"


def _copy(tmp_path, monkeypatch):
    """A copy of the benchmark's data folders under ``tmp_path``, which
    ``spec`` then reads in place of the checkout's."""
    bench_dir = tmp_path / "benchmark"
    for sub in DATA:
        shutil.copytree(spec.BENCH_DIR / sub, bench_dir / sub,
                        ignore=shutil.ignore_patterns("__pycache__"))
    monkeypatch.setattr(spec, "BENCH_DIR", bench_dir)
    monkeypatch.setattr(spec, "ROOT", tmp_path)
    return bench_dir


def test_new_files_add_a_config_cell_and_metric(tmp_path, monkeypatch):
    """A later change adds a configuration, a traffic mix, a cell and a
    per-layer metric as new files and entries; no file of the harness
    changes, and the yardstick's checks take the new configuration as
    they take the others."""
    import test_lhbench_yardstick as yardstick_checks
    from reference import models

    bench = spec.load_benchmark()
    bench_dir = _copy(tmp_path, monkeypatch)

    w18 = dict(spec.read_json(bench_dir / "configs" / "hrnet_w48_256.json"),
               model="hrnet_w18", widths=[18, 36, 72, 144], image_size=128,
               heatmap_size=32)
    with torch.device("meta"):
        ref = models.build(w18)
    w18["forward_flops"] = models.forward_flops(ref, w18["image_size"])
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


def test_new_files_add_an_architecture(tmp_path, monkeypatch):
    """A transformer pose architecture (``tests/rehearsal/``: a patch
    embedding, a position embedding, two pre-LN blocks with scaled
    dot-product attention, two deconvs with BatchNorm and a 1x1 conv) is
    added as new files alone: its reference, a configuration, its tiny
    configuration, a traffic mix, a cell's limits and a metric reading the
    "attention" family. ``spec`` takes them, ``build`` finds the
    reference by the architecture's name, ``weights`` draws every linear
    weight and the position embedding, and the FLOP count is the hand
    formula's. The program has no such model, so the rehearsal stops
    short of a run."""
    import conftest
    import test_lhbench_yardstick as yardstick_checks
    from lhbench import inputs, trace
    from reference import models

    added = sorted(p.relative_to(REHEARSAL) for p in REHEARSAL.rglob("*")
                   if p.is_file() and "__pycache__" not in p.parts)
    assert added and not any((spec.BENCH_DIR / p).exists() for p in added)
    bench = spec.load_benchmark()
    bench_dir = _copy(tmp_path, monkeypatch)
    shutil.copytree(REHEARSAL, bench_dir, dirs_exist_ok=True,
                    ignore=shutil.ignore_patterns("__pycache__"))

    bench["configs"].append({"name": "rehearsal_vit_128", "source": "x",
                             "file": "benchmark/configs/"
                                     "rehearsal_vit_128.json",
                             "reduced": [], "why": "a transformer"})
    bench["workloads"].append({"name": "vit.train.b8",
                               "config": "rehearsal_vit_128",
                               "traffic": "train_b8_k2", "chips": 1,
                               "why": "attention and layer norm"})
    for m in bench["end_to_end"]:
        if m["name"] == "train_img_s":
            m["workloads"].append("vit.train.b8")
    bench["per_layer"].append({
        "name": "attention_roofline.train", "unit": "%", "better": "higher",
        "source": "device_trace", "layer": "Model", "moves": "train_img_s",
        "workloads": ["vit.train.b8"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    assert spec.problems(spec.load_benchmark()) == []
    cell = conftest.tiny_cell("vit.train.b8")
    assert (cell.config["architecture"], cell.config["image_size"]) == \
        ("rehearsal_vit", 64)  # its tiny configuration
    cfg = spec.cell(spec.load_benchmark(), "vit.train.b8").config
    yardstick_checks.test_forward_flops_frozen_from_the_reference(
        "rehearsal_vit_128")

    with torch.device("meta"):
        ref = models.build(cfg)
    assert type(ref).__module__.startswith("lhbench_arch_")
    with pytest.raises(ValueError):
        models.build(cfg, quant_bits=8)
    side, dim, hidden = 8, cfg["embed_dim"], 4 * cfg["embed_dim"]
    tokens, feat, joints = side * side, 32, 21
    block = 2 * tokens * dim * (3 * dim + dim + 2 * hidden) \
        + 4 * tokens * tokens * dim  # linears, then Q K^T and P V
    hand = (2 * tokens * dim * 3 * 16 * 16 + 2 * block
            + 2 * dim * tokens * feat * 16 + 2 * feat * 4 * tokens * feat * 16
            + 2 * 16 * tokens * feat * joints)
    assert models.forward_flops(ref, cfg["image_size"]) == hand
    # counted on the CPU too, as the program's model is: the CPU's fused
    # SDPA counts no FLOPs, its math path counts both products
    assert models.forward_flops(models.build(cfg), cfg["image_size"]) == hand

    values = inputs.weights(ref, 2**31 + 1, torch.device("cpu"))
    drawn = [n for n, t in values.items()
             if t.ndim >= 2 or n.endswith("proj.bias")]
    assert "pos_embed" in drawn and sum(".fc1.weight" in n for n in drawn) == 2
    for name in drawn:
        t = values[name]
        assert t.abs().min() < 0.5 * t.abs().max()  # neither ones nor zeros
    assert values["pos_embed"].std().item() == pytest.approx(0.02, rel=0.1)
    ref.FREE_STD = {}
    with pytest.raises(ValueError, match="pos_embed"):
        inputs.weights(ref, 2**31 + 1, torch.device("cpu"))

    class Run:
        cell = spec.cell(spec.load_benchmark(), "vit.train.b8")
        device = torch.device("cpu")
        summary = trace.read([], 0.0, 2)
    read = spec.reader("attention_roofline.train").read
    assert read(Run) is None  # nothing ran in the family: left out
    Run.summary.families["attention"] = 2e-3
    least = 2 * sum(yardstick.tensor_bound_s(*yardstick.attention_work(
        8, 4, tokens, 16, b), "") for b in (False, True))
    assert read(Run) == pytest.approx(100 * least / 1e-3)

    (bench_dir / "reference" / "rehearsal_vit.py").unlink()
    assert any("no reference for its architecture" in p
               for p in spec.problems(spec.load_benchmark()))
    with pytest.raises(FileNotFoundError, match="rehearsal_vit.py"):
        models.build(cfg)
