"""What the benchmark runs, found by name: ``BENCHMARK.json`` at the root
of the checkout, and under ``benchmark/``

- ``configs/<config>.json``: a configuration's sizes;
- ``traffic/<mix>.json``: a traffic mix's parameters, whose ``kind`` names
  the general driver ``traffic/<kind>.py``;
- ``workloads/<cell>.json``: a cell's correctness limits;
- ``metrics/<metric>.py``: a per-layer metric's reader, ``read(run)``;
- ``reference/<architecture>.py``: the plain reference of an architecture
  that ``reference/models.py`` does not hold, ``build(config, quant)``.

A later change adds a configuration, a mix, a cell, a metric or an
architecture by adding files and entries; nothing here lists them.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType
from typing import Dict, List

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}")


@dataclasses.dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with its files read."""
    name: str
    chips: int
    config: dict
    mix: dict
    limits: Dict[str, float]
    end_to_end: List[dict]
    per_layer: List[dict]


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_benchmark(path: Path | None = None) -> dict:
    return read_json(path or ROOT / "BENCHMARK.json")


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(bench: dict, name: str) -> Cell:
    """The workload ``name`` of ``bench`` with its configuration, mix and
    limits read; raises KeyError for an unknown name."""
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    return Cell(
        name=name, chips=entry["chips"],
        config=read_json(ROOT / conf["file"]),
        mix=read_json(BENCH_DIR / "traffic" / f"{entry['traffic']}.json"),
        limits=read_json(BENCH_DIR / "workloads" / f"{name}.json")["limits"],
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)])


def _module(path: Path, prefix: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(
        prefix + re.sub(r"\W", "_", path.stem), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def kind(name: str) -> ModuleType:
    """The driver of a kind of traffic, ``traffic/<name>.py``."""
    return _module(BENCH_DIR / "traffic" / f"{name}.py", "lhbench_kind_")


def reader(metric: str) -> ModuleType:
    """The reader of a per-layer metric, ``metrics/<metric>.py``."""
    return _module(BENCH_DIR / "metrics" / f"{metric}.py", "lhbench_metric_")


def architecture(name: str) -> ModuleType:
    """The reference of an architecture, ``reference/<name>.py``; raises
    FileNotFoundError naming the file where there is none."""
    path = BENCH_DIR / "reference" / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no reference for the architecture "
                                f"{name!r}: {path} does not exist")
    return _module(path, "lhbench_arch_")


def problems(bench: dict) -> List[str]:
    """What in ``bench`` and the files it names breaks the benchmark's
    rules of names, units, references and files (empty when none)."""
    out = []
    names = {}
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in bench.get(group, []):
            n = e.get("name", "")
            if not NAME.fullmatch(n):
                out.append(f"{group}: bad name {n!r}")
            names.setdefault(group, []).append(n)
    for group, ns in names.items():
        if len(set(ns)) != len(ns):
            out.append(f"{group}: repeated names")
    metric_names = names.get("end_to_end", []) + names.get("per_layer", [])
    if len(set(metric_names)) != len(metric_names):
        out.append("a metric name is used twice")
    configs = {c["name"]: c for c in bench.get("configs", [])}
    cells = set(names.get("workloads", []))
    files = [c["file"] for c in configs.values()]
    if len(set(files)) != len(files):
        out.append("two configurations share a file")
    from reference import models

    for c in configs.values():
        if not (ROOT / c["file"]).is_file():
            out.append(f"config {c['name']}: no file {c['file']}")
        else:
            arch = read_json(ROOT / c["file"]).get("architecture", "")
            if arch not in models.ARCHITECTURES and not (
                    NAME.fullmatch(arch)
                    and (BENCH_DIR / "reference" / f"{arch}.py").is_file()):
                out.append(f"config {c['name']}: no reference for its "
                           f"architecture {arch!r}")
        for key in c.get("reduced", []):
            if not NAME.fullmatch(key):
                out.append(f"config {c['name']}: bad reduced key {key!r}")
    pairs = set()
    for w in bench.get("workloads", []):
        if w.get("config") not in configs:
            out.append(f"workload {w['name']}: unknown config")
        if not NAME.fullmatch(w.get("traffic", "")):
            out.append(f"workload {w['name']}: bad traffic name")
        pair = (w.get("config"), w.get("traffic"))
        if pair in pairs:
            out.append(f"workload {w['name']}: config and traffic repeated")
        pairs.add(pair)
        mix = BENCH_DIR / "traffic" / f"{w.get('traffic')}.json"
        if not mix.is_file():
            out.append(f"workload {w['name']}: no traffic file {mix.name}")
        elif not (BENCH_DIR / "traffic"
                  / f"{read_json(mix).get('kind')}.py").is_file():
            out.append(f"workload {w['name']}: no driver for its kind")
        if not (BENCH_DIR / "workloads" / f"{w['name']}.json").is_file():
            out.append(f"workload {w['name']}: no limits file")
        if w.get("chips") not in (1, 4):
            out.append(f"workload {w['name']}: chips must be 1 or 4")
    for m in bench.get("end_to_end", []) + bench.get("per_layer", []):
        if not UNIT.fullmatch(m.get("unit", "")):
            out.append(f"metric {m['name']}: bad unit")
        if m.get("better") not in ("lower", "higher"):
            out.append(f"metric {m['name']}: better must be lower|higher")
        for w in m.get("workloads", []):
            if w not in cells:
                out.append(f"metric {m['name']}: unknown workload {w}")
    e2e = {m["name"]: m for m in bench.get("end_to_end", [])}
    for m in bench.get("per_layer", []):
        if m.get("moves") not in e2e:
            out.append(f"metric {m['name']}: moves an unknown metric")
        elif not all(_applies(e2e[m["moves"]], w)
                     for w in m.get("workloads", cells)):
            out.append(f"metric {m['name']}: a cell lacks {m['moves']}")
        if not (BENCH_DIR / "metrics" / f"{m['name']}.py").is_file():
            out.append(f"metric {m['name']}: no reader file")
    return out
