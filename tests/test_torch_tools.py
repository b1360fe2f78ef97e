"""The port's measurement tools beside the JAX package's: the int8 serving
bench, the step profiler's summary and the cache pre-warmer, and the import
rule of all four new entry points (``bench_torch.py`` and the three
``tools/*_torch.py``).

The profiler's summary is held on a hand-made Chrome trace (ranking,
collapsing, families, the dropped-event share). The pre-warmer runs over a
fixture tree beside the JAX tool; each cache must then be full and the two
memmaps' crops equal (the port's codec is bit-exact with cv2 5.0.0 here).
"""

import ast
import json
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import chip_smoke

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "tools"))

import int8_serving_bench_torch as serving  # noqa: E402
import prewarm_cache_torch as prewarm  # noqa: E402
import profile_step_torch as profile  # noqa: E402

NEW_FILES = ["bench_torch.py", "tools/int8_serving_bench_torch.py",
             "tools/profile_step_torch.py", "tools/prewarm_cache_torch.py"]
BANNED = ("jax", "jaxlib", "flax", "optax", "orbax", "lighthand_tpu", "cv2",
          "PIL")


# ------------------------------------------------------------------ imports


@pytest.mark.parametrize("path", NEW_FILES)
def test_new_entry_points_import_no_jax(path):
    for node in ast.walk(ast.parse((REPO / path).read_text())):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names = [node.module]
        for name in names:
            assert name.split(".")[0] not in BANNED, (path, name)


def test_importing_the_entry_points_loads_no_jax():
    """Each file imported in a fresh process (the tools as modules) loads no
    jax, JAX package, cv2, PIL or orbax, and initialises no CUDA."""
    code = ("import sys; sys.path[:0] = [sys.argv[1], sys.argv[1] + "
            "'/tools']\n"
            "import bench_torch, int8_serving_bench_torch, "
            "profile_step_torch, prewarm_cache_torch, torch\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'lighthand_tpu', 'cv2', 'PIL', 'orbax')]\n"
            "print(bad, torch.cuda.is_initialized())\n"
            "sys.exit(1 if bad or torch.cuda.is_initialized() else 0)")
    out = subprocess.run([sys.executable, "-c", code, str(REPO)],
                         capture_output=True, text=True, timeout=120,
                         cwd=REPO)
    assert out.returncode == 0, out.stdout + out.stderr


# ------------------------------------------------------------------ serving


def test_serving_main_prints_the_jax_tools_keys(monkeypatch, capsys):
    calls = []

    def measure_predict(precision, **kw):
        calls.append(precision)
        return serving.Serving({"bf16": 200.0, "int8_fwd": 250.0}[precision],
                               None, torch.zeros(2, 21, 2))

    monkeypatch.setattr(serving, "resolve_device",
                        lambda device: torch.device("cpu"))
    monkeypatch.setattr(serving, "measure_predict", measure_predict)
    assert serving.main() == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert calls == ["bf16", "int8_fwd"]
    assert all(line.startswith("#") for line in out[:-1])
    assert json.loads(out[-1]) == {"bf16": 200.0, "int8_fwd": 250.0,
                                   "speedup": 1.25}


def test_serving_main_raises_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serving.main()
    assert "{" not in capsys.readouterr().out


@pytest.mark.parametrize("precision", ["bf16", "int8_fwd"])
def test_serving_predict_on_the_cpu(precision):
    """The tool's predict (hrnet_tiny, 64x64, B=2) gives the predict step's
    joints for its seeded weights and images, finite and in the image."""
    from lighthand_tpu_torch.models import get_model
    from lighthand_tpu_torch.train import (
        create_train_state,
        make_predict_step,
    )

    got = serving.measure_predict(precision, batch=2, size=64,
                                  model_name="hrnet_tiny", device="cpu",
                                  warmup=1, measure=1, blocked=1)
    assert got.img_per_sec > 0 and got.device_ms is None
    state = create_train_state(
        get_model("hrnet_tiny", policy=serving.policy_for(precision)),
        torch.Generator().manual_seed(0), device="cpu")
    images = np.random.default_rng(0).normal(size=(2, 64, 64, 3)).astype(
        np.float32)
    want, _ = make_predict_step(device="cpu")(state, torch.from_numpy(images))
    assert torch.equal(got.joints, want)
    assert got.joints.shape == (2, 21, 2)
    assert bool(((got.joints >= 0) & (got.joints < 64)).all())


# ----------------------------------------------------------------- profiler


def _kernel(name, ts, dur, corr, ext):
    return {"ph": "X", "cat": "kernel", "name": name, "pid": 0, "tid": 7,
            "ts": ts, "dur": dur, "args": {"correlation": corr,
                                           "External id": ext}}


def _launch(corr, name="cudaLaunchKernel", cat="cuda_runtime"):
    return {"ph": "X", "cat": cat, "name": name, "pid": 1, "tid": 1,
            "ts": 0, "dur": 1, "args": {"correlation": corr}}


def _write_trace(tmp_path, unanswered=0, event_ms=4.0):
    """Two dispatches: per dispatch a K1 launch (100 us), two instances of
    one collapsible name (300 + 100 us), a cuDNN conv (1000 us), a BN
    kernel (200 us), an elementwise kernel (50 us) and an Adam kernel (250
    us); ``unanswered`` more launch calls have no kernel event."""
    ops = [{"ph": "X", "cat": "cpu_op", "name": "aten::convolution",
            "ts": 0, "dur": 5, "args": {"External id": 1}},
           {"ph": "X", "cat": "cpu_op", "name": "aten::add_",
            "ts": 0, "dur": 5, "args": {"External id": 2}}]
    per = [("void fused_aug_kernel<__nv_bfloat16>(unsigned char const*)",
            100, 2),
           ("fusion.12", 300, 2), ("fusion.7", 100, 2),
           ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc",
            1000, 1),
           ("void at::native::batch_norm_collect_statistics_kernel", 200, 2),
           ("void at::native::vectorized_elementwise_kernel<4>", 50, 2),
           ("void at::native::multi_tensor_apply_kernel<AdamFunctor>", 250,
            2)]
    events, corr = list(ops), 0
    for d in range(2):
        for name, dur, ext in per:
            corr += 1
            events.append(_kernel(name, 10000 * d + corr, dur, corr, ext))
            events.append(_launch(corr, "cudaLaunchKernelExC" if corr % 2
                                  else "cuLaunchKernel",
                                  "cuda_runtime" if corr % 2
                                  else "cuda_driver"))
    for i in range(unanswered):
        events.append(_launch(1000 + i))
    events.append({"ph": "X", "cat": "cuda_runtime", "name":
                   "cudaMemcpyAsync", "ts": 0, "dur": 1,
                   "args": {"correlation": 5000}})
    (tmp_path / "trace.json").write_text(json.dumps({"traceEvents": events}))
    (tmp_path / "window.json").write_text(json.dumps({
        "model": "hrnet_w32", "batch": 128, "size": 256, "precision": "bf16",
        "scan_steps": 4, "dispatches": 2, "wall_ms": 10.0,
        "event_ms": 2 * event_ms, "loss": 1.0}))


def test_summarize_ranks_collapses_and_groups(tmp_path, capsys):
    _write_trace(tmp_path)
    got = profile.summarize(str(tmp_path), per_op=True)
    out = capsys.readouterr().out
    names = [r["op"] for r in got["rows"]]
    # fusion.12 and fusion.7 collapse into one row of 400 us a dispatch
    assert names[:2] == [
        "sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc",
        "fusion"]
    fusion = got["rows"][1]
    assert fusion["ms"] == pytest.approx(0.4) and fusion["count"] == 4
    assert got["kernel_ms"] == pytest.approx(2.0)
    assert sum(r["pct"] for r in got["rows"]) == pytest.approx(100.0)
    k1 = next(r for r in got["rows"] if "fused_aug" in r["op"])
    assert k1["count"] == 2 and k1["ms"] == pytest.approx(0.1)
    fam = got["families"]
    assert fam["port kernels"]["ms"] == pytest.approx(0.1)
    assert fam["conv / gemm (cuDNN, cuBLAS)"]["ms"] == pytest.approx(1.0)
    assert fam["batch norm"]["ms"] == pytest.approx(0.2)
    assert fam["optimizer"]["ms"] == pytest.approx(0.25)
    assert fam["elementwise / cast / copy"]["ms"] == pytest.approx(0.05)
    assert fam["other"]["ms"] == pytest.approx(0.4)  # the fusions
    assert fam["port kernels"]["count"] == 1.0
    # every launch answered; the sum against the events is a busy share
    assert got["launches"] == got["matched"] == 14 and got["dropped"] == 0
    assert got["busy"] == pytest.approx(0.5)
    assert "DROPPED" not in out
    assert "aten::convolution" in out  # the attribution view


def test_summarize_flags_dropped_events(tmp_path, capsys):
    _write_trace(tmp_path, unanswered=1)
    got = profile.summarize(str(tmp_path))
    assert got["launches"] == 15 and got["matched"] == 14
    out = capsys.readouterr().out
    assert got["dropped"] == 1 and "DROPPED EVENTS: 1 kernels missing" in out
    assert "not device time" in out  # 14 of 15 answered, under 0.95
    assert profile.summarize(str(tmp_path / "missing")) == {}


def test_profiler_workload_on_the_cpu(tmp_path, capsys):
    """``run_workload`` runs bench_torch's workload under the trace and
    writes the window; ``main --parse-only`` reads it back."""
    window = profile.run_workload("hrnet_tiny", 2, 64, str(tmp_path),
                                  steps=1, scan_steps=2, warmup=1,
                                  device="cpu")
    assert window["dispatches"] == 1 and window["event_ms"] is None
    assert np.isfinite(window["loss"])
    assert (tmp_path / "trace.json").is_file()
    assert profile.main(["--parse-only", "--out", str(tmp_path)]) == 0
    assert "window: 1 dispatches of hrnet_tiny" in capsys.readouterr().out


# ------------------------------------------------------------------ prewarm


def _tree(tmp_path, route):
    root = tmp_path / "datasets"
    argv = ["--name", "x", "--dataset-root", str(root), "--num_our", "12"]
    if route == "ours":
        chip_smoke.write_lighthand_tree(str(root), 12, 5)
        return argv + ["--root", "simplebaseline/ours"]
    yaml = chip_smoke.write_freihand_tree(str(root / "frei"), 20)
    return argv + ["--root", "simplebaseline/frei", "--train_yaml", yaml]


def _cache(source):
    while not hasattr(source, "cache_dir") and hasattr(source, "base"):
        source = source.base
    return source


@pytest.mark.parametrize("route", ["ours", "frei"])
def test_prewarm_fills_the_port_cache_as_the_jax_tool_fills_its(
        route, tmp_path, capsys):
    from lighthand_tpu.config import parse_args as jax_parse_args
    from lighthand_tpu.data.registry import build_dataset as jax_build
    from lighthand_tpu_torch.config import parse_args
    from lighthand_tpu_torch.data.registry import build_dataset

    argv = _tree(tmp_path, route)
    assert prewarm.main(argv + ["--batch", "4"]) == 0
    out = capsys.readouterr().out
    assert "train fill/verify pass" in out and "cached/fill speedup" in out
    assert not torch.cuda.is_initialized()
    jax_run = subprocess.run(
        [sys.executable, "tools/prewarm_cache.py", *argv, "--batch", "4"],
        capture_output=True, text=True, timeout=120, cwd=REPO,
        env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert jax_run.returncode == 0, jax_run.stderr
    # the two tools print the same lines, but for the cache directories
    # (each package's own) and the numbers
    def shape(text):
        return [re.sub(r"[\d.]+", "#", re.sub(r"\S*/\.lh_cache/\S+", "DIR",
                                              line))
                for line in text.splitlines()]
    assert shape(out) == shape(jax_run.stdout)

    ports = [_cache(s) for s in build_dataset(parse_args(argv))]
    jaxs = [_cache(s) for s in jax_build(jax_parse_args(argv))]
    assert len(ports) == len(jaxs) == 2
    for port, ref in zip(ports, jaxs):
        assert port.cache_dir != ref.cache_dir
        assert port.hit_fraction() == ref.hit_fraction() == 1.0
        for name in ("images", "joints", "flags"):
            np.testing.assert_array_equal(np.asarray(getattr(port, name)),
                                          np.asarray(getattr(ref, name)),
                                          err_msg=name)


def test_summarize_answers_graph_launches_by_their_kernels(tmp_path, capsys):
    """A graph replay is one ``cudaGraphLaunch`` whose kernels all carry its
    correlation id: each answered launch counts once, its kernels count in
    the ranking, and a graph launch no kernel answers is a dropped event."""
    events = []
    for d in range(2):  # two dispatches, each two replays of a graph
        for r in range(2):
            corr = 100 + 10 * d + r
            events.append(_launch(corr, "cudaGraphLaunch_v10000"))
            for i in range(3):
                events.append(_kernel("void fused_aug_kernel<float>"
                                      if i == 0 else "void bn_fw_kernel",
                                      1000 * corr + i, 50, corr, 0))
        events.append(_kernel("void multi_tensor_apply_kernel<Adam>",
                              5000 + d, 20, 200 + d, 0))
        events.append(_launch(200 + d, "cudaLaunchKernel"))
    events.append(_launch(300, "cudaGraphLaunch"))  # nothing answers it
    (tmp_path / "trace.json").write_text(json.dumps({"traceEvents": events}))
    (tmp_path / "window.json").write_text(json.dumps({
        "model": "hrnet_w32", "batch": 32, "size": 256, "precision": "bf16",
        "scan_steps": 2, "dispatches": 2, "wall_ms": 2.0, "event_ms": 1.0,
        "loss": 1.0}))
    got = profile.summarize(str(tmp_path))
    out = capsys.readouterr().out
    assert got["graph_launches"] == 5 and got["graph_kernels"] == 12
    assert got["launches"] == 7 and got["matched"] == 6
    assert got["dropped"] == 1 and "DROPPED EVENTS: 1" in out
    k1 = next(r for r in got["rows"] if "fused_aug" in r["op"])
    assert k1["count"] == 4
    assert got["kernels"] == 7.0  # a dispatch: 6 replayed, 1 of Adam's
    assert "graph launches: 5, answered by 4, carrying 12" in out


def test_summarize_labels_idle_gaps_by_the_launch_that_ends_them(
        tmp_path, capsys):
    """Each gap between device operations goes to ``queued`` where the
    call that launched the next operation had returned before the gap
    began, else to the innermost ``lighthand.*`` or ``Optimizer.step#``
    range holding that call, else to other host work; a host range
    mirrored onto the device is no device work."""
    def x(cat, name, ts, dur, corr=None):
        args = {} if corr is None else {"correlation": corr}
        return {"ph": "X", "cat": cat, "name": name, "pid": 0, "tid": 1,
                "ts": ts, "dur": dur, "args": args}

    events = [
        x("cpu_op", "lighthand.graph.call", 0, 55),
        x("cpu_op", "lighthand.graph.replay", 10, 20),
        x("cuda_runtime", "cudaGraphLaunch", 10, 18, 1),
        x("kernel", "void bn_fw_kernel", 20, 20, 1),
        x("kernel", "void bn_fw_kernel", 45, 5, 1),  # queued: 5 us
        x("gpu_user_annotation", "Optimizer.step#ShardAdam.step", 20, 60),
        x("user_annotation", "Optimizer.step#ShardAdam.step", 60, 30),
        x("cuda_runtime", "cudaLaunchKernel", 70, 5, 2),
        x("kernel", "multi_tensor_apply_kernel<Adam>", 72, 8, 2),  # 22 us
        x("cuda_runtime", "cudaMemcpyAsync", 92, 4, 3),
        x("gpu_memcpy", "Memcpy DtoD (Device -> Device)", 95, 2, 3),  # 15
        x("kernel", "void elementwise_kernel", 100, 1, 9),  # 3, no call
        x("cpu_op", "lighthand.graph.call", 120, 30),
        x("cpu_op", "lighthand.graph.replay", 125, 20),
        x("cuda_runtime", "cudaGraphLaunch", 130, 10, 4),
        x("kernel", "void bn_fw_kernel", 138, 12, 4),  # 37 us
    ]
    (tmp_path / "trace.json").write_text(json.dumps({"traceEvents": events}))
    (tmp_path / "window.json").write_text(json.dumps({
        "model": "hrnet_w32", "batch": 32, "size": 256, "precision": "bf16",
        "scan_steps": 4, "dispatches": 1, "wall_ms": 1.0, "event_ms": 1.0,
        "loss": 1.0}))
    got = profile.summarize(str(tmp_path))
    assert got["idle"] == pytest.approx({
        "lighthand.graph.replay": 0.037, "Optimizer.step#ShardAdam.step":
        0.022, "other host work": 0.015, "queued": 0.005,
        "no launch event": 0.003})
    assert list(got["idle"])[0] == "lighthand.graph.replay"
    assert "lighthand" not in " ".join(r["op"] for r in got["rows"])
    out = capsys.readouterr().out
    assert "0.082 ms a dispatch, by the launch that ends each gap" in out
