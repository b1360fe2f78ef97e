"""``bench_torch.py``, the port's bench, against ``bench.py``: its
constants, its batch, one dispatch of its workload against the JAX
package's fused scan step, and its command line.

The dispatch runs ``bench_torch.setup``'s workload on the CPU at a small
size (hrnet_tiny, 64x64, B=2, K=2) under the f32 policy, with JAX's
weights carried across (``utils/weights.py:hrnet_from_flax``) and JAX's
jitter draws injected (``tests/test_torch_step.py:_jax_draws``), against
``lighthand_tpu``'s ``make_fused_train_step(scan_steps=2)`` on the same
numpy batch, at ``tests/test_torch_step.py``'s stated tolerances (its lr
1e-4): the first microbatch's loss against JAX's scan-1 step within 1e-5
relative (no Adam update before it: measured 1.3e-6 to 2.5e-6); the
dispatch's mean loss, whose second step follows an update, within 5e-3
(that test's bound for scanned calls after an update: one Adam step moves
an element by about lr * sign(g), and a near-zero gradient's sign is the
summation order's; measured 2.6e-4 here, 5e-4 on the second step alone);
parameters within 2 * steps * lr and running statistics within 5e-3.
"""

import ast
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench_torch
from lighthand_tpu.core.dtypes import DTypePolicy as JaxPolicy
from lighthand_tpu.core.prng import cpu_prng_key, host_split
from lighthand_tpu.models import get_model as jax_get_model
from lighthand_tpu.train import create_train_state as jax_create_state
from lighthand_tpu.train.step import make_fused_train_step as jax_fused_step
from lighthand_tpu_torch.models.hrnet import HRNetCfg
from lighthand_tpu_torch.train import set_learning_rate
from lighthand_tpu_torch.train import step as port_step
from lighthand_tpu_torch.utils.weights import hrnet_from_flax
from test_torch_step import LR, _jax_draws, _variables

REPO = pathlib.Path(__file__).resolve().parents[1]
COPIED = ("REFERENCE_IMG_PER_SEC", "BATCH", "SCAN_STEPS", "SIZE", "WARMUP",
          "MEASURE", "EXTRA_CONFIGS", "REF_ESTIMATES")
K, B, S = 2, 2, 64


def _bench_py_constants() -> dict:
    """bench.py's module-level constants, read with ``ast`` (importing it
    would import jax's bench machinery)."""
    out = {}
    for node in ast.parse((REPO / "bench.py").read_text()).body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            name = getattr(node.targets[0], "id", None)
            if name in COPIED:
                out[name] = ast.literal_eval(node.value)
    return out


def test_constants_equal_bench_py():
    want = _bench_py_constants()
    assert sorted(want) == sorted(COPIED)
    for name in COPIED:
        assert getattr(bench_torch, name) == want[name], name
    # every configuration has a reference estimate
    for model_name, _, size, _, _ in bench_torch.EXTRA_CONFIGS:
        assert (model_name, size) in bench_torch.REF_ESTIMATES


def _bench_py_batch(scan_steps, batch, size, target_style):
    """A replay of ``bench.py:98-119`` in numpy (``shard`` left out)."""
    rng = np.random.default_rng(0)
    batch_d = {
        "image_u8": rng.integers(
            0, 255, size=(scan_steps, batch, size, size, 3),
            dtype=np.uint8),
        "joints": rng.uniform(
            16, size - 16,
            size=(scan_steps, batch, 21, 2)).astype(np.float32),
        "aug_enabled": np.ones((scan_steps, batch), np.float32),
        "noise_enabled": np.zeros((scan_steps, batch), np.float32),
    }
    if target_style == "per_sample":
        batch_d["hm_max"] = (
            (rng.uniform(size=(scan_steps, batch)) < 0.5)
            .astype(np.float32))
    return batch_d


@pytest.mark.parametrize("style", ["msra", "per_sample"])
def test_batch_equals_bench_py(style):
    """Bit for bit, and so is what ``setup`` stages on the device."""
    got = bench_torch.make_batch(3, 4, 40, style)
    want = _bench_py_batch(3, 4, 40, style)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    wl = bench_torch.setup("hrnet_tiny", 4, 40, scan_steps=3,
                           target_style=style, device="cpu")
    for k in want:
        np.testing.assert_array_equal(wl.batch[k].numpy(), want[k],
                                      err_msg=k)
    one = bench_torch.setup("hrnet_tiny", 4, 40, scan_steps=1,
                            target_style=style, device="cpu")
    np.testing.assert_array_equal(one.batch["joints"].numpy(),
                                  _bench_py_batch(1, 4, 40, style)["joints"][0])


@pytest.mark.parametrize("style", ["msra", "per_sample"])
def test_bench_dispatch_matches_jax(style, monkeypatch):
    """One dispatch of the bench's workload (jitter on, every sample) against
    JAX's fused scan step from the same weights, batch and draws."""
    def jax_state():
        return jax_create_state(
            jax_get_model("hrnet_tiny", policy=JaxPolicy.full_precision()),
            cpu_prng_key(0), input_shape=(1, S, S, 3), lr=LR)

    jstate = jax_state()
    wl = bench_torch.setup("hrnet_tiny", B, S, precision="f32",
                           scan_steps=K, target_style=style, device="cpu")
    wl.state.model.load_state_dict(hrnet_from_flax(_variables(jstate),
                                                   HRNetCfg.tiny()))
    set_learning_rate(wl.state, LR)

    batch = bench_torch.make_batch(K, B, S, style)
    _, sub = host_split(cpu_prng_key(1))
    keys = jax.random.split(sub, K)  # the scan's key a microbatch
    draws = iter(torch.from_numpy(_jax_draws(
        keys[k], batch["aug_enabled"][k], batch["noise_enabled"][k])[0])
        for k in range(K))
    monkeypatch.setattr(port_step, "draw_aug_params",
                        lambda gen, aug, noise: next(draws))
    losses, update = [], port_step._update
    monkeypatch.setattr(port_step, "_update", lambda *a: losses.append(
        update(*a)) or losses[-1])
    kw = dict(heatmap_size=S // 4, stride=4.0, jitter=True,
              target_style=style, compute_dtype=jnp.float32)
    _, first = jax_fused_step(scan_steps=1, **kw)(
        jax_state(), keys[0], {k: jnp.asarray(v[0]) for k, v in batch.items()})
    jstate, jm = jax_fused_step(scan_steps=K, **kw)(
        jstate, sub, {k: jnp.asarray(v) for k, v in batch.items()})
    loss = wl.dispatch()

    assert len(losses) == K
    np.testing.assert_allclose(float(losses[0]), float(first["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(loss), float(jm["loss"]), rtol=5e-3)
    assert wl.state.step == K
    want = hrnet_from_flax(_variables(jstate), HRNetCfg.tiny())
    got = wl.state.model.state_dict()
    for k, w in want.items():
        if k.endswith("num_batches_tracked"):
            continue
        stat = k.endswith(("running_mean", "running_var"))
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=0,
                                   atol=5e-3 if stat else 2 * K * LR,
                                   err_msg=k)


def test_measure_on_the_cpu():
    """The whole timing path at a small size: finite figures, no device
    figures on the CPU."""
    m = bench_torch.measure("hrnet_tiny", B, S, scan_steps=K, measure=1,
                            device="cpu", warmup=1, blocked=1)
    assert np.isfinite(m.loss) and m.img_per_sec > 0
    assert m.img_per_sec in (m.pipelined_img_per_sec, m.blocked_img_per_sec)
    assert m.device_ms is m.events_over_wall is m.peak_bytes is None


def test_unknown_precision_raises():
    with pytest.raises(ValueError, match="precision"):
        bench_torch.policy_for("fp8")


def test_main_raises_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench_torch.main([])
    assert "{" not in capsys.readouterr().out


def _stub_measure(calls):
    def measure(model_name, batch, size, precision="bf16", **kw):
        calls.append((model_name, batch, size, precision,
                      kw.get("target_style", "msra")))
        return bench_torch.Measurement(
            img_per_sec=100.0 + len(calls), pipelined_img_per_sec=0.0,
            blocked_img_per_sec=0.0, device_ms=12.5, events_over_wall=0.9,
            peak_bytes=3 << 30, loss=0.5)
    return measure


@pytest.mark.parametrize("argv", [[], ["--all"]], ids=["headline", "all"])
def test_main_output_and_table(argv, tmp_path, monkeypatch, capsys):
    """The last line has exactly bench.py's keys and metric text; --all
    writes BENCH_TABLE_torch.json in the working directory with a row for
    the headline and each EXTRA_CONFIGS entry, and never BENCH_TABLE.json."""
    calls = []
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(bench_torch, "resolve_device",
                        lambda device: torch.device("cpu"))
    monkeypatch.setattr(bench_torch, "measure", _stub_measure(calls))
    assert bench_torch.main(argv) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert all(line.startswith("#") for line in out[:-1])
    last = json.loads(out[-1])
    assert sorted(last) == ["metric", "unit", "value", "vs_baseline"]
    assert last["metric"] == ("train images/sec/chip (HRNet-W32@256^2, "
                              "bs128, bf16, scan4, incl. on-device "
                              "aug+heatmap-target)")
    assert last["value"] == 101.0 and last["unit"] == "images/sec/chip"
    assert last["vs_baseline"] == round(101.0 / 330.0, 3)
    assert calls[0] == ("hrnet_w32", 128, 256, "bf16", "msra")
    assert not (tmp_path / "BENCH_TABLE.json").exists()
    table_path = tmp_path / bench_torch.TABLE
    if not argv:
        assert len(calls) == 1 and not table_path.exists()
        return
    assert calls[1:] == [tuple(c) for c in bench_torch.EXTRA_CONFIGS]
    table = json.loads(table_path.read_text())
    rows = {k: v for k, v in table.items() if not k.startswith("_")}
    assert len(rows) == 1 + len(bench_torch.EXTRA_CONFIGS)
    assert "simplebaseline@256 bs256 bf16 per_sample(mix)" in rows
    row = rows["hrnet_w48@256 bs64 bf16"]
    assert row["ref_estimate"] == 237.0 and row["peak_gib"] == 3.0
    assert row["device_ms_per_dispatch"] == 12.5
    assert sum(line.count("GiB") for line in out) == len(rows)
