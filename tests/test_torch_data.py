"""The port's data modules (records, synthetic source, registry routes,
Loader) against the JAX package's, on the CPU.

Generated samples and loader batches must be identical: the port keeps its
own copy of the numpy-only code, and the Loader's order and padding are
the JAX Loader's (``mesh=None``).
"""

import dataclasses

import numpy as np
import pytest
import torch

from lighthand_tpu.config import Config as JaxConfig
from lighthand_tpu.data import DevicePreprocessor as JaxPreprocessor
from lighthand_tpu.data import Loader as JaxLoader
from lighthand_tpu.data import build_dataset as jax_build_dataset
from lighthand_tpu.data.records import (
    ConcatSource as JaxConcat,
    SubsetSource as JaxSubset,
    random_split_90_10 as jax_split,
    source_heatmap_styles as jax_styles,
)
from lighthand_tpu.data.synthetic import SyntheticHands as JaxSynthetic
from lighthand_tpu_torch.config import Config
from lighthand_tpu_torch.data import (
    ConcatSource,
    Loader,
    SubsetSource,
    SyntheticHands,
    build_dataset,
    preprocess_u8,
    random_split_90_10,
    source_heatmap_styles,
)
from lighthand_tpu_torch.data.records import Source


def _assert_same_sample(a, b):
    assert a.image.dtype == b.image.dtype == np.uint8
    np.testing.assert_array_equal(a.image, b.image)
    assert a.joints.dtype == b.joints.dtype
    np.testing.assert_array_equal(a.joints, b.joints)
    assert (a.aug_enabled, a.noise_enabled, a.hm_max, a.meta) == (
        b.aug_enabled, b.noise_enabled, b.hm_max, b.meta)


@pytest.mark.parametrize("kw", [
    {}, {"with_visibility": True, "seed": 555},
    {"aug_ratio": 0.5, "seed": 777}],
    ids=["plain", "visibility", "aug_ratio"])
def test_synthetic_samples_are_the_jax_samples(kw):
    port = SyntheticHands(length=6, size=48, **kw)
    ref = JaxSynthetic(length=6, size=48, **kw)
    assert len(port) == len(ref) == 6
    for i in range(6):
        _assert_same_sample(port[i], ref[i])
    if "aug_ratio" in kw:  # the gate: the first half of the indices
        assert [port[i].aug_enabled for i in range(6)] == [True] * 3 + [
            False] * 3


def _cfgs(tmp_path, dataset, **data):
    """(port Config, JAX Config) with the same fields, at 32x32."""
    out = []
    for cls in (Config, JaxConfig):
        cfg = cls(name=f"simplebaseline/{dataset}/t")
        cfg.data.dataset = dataset
        cfg.data.dataset_root = str(tmp_path / "datasets")
        cfg.data.train_yaml = str(tmp_path / "datasets" / "frei.yaml")
        cfg.data.image_size = 32
        cfg.data.num_our = 40
        cfg.data.batch_size = 8
        for k, v in data.items():
            setattr(cfg.data, k, v)
        out.append(cfg)
    return out


@pytest.mark.parametrize("synthetic", [True, False],
                         ids=["synthetic", "missing_tree"])
@pytest.mark.parametrize("dataset", ["ours", "frei", "rhd", "interhand",
                                     "gan", "mix"])
def test_build_dataset_routes_match_jax(tmp_path, dataset, synthetic):
    cfg, jcfg = _cfgs(tmp_path, dataset, synthetic=synthetic,
                      ratio_of_aug=0.25, ratio_of_other=0.5)
    train, val = build_dataset(cfg)
    jtrain, jval = jax_build_dataset(jcfg)
    assert (len(train), len(val)) == (len(jtrain), len(jval))
    assert source_heatmap_styles(train) == jax_styles(jtrain) == {"msra"}
    assert source_heatmap_styles(val) == jax_styles(jval)
    for src, ref in ((train, jtrain), (val, jval)):
        for i in (0, len(src) - 1):
            _assert_same_sample(src[i], ref[i])


def test_build_dataset_eval_stand_in_matches_jax(tmp_path):
    cfg, jcfg = _cfgs(tmp_path, "ours")
    cfg.eval.eval = jcfg.eval.eval = True
    test, same = build_dataset(cfg)
    jtest, _ = jax_build_dataset(jcfg)
    assert test is same and len(test) == len(jtest) == 971
    _assert_same_sample(test[970], jtest[970])
    assert test[0].joints.shape == (21, 3)


def test_build_dataset_stb_and_unknown_raise(tmp_path):
    cfg, jcfg = _cfgs(tmp_path, "stb")
    for fn, c in ((build_dataset, cfg), (jax_build_dataset, jcfg)):
        with pytest.raises(NotImplementedError, match="STB"):
            fn(c)
    with pytest.raises(ValueError, match="unknown dataset"):
        build_dataset(cfg, name="coco")


def _write_tree(tmp_path, route):
    """The tree(s) a route reads, under ``{tmp_path}/datasets``."""
    import torch_fixtures
    from test_torch_sources import (
        write_armo_tree,
        write_interhand_tree,
        write_rhd_tree,
    )

    root = str(tmp_path / "datasets")
    if route in ("ours", "mix"):
        torch_fixtures.write_lighthand_tree(root, 12, 5)
    if route in ("frei", "mix"):
        torch_fixtures.write_freihand_tree(root, 20)
        (tmp_path / "datasets" / "train.yaml").rename(
            tmp_path / "datasets" / "frei.yaml")
    if route in ("rhd", "mix"):
        for phase in ("training", "evaluation"):
            write_rhd_tree(root, phase)
    if route == "interhand":
        for mode in ("train", "val"):
            write_interhand_tree(root, mode)
    if route == "gan":
        torch_fixtures.write_gan_tree(root, 10)
    if route == "eval":
        write_armo_tree(root)


@pytest.mark.parametrize("route", ["ours", "frei", "rhd", "interhand", "gan",
                                   "mix", "eval"])
def test_build_dataset_present_tree_matches_jax(tmp_path, route):
    """A present dataset tree is read, never replaced by generated data:
    the port's sources equal the JAX package's (lengths, target styles,
    every sample, read twice so the second read comes from each side's
    decoded-crop cache); --synthetic still routes to generated data."""
    _write_tree(tmp_path, route)
    cfg, jcfg = _cfgs(tmp_path, "ours" if route == "eval" else route,
                      ratio_of_aug=0.25, ratio_of_other=0.5)
    cfg.eval.eval = jcfg.eval.eval = route == "eval"
    got, want = build_dataset(cfg), jax_build_dataset(jcfg)
    for src, ref in zip(got, want):
        assert len(src) == len(ref) > 0
        assert source_heatmap_styles(src) == jax_styles(ref)
        assert not isinstance(src, SyntheticHands)
        for _ in range(2):
            for i in range(len(src)):
                _assert_same_sample(src[i], ref[i])
    if route == "gan":
        assert source_heatmap_styles(got[0]) == {"max"}
    cfg.data.synthetic = True
    synth = build_dataset(cfg)[0]
    for part in (synth.sources if route == "mix" else [synth]):
        while isinstance(part, SubsetSource):
            part = part.base
        assert isinstance(part, SyntheticHands)


def test_no_cache_crops_reads_the_tree_uncached(tmp_path):
    from lighthand_tpu_torch.data.cache import cached_sources

    _write_tree(tmp_path, "ours")
    cfg, _ = _cfgs(tmp_path, "ours")
    train, val = build_dataset(cfg)
    assert len(cached_sources(train)) == len(cached_sources(val)) == 1
    cfg.data.cache_crops = False
    train, val = build_dataset(cfg)
    assert cached_sources(train) == cached_sources(val) == []


def test_random_split_and_compositions_match_jax():
    src, ref = SyntheticHands(length=37, size=16), JaxSynthetic(length=37,
                                                                size=16)
    (tr, va), (jtr, jva) = random_split_90_10(src, 5), jax_split(ref, 5)
    assert tr.indices == jtr.indices and va.indices == jva.indices
    assert len(tr) == 33 and len(va) == 4
    assert sorted(tr.indices + va.indices) == list(range(37))

    cat = ConcatSource(va, SubsetSource(tr, [3, 1]))
    jcat = JaxConcat(jva, JaxSubset(jtr, [3, 1]))
    assert len(cat) == len(jcat) == 6
    for i in range(6):
        _assert_same_sample(cat[i], jcat[i])
    for a, b in zip(cat.getitems([5, 0]), jcat.getitems([5, 0])):
        _assert_same_sample(a, b)

    class MaxStyle(Source):
        heatmap_style = "max"

    assert source_heatmap_styles(ConcatSource(tr, SubsetSource(
        MaxStyle(), []))) == {"msra", "max"}


def _batches(loader, epoch):
    loader.set_epoch(epoch)
    return list(loader)


@pytest.mark.parametrize("shuffle,drop_last,length", [
    (True, True, 21), (False, False, 21), (True, False, 24)],
    ids=["train_drop_last", "eval_padded_tail", "shuffled_even"])
def test_loader_batches_match_jax(shuffle, drop_last, length):
    src = SyntheticHands(length=length, size=16, aug_ratio=0.5)
    ref = JaxSynthetic(length=length, size=16, aug_ratio=0.5)
    kw = dict(shuffle=shuffle, seed=11, num_workers=2, prefetch=1,
              drop_last=drop_last)
    loader = Loader(src, 8, device="cpu", **kw)
    jloader = JaxLoader(ref, 8, mesh=None, **kw)
    assert len(loader) == len(jloader) == (2 if drop_last else 3)
    seen = []
    for epoch in (0, 1):
        got, want = _batches(loader, epoch), _batches(jloader, epoch)
        assert len(got) == len(want) == len(loader)
        for g, w in zip(got, want):
            assert set(g) == set(w)
            assert g["pose_ctgy"] == w["pose_ctgy"]
            for k in set(g) - {"pose_ctgy"}:
                assert isinstance(g[k], torch.Tensor)
                assert g[k].device.type == "cpu"
                np.testing.assert_array_equal(g[k].numpy(), np.asarray(w[k]),
                                              err_msg=k)
        seen.append(torch.cat([b["joints"] for b in got]))
    if shuffle:  # a new order every epoch
        assert not torch.equal(seen[0], seen[1])
    if not drop_last and length % 8:
        tail = got[-1]
        n = length % 8
        assert tail["valid"].tolist() == [1.0] * n + [0.0] * (8 - n)
        # padding repeats the last real row
        assert torch.equal(tail["image_u8"][n:],
                           tail["image_u8"][n - 1:n].expand(8 - n, -1, -1, -1))


def test_preprocess_u8_matches_jax_eval_preprocessor():
    images = np.random.default_rng(0).integers(0, 256, size=(2, 8, 8, 3),
                                               dtype=np.uint8)
    got = preprocess_u8(torch.from_numpy(images), torch.float32)
    import jax
    import jax.numpy as jnp

    want = JaxPreprocessor(jitter=False, out_dtype=jnp.float32)(
        jax.random.PRNGKey(0), jnp.asarray(images), jnp.zeros(2))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)
    assert preprocess_u8(torch.from_numpy(images)).dtype == torch.bfloat16


def test_config_copies_have_the_same_data_fields():
    assert [f.name for f in dataclasses.fields(Config().data)] == [
        f.name for f in dataclasses.fields(JaxConfig().data)]
