"""The port's dataset readers, TSV engine and decoded-crop cache against
the JAX package's on the same generated trees.

The trees are built from the committed fixture images
(``tests/fixtures/images``) by ``chip_smoke.py``'s writers (LightHand,
FreiHAND, GAN) and by the fixtures below (RHD, InterHand, Armo). Joints and
flags must be equal, and images bit-exact: the port's codec, resize and
warp give cv2's bytes (``tests/test_torch_imageio.py``).
"""

import json
import os
import pickle
import shutil

import numpy as np
import pytest

import torch_fixtures
from lighthand_tpu.data import cache as jcache
from lighthand_tpu.data import tsv as jtsv
from lighthand_tpu.data.armo import ArmoEvalSet as JArmo
from lighthand_tpu.data.freihand import FreiHandTSVDataset as JFrei
from lighthand_tpu.data.gan import GANeratedDataset as JGan
from lighthand_tpu.data.interhand import InterHandDataset as JInter
from lighthand_tpu.data.lighthand import LightHandDataset as JLight
from lighthand_tpu.data.lighthand import LightHandValSet as JLightVal
from lighthand_tpu.data.rhd import RHDDataset as JRhd
from lighthand_tpu_torch.data import cache, native, tsv
from lighthand_tpu_torch.data.armo import ArmoEvalSet
from lighthand_tpu_torch.data.freihand import FreiHandTSVDataset
from lighthand_tpu_torch.data.gan import GANeratedDataset
from lighthand_tpu_torch.data.interhand import InterHandDataset
from lighthand_tpu_torch.data.lighthand import LightHandDataset, LightHandValSet
from lighthand_tpu_torch.data.records import Sample, Source, SubsetSource
from lighthand_tpu_torch.data.rhd import RHDDataset

MANIFEST = torch_fixtures.load_manifest()
JPEGS = [e for e in MANIFEST if e["kind"] == "jpeg"]
PNGS = [e for e in MANIFEST if e["kind"] == "png"]
MASK = next(e for e in MANIFEST if e["kind"] == "mask")


def assert_same(got, want, ctx=""):
    np.testing.assert_array_equal(got.image, want.image, err_msg=ctx)
    assert got.image.dtype == np.uint8 and want.image.dtype == np.uint8
    np.testing.assert_array_equal(got.joints, want.joints, err_msg=ctx)
    assert got.joints.dtype == want.joints.dtype, ctx
    assert (got.aug_enabled, got.noise_enabled, got.hm_max) == (
        want.aug_enabled, want.noise_enabled, want.hm_max), ctx
    assert got.meta == want.meta, ctx


def assert_same_source(src, ref, indices=None):
    assert len(src) == len(ref)
    assert getattr(src, "heatmap_style", "msra") == getattr(
        ref, "heatmap_style", "msra")
    for i in indices if indices is not None else range(len(src)):
        assert_same(src[i], ref[i], f"index {i}")


# ----------------------------------------------------------------- trees


def write_rhd_tree(root, phase="training", n=5):
    """RHD: 320x320 colour PNGs (the fixture renders, placed on a canvas),
    gray mask PNGs (the fixture mask; one empty, one too small, so the
    filter drops them), K and 42 xyz joints whose left block (rows 21:)
    projects onto the fixture joints."""
    base = os.path.join(root, "RHD_published_v2", phase)
    os.makedirs(os.path.join(base, "color"))
    os.makedirs(os.path.join(base, "mask"))
    import cv2

    anno = {}
    for i in range(n):
        e = PNGS[i % len(PNGS)]
        img = cv2.imread(e["path"], cv2.IMREAD_UNCHANGED)
        canvas = np.zeros((320, 320) + img.shape[2:], img.dtype)
        oy, ox = 20 + 7 * i, 40 - 5 * i
        canvas[oy:oy + img.shape[0], ox:ox + img.shape[1]] = img
        cv2.imwrite(os.path.join(base, "color", f"{i:05d}.png"), canvas)
        mask = cv2.imread(MASK["path"], cv2.IMREAD_GRAYSCALE)
        mcanvas = np.zeros((320, 320), np.uint8)
        if i == 1:
            pass  # empty mask: dropped
        elif i == 2:
            mcanvas[50:60, 50:70] = 30  # under 30 px: dropped
        else:
            mcanvas[oy:oy + 224, ox:ox + 224] = mask
        cv2.imwrite(os.path.join(base, "mask", f"{i:05d}.png"), mcanvas)
        uv = np.asarray(e["joints"]) + [ox, oy]
        z = np.linspace(0.4, 0.6, 21)[:, None]
        left = np.concatenate([uv * z, z], 1)
        right = left[::-1] * 1.1
        anno[i] = {"K": np.eye(3), "xyz": np.concatenate([right, left])}
    with open(os.path.join(base, f"anno_{phase}.pickle"), "wb") as f:
        pickle.dump(anno, f)


def write_interhand_tree(root, mode="train", n=4):
    """InterHand2.6M: fixture JPEGs on 320x320 canvases, one right-hand
    annotation each (plus one left hand, dropped), bboxes covering the
    context crop's interior, clamped and oversized branches."""
    import cv2

    base = os.path.join(root, "InterHand2.6M_5fps_batch1")
    annot = os.path.join(base, "annotations", mode)
    img_dir = os.path.join(base, "images", mode)
    os.makedirs(annot)
    os.makedirs(img_dir)
    cameras = {"0": {"campos": {"4": [0.0, 0.0, -500.0]},
                     "camrot": {"4": np.eye(3).tolist()},
                     "focal": {"4": [500.0, 500.0]},
                     "princpt": {"4": [0.0, 0.0]}}}
    images, annotations, joints3d = [], [], {"0": {}}
    bboxes = [[60, 60, 150, 150], [0, 250, 60, 60], [10, 10, 300, 200],
              [200, 5, 100, 90]]
    for i in range(n):
        e = JPEGS[i % len(JPEGS)]
        canvas = np.zeros((320, 320, 3), np.uint8)
        canvas[40:40 + 224, 50:50 + 224] = cv2.imread(e["path"])[:224, :224]
        fn = f"img{i}.jpg"
        cv2.imwrite(os.path.join(img_dir, fn), canvas,
                    [cv2.IMWRITE_JPEG_QUALITY, 90])
        images.append({"id": i, "file_name": fn, "capture": 0,
                       "camera": "4", "frame_idx": i})
        annotations.append({"id": i, "image_id": i, "hand_type": "right",
                            "bbox": bboxes[i % len(bboxes)]})
        uv = np.asarray(e["joints"]) + [50, 40]
        z = 500.0
        world = np.concatenate([uv * z / 500.0, np.zeros((21, 1))], 1)
        world = np.concatenate([world, world])
        world[:, 2] = 0.0
        joints3d["0"][str(i)] = {"world_coord": world.tolist()}
    annotations.append({"id": n, "image_id": 0, "hand_type": "left",
                        "bbox": [0, 0, 10, 10]})
    for name, obj in (("data", {"images": images,
                                "annotations": annotations}),
                      ("camera", cameras), ("joint_3d", joints3d)):
        with open(os.path.join(annot, f"InterHand2.6M_{mode}_{name}.json"),
                  "w") as f:
            json.dump(obj, f)


def write_armo_tree(root, n=5):
    """Armo: fixture JPEGs as rgb/{image_id}.jpg, normalized joints,
    visibility, pose categories, and one incomplete record (dropped)."""
    rgb = os.path.join(root, "Armo_hand_dataset", "rgb")
    os.makedirs(rgb)
    annos = {}
    cats = ("Standard", "Occlusion_by_Pinky", "Occlusion_by_Thumb",
            "Occlusion_by_Both")
    for i in range(n):
        e = JPEGS[i % len(JPEGS)]
        shutil.copyfile(e["path"], os.path.join(rgb, f"im{i}.jpg"))
        h, w = e["shape"][:2]
        annos[f"k{i}"] = {
            "coordinates": (np.asarray(e["joints"]) / [w, h]).tolist(),
            "visible": [1.0] * 20 + [float(i % 2)],
            "pose_ctgy": cats[i % 4], "image_id": f"im{i}"}
    annos["bad"] = {"coordinates": [[0.5, 0.5]] * 10, "visible": [1] * 10,
                    "pose_ctgy": "Standard", "image_id": "im0"}
    with open(os.path.join(root, "Armo_hand_dataset", "annotations.json"),
              "w") as f:
        json.dump(annos, f)


# ------------------------------------------------------------- readers


@pytest.mark.parametrize("num_our,ratio", [(10, 0.6), (200000, 0.25)])
def test_lighthand_matches_jax(tmp_path, num_our, ratio):
    root = str(tmp_path)
    torch_fixtures.write_lighthand_tree(root, 12, 5)
    # a train2 shard, read only above 150 000 (dataset.py:115-120)
    d2 = tmp_path / "LightHand" / "annotations" / "train2"
    d2.mkdir()
    shutil.copy(tmp_path / "LightHand" / "annotations" / "train"
                / "CISLAB_train_data.json", d2 / "CISLAB_train2_data.json")
    kw = dict(num_our=num_our, ratio_of_aug=ratio, image_size=256)
    got, want = (LightHandDataset(root, "train", **kw),
                 JLight(root, "train", **kw))
    assert len(got) == (10 if num_our == 10 else 24)
    assert_same_source(got, want)
    assert sum(got[i].aug_enabled for i in range(len(got))) > 0
    assert_same_source(LightHandValSet(root), JLightVal(root))


@pytest.mark.parametrize("phase", ["eval", "val"])
def test_armo_matches_jax(tmp_path, phase):
    write_armo_tree(str(tmp_path))
    got = ArmoEvalSet(str(tmp_path), phase=phase)
    want = JArmo(str(tmp_path), phase=phase)
    assert len(got) == 5  # the incomplete record is dropped
    assert_same_source(got, want)
    assert got[0].joints.shape == ((21, 3) if phase == "eval" else (21, 2))


@pytest.mark.parametrize("is_train", [True, False])
def test_freihand_matches_jax(tmp_path, is_train):
    yaml_path = torch_fixtures.write_freihand_tree(str(tmp_path / "frei"), 20)
    got = FreiHandTSVDataset(yaml_path, is_train=is_train)
    want = JFrei(yaml_path, is_train=is_train)
    assert_same_source(got, want)
    order = [7, 3, 19, 0, 3]
    for g, w in zip(got.getitems(order), [want[i] for i in order]):
        assert_same(g, w)
    assert all(s.noise_enabled == is_train for s in got.getitems(range(20)))
    if is_train:  # some rows rotate, so the warp is exercised
        rots = [got._augm_params(np.random.default_rng(got.seed * 2_000_003
                                                       + i))[0]
                for i in range(20)]
        assert any(r != 0 for r in rots)


def test_freihand_composite_and_linelist_match_jax(tmp_path):
    d = tmp_path / "frei"
    torch_fixtures.write_freihand_tree(str(d), 9)
    (d / "train.linelist.tsv").write_text("2\n5\n8\n")
    (d / "lin.yaml").write_text("img: train.img.tsv\nlabel: train.label.tsv"
                                "\nlinelist: train.linelist.tsv\n")
    assert_same_source(FreiHandTSVDataset(str(d / "lin.yaml")),
                       JFrei(str(d / "lin.yaml")))
    (d / "seq.tsv").write_text("0\t4\n0\t1\n")
    (d / "comp.yaml").write_text("composite: true\nimg: [train.img.tsv]\n"
                                 "label: [train.label.tsv]\n"
                                 "hw: [train.hw.tsv]\nlinelist: seq.tsv\n")
    got, want = (FreiHandTSVDataset(str(d / "comp.yaml")),
                 JFrei(str(d / "comp.yaml")))
    assert_same_source(got, want)
    for g, w in zip(got.getitems([1, 0]), [want[1], want[0]]):
        assert_same(g, w)


@pytest.mark.parametrize("phase", ["training", "evaluation"])
def test_rhd_matches_jax(tmp_path, phase):
    write_rhd_tree(str(tmp_path), phase)
    got, want = RHDDataset(str(tmp_path), phase), JRhd(str(tmp_path), phase)
    assert [i for i, _ in got.anno] == [i for i, _ in want.anno] == [0, 3, 4]
    assert_same_source(got, want)


def test_interhand_matches_jax(tmp_path):
    write_interhand_tree(str(tmp_path))
    got = InterHandDataset(str(tmp_path), "train")
    want = JInter(str(tmp_path), "train")
    assert len(got) == 4  # the left hand is dropped
    assert_same_source(got, want)


def test_gan_matches_jax(tmp_path):
    torch_fixtures.write_gan_tree(str(tmp_path), 6)
    got, want = GANeratedDataset(str(tmp_path)), JGan(str(tmp_path))
    assert got.heatmap_style == "max" and len(got) == 6
    assert_same_source(got, want)
    assert got[0].hm_max and np.array_equal(got[0].joints,
                                            np.trunc(got[0].joints))


# ---------------------------------------------------------- TSV engine


def _rows(n):
    rng = np.random.default_rng(0)
    return [[f"k{i}", "x" * int(rng.integers(0, 300)), str(i)]
            for i in range(n)]


def test_tsv_engine_matches_jax(tmp_path):
    path = str(tmp_path / "a.tsv")
    tsv.tsv_writer(_rows(40), path)
    with open(path[:-4] + ".lineidx") as f:
        written = f.read()
    os.remove(path[:-4] + ".lineidx")
    got, want = tsv.TSVFile(path), jtsv.TSVFile(path)
    with open(path[:-4] + ".lineidx") as f:
        assert f.read() == written  # the engine's index = the writer's
    assert len(got) == len(want) == 40
    for i in (0, 17, 39):
        assert got[i] == want[i] and got.get_key(i) == want.get_key(i)
    order = [39, 0, 5, 5, 21]
    assert got.read_rows(order) == want.read_rows(order)
    assert got.read_rows([]) == []
    assert list(tsv.tsv_reader(path)) == list(jtsv.tsv_reader(path))


def test_tsv_concat_hw_and_linelist_match_jax(tmp_path):
    a, b = str(tmp_path / "a.tsv"), str(tmp_path / "b.tsv")
    tsv.tsv_writer(_rows(5), a)
    tsv.tsv_writer(_rows(3), b)
    tsv.concat_tsv_files([a, b], str(tmp_path / "p" / "c.tsv"))
    jtsv.concat_tsv_files([a, b], str(tmp_path / "j" / "c.tsv"))
    for name in ("c.tsv", "c.lineidx"):
        assert ((tmp_path / "p" / name).read_bytes()
                == (tmp_path / "j" / name).read_bytes())
    imgs = str(tmp_path / "img.tsv")
    rows = torch_fixtures.write_freihand_tree(str(tmp_path / "f"), 4)
    shutil.copy(os.path.join(os.path.dirname(rows), "train.img.tsv"), imgs)
    got = tsv.generate_hw_file(imgs, str(tmp_path / "p.hw.tsv"))
    want = jtsv.generate_hw_file(imgs, str(tmp_path / "j.hw.tsv"))
    with open(got) as f1, open(want) as f2:
        assert f1.read() == f2.read()
    labels = str(tmp_path / "lab.tsv")
    tsv.tsv_writer([["a", "[]"], ["b", json.dumps([{"x": 1}])],
                    ["c", json.dumps([{"ig": 1}])]], labels)
    for kw in ({}, {"ignore_attrs": ("ig",)}):
        g = tsv.generate_linelist_file(labels, str(tmp_path / "p.ll"), **kw)
        w = jtsv.generate_linelist_file(labels, str(tmp_path / "j.ll"), **kw)
        with open(g) as f1, open(w) as f2:
            assert f1.read() == f2.read()


def test_b64_and_yaml_match_jax(tmp_path):
    data = bytes(range(256)) * 3
    import base64

    for n in (0, 1, 2, 3, 100, len(data)):
        s = base64.b64encode(data[:n]).decode()
        assert native.b64_decode(s).tobytes() == data[:n]
    with pytest.raises(ValueError):
        native.b64_decode("a$bc")
    with open(JPEGS[0]["path"], "rb") as f:
        s = base64.b64encode(f.read())
    np.testing.assert_array_equal(tsv.img_from_base64(s),
                                  jtsv.img_from_base64(s)[..., ::-1])
    p = tmp_path / "d.yaml"
    p.write_text("img: a.tsv\nlabel: b.tsv\ncomposite: false\nn: 3\n")
    assert tsv.load_from_yaml_file(str(p)) == jtsv.load_from_yaml_file(str(p))
    assert tsv.find_file_path_in_yaml("d.yaml", str(tmp_path)) == str(p)
    with pytest.raises(FileNotFoundError):
        tsv.find_file_path_in_yaml("nope.yaml", str(tmp_path))


def test_tsv_engine_errors_raise(tmp_path):
    with pytest.raises(OSError):
        native.generate_lineidx(str(tmp_path / "missing.tsv"),
                                str(tmp_path / "x.lineidx"))
    with pytest.raises(OSError):
        native.read_rows(str(tmp_path / "missing.tsv"),
                         np.array([0], np.int64), [0])


# --------------------------------------------------------------- cache


class _Counting(Source):
    """Deterministic source that counts base reads."""

    def __init__(self, n=6, meta=False):
        self.n, self.meta, self.reads = n, meta, 0

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        self.reads += 1
        rng = np.random.default_rng(i)
        return Sample(image=rng.integers(0, 256, (8, 8, 3), dtype=np.uint8),
                      joints=rng.normal(size=(21, 2)).astype(np.float32),
                      aug_enabled=i % 2 == 0, noise_enabled=i % 3 == 0,
                      hm_max=i == 1, meta={"i": i} if self.meta else None)


def test_cache_fill_warm_read_and_layout(tmp_path):
    base = _Counting()
    c = cache.maybe_cache(base, str(tmp_path), "tok")
    assert isinstance(c, cache.CachedSource)
    assert c.hit_fraction() == 1 / 6  # the probe row
    got = c.getitems([3, 1, 3])
    assert c.hit_fraction() == 3 / 6
    for i, s in zip([3, 1, 3], got):
        assert_same(s, base[i])
    for i in range(6):
        assert_same(c[i], base[i])
    assert c.hit_fraction() == 1.0
    reads = base.reads
    warm = cache.maybe_cache(base, str(tmp_path), "tok")
    assert warm.cache_dir == c.cache_dir and warm.hit_fraction() == 1.0
    for i in range(6):
        assert_same(warm[i], base[i])
    # only maybe_cache's meta probe and the comparisons read the base
    assert base.reads == reads + 1 + 6
    assert sorted(os.listdir(c.cache_dir)) == [
        "filled.u8", "flags.u8", "images.u8", "joints.f32", "meta.json"]


def test_cache_invalidation(tmp_path):
    anno = tmp_path / "anno.json"
    anno.write_text("[1]")
    c = cache.maybe_cache(_Counting(), str(tmp_path), "t",
                          fingerprint_paths=[str(anno)])
    c.getitems(range(6))
    assert cache.maybe_cache(_Counting(), str(tmp_path), "t",
                             fingerprint_paths=[str(anno)]).cache_dir \
        == c.cache_dir
    os.utime(anno, ns=(1, 1))  # a regenerated tree
    c2 = cache.maybe_cache(_Counting(), str(tmp_path), "t",
                           fingerprint_paths=[str(anno)])
    assert c2.cache_dir != c.cache_dir and c2.hit_fraction() == 1 / 6
    # same directory, other length: the stale rows are dropped
    c3 = cache.CachedSource(_Counting(4), c.cache_dir, "t|x")
    assert len(c3) == 4 and c3.hit_fraction() == 1 / 4
    # a corrupt meta.json invalidates too
    with open(os.path.join(c2.cache_dir, "meta.json"), "w") as f:
        f.write("{")
    c4 = cache.CachedSource(_Counting(), c2.cache_dir, "whatever")
    assert c4.hit_fraction() == 1 / 6


def test_cache_skips_meta_disabled_and_empty(tmp_path):
    src = _Counting(meta=True)
    assert cache.maybe_cache(src, str(tmp_path), "t") is src
    with pytest.raises(ValueError, match="meta"):
        cache.CachedSource(src, str(tmp_path / "c"), "t")
    plain = _Counting()
    assert cache.maybe_cache(plain, str(tmp_path), "t", enabled=False) \
        is plain
    empty = _Counting(0)
    assert cache.maybe_cache(empty, str(tmp_path), "t") is empty


def test_cache_unwritable_returns_the_source(tmp_path, caplog):
    blocker = tmp_path / "root"
    blocker.write_text("a file where the cache directory would go")
    src = _Counting()
    assert cache.maybe_cache(src, str(blocker), "t") is src


def test_port_and_jax_caches_use_separate_directories(tmp_path):
    port = cache.maybe_cache(_Counting(), str(tmp_path), "ours-train|256")
    jax_src = jcache.maybe_cache(_Counting(), str(tmp_path), "ours-train|256")
    assert isinstance(jax_src, jcache.CachedSource)
    assert port.cache_dir != jax_src.cache_dir
    assert os.path.dirname(port.cache_dir) == os.path.dirname(
        jax_src.cache_dir) == str(tmp_path / ".lh_cache")


def test_cached_sources_walks_subsets_and_concats(tmp_path):
    from lighthand_tpu_torch.data.records import ConcatSource

    c = cache.maybe_cache(_Counting(), str(tmp_path), "t")
    tree = ConcatSource(SubsetSource(c, [0, 2]), _Counting())
    assert cache.cached_sources(tree) == [c]
    assert cache.cached_sources(_Counting()) == []
