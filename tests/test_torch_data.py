"""The port's datasets and transforms held to the JAX package's on toy data.

The port's ``data/datasets.py`` and ``data/transforms.py`` are copies of the
JAX modules, with jsonl metadata read by the json module instead of pandas
and the bilinear label resize in torch instead of cv2. Every key of every
item must equal the JAX dataset's (values, dtypes and shapes) in EVAL, TRAIN
(flip augmentation, depth normalizer, far plane, resize) and RGB_ONLY, for
the folder, the tar and the jsonl layouts; the keys the bilinear resize
makes agree within 1e-6 of their largest value (cv2 rounds its two lerps
apart: readings up to two float32 ulps). ``get_dataset`` on every
configs/dataset/eval/*.yaml reads toy data at the split's first paths.
"""

import dataclasses
import io
import json
import tarfile
import types
from pathlib import Path

import numpy as np
import pytest
import yaml
from PIL import Image

import genpercept_tpu.data as jdata
import genpercept_tpu.data.datasets as jds
import genpercept_tpu_torch.data as tdata
import genpercept_tpu_torch.data.datasets as tds

REPO = Path(__file__).resolve().parent.parent
HW = (24, 32)
LINEAR_REL_TOL = 1e-6
MODES = ["EVAL", "TRAIN", "RGB_ONLY"]


def png(arr) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return buf.getvalue()


def jpg(arr) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="JPEG", quality=90)
    return buf.getvalue()


def npy(arr) -> bytes:
    buf = io.BytesIO()
    np.save(buf, arr)
    return buf.getvalue()


def rgb(rng):
    return rng.integers(0, 256, HW + (3,), dtype=np.uint8)


def depth_png(rng, lo=100, hi=9000):
    d = rng.integers(lo, hi, HW).astype(np.uint16)
    d[rng.uniform(size=HW) < 0.1] = 0  # invalid pixels
    return png(d)


def toy_file(rel: str, rng, kind: str) -> bytes:
    """A file for a split path: rgb by extension, depth by dataset."""
    if kind == "rgb":
        return jpg(rgb(rng)) if rel.lower().endswith(".jpg") else png(rgb(rng))
    if kind == "eth3d":
        d = rng.uniform(0.5, 30.0, HW).astype(np.float32)
        d[rng.uniform(size=HW) < 0.1] = np.inf
        return d.tobytes()
    if kind == "diode_depth":
        return npy(rng.uniform(0.5, 50.0, HW + (1,)).astype(np.float32))
    if kind == "diode_mask":
        return npy(rng.uniform(size=HW) > 0.2)
    return depth_png(rng)


def write(files: dict, root: Path, tar: bool) -> Path:
    """``files`` {relative path: bytes} as a folder, or as a tar whose
    members are named ./<path> as the published archives name them."""
    if not tar:
        for rel, data in files.items():
            (root / rel).parent.mkdir(parents=True, exist_ok=True)
            (root / rel).write_bytes(data)
        return root
    path = root.with_suffix(".tar")
    with tarfile.open(path, "w") as tf:
        for rel, data in files.items():
            info = tarfile.TarInfo("./" + rel)
            info.size = len(data)
            tf.addfile(info, io.BytesIO(data))
    return path


def assert_items_equal(ours, ref):
    assert len(ours) == len(ref)
    for i in range(len(ref)):
        a, b = ours[i], ref[i]
        assert sorted(a) == sorted(b), i
        for k, vb in b.items():
            va = a[k]
            if isinstance(vb, np.ndarray):
                assert va.dtype == vb.dtype and va.shape == vb.shape, (i, k)
                if ours.resize_to_hw is not None and ("matting" in k or "dis" in k) \
                        and vb.dtype != bool:
                    tol = LINEAR_REL_TOL * max(float(np.abs(vb).max()), 1.0)
                    assert float(np.abs(va - vb).max()) <= tol, (i, k)
                else:
                    np.testing.assert_array_equal(va, vb, err_msg=f"{i} {k}")
            else:
                assert va == vb, (i, k)


def build(pkg, cls_name, mode, split, data_dir, **kw):
    """The same dataset from one package: its own normalizer, an rng of the
    same seed for the flips."""
    extra = {}
    if mode == "TRAIN":
        extra = dict(depth_transform=pkg.DepthNormalizer(),
                     augmentation_args=types.SimpleNamespace(lr_flip_p=0.5),
                     rng=np.random.default_rng(7))
    return getattr(pkg.datasets, cls_name)(
        mode=getattr(pkg.DatasetMode, mode), filename_ls_path=str(split),
        dataset_dir=str(data_dir), **extra, **kw)


@pytest.fixture(scope="module")
def nyu_toy(tmp_path_factory):
    """NYU lines (rgb, depth, filled) in a folder and in a tar."""
    root = tmp_path_factory.mktemp("nyu")
    rng = np.random.default_rng(0)
    lines, files = [], {}
    for i in range(4):
        names = [f"scene_{i % 2}/rgb_{i:04d}.png", f"scene_{i % 2}/depth_{i:04d}.png",
                 f"scene_{i % 2}/filled_{i:04d}.png"]
        files[names[0]] = toy_file(names[0], rng, "rgb")
        files[names[1]], files[names[2]] = depth_png(rng), depth_png(rng, lo=1)
        lines.append(" ".join(names))
    (root / "split.txt").write_text("\n".join(lines) + "\n")
    return (root / "split.txt", write(files, root / "folder", False),
            write(files, root / "archive", True))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("layout", ["folder", "tar"])
@pytest.mark.parametrize("resize", [None, (16, 20)])
def test_txt_layouts_match_jax(nyu_toy, mode, layout, resize):
    split, folder, archive = nyu_toy
    data_dir = folder if layout == "folder" else archive
    kw = dict(eigen_valid_mask=True, resize_to_hw=resize)
    assert_items_equal(build(tdata, "NYUDataset", mode, split, data_dir, **kw),
                       build(jdata, "NYUDataset", mode, split, data_dir, **kw))


@pytest.fixture(scope="module")
def jsonl_toy(tmp_path_factory):
    """A diffusers-style metadata directory (two .jsonl files and one that is
    not) over images with every task's label; some rows lack some labels."""
    root = tmp_path_factory.mktemp("jsonl")
    rng = np.random.default_rng(1)
    files, rows = {}, []
    for i in range(5):
        row = {"image": f"img/rgb_{i}.png", "text": ""}
        files[row["image"]] = toy_file(row["image"], rng, "rgb")
        for task in ("depth", "normal", "matting", "dis", "seg"):
            if (i + len(task)) % 4 == 0:
                continue  # this row lacks that label
            rel = f"{task}/{task}_{i}.png"
            row[f"{task}_conditioning_image"] = rel
            files[rel] = depth_png(rng) if task == "depth" else png(rgb(rng))
        rows.append(row)
    meta = root / "meta"
    meta.mkdir()
    (meta / "a.jsonl").write_text("".join(json.dumps(r) + "\n" for r in rows[:3]))
    (meta / "b.jsonl").write_text("\n".join(json.dumps(r) for r in rows[3:]) + "\n\n")
    (meta / "notes.txt").write_text("not metadata")
    return meta, write(files, root / "data", False)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("resize", [None, (16, 20)])
def test_jsonl_layout_matches_jax(jsonl_toy, mode, resize):
    meta, data_dir = jsonl_toy
    ours = build(tdata, "P3M10KDataset", mode, meta, data_dir, resize_to_hw=resize)
    ref = build(jdata, "P3M10KDataset", mode, meta, data_dir, resize_to_hw=resize)
    assert ours.filenames == ref.filenames and len(ours) == 5
    assert_items_equal(ours, ref)


EVAL_YAMLS = sorted(p.name for p in (REPO / "configs" / "dataset" / "eval").glob("*.yaml"))
DEPTH_KIND = {"eth3d": "eth3d"}


@pytest.mark.parametrize("mode", ["EVAL", "RGB_ONLY"])
@pytest.mark.parametrize("name", EVAL_YAMLS)
def test_get_dataset_on_every_eval_config(tmp_path, monkeypatch, name, mode):
    """Each eval yaml's dataset at its split's first two lines, written as a
    toy tar at the yaml's ``dir`` (ETH3D's raw depth at the toy size)."""
    cfg = yaml.safe_load((REPO / "configs" / "dataset" / "eval" / name).read_text())["dataset"]
    lines = (REPO / cfg["filenames"]).read_text().split("\n")[:2]
    rng = np.random.default_rng(len(name))
    files = {}
    for line in lines:
        parts = line.split()
        files[parts[0]] = toy_file(parts[0], rng, "rgb")
        if cfg["name"] == "diode":
            files[parts[1]] = toy_file(parts[1], rng, "diode_depth")
            files[parts[2]] = toy_file(parts[2], rng, "diode_mask")
        else:
            files[parts[1]] = toy_file(parts[1], rng, DEPTH_KIND.get(cfg["name"], "png"))
        if cfg["name"] == "nyu_v2":  # the filled depth
            files[parts[2]] = toy_file(parts[2], rng, "png")
    archive = tmp_path / cfg["dir"]
    archive.parent.mkdir(parents=True)
    write(files, archive.with_suffix(""), True)
    split = tmp_path / "split.txt"
    split.write_text("\n".join(lines) + "\n")
    for cls in (jds.ETH3DDataset, tds.ETH3DDataset):
        monkeypatch.setattr(cls, "HEIGHT", HW[0])
        monkeypatch.setattr(cls, "WIDTH", HW[1])
    cfg = dict(cfg, filenames=str(split))
    ours = tdata.get_dataset(cfg, str(tmp_path), getattr(tdata.DatasetMode, mode))
    ref = jdata.get_dataset(cfg, str(tmp_path), getattr(jdata.DatasetMode, mode))
    assert type(ours).__name__ == type(ref).__name__
    assert ours.name_mode.name == ref.name_mode.name and len(ours) == len(ref) == 2
    assert_items_equal(ours, ref)


def test_get_dataset_mixed_returns_each(nyu_toy):
    split, folder, _ = nyu_toy
    cfg = {"name": "mixed", "dataset_list": [
        {"name": "nyu_v2", "dir": str(folder), "filenames": str(split)},
        {"name": "scannet", "dir": str(folder), "filenames": str(split)}]}
    ours = tdata.get_dataset(cfg, "", tdata.DatasetMode.EVAL)
    ref = jdata.get_dataset(cfg, "", jdata.DatasetMode.EVAL)
    assert [type(d).__name__ for d in ours] == [type(d).__name__ for d in ref] == \
        ["NYUDataset", "ScanNetDataset"]
    for a, b in zip(ours, ref):
        assert_items_equal(a, b)


@pytest.mark.parametrize("name_mode", list(jds.PredNameMode))
@pytest.mark.parametrize("suffix", [".png", ".npy"])
def test_get_pred_name_matches_jax(name_mode, suffix):
    ours_mode = tds.PredNameMode[name_mode.name]
    for base in ("rgb_0001.png", "0001_rgb.png", "rgb_a_b.jpg", "0000000069.png", "x_y_z.JPG"):
        try:
            ref = jds.get_pred_name(base, name_mode, suffix)
        except IndexError:  # rgb_id needs an underscore, in both packages
            with pytest.raises(IndexError):
                tds.get_pred_name(base, ours_mode, suffix)
            continue
        assert tds.get_pred_name(base, ours_mode, suffix) == ref
    assert [m.value for m in tds.PredNameMode] == [m.value for m in jds.PredNameMode]


def test_registry_and_class_constants_match_jax():
    assert tdata.DATASET_REGISTRY.keys() == jdata.DATASET_REGISTRY.keys()
    for key, cls in jdata.DATASET_REGISTRY.items():
        ours = tdata.DATASET_REGISTRY[key]
        assert ours.__name__ == cls.__name__
        for attr in ("min_depth", "max_depth", "has_filled_depth", "INTRINSIC", "NATIVE_HW"):
            assert getattr(ours, attr) == getattr(cls, attr), (key, attr)
        assert ours.name_mode.name == cls.name_mode.name


@pytest.mark.parametrize("kind", ["scale_shift_depth", "scale_shift_disparity"])
def test_transforms_match_jax(kind):
    from genpercept_tpu.data import transforms as jt
    from genpercept_tpu_torch.data import transforms as tt

    rng = np.random.default_rng(3)
    depth = rng.uniform(0.1, 20.0, (40, 50)).astype(np.float32)
    depth[rng.uniform(size=depth.shape) < 0.2] = 0.0
    valid = rng.uniform(size=depth.shape) > 0.1
    for clip in (True, False):
        a = tt.DepthNormalizer(kind=kind, clip=clip)(depth, valid)
        b = jt.DepthNormalizer(kind=kind, clip=clip)(depth, valid)
        np.testing.assert_array_equal(a, b)
    from genpercept_tpu_torch.utils.config import Config

    cfg = Config(type=kind, norm_min=-0.5, norm_max=2.0, min_max_quantile=0.05, clip=False)
    assert dataclasses.asdict(tt.get_depth_normalizer(cfg)) == \
        dataclasses.asdict(jt.get_depth_normalizer(cfg))
    n = rng.normal(size=(8, 9, 3)).astype(np.float32)
    np.testing.assert_array_equal(tt.normalize_normals(n), jt.normalize_normals(n))
    np.testing.assert_array_equal(tt.min_max_to_pm1(depth), jt.min_max_to_pm1(depth))


@pytest.mark.parametrize("shape,out_hw", [((24, 32, 3), (16, 20)), ((24, 32), (50, 70)),
                                          ((24, 32, 1), (7, 9)), ((480, 640, 3), (352, 1216))])
def test_bilinear_np_matches_cv2(shape, out_hw):
    import cv2

    x = np.random.default_rng(4).uniform(0, 255, shape).astype(np.float32)
    ref = cv2.resize(x, (out_hw[1], out_hw[0]), interpolation=cv2.INTER_LINEAR)
    ours = tds._bilinear_np(x, out_hw)
    assert ours.shape == ref.shape and ours.dtype == np.float32
    assert float(np.abs(ours - ref).max()) <= LINEAR_REL_TOL * 255.0
