"""The port's dataset inference CLI held to the JAX CLI.

Both CLIs read the same tiny published-layout checkpoint
(tests/test_torch_checkpoint.py's) and the same toy NYU-layout dataset: the
first three paths of data_split/nyu/labeled/filename_list_test.txt as
synthetic PNGs in a tar, read through a copy of configs/dataset/eval/nyu.yaml
pointed at the tar and the split. The port runs with ``--device cpu``. Same
file tree (the scene directories kept, NYU's pred_<id>.npy names); each npy
within the port pipeline tests' bar (mean abs deviation <= 1e-4) of JAX's
and equal to the port pipeline's own output on the dataset's decoded rgb.
``--prompt`` runs a tiny CLIP text tower with a toy vocabulary in both.
"""

import io
import os
import tarfile
import types
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from genpercept_tpu.cli import infer as jax_infer
from genpercept_tpu.models import clip_text as j_clip
from genpercept_tpu.models.clip_text import CLIPTextConfig as JCLIPConfig
from genpercept_tpu.models.clip_text import init_clip_text
from genpercept_tpu_torch.cli import infer
from genpercept_tpu_torch.data import DatasetMode, get_dataset, get_pred_name
from genpercept_tpu_torch.io.checkpoints import load_genpercept_checkpoint
from genpercept_tpu_torch.pipeline import GenPerceptPipeline, PipelineConfig
from test_torch_checkpoint import ckpts, write_part  # noqa: F401  (module-scoped fixture)
from test_torch_models import numpy_params
from test_torch_pipeline import MEAN_TOL
from test_torch_tokenizer import toy_vocab, write_tokenizer

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
N_IMAGES = 3
RES = 64
TINY_CLIP = dict(vocab_size=49408, hidden_size=48, num_layers=1, num_heads=16,
                 intermediate_size=96)


def nyu_layout(root: Path, hw=(48, 64)) -> Path:
    """The tar and the dataset yaml of a toy NYU test set: the split's first
    N_IMAGES lines, rgb / depth / filled PNGs at their relative paths."""
    cfg = yaml.safe_load((REPO / "configs/dataset/eval/nyu.yaml").read_text())
    lines = (REPO / cfg["dataset"]["filenames"]).read_text().splitlines()[:N_IMAGES]
    rng = np.random.default_rng(11)
    tar_path = root / cfg["dataset"]["dir"]
    tar_path.parent.mkdir(parents=True)
    with tarfile.open(tar_path, "w") as tf:
        for line in lines:
            for k, rel in enumerate(line.split()):
                arr = (rng.integers(0, 256, hw + (3,), dtype=np.uint8) if k == 0
                       else rng.integers(1, 9000, hw).astype(np.uint16))
                buf = io.BytesIO()
                Image.fromarray(arr).save(buf, format="PNG")
                info = tarfile.TarInfo("./" + rel)
                info.size = len(buf.getvalue())
                tf.addfile(info, io.BytesIO(buf.getvalue()))
    (root / "split.txt").write_text("\n".join(lines) + "\n")
    cfg["dataset"].update(dir=str(tar_path.relative_to(root)), filenames=str(root / "split.txt"))
    (root / "nyu.yaml").write_text(yaml.safe_dump(cfg))
    return root / "nyu.yaml"


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("data")
    return root, nyu_layout(root)


def argv(ckpt, data, out, *extra):
    root, cfg = data
    return ["--checkpoint", str(ckpt), "--dataset_config", str(cfg), "--base_data_dir",
            str(root), "--output_dir", str(out), "--processing_res", str(RES), *extra]


def files(root: Path) -> list:
    return sorted(str(p.relative_to(root)) for p in root.rglob("*") if p.is_file())


def expected_files(data) -> list:
    ds = get_dataset(yaml.safe_load(data[1].read_text())["dataset"], str(data[0]),
                     DatasetMode.RGB_ONLY)
    return sorted(os.path.join(os.path.dirname(line[0]),
                               get_pred_name(os.path.basename(line[0]), ds.name_mode, ".npy"))
                  for line in ds.filenames)


def assert_matches(ours: Path, ref: Path, data):
    assert files(ours) == files(ref) == expected_files(data)
    for f in files(ref):
        a, b = np.load(ours / f), np.load(ref / f)
        assert a.shape == b.shape == (48, 64) and a.dtype == b.dtype == np.float32
        assert float(np.mean(np.abs(a - b))) <= MEAN_TOL, f


@pytest.fixture(scope="module")
def jax_out(ckpts, data, tmp_path_factory):  # noqa: F811
    out = tmp_path_factory.mktemp("jax_out")
    jax_infer.main(argv(ckpts["plain"][0], data, out))
    return out


def test_infer_cli_matches_jax(ckpts, data, jax_out, tmp_path):  # noqa: F811
    infer.main(argv(ckpts["plain"][0], data, tmp_path, "--device", "cpu"))
    assert_matches(tmp_path, jax_out, data)


def test_infer_cli_npy_is_the_pipelines(ckpts, data, tmp_path):  # noqa: F811
    """chip_smoke.py's check on the card, here: each npy equals the port
    pipeline's output on the dataset's decoded rgb (0.0)."""
    infer.main(argv(ckpts["plain"][0], data, tmp_path, "--device", "cpu"))
    pipe = GenPerceptPipeline(load_genpercept_checkpoint(str(ckpts["plain"][0]), device="cpu"),
                              PipelineConfig(processing_res=RES), device="cpu")
    ds = get_dataset(yaml.safe_load(data[1].read_text())["dataset"], str(data[0]),
                     DatasetMode.RGB_ONLY)
    for i, rel in enumerate(expected_files(data)):
        rgb = ((ds[i]["rgb_norm"] + 1.0) / 2.0 * 255).astype(np.uint8)
        np.testing.assert_array_equal(np.load(tmp_path / rel), pipe(rgb, color_map=None).pred_np)


def test_infer_cli_prompt_matches_jax(ckpts, data, tmp_path, monkeypatch):  # noqa: F811
    """--prompt: the checkpoint's text encoder (a tiny CLIP at the UNet's
    context width) and tokenizer/ encode it in both CLIPs."""
    from genpercept_tpu_torch.io import checkpoints as tck
    from genpercept_tpu_torch.models.clip_text import CLIPTextConfig, CLIPTextModel

    plain = ckpts["plain"][0]
    ckpt = tmp_path / "ckpt"
    ckpt.mkdir()
    for sub in ("unet", "vae", "empty_text_embed.npy"):
        os.symlink(plain / sub, ckpt / sub)
    write_part(ckpt / "text_encoder", numpy_params(init_clip_text, JCLIPConfig(**TINY_CLIP),
                                                   seed=12),
               name="model.safetensors", prefix="text_model.")
    write_tokenizer(ckpt, *toy_vocab())
    # both loaders build SD2.1's text tower; the tiny one stands in for it
    monkeypatch.setattr(tck, "CLIPTextModel", lambda: CLIPTextModel(CLIPTextConfig(**TINY_CLIP)))
    monkeypatch.setattr(j_clip, "SD21_CLIP_TEXT", JCLIPConfig(**TINY_CLIP))
    extra = ["--prompt", "the depth of a room"]
    jax_infer.main(argv(ckpt, data, tmp_path / "jax", *extra))
    infer.main(argv(ckpt, data, tmp_path / "ours", *extra, "--device", "cpu"))
    assert_matches(tmp_path / "ours", tmp_path / "jax", data)
    # the prompt reached the UNet: another embedding than the empty prompt's
    infer.main(argv(ckpt, data, tmp_path / "empty", "--device", "cpu"))
    f = expected_files(data)[0]
    assert float(np.abs(np.load(tmp_path / "ours" / f) - np.load(tmp_path / "empty" / f)).max()) \
        > 1e-4


def test_infer_cli_refuses_a_full_output_dir(ckpts, data, tmp_path, monkeypatch):  # noqa: F811
    """Headless (no TTY) it refuses a non-empty output dir unless
    --overwrite; on a TTY it asks and exits on 'n', as JAX's does."""
    (tmp_path / "old.npy").write_bytes(b"x")
    ref_args = argv(ckpts["plain"][0], data, tmp_path)
    args = ref_args + ["--device", "cpu"]
    monkeypatch.setattr("sys.stdin", types.SimpleNamespace(isatty=lambda: False))
    for main, a in ((infer.main, args), (jax_infer.main, ref_args)):
        with pytest.raises(SystemExit, match="--overwrite"):
            main(a)
    answers = iter(["maybe", "n"])
    monkeypatch.setattr("sys.stdin", types.SimpleNamespace(isatty=lambda: True))
    monkeypatch.setattr("builtins.input", lambda _: next(answers))
    with pytest.raises(SystemExit, match="Exiting"):
        infer.main(args)
    assert files(tmp_path) == ["old.npy"]
    infer.main(args + ["--overwrite"])
    assert files(tmp_path) == sorted(["old.npy"] + expected_files(data))


def test_infer_cli_flags_mirror_jax_and_default_to_the_card(ckpts, data, tmp_path,  # noqa: F811
                                                            monkeypatch):
    ours = {a.dest: a.default for a in infer.build_parser()._actions}
    ref = {a.dest: a.default for a in jax_infer.build_parser()._actions}
    assert set(ours) == set(ref) | {"device"} and ours["device"] == "cuda"
    assert {k: ours[k] for k in ref} == ref
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device"):
        infer.main(argv(ckpts["plain"][0], data, tmp_path / "out"))
    assert not (tmp_path / "out").exists()
