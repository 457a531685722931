"""The port's folder CLI held to the JAX CLI on tiny checkpoints.

Both CLIs read the same published-layout checkpoints (the plain and the
DPT-identity layouts of tests/test_torch_checkpoint.py, written by the JAX
side) and the same folder of PNGs, the port with ``--device cpu``. Per mode
(depth, normal, seg, disparity_dpt_head): the same files; each npy within
the port pipeline tests' bar (mean abs deviation <= 1e-4,
tests/test_torch_pipeline.py); each PNG the truncation of its own npy, so
two PNGs differ by at most 1 LSB, and only where the two npy values
straddle a rounding step; colored PNGs within 1 (uint8 truncation).
"""

import os
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

import chip_smoke
from genpercept_tpu.cli import run as jax_run
from genpercept_tpu_torch.cli import run as torch_run
from genpercept_tpu_torch.io.checkpoints import load_genpercept_checkpoint
from genpercept_tpu_torch.pipeline import GenPerceptPipeline, PipelineConfig
from test_torch_checkpoint import ckpts  # noqa: F401  (module-scoped fixture)

torch.set_num_threads(1)

MEAN_TOL = 1e-4
MODES = ["depth", "normal", "seg", "disparity_dpt_head"]


@pytest.fixture(scope="module")
def image_dir(tmp_path_factory):
    """Two square images (both processed at 64x64, so each JAX CLI compiles
    one shape, and the DPT head's four levels halve exactly), one of them
    in a subfolder."""
    root = tmp_path_factory.mktemp("images")
    (root / "sub").mkdir()
    rng = np.random.default_rng(41)
    for path, hw in ((root / "a.png", (64, 64)), (root / "sub" / "b.png", (32, 32))):
        Image.fromarray((rng.uniform(size=hw + (3,)) * 255).astype(np.uint8)).save(path)
    return root


def ckpt_for(ckpts, mode):  # noqa: F811
    return str(ckpts["dpt_identity" if mode == "disparity_dpt_head" else "plain"][0])


def argv(ckpts, image_dir, out_dir, mode, *extra):  # noqa: F811
    return ["--checkpoint", ckpt_for(ckpts, mode), "--input_rgb_dir", str(image_dir),
            "--output_dir", str(out_dir), "--mode", mode, "--processing_res", "64", *extra]


@pytest.fixture(scope="module")
def jax_outputs(ckpts, image_dir, tmp_path_factory):  # noqa: F811
    """One JAX CLI run per mode."""
    outs = {}
    for mode in MODES:
        out = tmp_path_factory.mktemp(f"jax_{mode}")
        jax_run.main(argv(ckpts, image_dir, out, mode))
        outs[mode] = out
    return outs


def files(root: Path) -> list:
    return sorted(str(p.relative_to(root)) for p in root.rglob("*") if p.is_file())


def read_png(path: Path) -> np.ndarray:
    with Image.open(path) as im:
        return np.asarray(im)


def assert_outputs_match(ours: Path, ref: Path, mode: str):
    assert files(ours) == files(ref)
    scale, dt = (65535.0, np.uint16) if mode == "depth" else (255.0, np.uint8)
    npys = [f for f in files(ref) if f.endswith("_pred.npy")]
    assert len(npys) == 2
    for f in npys:
        a, b = np.load(ours / f), np.load(ref / f)
        assert a.shape == b.shape and a.dtype == b.dtype == np.float32
        assert float(np.mean(np.abs(a - b))) <= MEAN_TOL, f
        png = f.replace(".npy", ".png")
        pa, pb = read_png(ours / png).astype(dt), read_png(ref / png).astype(dt)
        np.testing.assert_array_equal(pa, (a * scale).astype(dt))
        np.testing.assert_array_equal(pb, (b * scale).astype(dt))
        assert int(np.abs(pa.astype(np.int64) - pb).max()) <= 1, png
        colored = f.replace(".npy", "_colored.png")
        if (ref / colored).exists():
            ca, cb = read_png(ours / colored), read_png(ref / colored)
            assert int(np.abs(ca.astype(int) - cb).max()) <= 1, colored


@pytest.mark.parametrize("mode", MODES)
def test_cli_matches_jax(ckpts, image_dir, jax_outputs, tmp_path, mode):  # noqa: F811
    torch_run.main(argv(ckpts, image_dir, tmp_path, mode, "--device", "cpu"))
    assert_outputs_match(tmp_path, jax_outputs[mode], mode)
    expect = {"a_pred.npy", "a_pred.png", "sub/b_pred.npy", "sub/b_pred.png"}
    if mode in ("depth", "disparity_dpt_head"):
        expect |= {"a_pred_colored.png", "sub/b_pred_colored.png"}
    assert set(files(tmp_path)) == expect


@pytest.mark.parametrize("batch_size", ["-1", "2"])
def test_cli_batched_matches_jax(ckpts, image_dir, jax_outputs, tmp_path, batch_size):  # noqa: F811
    """--batch_size -1 (the H100 table's size) and 2: one batch of both
    images, the same outputs as the JAX CLI's single-image loop."""
    torch_run.main(argv(ckpts, image_dir, tmp_path, "depth", "--device", "cpu",
                        "--batch_size", batch_size))
    assert_outputs_match(tmp_path, jax_outputs["depth"], "depth")


@pytest.mark.parametrize("mode", ["depth", "disparity_dpt_head"])
def test_cli_outputs_are_the_pipelines(ckpts, image_dir, tmp_path, mode):  # noqa: F811
    """chip_smoke's check on the card, here: every file, each npy equal to
    the pipeline's own output on the decoded image."""
    torch_run.main(argv(ckpts, image_dir, tmp_path, mode, "--device", "cpu"))
    paths = [image_dir / "a.png", image_dir / "sub" / "b.png"]
    models = load_genpercept_checkpoint(ckpt_for(ckpts, mode), device="cpu")
    pipe = GenPerceptPipeline(models, PipelineConfig(mode=mode, processing_res=64),
                              device="cpu")
    direct = [pipe(read_png(p)[..., :3]) for p in paths]
    outs = [tmp_path, tmp_path / "sub"]
    for path, out_dir, d in zip(paths, outs, direct):
        assert chip_smoke.check_cli_outputs([path], out_dir, mode, [d]) == 0.0


@pytest.mark.parametrize("extra", [["--data_parallel", "--batch_size", "2"]])
def test_cli_refuses_unported(ckpts, image_dir, tmp_path, extra):  # noqa: F811
    """--data_parallel runs: over the one CPU device each npy equals the run
    without it (0.0); without batched mode it is refused, as in the JAX
    package."""
    torch_run.main(argv(ckpts, image_dir, tmp_path / "dp", "depth", "--device", "cpu", *extra))
    torch_run.main(argv(ckpts, image_dir, tmp_path / "one", "depth", "--device", "cpu",
                        *extra[1:]))
    for rel in ("a_pred.npy", "sub/b_pred.npy"):
        np.testing.assert_array_equal(np.load(tmp_path / "dp" / rel),
                                      np.load(tmp_path / "one" / rel))
    with pytest.raises(ValueError, match="batched mode"):
        torch_run.main(argv(ckpts, image_dir, tmp_path / "no", "depth", "--device", "cpu",
                            "--data_parallel"))


class _Stop(Exception):
    pass


@pytest.mark.parametrize("extra,expect", [
    (["--archs", "marigold", "--denoise_steps", "4", "--ensemble_size", "3"],
     dict(arch="marigold", denoising_steps=4, ensemble_size=3, fix_timesteps=None)),
    (["--fix_timesteps", "5", "--denoise_steps", "4", "--ensemble_size", "3"],
     dict(arch="genpercept", denoising_steps=1, ensemble_size=1, fix_timesteps=5)),
])
def test_cli_passes_the_ddim_flags(ckpts, image_dir, tmp_path, monkeypatch, extra,  # noqa: F811
                                   expect):
    """--archs, --denoise_steps, --ensemble_size and --fix_timesteps reach
    the pipeline's config as in the JAX CLI, which forces one step and no
    ensemble on the genpercept arch only (tests/test_torch_marigold.py runs
    them end to end)."""
    import genpercept_tpu_torch.pipeline as tpipeline

    def capture(models, cfg, device):
        raise _Stop(cfg)

    monkeypatch.setattr(tpipeline, "GenPerceptPipeline", capture)
    with pytest.raises(_Stop) as stop:
        torch_run.main(argv(ckpts, image_dir, tmp_path, "depth", "--device", "cpu", *extra))
    cfg = stop.value.args[0]
    assert {k: getattr(cfg, k) for k in expect} == expect


def test_cli_flags_mirror_jax_and_default_to_the_card(ckpts, image_dir, tmp_path,  # noqa: F811
                                                       monkeypatch):
    ours = {a.dest for a in torch_run.build_parser()._actions}
    ref = {a.dest for a in jax_run.build_parser()._actions}
    assert ours == ref | {"device"}
    assert torch_run.build_parser().get_default("device") == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device"):
        torch_run.main(argv(ckpts, image_dir, tmp_path, "depth"))
    assert not os.listdir(tmp_path)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32", "torch.bfloat16"])
def test_find_batch_size_reads_its_table_as_jax_reads_its_own(dtype, monkeypatch):
    """The same lookup as genpercept_tpu/utils/batchsize.py over the H100
    table: the smallest measured resolution at or above the input, 1 past
    the table, capped by an ensemble."""
    from genpercept_tpu.utils import batchsize as jb
    from genpercept_tpu_torch.utils import batchsize as tb

    monkeypatch.setattr(jb, "_V5E_TABLE", tb._H100_TABLE)
    for res in (64, 512, 513, 768, 1000, 1024, 1536, 1537, 4096):
        for ens in (1, 3, 100):
            assert tb.find_batch_size(ens, res, dtype) == \
                jb.find_batch_size(ens, res, dtype.replace("torch.", "")), (res, ens)
    assert tb.find_batch_size(1, 768, dtype) == tb._H100_TABLE[dtype.replace("torch.", "")][768]
