"""The port's training CLI held to the JAX package's.

Both ``cli.train.main`` read one tiny genpercept depth recipe (the
customized pixel losses mse/ssi/grad, bf16 first moments, an effective
batch of 4 as 2 micro-batches of 2, validation at step 2, a fixed timestep:
the two frameworks draw timesteps from different generators) over the same
toy NYU training and validation files (64x64 PNGs from a numpy seed, the
folder layout, no eigen crop) and the tiny published-layout checkpoint of
tests/test_torch_checkpoint.py, with ``--data_parallel 1``: two steps, then
``--resume_run final`` to three. The port runs with ``--device cpu``.
Tolerances are stated beside each test.
"""

import os
import tarfile

import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from genpercept_tpu.cli import train as jax_train
from genpercept_tpu.io.checkpoints import load_genpercept_checkpoint as jax_load
from genpercept_tpu.io.checkpoints import load_train_checkpoint as jax_load_state
from genpercept_tpu.models import clip_text as j_clip
from genpercept_tpu.models.clip_text import CLIPTextConfig as JCLIPConfig
from genpercept_tpu.models.clip_text import init_clip_text
from genpercept_tpu.utils.config import Config as JConfig
from genpercept_tpu_torch.cli import train as port_train
from genpercept_tpu_torch.io import state_dict_from_jax
from genpercept_tpu_torch.io import checkpoints as tck
from genpercept_tpu_torch.io.checkpoints import load_genpercept_checkpoint, load_train_checkpoint
from genpercept_tpu_torch.utils.config import Config
from test_torch_checkpoint import ckpts, write_part  # noqa: F401  (module-scoped fixture)
from test_torch_infer_cli import TINY_CLIP
from test_torch_models import numpy_params
from test_torch_tokenizer import toy_vocab, write_tokenizer

torch.set_num_threads(1)

HW = 64
LOSS_RTOL = 1e-5  # tests/test_torch_train.py's f32 loss bar
LR = 1e-4
# The parameters after the run. Adam moves a parameter by ~LR whatever its
# gradient's size, so one whose gradient is rounding noise in both
# frameworks (the resnets' time_emb_proj at a fixed timestep, first moments
# ~1e-24) moves either way: every parameter is held to 2.5 LR absolute
# (reading 0.77 LR over two real updates). The others' update (final -
# initial) is held to 8e-3 global relative L2: the first moments are bf16,
# and a gradient that differs in its 6th digit can round mu to the
# neighbouring bf16 value, 2^-8 = 3.9e-3 of it (tests/test_torch_train.py
# holds bf16 moments to 8e-3); reading 3.9e-3, over the parameters whose
# first moment is at least 1e-6 of the largest.
UPDATE_RTOL = 8e-3


def write_nyu(root, n, seed, name):
    """n rgb / depth (mm) / filled PNGs and their split file."""
    rng = np.random.default_rng(seed)
    d = root / "nyu"
    d.mkdir(parents=True, exist_ok=True)
    lines = []
    for i in range(n):
        stem = f"{name}_{i}"
        Image.fromarray(rng.integers(0, 256, (HW, HW, 3), dtype=np.uint8)).save(
            d / f"rgb_{stem}.png")
        depth = rng.integers(500, 9000, (HW, HW)).astype(np.uint16)
        depth[:8, :12] = 0  # an invalid block
        Image.fromarray(depth).save(d / f"depth_{stem}.png")
        lines.append(f"rgb_{stem}.png depth_{stem}.png depth_{stem}.png")
    (root / f"{name}.txt").write_text("\n".join(lines) + "\n")
    return str(root / f"{name}.txt")


def recipe(root, train_list, val_list, max_iter, **over) -> str:
    cfg = {
        "mode": "depth",
        "pipeline": {"name": "GenPerceptPipeline", "kwargs": {"mode": "depth"}},
        "depth_normalization": {"type": "scale_shift_depth", "clip": True, "norm_min": -1.0,
                                "norm_max": 1.0, "min_max_quantile": 0.02},
        "augmentation": {"lr_flip_p": 0.5},
        "dataloader": {"effective_batch_size": 4, "max_train_batch_size": 2, "seed": 2024},
        "dataset": {"train": {"name": "nyu_v2", "dir": "nyu", "filenames": train_list,
                              "eigen_valid_mask": False},
                    "val": [{"name": "nyu_v2", "dir": "nyu", "filenames": val_list,
                             "eigen_valid_mask": False}]},
        "trainer": {"init_seed": 2024, "save_period": 0, "validation_period": 2,
                    "visualization_period": 0},
        "max_iter": max_iter,
        "loss": {"customized_loss": True,
                 "name": ["mse_loss", "least_square_ssi_loss", "grad_loss"]},
        "lr": LR,
        "lr_scheduler": {"name": "IterExponential",
                         "kwargs": {"total_iter_length": 100, "final_ratio": 0.01,
                                    "warmup_steps": 1}},
        "model": {"remat_unet": False, "fix_timesteps": 1},
        "optimizer": {"name": "Adam", "mu_dtype": "bf16"},
    }
    for k, v in over.items():
        if v is None:
            cfg.pop(k)
        else:
            cfg[k] = v
    path = root / f"recipe_{max_iter}_{len(over)}.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("train_data")
    train_list = write_nyu(root, 6, 70, "train")
    val_list = write_nyu(root, 2, 71, "val")
    return root, train_list, val_list


def argv(cfg, ckpt, data, out, *extra):
    return ["--config", cfg, "--checkpoint", str(ckpt), "--base_data_dir", str(data[0]),
            "--output_dir", str(out), "--data_parallel", "1", *extra]


def run_both_steps(main, ckpt, data, out, *extra):
    """Two steps, then a resume from the final checkpoint to three."""
    root, train_list, val_list = data
    main(argv(recipe(root, train_list, val_list, 2), ckpt, data, out, *extra))
    main(argv(recipe(root, train_list, val_list, 3), ckpt, data, out, "--resume_run", "final",
              *extra))


@pytest.fixture(scope="module")
def runs(ckpts, data, tmp_path_factory):  # noqa: F811
    out = tmp_path_factory.mktemp("runs")
    ckpt = ckpts["plain"][0]
    run_both_steps(jax_train.main, ckpt, data, out / "jax")
    run_both_steps(port_train.main, ckpt, data, out / "port", "--device", "cpu")
    return out


def metrics(run_dir) -> dict:
    """{tag: [(step, value), ...]} from metrics.jsonl."""
    out = {}
    for line in (run_dir / "metrics.jsonl").read_text().splitlines():
        rec = yaml.safe_load(line)
        for k, v in rec.items():
            if k not in ("t", "step"):
                out.setdefault(k, []).append((rec["step"], v))
    return out


def test_train_cli_writes_the_run_directory(runs):
    """config.yaml parses equal to JAX's; the code snapshot holds the port's
    package under its name; metrics.jsonl, logging.log and the final
    checkpoint are there."""
    jax_dir, port_dir = runs / "jax", runs / "port"
    assert yaml.safe_load((port_dir / "config.yaml").read_text()) \
        == yaml.safe_load((jax_dir / "config.yaml").read_text())
    with tarfile.open(port_dir / "code_snapshot.tar.gz") as tar:
        names = tar.getnames()
    assert "genpercept_tpu_torch/cli/train.py" in names
    assert not any(n.startswith("genpercept_tpu/") for n in names)
    for f in ("metrics.jsonl", "logging.log", "checkpoint/final/state.pt"):
        assert (port_dir / f).is_file(), f
    assert "resumed at iter 2" in (port_dir / "logging.log").read_text()


def test_train_cli_losses_and_validation_match_jax(runs):
    """train/loss and each loss at steps 1-3 within LOSS_RTOL (steps 1 and
    2 on the initial weights: the warmup's lr is 0 at count 0; step 3 after
    a resume from final); val/nyu_v2/* at step 2 within 1e-3 (predictions
    within the pipeline bar, lstsq-aligned)."""
    ours, ref = metrics(runs / "port"), metrics(runs / "jax")
    assert set(ours) == set(ref)
    for tag in ("train/loss", "train/mse", "train/ssi", "train/grad"):
        assert [s for s, _ in ours[tag]] == [s for s, _ in ref[tag]] == [1, 2, 3], tag
        np.testing.assert_allclose([v for _, v in ours[tag]], [v for _, v in ref[tag]],
                                   rtol=LOSS_RTOL, err_msg=tag)
    for tag in ("val/nyu_v2/abs_relative_difference", "val/nyu_v2/delta1_acc"):
        assert [s for s, _ in ours[tag]] == [2]
        np.testing.assert_allclose(ours[tag][0][1], ref[tag][0][1], rtol=1e-3, err_msg=tag)


def test_train_cli_state_matches_jax(runs, ckpts):  # noqa: F811
    """The final checkpoint: counters equal; every trainable parameter
    within 2.5 LR of JAX's, and the run's update within UPDATE_RTOL."""
    state = load_train_checkpoint(str(runs / "port" / "checkpoint"), "final")
    jstate = jax_load_state(str(runs / "jax" / "checkpoint"), "final")
    assert state["counters"] == {k: int(v) for k, v in jstate["counters"].items()}
    assert state["counters"]["effective_iter"] == 3
    ref = {f"unet.{k}": v.numpy()
           for k, v in state_dict_from_jax(jstate["trainable"]["unet"]).items()}
    ours = {k: v.float().numpy() for k, v in state["trainable"].items()}
    assert set(ours) == set(ref)
    init = {f"unet.{k}": v.float().numpy() for k, v in load_genpercept_checkpoint(
        str(ckpts["plain"][0]), device="cpu").unet.state_dict().items()}
    worst = max(float(np.abs(ours[k] - ref[k]).max()) for k in ref)
    assert worst <= 2.5 * LR, worst
    names = list(state["trainable"])
    mu = {names[i]: float(st["mu"].float().abs().max())
          for i, st in state["opt_state"]["state"].items()}
    keep = [k for k in ref if mu[k] >= 1e-6 * max(mu.values())]
    assert len(keep) > 0.9 * len(ref)
    num = sum(float(np.sum(((ours[k] - init[k]) - (ref[k] - init[k])) ** 2)) for k in keep)
    den = sum(float(np.sum((ref[k] - init[k]) ** 2)) for k in keep)
    assert den > 0 and (num / den) ** 0.5 <= UPDATE_RTOL, (num / den) ** 0.5


def test_resume_from_final_equals_uninterrupted(ckpts, data, tmp_path):  # noqa: F811
    """2 steps + --resume_run final to 3 equal 3 straight (1e-7, CPU). The
    trainer saves `final` after leaving its epoch, so the resumed run starts
    a new epoch and restarts the sample stream, as JAX's does (the test
    above holds that stream to JAX's); with one sample, a batch of it and
    no augmentation every epoch is the same data, and what is left to
    differ is what the checkpoint restores: parameters, Adam state,
    counters and the seed sequence."""
    root, train_list, val_list = data
    one = root / "one.txt"
    one.write_text(open(train_list).read().splitlines()[0] + "\n")
    over = dict(dataloader={"effective_batch_size": 1, "max_train_batch_size": 1},
                augmentation=None,
                trainer={"init_seed": 5, "save_period": 0, "validation_period": 0},
                model={"remat_unet": False}, lr_scheduler={"kwargs": {"warmup_steps": 1}})
    ckpt = ckpts["plain"][0]
    for name, steps in (("resumed", (2, 3)), ("straight", (3,))):
        for i, n in enumerate(steps):
            cfg = recipe(root, str(one), val_list, n, **over)
            port_train.main(argv(cfg, ckpt, data, tmp_path / name, "--device", "cpu",
                                 *(["--resume_run", "final"] if i else [])))
    a = load_train_checkpoint(str(tmp_path / "resumed" / "checkpoint"), "final")
    b = load_train_checkpoint(str(tmp_path / "straight" / "checkpoint"), "final")
    assert a["counters"]["effective_iter"] == b["counters"]["effective_iter"] == 3
    for k, v in b["trainable"].items():
        np.testing.assert_allclose(a["trainable"][k].numpy(), v.numpy(), rtol=0, atol=1e-7,
                                   err_msg=k)
    la, lb = metrics(tmp_path / "resumed"), metrics(tmp_path / "straight")
    np.testing.assert_allclose([v for _, v in la["train/loss"]],
                               [v for _, v in lb["train/loss"]], rtol=1e-7)


def test_train_cli_flags_mirror_jax():
    ours = {a.dest: a.default for a in port_train.build_parser()._actions}
    ref = {a.dest: a.default for a in jax_train.build_parser()._actions}
    assert set(ours) == set(ref) | {"device"} and ours["device"] == "cuda"
    assert {k: ours[k] for k in ref} == ref


@pytest.mark.parametrize("flags,error,match", [
    (["--data_parallel", "2"], ValueError, "one process per data-parallel rank"),
    (["--data_parallel", "0"], ValueError, "one process per data-parallel rank"),
    (["--model_parallel", "2"], ValueError, "does not divide the 1 process"),
    (["--coordinator_address", "localhost:1234", "--num_processes", "2"], ValueError,
     "--process_id"),
    (["--coordinator_address", "localhost:1234"], ValueError, "--num_processes"),
    (["--multihost"], RuntimeError, "torchrun"),
])
def test_train_cli_refuses_more_than_one_device(flags, error, match, tmp_path, monkeypatch):
    """What one process cannot run is refused before anything is written:
    more data-parallel ranks than processes, a model group of two ranks (a
    world that --model_parallel does not divide), a coordinator without the
    rank count or this rank, --multihost without a launcher's environment.
    (Several processes run in tests/test_torch_parallel.py and
    tests/test_torch_tensor_parallel.py.)"""
    for key in ("RANK", "WORLD_SIZE", "SLURM_PROCID", "SLURM_NTASKS"):
        monkeypatch.delenv(key, raising=False)
    args = ["--config", "unused.yaml", "--checkpoint", "unused", "--output_dir",
            str(tmp_path / "out"), *flags]
    with pytest.raises(error, match=match):
        port_train.main(args)
    assert not (tmp_path / "out").exists()


def test_train_cli_defaults_to_the_card(ckpts, data, tmp_path, monkeypatch):  # noqa: F811
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    root, train_list, val_list = data
    with pytest.raises(RuntimeError, match="--device cpu"):
        port_train.main(argv(recipe(root, train_list, val_list, 1), ckpts["plain"][0], data,
                             tmp_path / "out"))
    assert not (tmp_path / "out").exists()


# ------------------------------------------------------ apply_model_overrides


def test_from_scratch_overrides(ckpts):  # noqa: F811
    """model.unet_from_scratch / vae_decoder_from_scratch re-initialise in
    place with the JAX scheme: biases 0, norms (1, 0), weights within
    +-1/sqrt(fan_in) with std within 5% of bound/sqrt(3) (every tensor of
    at least 1000 elements); the encoder untouched; seeded (seed, seed + 1)."""
    ckpt = str(ckpts["plain"][0])
    models = load_genpercept_checkpoint(ckpt, device="cpu")
    enc = {k: v.clone() for k, v in models.vae.encoder.state_dict().items()}
    cfg = Config({"model": {"unet_from_scratch": True, "vae_decoder_from_scratch": True}})
    port_train.apply_model_overrides(cfg, models, seed=3)
    for module in (models.unet, models.vae.decoder, models.vae.post_quant_conv):
        for name, m in module.named_modules():
            if isinstance(m, (torch.nn.Linear, torch.nn.Conv2d)):
                bound = 1 / m.weight[0].numel() ** 0.5
                assert float(m.weight.abs().max()) <= bound, name
                if m.weight.numel() >= 1000:
                    assert abs(float(m.weight.std()) / (bound / 3**0.5) - 1) <= 0.05, name
                assert m.bias is None or not m.bias.any(), name
            elif hasattr(m, "weight") and m.weight is not None and m.weight.ndim == 1:
                assert torch.equal(m.weight, torch.ones_like(m.weight)), name
                assert not m.bias.any(), name
    for k, v in models.vae.encoder.state_dict().items():
        assert torch.equal(v, enc[k]), k
    again = load_genpercept_checkpoint(ckpt, device="cpu")
    port_train.apply_model_overrides(cfg, again, seed=3)
    w = "conv_in.weight"
    assert torch.equal(again.unet.state_dict()[w], models.unet.state_dict()[w])
    other = load_genpercept_checkpoint(ckpt, device="cpu")
    port_train.apply_model_overrides(cfg, other, seed=4)
    assert not torch.equal(other.unet.state_dict()[w], models.unet.state_dict()[w])


def test_dpt_head_override_is_refused(ckpts):  # noqa: F811
    """model.customized_head on a checkpoint without a head is no longer
    refused: a fresh head (DPT_IDENTITY when the name holds "identity"), on
    the models' device, the JAX scheme (weights within +-1/sqrt(fan_in),
    std within 5% of bound/sqrt(3) for tensors of at least 1000 elements,
    biases 0), seeded seed + 2; a checkpoint's own head is kept."""
    from genpercept_tpu.cli import train as j_train
    from genpercept_tpu.io.checkpoints import load_genpercept_checkpoint as j_load

    heads = {}
    for name, act in (("dpt_head_identity", "identity"), ("dpt_head", "relu")):
        models = load_genpercept_checkpoint(str(ckpts["plain"][0]), device="cpu")
        port_train.apply_model_overrides(Config({"model": {"customized_head": name}}),
                                         models, seed=0)
        jm = j_load(str(ckpts["plain"][0]))
        j_train.apply_model_overrides(JConfig({"model": {"customized_head": name}}), jm, seed=0)
        assert models.dpt_head.cfg.final_act == jm.dpt_cfg.final_act == act
        want = state_dict_from_jax(jm.dpt_head)
        got = models.dpt_head.state_dict()
        assert set(got) == set(want)
        for k, v in got.items():
            assert v.shape == want[k].shape and v.dtype == torch.float32, k
            if k.endswith("bias"):
                assert not v.any(), k
            else:
                bound = 1 / v[0].numel() ** 0.5
                assert float(v.abs().max()) <= bound * (1 + 1e-6), k  # the bound in f32
                if v.numel() >= 1000:
                    assert abs(float(v.std()) / (bound / 3**0.5) - 1) <= 0.05, k
        heads[name] = got
    again = load_genpercept_checkpoint(str(ckpts["plain"][0]), device="cpu")
    port_train.apply_model_overrides(Config({"model": {"customized_head": "dpt_head_identity"}}),
                                     again, seed=0)
    assert all(torch.equal(v, heads["dpt_head_identity"][k])
               for k, v in again.dpt_head.state_dict().items())
    own = load_genpercept_checkpoint(str(ckpts["dpt_identity"][0]), device="cpu")
    kept = {k: v.clone() for k, v in own.dpt_head.state_dict().items()}
    port_train.apply_model_overrides(Config({"model": {"customized_head": "dpt_head"}}), own,
                                     seed=0)
    assert all(torch.equal(v, kept[k]) for k, v in own.dpt_head.state_dict().items())


def test_text_input_matches_jax_encode_prompt(ckpts, tmp_path, monkeypatch):  # noqa: F811
    """model.text_input replaces the text embedding with the prompt's CLIP
    embedding: a tiny text tower and a toy vocabulary in both packages, 1e-5
    of JAX's (f32, one layer)."""
    plain = ckpts["plain"][0]
    ckpt = tmp_path / "ckpt"
    ckpt.mkdir()
    for sub in ("unet", "vae", "empty_text_embed.npy"):
        os.symlink(plain / sub, ckpt / sub)
    write_part(ckpt / "text_encoder", numpy_params(init_clip_text, JCLIPConfig(**TINY_CLIP),
                                                   seed=12),
               name="model.safetensors", prefix="text_model.")
    write_tokenizer(ckpt, *toy_vocab())
    from genpercept_tpu_torch.models.clip_text import CLIPTextConfig, CLIPTextModel

    monkeypatch.setattr(tck, "CLIPTextModel", lambda: CLIPTextModel(CLIPTextConfig(**TINY_CLIP)))
    monkeypatch.setattr(j_clip, "SD21_CLIP_TEXT", JCLIPConfig(**TINY_CLIP))
    prompt = "the depth of a room"
    jm = jax_load(str(ckpt))
    jax_train.apply_model_overrides(JConfig({"model": {"text_input": prompt}}), jm, 0)
    tm = load_genpercept_checkpoint(str(ckpt), device="cpu")
    empty = tm.get_text_embed().clone()
    port_train.apply_model_overrides(Config({"model": {"text_input": prompt}}), tm, 0)
    np.testing.assert_allclose(tm.text_embed.numpy(), np.asarray(jm.text_embed), rtol=0,
                               atol=1e-5)
    assert float((tm.text_embed - empty).abs().max()) > 1e-3


def test_chip_smoke_recipe_is_the_main_paper_recipe(tmp_path):
    """chip_smoke.py's train_eval phase points the recipe's datasets at its
    files and sets max_iter and the periods, nothing else: the file resolves
    to chip_smoke.TRAIN_CFG with its 4 accumulation steps. Its first three
    steps draw Hypersim alone, whose per-micro-step launches (the phase's
    STEP_LAUNCHES) are the counts tests/test_torch_train.py pins against
    JAX's routing."""
    import dataclasses

    import chip_smoke as cs
    from genpercept_tpu_torch.utils.config import recursive_load_config
    from test_torch_train import STEP_LAUNCHES

    data = {k: (k, str(tmp_path / k)) for k in ("train", "vkitti", "val", "vis")}
    cs.write_recipe(tmp_path / "recipe.yaml", data, 3, 2)
    cfg = recursive_load_config(str(tmp_path / "recipe.yaml"))
    accum = int(cfg.get_path("dataloader.effective_batch_size")
                / cfg.get_path("dataloader.max_train_batch_size"))
    assert accum == cs.ACCUM and cfg.get_path("dataloader.max_train_batch_size") == cs.MICRO
    assert port_train.resolve_train_config(cfg, grad_accum_steps=accum) \
        == dataclasses.replace(cs.TRAIN_CFG, grad_accum_steps=cs.ACCUM)
    assert cfg["dataset"]["train"]["prob_ls"] == [0.9, 0.1]
    assert [e["dir"] for e in cfg["dataset"]["train"]["dataset_list"]] == ["train", "vkitti"]
    assert cfg["max_iter"] == 3 and cfg["trainer"]["validation_period"] == 2
    want = STEP_LAUNCHES[(cs.TRAIN_HW, cs.MICRO)]
    assert {k: cs.STEP_LAUNCHES[k] for k in want} == want and not any(
        v for k, v in cs.STEP_LAUNCHES.items() if k not in want)
    assert set(cs.STEP_LAUNCHES) == set(cs.COUNTERS)
    assert cs.te_sources(cfg, 3) == ["hypersim"] * 3
