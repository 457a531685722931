"""The port's Trainer.validate and Trainer.visualize held to the JAX
Trainer's, on tiny models (tests/test_torch_train.py's weights) and val/vis
batches from a numpy seed, in f32 compute and in bf16 compute, where both
trainers store the frozen VAE in bf16 and validation runs the f32 pipeline
on those weights. The port runs on the CPU.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from genpercept_tpu.train import TrainConfig as JConfig
from genpercept_tpu.train.trainer import Trainer as JTrainer
from genpercept_tpu_torch.data.sampler import collate
from genpercept_tpu_torch.train import TrainConfig
from genpercept_tpu_torch.train.trainer import Trainer
from test_torch_train import port_models, tiny  # noqa: F401  (module-scoped fixture)

torch.set_num_threads(1)

HW = 64
# validate's metrics: the pipelines' predictions agree within the pipeline
# tests' 1e-4 mean bar; least-squares aligned, abs_rel and delta1 (3 images
# of 3072 valid pixels) move by less than 1e-3 relative of JAX's
METRIC_RTOL = 1e-3
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
# --bf16_masters: the trainable UNet itself stored in bf16 (bf16 compute)
MASTERS = {"f32": (None, None), "bf16": (None, None),
           "bf16_masters": (jnp.bfloat16, torch.bfloat16)}


def val_batches(seed=50, n=3):
    """Eval-mode items, one a batch (the CLI's val loaders): rgb in [-1, 1],
    metric depth in [1, 9] with an invalid block, a normal map for the
    non-depth branch."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        valid = np.ones((HW, HW), bool)
        valid[:16, :16] = False
        normal = rng.normal(size=(HW, HW, 3))
        normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
        out.append(collate([{
            "rgb_norm": rng.uniform(-1, 1, (HW, HW, 3)).astype(np.float32),
            "depth_raw_linear": rng.uniform(1, 9, (HW, HW)).astype(np.float32),
            "valid_mask_raw": valid,
            "normal_raw_norm": normal.astype(np.float32),
            "valid_mask_raw_normal": valid,
        }]))
    return out


def trainers(tiny, tmp_path, dtype, **kw):  # noqa: F811
    jdt, tdt = DTYPES["bf16" if dtype == "bf16_masters" else dtype]
    jm, tm = MASTERS[dtype]
    loaders = dict(val_loaders={"toy": val_batches()}, vis_loaders={"vis": val_batches(51, 5)})
    jt = JTrainer(JConfig(loss_names=("mse", "ssi", "grad"), fix_timesteps=1,
                          compute_dtype=jdt, master_dtype=jm), tiny[0], [],
                  str(tmp_path / "jax"), save_period=0, **loaders, **kw)
    tt = Trainer(TrainConfig(loss_names=("mse", "ssi", "grad"), fix_timesteps=1,
                             compute_dtype=tdt, master_dtype=tm), port_models(tiny), [],
                 str(tmp_path / "port"), save_period=0, **loaders, **kw)
    return jt, tt


@pytest.mark.parametrize("dtype", sorted(MASTERS))
def test_validate_matches_jax(tiny, tmp_path, dtype):  # noqa: F811
    """Depth: the aligned abs_rel and delta1 within METRIC_RTOL, logged under
    val/toy/; in bf16 compute the frozen VAE is stored in bf16 by both (and
    with bf16 masters the trained UNet too) and validated as stored: the
    modules are not copied or recast."""
    jt, tt = trainers(tiny, tmp_path, dtype)
    vae_dtype = torch.float32 if dtype == "f32" else torch.bfloat16
    unet_dtype = torch.bfloat16 if dtype == "bf16_masters" else torch.float32
    assert all(p.dtype == vae_dtype for p in tt.models.vae.parameters())
    assert all(p.dtype == unet_dtype for p in tt.models.unet.parameters())
    vae_before = [p.data_ptr() for p in tt.models.vae.parameters()]
    ref = jt.validate()
    ours = tt.validate()
    assert list(ours) == ["toy"] and list(ours["toy"]) == ["abs_relative_difference", "delta1_acc"]
    for k, v in ref["toy"].items():
        np.testing.assert_allclose(ours["toy"][k], v, rtol=METRIC_RTOL, err_msg=k)
    assert [p.data_ptr() for p in tt.models.vae.parameters()] == vae_before
    assert all(p.dtype == vae_dtype for p in tt.models.vae.parameters())
    assert all(p.dtype == unet_dtype for p in tt.models.unet.parameters())
    logged = (tmp_path / "port" / "metrics.jsonl").read_text()
    assert '"val/toy/abs_relative_difference"' in logged and '"val/toy/delta1_acc"' in logged


def test_validate_masked_l1_branch_matches_jax(tiny, tmp_path):  # noqa: F811
    """The other modes' branch (no training run reaches it until the
    non-depth modes are ported): a depth trainer with cfg.mode swapped to
    normal after construction, in both packages; masked L1 of the
    3-channel prediction against the normal map within METRIC_RTOL."""
    jt, tt = trainers(tiny, tmp_path, "f32")
    jt.cfg = dataclasses.replace(jt.cfg, mode="normal")
    tt.cfg = dataclasses.replace(tt.cfg, mode="normal")
    ref, ours = jt.validate(), tt.validate()
    assert list(ours["toy"]) == ["masked_l1"]
    np.testing.assert_allclose(ours["toy"]["masked_l1"], ref["toy"]["masked_l1"],
                               rtol=METRIC_RTOL)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_visualize_matches_jax(tiny, tmp_path, dtype):  # noqa: F811
    """At most 4 PNGs a vis split (5 batches given), the same names in
    visualization/iter_000000/; the colorized depth within one uint8 level
    of JAX's (both truncate x255 of predictions within the pipeline bar)."""
    jt, tt = trainers(tiny, tmp_path, dtype)
    jt.visualize()
    tt.visualize()
    names = [f"vis_{j:03d}.png" for j in range(4)]
    for sub in ("jax", "port"):
        vis = tmp_path / sub / "visualization" / "iter_000000"
        assert sorted(p.name for p in vis.iterdir()) == names
    for n in names:
        ours = np.asarray(Image.open(tmp_path / "port/visualization/iter_000000" / n), np.int32)
        ref = np.asarray(Image.open(tmp_path / "jax/visualization/iter_000000" / n), np.int32)
        assert ours.shape == ref.shape == (HW, HW, 3)
        assert np.abs(ours - ref).max() <= 1


class Batches:
    """A training loader over fixed batches (the depth trainer's keys)."""

    def __init__(self, seed=60, n=2):
        rng = np.random.default_rng(seed)
        mask = np.ones((2, HW, HW), bool)
        mask[:, :16, :16] = False
        self.batches = [{"rgb_norm": rng.uniform(-1, 1, (2, HW, HW, 3)).astype(np.float32),
                         "depth_raw_norm": rng.uniform(-1, 1, (2, HW, HW)).astype(np.float32),
                         "valid_mask_raw": mask} for _ in range(n)]

    def __iter__(self):
        return iter(self.batches)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_validation_changes_no_training_state(tiny, tmp_path, dtype):  # noqa: F811
    """Trainer(val_period=1, vis_period=1) validates and visualizes after
    each step, leaves requires_grad and the optimizer state as they were,
    and its parameters after two steps equal those of a run without
    validation, bit for bit."""
    cfg = TrainConfig(loss_names=("mse", "ssi", "grad"), fix_timesteps=1, lr=1e-3,
                      lr_warmup_steps=1, compute_dtype=DTYPES[dtype][1])
    runs = {}
    for name, periods in (("plain", {}), ("val", dict(val_period=1, vis_period=1))):
        tr = Trainer(cfg, port_models(tiny), Batches(), str(tmp_path / name), max_iter=2,
                     save_period=0, val_loaders={"toy": val_batches()},
                     vis_loaders={"vis": val_batches(51, 2)}, **periods)
        grads = {k: p.requires_grad for k, p in tr.models.unet.named_parameters()}
        tr.train()
        if name == "val":
            before = {k: v.clone() for k, v in tr.optimizer.state_dict()["state"][0].items()}
            tr.validate()
            after = tr.optimizer.state_dict()["state"][0]
            assert all(torch.equal(before[k], after[k]) for k in before)
        assert grads == {k: p.requires_grad for k, p in tr.models.unet.named_parameters()}
        runs[name] = tr
    for k, p in runs["plain"].trainable.items():
        assert torch.equal(runs["val"].trainable[k], p), k
    vis = tmp_path / "val" / "visualization"
    assert sorted(p.name for p in vis.iterdir()) == ["iter_000001", "iter_000002"]
    logged = (tmp_path / "val" / "metrics.jsonl").read_text().splitlines()
    assert sum('"val/toy/delta1_acc"' in line for line in logged) == 3  # steps 1, 2, and by hand
