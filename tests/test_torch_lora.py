"""The port's LoRA adapters held to the JAX package's.

The JAX ``init_lora`` tree sets the targets and shapes; its values are
replaced by numpy-seeded ones with a non-zero B (JAX seeds each subtree with
Python's salted ``hash``, so its own draw differs between processes), and
that tree is carried into the port with ``state_dict_from_jax`` (A and B
keep JAX's (din, r) / (r, dout) layout). Merges are exact in f32; the
training step's loss and adapter gradients meet tests/test_torch_train.py's
f32 bars; under bf16 compute the merge rounds as JAX's on its
Trainer-cast trees and one micro-step meets tests/test_torch_train.py's bf16
bars; training moves only the adapters; the export merges them as the JAX
export does.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genpercept_tpu.cli import export as jax_export
from genpercept_tpu.io.checkpoints import load_genpercept_checkpoint as jax_load
from genpercept_tpu.io.checkpoints import save_train_checkpoint as jax_save_state
from genpercept_tpu.train import lora as JLORA
from genpercept_tpu.train import train_step as JT
from genpercept_tpu_torch.cli import export as port_export
from genpercept_tpu_torch.io import state_dict_from_jax
from genpercept_tpu_torch.io.checkpoints import load_genpercept_checkpoint, save_train_checkpoint
from genpercept_tpu_torch.io.weights import load_safetensors
from genpercept_tpu_torch.train import lora as TLORA
from genpercept_tpu_torch.train import train_step as TT
from test_torch_checkpoint import ckpts  # noqa: F401  (module-scoped fixture)
from test_torch_export import COUNTERS, export_argv
from test_torch_train import global_rel_l2, make_batch, port_models, rel_l2, tiny  # noqa: F401
from test_torch_train import torch_batch
from test_torch_train_modes import jax_loss_and_grads, port_loss_and_grads

torch.set_num_threads(1)

RANK = 4


def seeded(tree, seed):
    """The JAX LoRA tree's structure with numpy-seeded values: A ~ N/r, B
    non-zero."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        scale = 1.0 / RANK if str(path[-1].key) == "lora_A" else 0.05
        return (rng.normal(size=leaf.shape) * scale).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, tree)


@pytest.fixture(scope="module")
def lora_tree(tiny):
    return seeded(JLORA.init_lora(jax.random.key(0), tiny[1], RANK), 50)


def test_targets_and_init_match_jax(tiny, lora_tree):
    models = port_models(tiny)
    ours = TLORA.init_lora(torch.Generator().manual_seed(0), models.unet, RANK)
    want = state_dict_from_jax(lora_tree)
    assert set(ours) == set(want)
    assert len(ours) == 2 * 4 * 2 * 16  # q, k, v, out of 2 attentions in 16 transformers
    for k, v in want.items():
        assert ours[k].shape == v.shape and ours[k].dtype == torch.float32, k
        if k.endswith("lora_B"):
            assert not ours[k].any(), k
    a = torch.cat([v.flatten() for k, v in ours.items() if k.endswith("lora_A")])
    assert abs(float(a.std()) * RANK - 1.0) < 0.05
    again = TLORA.init_lora(torch.Generator().manual_seed(0), models.unet, RANK)
    assert all(torch.equal(ours[k], again[k]) for k in ours)
    assert TLORA.count_lora_params(ours) == JLORA.count_lora_params(lora_tree)


def test_apply_and_merge_lora_are_exact(tiny, lora_tree):
    """W + (A @ B)^T in f32 against JAX's W + A @ B, bit for bit; the
    module's own weights untouched."""
    models = port_models(tiny)
    lora = state_dict_from_jax(lora_tree)
    want = state_dict_from_jax(JLORA.apply_lora(tiny[1], lora_tree))
    before = {k: v.clone() for k, v in models.unet.state_dict().items()}
    got = TLORA.apply_lora(models.unet, lora)
    assert set(got) == {k.rsplit(".", 1)[0] for k in lora}
    for k, v in got.items():
        assert torch.equal(v.detach(), want[k]), k
    merged = TLORA.merge_lora(models.unet, lora)
    for k, v in merged.items():
        assert torch.equal(v, want[k]), k
    for k, v in models.unet.state_dict().items():
        assert torch.equal(v, before[k]), k


def lora_models(tiny, lora_tree):
    models = port_models(tiny)
    models.unet_lora = {k: v.clone() for k, v in state_dict_from_jax(lora_tree).items()}
    return models


@pytest.mark.parametrize("remat", ["off", "unet", "block"])
def test_lora_loss_and_grads_match_jax(tiny, lora_tree, remat):
    """Only the adapters are trainable; their gradients to the f32 bars, and
    with remat equal bit for bit to the port's own without (the recompute
    reads the adapted weights too)."""
    ref = _jax_ref(tiny, lora_tree)
    kw = {"off": dict(remat_unet=False), "unet": dict(remat_unet=True),
          "block": dict(remat_unet=True, remat_granularity="block")}[remat]
    cfg = TT.TrainConfig(loss_names=("mse", "grad"), fix_timesteps=1, unet_lora_rank=RANK, **kw)
    loss, aux, grads = port_loss_and_grads(lora_models(tiny, lora_tree), cfg, make_batch())
    assert set(grads) == {f"unet_lora.{k}" for k in state_dict_from_jax(lora_tree)}
    jloss, jaux, jgrads = ref
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    for k in aux:
        np.testing.assert_allclose(aux[k], jaux[k], rtol=1e-5, err_msg=k)
    assert global_rel_l2(grads, jgrads) <= 1e-4
    top = max(np.linalg.norm(g) for g in jgrads.values())
    assert max(rel_l2(grads[k], jgrads[k]) for k in grads
               if np.linalg.norm(jgrads[k]) > 1e-6 * top) <= 1e-3
    if remat != "off":
        plain = port_loss_and_grads(lora_models(tiny, lora_tree),
                                    dataclasses.replace(cfg, remat_unet=False), make_batch())[2]
        for k in grads:
            np.testing.assert_array_equal(grads[k], plain[k], err_msg=k)


_REF = {}


def _jax_ref(tiny, lora_tree):
    """JAX's f32 LoRA micro-step, once a module."""
    if "ref" not in _REF:
        jcfg = JT.TrainConfig(loss_names=("mse", "grad"), fix_timesteps=1, unet_lora_rank=RANK)
        _REF["ref"] = jax_loss_and_grads(tiny[0], jcfg, make_batch(),
                                         trainable_override={"unet_lora": lora_tree})
    return _REF["ref"]


def test_lora_training_moves_only_adapters(tiny, lora_tree):
    """Two optimizer steps: the base UNet stays bit for bit, every B moves
    but the mid block's self-attention q and k (one token at the 1x1 latent:
    the softmax is 1 whatever they are, so their gradient is 0); with
    master_dtype bf16 the adapters are bf16 and the base stays f32."""
    for master in (None, torch.bfloat16):
        models = lora_models(tiny, lora_tree)
        base = {k: v.clone() for k, v in models.unet.state_dict().items()}
        cfg = TT.TrainConfig(loss_names=("mse",), fix_timesteps=1, unet_lora_rank=RANK, lr=1e-2,
                             lr_warmup_steps=0, master_dtype=master)
        trainable, _, opt = TT.init_train_state(models, cfg)
        assert all(k.startswith("unet_lora.") for k in trainable)
        assert all(v.dtype == (master or torch.float32) for v in trainable.values())
        start = {k: v.detach().clone() for k, v in trainable.items()}
        step = TT.build_train_step(cfg, models, opt)
        for _ in range(2):
            step(torch_batch(make_batch()))
        for k, v in models.unet.state_dict().items():
            assert torch.equal(v, base[k]), k
        moved = [k for k in trainable if not torch.equal(trainable[k].detach(), start[k])]
        still = {k for k in trainable if k.endswith("lora_B")} - set(moved)
        assert still == {f"unet_lora.mid_block.attentions.0.transformer_blocks.0.attn1.{p}"
                         ".weight.lora_B" for p in ("to_q", "to_k")}, still


def test_lora_trainer_checkpoint_carries_the_adapters(tiny, lora_tree, tmp_path):
    from genpercept_tpu_torch.train.trainer import Trainer

    cfg = TT.TrainConfig(loss_names=("mse",), fix_timesteps=1, unet_lora_rank=RANK,
                         compute_dtype=torch.bfloat16)
    trainer = Trainer(cfg, port_models(tiny), [], str(tmp_path), main_seed=5)
    assert trainer.models.unet_lora is not None
    # bf16 compute stores the frozen base UNet in bf16, as JAX's Trainer
    # casts its frozen tree; the adapters stay f32 masters
    assert all(p.dtype == torch.bfloat16 for p in trainer.models.unet.parameters())
    assert all(v.dtype == torch.float32 for v in trainer.trainable.values())
    with torch.no_grad():
        for v in trainer.models.unet_lora.values():
            v.add_(0.5)
    trainer.save_checkpoint("latest")
    other = Trainer(cfg, port_models(tiny), [], str(tmp_path), main_seed=6)
    other.load_checkpoint("latest")
    for k, v in trainer.trainable.items():
        assert torch.equal(other.trainable[k], v.detach()), k


def bf16_lora_trainer(tiny, lora_tree, tmp_path):
    from genpercept_tpu_torch.train.trainer import Trainer

    cfg = TT.TrainConfig(loss_names=("mse", "grad"), fix_timesteps=1, unet_lora_rank=RANK,
                         compute_dtype=torch.bfloat16)
    return Trainer(cfg, lora_models(tiny, lora_tree), [], str(tmp_path))


def test_bf16_lora_merge_rounds_as_jax(tiny, lora_tree, tmp_path):
    """Under bf16 compute each adapted weight is the bf16 base plus the
    delta rounded to bf16, added in bf16: JAX's apply_lora on the tree its
    Trainer casts to bf16, bit for bit."""
    trainer = bf16_lora_trainer(tiny, lora_tree, tmp_path)
    cast = jax.tree.map(lambda x: jnp.asarray(x, jnp.bfloat16), tiny[1])
    merged = JLORA.apply_lora(cast, jax.tree.map(jnp.asarray, lora_tree))
    want = state_dict_from_jax(jax.tree.map(lambda x: np.asarray(x, np.float32), merged))
    got = TLORA.apply_lora(trainer.models.unet, trainer.models.unet_lora)
    assert len(got) == len(state_dict_from_jax(lora_tree)) // 2
    for k, v in got.items():
        assert v.dtype == torch.bfloat16, k
        assert torch.equal(v.detach().float(), want[k]), k


def test_bf16_lora_step_matches_jax(tiny, lora_tree, tmp_path):
    """One bf16 micro-step on the Trainer's trees against JAX's on its
    Trainer-cast trees, with tests/test_torch_train.py's bf16 bars: the loss
    within 1e-2 of JAX's bf16 loss, the adapters' gradients no farther from
    JAX's f32 gradients than 1.5x JAX's own bf16 gradients are."""
    trainer = bf16_lora_trainer(tiny, lora_tree, tmp_path)
    jcfg = JT.TrainConfig(loss_names=("mse", "grad"), fix_timesteps=1, unet_lora_rank=RANK,
                          compute_dtype=jnp.bfloat16)
    jloss, _, jgrads = jax_loss_and_grads(tiny[0], jcfg, make_batch(),
                                          trainable_override={"unet_lora": lora_tree})
    _, _, jgrads32 = _jax_ref(tiny, lora_tree)
    loss, _, grads = port_loss_and_grads(trainer.models, trainer.cfg, make_batch())
    assert set(grads) == set(jgrads)
    np.testing.assert_allclose(loss, jloss, rtol=1e-2)
    assert global_rel_l2(grads, jgrads32) <= 1.5 * global_rel_l2(jgrads, jgrads32)


def test_export_of_a_lora_run_matches_jax(ckpts, tmp_path):  # noqa: F811
    """The same file tree as the JAX export and the merged UNet bit for bit
    (f32); the export loads through the port's loader."""
    base = ckpts["plain"][0]
    tree = seeded(JLORA.init_lora(jax.random.key(0), jax_load(str(base)).unet, RANK), 51)
    jax_save_state(str(tmp_path / "jax_run" / "checkpoint"),
                   {"trainable": {"unet_lora": tree}, "opt_state": {"count": np.int32(7)},
                    "counters": {k: np.int32(v) for k, v in COUNTERS.items()}}, "final")
    jax_export.main(export_argv(tmp_path / "jax_run", base, tmp_path / "jax"))
    state = {f"unet_lora.{k}": v for k, v in state_dict_from_jax(tree).items()}
    save_train_checkpoint(str(tmp_path / "run" / "checkpoint"),
                          {"trainable": state, "opt_state": {}, "counters": COUNTERS}, "final")
    port_export.main(export_argv(tmp_path / "run", base, tmp_path / "port", "--device", "cpu"))
    name = "unet/diffusion_pytorch_model.safetensors"
    ours, ref = load_safetensors(str(tmp_path / "port" / name)), load_safetensors(
        str(tmp_path / "jax" / name))
    assert set(ours) == set(ref)
    for k in ref:
        assert torch.equal(ours[k], ref[k]), k
    base_unet = load_safetensors(str(base / name))
    assert not torch.equal(ours["down_blocks.0.attentions.0.transformer_blocks.0.attn1.to_q.weight"],
                           base_unet["down_blocks.0.attentions.0.transformer_blocks.0.attn1.to_q.weight"])
    models = load_genpercept_checkpoint(str(tmp_path / "port"), base_ckpt_dir=str(base),
                                        device="cpu")
    for k, v in models.unet.state_dict().items():
        assert torch.equal(v, ref[k]), k
