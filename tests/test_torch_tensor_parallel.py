"""Tensor parallelism (``--model_parallel``) on the CPU with gloo.

The split rules against the JAX package's (``genpercept_tpu.parallel.mesh.
_tp_spec_for`` and ``shard_params_tp``), the shard and gather round trips,
Megatron's f and g on two ranks, one training step of tiny models on a
model group of two ranks against one process, against the split emulated
in one process and against JAX's own step jitted on a (1, 2) mesh, then the
training CLI: a model group of two (a checkpoint resumed across layouts
both ways, the export), 2 x 2 ranks with and without --zero1, and the
DPT-head and LoRA recipes. The spawned ranks run tests/torch_tp_worker.py;
the tiny models are tests/test_torch_train.py's (JAX ``init_*`` shapes
filled from numpy seeds). The bars stand beside each test, with the
readings they were set from.
"""

import math
import re
import shutil

import jax
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp
import yaml

from genpercept_tpu.models import UNetConfig as JUNetConfig
from genpercept_tpu.models import VAEConfig as JVAEConfig
from genpercept_tpu.models import init_unet, init_vae
from genpercept_tpu.models.clip_text import SD21_CLIP_TEXT, init_clip_text
from genpercept_tpu.parallel import batch_sharding, make_mesh, shard_params_tp
from genpercept_tpu.parallel.mesh import _tp_spec_for as jax_spec
from genpercept_tpu.pipeline import GenPerceptModels as JModels
from genpercept_tpu.train import train_step as JT
from genpercept_tpu_torch.cli import export as port_export
from genpercept_tpu_torch.cli import train as port_train
from genpercept_tpu_torch.io import state_dict_from_jax
from genpercept_tpu_torch.io.checkpoints import load_train_checkpoint
from genpercept_tpu_torch.io.weights import _flatten, load_safetensors
from genpercept_tpu_torch.models import UNet2DConditionModel, UNetConfig
from genpercept_tpu_torch.parallel import tensor as TP
from test_torch_checkpoint import ckpts  # noqa: F401  (module-scoped fixture)
from test_torch_models import numpy_params
from test_torch_parallel import free_port, write_nyu
from test_torch_train import TINY_UNET, TINY_VAE, make_batch
import torch_tp_worker as W

torch.set_num_threads(1)

M = 2
P = jax.sharding.PartitionSpec
# the names whose layer the port keeps whole where JAX splits it: an
# attention of one head (the tiny UNet's level 0, the VAE's mid block) or of
# SD2.1's level-0 five, which two ranks do not divide
WHOLE = re.compile(r"^(unet\.(down_blocks\.0|up_blocks\.3)\.attentions\.\d+\.transformer_blocks"
                   r"\.\d+\.attn[12]\.|vae\.(encoder|decoder)\.mid_block\.attentions\.0\.)"
                   r"((to_q|to_k|to_v)\.(weight|bias)|to_out\.0\.weight)$")


# ------------------------------------------------------------ the rules


def jax_names(model: str):
    """{dotted name: (JAX shape, heads of its attention)} of the UNet and
    the VAE (and SD2.1's CLIP), as ``state_dict_from_jax`` names them."""
    ucfg = JUNetConfig(**TINY_UNET) if model == "tiny" else JUNetConfig()
    vcfg = JVAEConfig(**TINY_VAE) if model == "tiny" else JVAEConfig()
    parts = {"unet": (init_unet, ucfg, lambda n: TP.unet_heads(ucfg.attention_heads, n)),
             "vae": (init_vae, vcfg, lambda n: 1)}
    if model == "sd21":
        parts["clip"] = (init_clip_text, SD21_CLIP_TEXT, lambda n: SD21_CLIP_TEXT.num_heads)
    out = {}
    for part, (init, cfg, heads) in parts.items():
        tree = jax.eval_shape(lambda k: init(k, cfg), jax.random.key(0))
        for name, leaf in _flatten(tree).items():
            out[f"{part}.{name}"] = (tuple(leaf.shape), heads(name))
    return out


def jax_placed_spec(name: str, shape) -> P:
    """``shard_params_tp``'s spec for one leaf on a model axis of M."""
    spec = jax_spec(name, len(shape))
    if any(s == "model" and shape[d] % M for d, s in enumerate(spec)):
        return P()
    return spec


def as_jax_spec(split, ndim: int) -> P:
    if split is None:
        return P()
    if ndim == 1:
        return P("model")
    return P(None, "model") if split.dim == 0 else P("model", None)


@pytest.mark.parametrize("model", ["tiny", "sd21"])
def test_split_rules_match_jax(model):
    """tp_spec_for and the plan of M = 2 against JAX's ``_tp_spec_for`` as
    ``shard_params_tp`` places it, on every parameter name (torch layouts:
    2-D weights transposed). The one difference, deliberate: a layer whose
    heads two ranks do not divide stays whole (WHOLE: 40 UNet and 14 VAE
    names), where JAX splits its columns. The other, net.0.proj's matched
    halves, is in the same spec and is held in the next test."""
    names = jax_names(model)
    differ, split = set(), 0
    for name, (shape, heads) in names.items():
        port_shape = shape[::-1] if len(shape) == 2 and not name.endswith("embedding.weight") \
            else shape
        ours = TP.plan({name: port_shape}, lambda _: heads, M).get(name)
        split += ours is not None
        if as_jax_spec(ours, len(shape)) != jax_placed_spec(name, shape):
            differ.add(name)
            assert ours is None and jax_placed_spec(name, shape) != P(), name
    assert differ == {n for n in names if WHOLE.match(n)}
    assert len(differ) == 54
    # 11 split transformer blocks x 11 (q, k, v, out of two attentions;
    # net.0.proj's weight and bias, net.2), 5 x 3 at level 0 (the
    # feed-forward alone); SD2.1's 23 CLIP layers x 10 (q, k, v and fc1 with
    # their biases, out_proj, fc2)
    assert split == 11 * 11 + 5 * 3 + (23 * 10 if model == "sd21" else 0)


def test_shard_and_gather_round_trip():
    """shard_state and gather_state go between the one-process layout and
    the ranks' exactly (M = 2 and 4, the tiny UNet's every tensor); a
    rank's attention share is its heads' rows (to_q) and columns
    (to_out.0); its net.0.proj share is its hidden rows stacked on its
    gate rows, not JAX's contiguous block of the stacked matrix."""
    gen = torch.Generator().manual_seed(0)
    unet = UNet2DConditionModel(UNetConfig(**TINY_UNET))
    state = {k: torch.randn(v.shape, generator=gen) for k, v in unet.state_dict().items()}
    for m in (2, 4):
        splits = TP.unet_plan(unet, m)
        shares = [TP.shard_state(state, splits, m, r) for r in range(m)]
        back = TP.gather_state(shares, splits)
        assert back.keys() == state.keys()
        assert all(torch.equal(back[k], state[k]) for k in state)
        name = "up_blocks.1.attentions.0.transformer_blocks.0"
        q, out = state[f"{name}.attn1.to_q.weight"], state[f"{name}.attn1.to_out.0.weight"]
        w1 = state[f"{name}.ff.net.0.proj.weight"]
        inner = w1.shape[0] // 2
        for r, sh in enumerate(shares):
            rows = slice(r * 128 // m, (r + 1) * 128 // m)  # 4 heads of 32 at C = 128
            assert torch.equal(sh[f"{name}.attn1.to_q.weight"], q[rows])
            assert torch.equal(sh[f"{name}.attn1.to_out.0.weight"], out[:, rows])
            hid = slice(r * inner // m, (r + 1) * inner // m)
            gate = slice(inner + r * inner // m, inner + (r + 1) * inner // m)
            assert torch.equal(sh[f"{name}.ff.net.0.proj.weight"],
                               torch.cat([w1[hid], w1[gate]]))
            assert not torch.equal(sh[f"{name}.ff.net.0.proj.weight"], w1.chunk(m)[r])
        # level 0's one head stays whole
        assert "down_blocks.0.attentions.0.transformer_blocks.0.attn1.to_q.weight" not in splits
        assert "down_blocks.0.attentions.0.transformer_blocks.0.ff.net.2.weight" in splits


def test_modules_not_split_are_refused_where_the_rules_would_split(monkeypatch):
    """Under a model group of two, only the UNet is split: the VAE (its
    attention one head) passes, and a module that the name rules would
    split (a CLIP-like MLP, fc1/fc2) raises rather than run unsplit."""
    from genpercept_tpu_torch import parallel
    from genpercept_tpu_torch.models import AutoencoderKL, VAEConfig

    monkeypatch.setattr(parallel, "model_world", lambda: M)
    TP.check_carried(AutoencoderKL(VAEConfig(**TINY_VAE)), "vae")
    mlp = torch.nn.Module()
    mlp.fc1, mlp.fc2 = torch.nn.Linear(8, 32), torch.nn.Linear(32, 8)
    with pytest.raises(NotImplementedError, match="UNet's attention and GEGLU layers only"):
        TP.check_carried(mlp, "text_encoder")


# ------------------------------------------------------------- the ranks


def recipe(root, data, max_iter: int, micro: int, save: bool = False, **model) -> str:
    """tests/test_torch_parallel.py's recipe (an effective batch of 4, f32,
    mse and gradient losses, no warmup, no augmentation), remat by blocks,
    validation at step 1 and, with ``save``, a `latest` checkpoint every
    step; ``model`` adds recipe keys (a DPT head, LoRA)."""
    cfg = {
        "mode": "depth",
        "pipeline": {"name": "GenPerceptPipeline", "kwargs": {"mode": "depth"}},
        "depth_normalization": {"type": "scale_shift_depth", "clip": True, "norm_min": -1.0,
                                "norm_max": 1.0, "min_max_quantile": 0.02},
        "dataloader": {"effective_batch_size": 4, "max_train_batch_size": micro},
        "dataset": {"train": {"name": "nyu_v2", "dir": "nyu", "filenames": data["train"],
                              "eigen_valid_mask": False},
                    "val": [{"name": "nyu_v2", "dir": "nyu", "filenames": data["val"],
                             "eigen_valid_mask": False}]},
        "trainer": {"init_seed": 7, "save_period": int(save),
                    "validation_period": 0 if model else 1, "visualization_period": 0},
        "max_iter": max_iter,
        "loss": {"customized_loss": True, "name": ["mse_loss", "grad_loss"]},
        "lr": 1e-4,
        "lr_scheduler": {"name": "IterExponential",
                         "kwargs": {"total_iter_length": 100, "final_ratio": 0.01,
                                    "warmup_steps": 0}},
        "model": {"remat_unet": True, "remat_granularity": "block", **model},
    }
    path = root / f"recipe_{max_iter}_{micro}_{int(save)}_{'_'.join(model)}.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


STEP = dict(fix_timesteps=1, lr=1e-4, lr_warmup_steps=0)
CONFIGS = {"f32": (dict(loss_names=("mse", "grad"), remat_unet=True, **STEP), torch.float32),
           "bf16": (dict(loss_names=("mse", "grad"), remat_unet=True,
                         compute_dtype=torch.bfloat16, **STEP), torch.float32),
           "latent": (dict(loss_names=("latent_mse",), **STEP), torch.float32)}


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """The tiny models: JAX trees (test_torch_train's seeds) and the port's
    state dicts in a file the ranks read."""
    ucfg, vcfg = JUNetConfig(**TINY_UNET), JVAEConfig(**TINY_VAE)
    unet_p = numpy_params(init_unet, ucfg, seed=20)
    vae_p = numpy_params(init_vae, vcfg, seed=21)
    embed = np.random.default_rng(22).normal(size=(1, 77, 48)).astype(np.float32)
    path = tmp_path_factory.mktemp("tiny") / "models.pt"
    torch.save({"unet_cfg": TINY_UNET, "vae_cfg": TINY_VAE, "unet": state_dict_from_jax(unet_p),
                "vae": state_dict_from_jax(vae_p), "embed": torch.from_numpy(embed)}, path)
    jmodels = JModels(unet=unet_p, vae=vae_p, unet_cfg=ucfg, vae_cfg=vcfg,
                      text_embed=jax.numpy.asarray(embed))
    return str(path), jmodels


def torch_batch():
    return {k: torch.from_numpy(np.asarray(v)) for k, v in make_batch().items()}


@pytest.fixture(scope="module")
def runs(ckpts, tiny, tmp_path_factory):  # noqa: F811
    """One process's CLI runs (P1: one step, P2: two, a DPT head, LoRA),
    then a spawn of two ranks (f and g; the steps of CONFIGS; the CLI at
    --model_parallel 2: T1 one step, T2 resumed from P1's checkpoint to
    step 2, a DPT head, LoRA) and one of four (data 2 x model 2, with and
    without --zero1); then one process resumes T1 to step 2 (R2) and the
    export CLI writes T1's and P1's checkpoints. The runs' files go once the
    module's tests are done."""
    root = tmp_path_factory.mktemp("tp")
    data = {"train": write_nyu(root, 8, 80, "train"), "val": write_nyu(root, 2, 81, "val")}
    plain, dpt = str(ckpts["plain"][0]), str(ckpts["dpt_identity"][0])

    def argv(name, steps, micro=2, ckpt=plain, save=False, **model):
        return ["--config", recipe(root, data, steps, micro, save, **model), "--checkpoint",
                ckpt, "--base_data_dir", str(root), "--output_dir", str(root / name)]

    jobs = {"P1": argv("P1", 1, save=True), "P2": argv("P2", 2), "Pdpt": argv("Pdpt", 1, ckpt=dpt),
            "Plora": argv("Plora", 1, unet_lora_rank=2)}
    for a in jobs.values():
        port_train.main([*a, "--device", "cpu"])
    shutil.copytree(root / "P1" / "checkpoint", root / "T2" / "checkpoint")
    tp = ["--model_parallel", str(M)]
    two = [argv("T1", 1, save=True) + tp, argv("T2", 2) + tp + ["--resume_run", "latest"],
           argv("Tdpt", 1, ckpt=dpt) + tp, argv("Tlora", 1, unet_lora_rank=2) + tp]
    spec = {"fg": (free_port(), str(root / "fg")),
            "steps": (free_port(), {"models": tiny[0], "batch": torch_batch(),
                                    "configs": CONFIGS, "out": str(root / "step")}),
            "jobs": [(a, free_port()) for a in two]}
    mp.spawn(W.ranks, args=(2, spec), nprocs=2, join=True)
    four = [argv("Q", 1, micro=1) + tp, argv("Qz", 1, micro=1) + tp + ["--zero1"]]
    mp.spawn(W.ranks, args=(4, {"jobs": [(a, free_port()) for a in four]}), nprocs=4,
             join=True)
    shutil.copytree(root / "T1" / "checkpoint", root / "R2" / "checkpoint")
    port_train.main([*argv("R2", 2), "--resume_run", "latest", "--device", "cpu"])
    for run in ("T1", "P1"):
        port_export.main(["--run_dir", str(root / run), "--base_checkpoint", plain, "--name",
                          "final", "--output_dir", str(root / f"E{run}"), "--device", "cpu"])
    yield root
    shutil.rmtree(root, ignore_errors=True)


def rank_file(runs, name, r):
    return torch.load(runs / f"step.{name}.rank{r}.pt")


def rel_l2(a: dict, b: dict, keys=None) -> float:
    keys = list(b) if keys is None else keys
    num = sum(float((a[k].double() - b[k].double()).pow(2).sum()) for k in keys)
    den = sum(float(b[k].double().pow(2).sum()) for k in keys)
    return math.sqrt(num / den)


def moving(grads: dict) -> list:
    """The parameters whose gradient reaches 1e-6 of the largest (a bias
    before a GroupNorm has a gradient of rounding noise alone)."""
    top = max(float(g.abs().max()) for g in grads.values())
    return [k for k, g in grads.items() if float(g.abs().max()) >= 1e-6 * top]


def test_f_and_g_on_two_ranks(runs):
    """g: the ranks' parts summed and the bias added once forward
    (x (r + 1) over r = 0, 1 is 3x, exactly), the gradient passed as it is
    backward; f: x as it is forward, the ranks' gradients summed backward
    (1 + 2 on every element)."""
    x = torch.arange(6.0).reshape(2, 3)
    for r in range(M):
        got = torch.load(runs / f"fg.rank{r}.pt")
        assert torch.equal(got["y"], 3 * x + torch.tensor([1.0, 2.0, 3.0]))
        assert torch.equal(got["g_grad"], torch.full((2, 3), 2.0))
        assert torch.equal(got["z"], x * (r + 1))
        assert torch.equal(got["f_grad"], torch.full((2, 3), 3.0))


def test_two_ranks_equal_one_process_step_f32(runs, tiny):
    """One f32 step (mse + gradient losses, remat of the whole UNet) on a
    model group of two against one process and against the split emulated
    in one process (``tensor.emulated(2)``: the same shares, their partial
    products summed in order). Bars from readings: the loss to 1e-6
    relative (read 7.9e-8); the gathered gradient to 5e-5 global relative
    L2 of one process's (read 9.8e-6; the emulated split reads 9.7e-6:
    the row-parallel sums' rounding, which the random-weight backward
    amplifies) and to 1e-5 of the emulated split's (read 0.0: the emulation
    sums what a rank sums, each share's input gradients at its own f first);
    the update to 1e-4 (read 1.8e-6). Every split layer of the
    plan was split (136 tensors); the ranks' replicated gradients before
    the reduction are equal bit for bit, as f and g make them, and so are
    their replicated parameters after the step."""
    kw, dt = CONFIGS["f32"]
    one = W.run_step(tiny[0], kw, torch_batch(), dt)
    with TP.emulated(M):
        emu = W.run_step(tiny[0], kw, torch_batch(), dt)
    r0, r1 = rank_file(runs, "f32", 0), rank_file(runs, "f32", 1)
    assert len(r0["split"]) == 136 and r0["split"] == r1["split"]
    np.testing.assert_allclose(r0["metrics"]["loss"], one["metrics"]["loss"], rtol=1e-6)
    keep = moving(one["grads"])
    assert len(keep) > 0.9 * len(one["grads"])
    print("f32 step", rel_l2(r0["grads"], one["grads"], keep),
          rel_l2(emu["grads"], one["grads"], keep), rel_l2(r0["grads"], emu["grads"], keep))
    assert rel_l2(r0["grads"], one["grads"], keep) <= 5e-5
    assert rel_l2(r0["grads"], emu["grads"], keep) <= 1e-5
    assert rel_l2({k: r0["params"][k] for k in keep}, {k: one["params"][k] for k in keep}) <= 1e-4
    for k in r0["replicated_pre"]:
        assert torch.equal(r0["replicated_pre"][k], r1["replicated_pre"][k]), k
    assert r1["params"].keys() == r0["replicated_pre"].keys()
    for k in r1["params"]:
        assert torch.equal(r0["params"][k], r1["params"][k]), k


def test_two_ranks_bf16_within_one_process_distance_to_f32(runs, tiny):
    """bf16 compute: a rank rounds its row-parallel partial products to
    bf16, the model group sums them in f32 and rounds once after the bias
    (one process rounds the product once and the bias add once). The
    gathered gradient's distance to the f32 one-process gradient within
    1.2x the one-process bf16 gradient's (read 0.444 against 0.475), as
    chip_smoke.py holds the card's; the loss within 1e-2 of one process's
    bf16 loss (read 5.1e-4)."""
    one32 = W.run_step(tiny[0], CONFIGS["f32"][0], torch_batch(), CONFIGS["f32"][1])
    one16 = W.run_step(tiny[0], CONFIGS["bf16"][0], torch_batch(), CONFIGS["bf16"][1])
    r0 = rank_file(runs, "bf16", 0)
    keep = moving(one32["grads"])
    np.testing.assert_allclose(r0["metrics"]["loss"], one16["metrics"]["loss"], rtol=1e-2)
    assert rel_l2(r0["grads"], one32["grads"], keep) <= \
        1.2 * rel_l2(one16["grads"], one32["grads"], keep)


@pytest.fixture(scope="module")
def jax_tp_step(tiny):
    """JAX's own training step (latent mse, f32) jitted on a (1, 2) mesh,
    the trees placed by ``shard_params_tp``, as tests/test_train.py's
    sharded step: the loss, Adam's first moment and the updated
    parameters, in the port's names and layouts."""
    jmodels = tiny[1]
    mesh = make_mesh(data=1, model=M, devices=jax.devices()[:M])
    cfg = JT.TrainConfig(loss_names=("latent_mse",), fix_timesteps=1, lr=1e-4, lr_warmup_steps=0)
    trainable, frozen, tx, opt_state = JT.init_train_state(jmodels.params(), cfg)
    trainable, frozen = shard_params_tp(trainable, mesh), shard_params_tp(frozen, mesh)
    batch = jax.device_put({k: jax.numpy.asarray(v) for k, v in make_batch().items()},
                           batch_sharding(mesh))
    step = jax.jit(JT.build_train_step(cfg, jmodels, tx))
    new, state, metrics = step(trainable, frozen, opt_state, batch, jax.random.key(0))

    def port(tree):
        return {f"unet.{k}": v for k, v in state_dict_from_jax(
            jax.tree.map(lambda x: np.asarray(x, np.float32), tree["unet"])).items()}

    return float(metrics["loss"]), port(state[0].mu), port(new)


def test_two_ranks_match_jax_sharded_step(runs, jax_tp_step):
    """The model group's step against JAX's on the (1, 2) mesh, at
    tests/test_torch_train.py's bars: the loss to 1e-5 relative (read
    2.6e-7), the first moment (0.1 g) to 1e-4 global relative L2 (read
    2.0e-5) and each moving parameter's to 1e-3 relative L2 (read 6.0e-5 at
    worst); the updated parameters to 1e-3 global relative L2 (read 3.2e-6;
    Adam's first step, lr g / (|g| + eps), moves where |g| is near the
    frameworks' rounding gaps)."""
    loss, mu, params = jax_tp_step
    r0 = rank_file(runs, "latent", 0)
    ours, theirs = r0["mu"], mu
    np.testing.assert_allclose(r0["metrics"]["loss"], loss, rtol=1e-5)
    assert ours.keys() == theirs.keys()
    keep = moving(theirs)
    assert rel_l2(ours, theirs, keep) <= 1e-4
    worst = max(rel_l2({k: ours[k]}, {k: theirs[k]}) for k in keep)
    assert worst <= 1e-3, worst
    assert rel_l2({k: r0["params"][k] for k in keep}, {k: params[k] for k in keep}) <= 1e-3


# ----------------------------------------------------------------- the CLI


def state(runs, run, name="final"):
    return load_train_checkpoint(str(runs / run / "checkpoint"), name)


def losses(runs, run) -> list:
    return [(r["step"], r["train/loss"]) for r in map(
        yaml.safe_load, (runs / run / "metrics.jsonl").read_text().splitlines())
        if "train/loss" in r]


def initial(ckpt, lora_rank=None) -> dict:
    """A run's trainable parameters before its first step: the checkpoint's
    UNet (and DPT head), or LoRA adapters drawn as the Trainer draws them
    (its generator seeded with the recipe's init_seed, 7)."""
    from genpercept_tpu_torch.io.checkpoints import load_genpercept_checkpoint
    from genpercept_tpu_torch.train.lora import init_lora

    models = load_genpercept_checkpoint(str(ckpt), device="cpu")
    if lora_rank:
        return {f"unet_lora.{k}": v for k, v in init_lora(
            torch.Generator().manual_seed(7), models.unet, lora_rank).items()}
    out = {f"unet.{k}": v for k, v in models.unet.state_dict().items()}
    if models.dpt_head is not None:
        out.update({f"dpt_head.{k}": v for k, v in models.dpt_head.state_dict().items()})
    return out


def close_to(a: dict, b: dict, base: dict, readings: list, grad_bar=1e-4, update_bar=1e-2):
    """Two runs' checkpoints: the first moments (0.1 g) within ``grad_bar``
    and the parameters' updates (from ``base``) within ``update_bar``
    global relative L2, over the parameters whose moment reaches 1e-6 of
    the largest, as tests/test_torch_parallel.py holds data parallelism.
    The two readings are appended to ``readings``."""
    names = list(b["trainable"])
    assert list(a["trainable"]) == names
    mu_a = {names[i]: st["mu"] for i, st in a["opt_state"]["state"].items()}
    mu_b = {names[i]: st["mu"] for i, st in b["opt_state"]["state"].items()}
    keep = moving(mu_b)
    assert len(keep) > 0.4 * len(names)  # LoRA's A takes no gradient while B is 0
    readings.append((rel_l2(mu_a, mu_b, keep),
                     rel_l2({k: a["trainable"][k] - base[k] for k in keep},
                            {k: b["trainable"][k] - base[k] for k in keep})))
    assert readings[-1][0] <= grad_bar
    assert readings[-1][1] <= update_bar


def test_cli_model_group_equals_one_process(runs, ckpts):  # noqa: F811
    """T1 (--model_parallel 2, one model group, remat by blocks, validation
    at step 1 on both ranks, rank 0 writing) against P1 (one process, the
    same micro-batches): the loss to 1e-6 relative (read 7.6e-8), the first
    moments to 1e-4 and the update to 1e-2 global relative L2 (reads 1.4e-5
    and 1.7e-3: Adam's first step, lr g / (|g| + eps), moves by up to 2 lr
    where |g| lies within the splits' rounding of 0); the checkpoint whole,
    in the one-process layout, with
    every moment; the ranks' own parameters are their shares of it, exactly,
    and replicated ones equal."""
    (s1, l1), = losses(runs, "T1")
    (s0, l0), = losses(runs, "P1")
    assert s1 == s0 == 1
    np.testing.assert_allclose(l1, l0, rtol=1e-6)
    t1, p1 = state(runs, "T1"), state(runs, "P1")
    assert {k: v.shape for k, v in t1["trainable"].items()} == \
        {k: v.shape for k, v in p1["trainable"].items()}
    assert len(t1["opt_state"]["state"]) == len(t1["trainable"])
    read = []
    close_to(t1, p1, initial(ckpts["plain"][0]), read)
    print("T1 vs P1", abs(l1 - l0) / abs(l0), read)
    log = [yaml.safe_load(x) for x in (runs / "T1" / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in log if "val/nyu_v2/abs_relative_difference" in r] == [1]
    unet = UNet2DConditionModel(UNetConfig(**TINY_UNET))
    splits = {f"unet.{k}": v for k, v in TP.unet_plan(unet, M).items()}
    whole = t1["trainable"]
    for r in range(M):
        own = torch.load(runs / "T1" / f"rank{r}_job0.pt")
        want = TP.shard_state(whole, splits, M, r)
        for k in whole:
            assert torch.equal(own[k], want[k]), (r, k)


def test_cli_resumes_across_layouts(runs, ckpts):  # noqa: F811
    """T2: the model group resumed from one process's checkpoint (P1's
    `latest`) to step 2; R2: one process resumed from the model group's
    (T1's) to step 2; both against P2 (one process, two steps straight).
    T2's step 2 is one process's but for the splits' rounding: the loss to
    1e-6 relative (read 0.0), the moments to 1e-4 and the update to 1e-2
    global relative L2 (read 7.3e-6, 1.4e-5). R2's step 2 starts from T1's
    parameters, which Adam's first step moved 1.7e-3 apart from P1's (the
    test above), so its gradient is taken elsewhere: the loss to 1e-6
    (read 3.0e-7), the moments to 1e-3 (read 2.0e-4), the update to
    1e-2 (read 1.2e-3)."""
    (_, l2), = [x for x in losses(runs, "P2") if x[0] == 2]
    p2 = state(runs, "P2")
    for run, grad_bar in (("T2", 1e-4), ("R2", 1e-3)):
        (_, l), = [x for x in losses(runs, run) if x[0] == 2]
        np.testing.assert_allclose(l, l2, rtol=1e-6, err_msg=run)
        assert "resumed at iter 1" in (runs / run / "logging.log").read_text()
        read = []
        close_to(state(runs, run), p2, initial(ckpts["plain"][0]), read, grad_bar=grad_bar)
        print(run, "vs P2", abs(l - l2) / abs(l2), read)


def test_cli_export_of_a_model_group_run(runs):
    """cli/export.py reads the model group's checkpoint unchanged: the
    exported UNet is its trained tensors exactly, and P1's export differs
    from it by the splits' rounding alone (1e-4 relative L2 over the
    tensors that differ, read 5.8e-6)."""
    t = load_safetensors(str(runs / "ET1" / "unet" / "diffusion_pytorch_model.safetensors"))
    p = load_safetensors(str(runs / "EP1" / "unet" / "diffusion_pytorch_model.safetensors"))
    trained = state(runs, "T1")["trainable"]
    assert t.keys() == p.keys() == {k[len("unet."):] for k in trained}
    for k, v in trained.items():
        assert torch.equal(t[k[len("unet."):]], v.to(t[k[len("unet."):]].dtype)), k
    moved = [k for k in t if not torch.equal(t[k], p[k])]
    print("export", rel_l2(t, p, moved))
    assert rel_l2(t, p, moved) <= 1e-4


def test_cli_four_ranks_equal_one_process(runs, ckpts):  # noqa: F811
    """Q: data 2 x model 2 (one image a data index, the global micro-batch
    of two), against P1 at the data-parallel bars (the loss to 1e-6, read
    1.5e-7; the moments to 1e-4, read 4.1e-5; the update to 1e-2, read
    3.8e-3: the batch split's rounding beside the tensor split's); Qz
    (--zero1: the moments
    sharded over each data group) equal to Q exactly. The ranks of a data
    group hold the same shares, the replicated parameters are equal on all
    four, and each rank's shares are its model index's share of the
    checkpoint."""
    (_, lq), = losses(runs, "Q")
    (_, l0), = losses(runs, "P1")
    np.testing.assert_allclose(lq, l0, rtol=1e-6)
    q, qz = state(runs, "Q"), state(runs, "Qz")
    read = []
    close_to(q, state(runs, "P1"), initial(ckpts["plain"][0]), read)
    print("Q vs P1", abs(lq - l0) / abs(l0), read)
    for k, v in q["trainable"].items():
        assert torch.equal(qz["trainable"][k], v), k
    unet = UNet2DConditionModel(UNetConfig(**TINY_UNET))
    splits = {f"unet.{k}": v for k, v in TP.unet_plan(unet, M).items()}
    for run, job in (("Q", 0), ("Qz", 1)):
        whole = state(runs, run)["trainable"]
        for r in range(4):
            own = torch.load(runs / run / f"rank{r}_job{job}.pt")
            want = TP.shard_state(whole, splits, M, r % M)
            for k in whole:
                assert torch.equal(own[k], want[k]), (run, r, k)
    assert len(qz["opt_state"]["state"]) == len(qz["trainable"])


@pytest.mark.parametrize("run", ["dpt", "lora"])
def test_cli_dpt_head_and_lora_recipes(runs, ckpts, run):  # noqa: F811
    """A DPT-head run (the head replicated, trained beside the split UNet)
    and a LoRA run (the adapters replicated, each merge sliced to the
    rank's share of the frozen base) on a model group of two against one
    process: the loss to 1e-6 relative, the moments and updates at the
    data-parallel bars (reads: DPT head 0.0, 1.1e-6, 2.7e-5; LoRA 7.6e-8,
    1.3e-5, 3.3e-4); the trainable names (dpt_head.*, unet_lora.*) the one
    process's."""
    (_, lt), = losses(runs, f"T{run}")
    (_, lp), = losses(runs, f"P{run}")
    np.testing.assert_allclose(lt, lp, rtol=1e-6)
    t, p = state(runs, f"T{run}"), state(runs, f"P{run}")
    prefix = "dpt_head." if run == "dpt" else "unet_lora."
    assert any(k.startswith(prefix) for k in t["trainable"])
    read = []
    close_to(t, p, initial(ckpts["dpt_identity" if run == "dpt" else "plain"][0],
                           None if run == "dpt" else 2), read)
    print(run, abs(lt - lp) / abs(lp), read)
