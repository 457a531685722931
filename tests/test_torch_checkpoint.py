"""The port's safetensors reader and writer and its checkpoint loader, held
to the ``safetensors`` package and to the JAX loader.

The checkpoints are tiny published-layout directories that the JAX side
writes (``genpercept_tpu.io.weights.save_safetensors`` of
``to_torch_state_dict``), as tests/test_cli_end_to_end.py builds them, with
values from numpy seeds. Both loaders read the same directory; the port's
state dicts must equal the JAX trees moved with ``state_dict_from_jax``
exactly (the same f32 values, transposed twice).
"""

import ast
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import ml_dtypes
import numpy as np
import pytest
import torch
from safetensors import safe_open

from genpercept_tpu.io.checkpoints import load_genpercept_checkpoint as jax_load
from genpercept_tpu.io.weights import save_safetensors as jax_save
from genpercept_tpu.io.weights import to_torch_state_dict
from genpercept_tpu.models import DPTHeadConfig as JDPTConfig
from genpercept_tpu.models import UNetConfig as JUNetConfig
from genpercept_tpu.models import VAEConfig as JVAEConfig
from genpercept_tpu.models import init_dpt_head, init_unet, init_vae
from genpercept_tpu_torch.io import state_dict_from_jax
from genpercept_tpu_torch.io.checkpoints import load_genpercept_checkpoint
from genpercept_tpu_torch.io.weights import load_safetensors, save_safetensors
from test_torch_models import numpy_params

REPO = Path(__file__).resolve().parent.parent
TINY_UNET = dict(block_out_channels=(32, 64, 128, 128), attention_heads=(1, 2, 4, 4),
                 cross_attention_dim=48)
TINY_VAE = dict(block_out_channels=(32, 32, 64, 64))
TINY_DPT = dict(neck_hidden_sizes=(32, 64, 128, 128), fusion_hidden_size=32)
UNUSED = "neck.fusion_stage.layers.0.residual_layer1."


def unet_config_json(cfg):
    return {"in_channels": cfg.in_channels, "out_channels": cfg.out_channels,
            "block_out_channels": list(cfg.block_out_channels),
            "layers_per_block": cfg.layers_per_block,
            "attention_head_dim": list(cfg.attention_heads),
            "cross_attention_dim": cfg.cross_attention_dim,
            "down_block_types": ["CrossAttnDownBlock2D"] * 3 + ["DownBlock2D"],
            "norm_eps": cfg.norm_eps}


def write_part(dirpath: Path, tree, name="diffusion_pytorch_model.safetensors", config=None,
               prefix="", extra=None):
    dirpath.mkdir(parents=True)
    state = to_torch_state_dict(tree, add_prefix=prefix)
    state.update(extra or {})
    jax_save(state, str(dirpath / name))
    if config is not None:
        (dirpath / "config.json").write_text(json.dumps(config))


def unused_residual(seed: int, f: int) -> dict:
    """The weights of transformers' unused fusion residual unit that published
    DPT heads carry."""
    rng = np.random.default_rng(seed)
    return {f"{UNUSED}convolution{i}.{k}": rng.normal(size=s).astype(np.float32)
            for i in (1, 2) for k, s in (("weight", (f, f, 3, 3)), ("bias", (f,)))}


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """Six layouts: plain diffusers; DPT identity head (unet/ with conv_out,
    the head with the unused unit, a dpt_head/ beside it that loses); a
    general DPT head alone; unet-only over a base; no unet over a base
    (frozen-unet fallback); decoder and post_quant_conv overrides."""
    root = tmp_path_factory.mktemp("ckpts")
    ucfg, vcfg = JUNetConfig(**TINY_UNET), JVAEConfig(**TINY_VAE)
    embed = np.random.default_rng(9).normal(size=(1, 77, 48)).astype(np.float32)
    unet = numpy_params(init_unet, ucfg, seed=0)
    vae = numpy_params(init_vae, vcfg, seed=1)
    vae_json = {"block_out_channels": list(vcfg.block_out_channels),
                "latent_channels": 4, "scaling_factor": 0.18215}

    plain = root / "plain"
    write_part(plain / "unet", unet, config=unet_config_json(ucfg))
    write_part(plain / "vae", vae, config=vae_json)
    np.save(plain / "empty_text_embed.npy", embed)

    dcfg = JDPTConfig(**TINY_DPT)
    head_json = {"neck_hidden_sizes": list(dcfg.neck_hidden_sizes),
                 "fusion_hidden_size": dcfg.fusion_hidden_size,
                 "add_projection": True, "head_in_index": -1}
    dpt, general = root / "dpt", root / "dpt_general"
    for d in (dpt, general):
        d.mkdir()
        os.symlink(plain / "unet", d / "unet")
        os.symlink(plain / "vae", d / "vae")
        np.save(d / "empty_text_embed.npy", embed)
    write_part(dpt / "dpt_head_identity", numpy_params(init_dpt_head, dcfg, seed=2),
               name="model.safetensors", config=head_json,
               extra=unused_residual(3, dcfg.fusion_hidden_size))
    for d, seed in ((dpt, 6), (general, 7)):
        write_part(d / "dpt_head", numpy_params(init_dpt_head, dcfg, seed=seed),
                   name="model.safetensors", config=head_json,
                   extra=unused_residual(seed, dcfg.fusion_hidden_size))

    unet_only = root / "models" / "unet_depth_v2"
    write_part(unet_only, numpy_params(init_unet, ucfg, seed=4))

    frozen = root / "frozen"
    frozen.mkdir()
    np.save(frozen / "empty_text_embed.npy", embed)

    over = root / "override"
    over.mkdir()
    os.symlink(plain / "unet", over / "unet")
    os.symlink(plain / "vae", over / "vae")
    np.save(over / "empty_text_embed.npy", embed)
    vae2 = numpy_params(init_vae, vcfg, seed=5)
    write_part(over / "vae_decoder", {"decoder": vae2["decoder"]}, prefix="")
    write_part(over / "vae_post_quant_conv", vae2["post_quant_conv"])
    return {"plain": (plain, None), "dpt_identity": (dpt, None),
            "dpt_general": (general, None), "unet_only": (unet_only, plain),
            "frozen_unet": (frozen, plain), "vae_override": (over, None)}


def assert_same_params(module, jax_tree, dropped=()):
    ours = module.state_dict()
    ref = {k: v for k, v in state_dict_from_jax(jax_tree).items()
           if not k.startswith(tuple(dropped))}
    assert set(ours) == set(ref)
    for k, v in ours.items():
        np.testing.assert_array_equal(v.numpy(), ref[k].numpy(), err_msg=k)


def common_fields(a, b) -> dict:
    fa, fb = dataclasses.asdict(a), dataclasses.asdict(b)
    return {k: (fa[k], fb[k]) for k in fa.keys() & fb.keys()}


@pytest.mark.parametrize("layout", ["plain", "dpt_identity", "dpt_general", "unet_only",
                                    "frozen_unet", "vae_override"])
def test_loader_matches_jax(ckpts, layout):
    path, base = ckpts[layout]
    base = None if base is None else str(base)
    ref = jax_load(str(path), base_ckpt_dir=base)
    ours = load_genpercept_checkpoint(str(path), base_ckpt_dir=base, device="cpu")
    assert_same_params(ours.unet, ref.unet)
    assert_same_params(ours.vae, ref.vae)
    for k, (a, b) in common_fields(ours.unet.cfg, ref.unet_cfg).items():
        assert tuple(a) == tuple(b) if isinstance(a, (list, tuple)) else a == b, k
    assert ours.unet.cfg.with_conv_out == (not layout.startswith("dpt"))
    if ref.text_embed is None:  # the embedding is read from ckpt_dir only
        assert ours.text_embed is None
    else:
        np.testing.assert_array_equal(ours.text_embed.numpy(), np.asarray(ref.text_embed))
    assert ours.clip is None and ref.clip is None
    if layout.startswith("dpt"):
        assert_same_params(ours.dpt_head, ref.dpt_head, dropped=(UNUSED,))
        for k, (a, b) in common_fields(ours.dpt_cfg, ref.dpt_cfg).items():
            assert tuple(a) == tuple(b) if isinstance(a, (list, tuple)) else a == b, k
        assert ours.dpt_cfg.final_act == ("identity" if layout == "dpt_identity" else "relu")
    else:
        assert ours.dpt_head is None and ref.dpt_head is None


def test_loader_reads_a_text_encoder(tmp_path, monkeypatch):
    """text_encoder/: the published keys under ``text_model.`` (the prefix
    stripped, position_ids dropped) load into the port's CLIP as the JAX
    loader reads them. The
    loader builds SD2.1's text tower; a small one stands in for it here."""
    from genpercept_tpu.models.clip_text import CLIPTextConfig as JCLIPConfig
    from genpercept_tpu.models.clip_text import init_clip_text
    from genpercept_tpu_torch.io import checkpoints as tck
    from genpercept_tpu_torch.models.clip_text import CLIPTextConfig, CLIPTextModel

    kw = dict(vocab_size=300, hidden_size=64, num_layers=2, num_heads=4,
              intermediate_size=128)
    p = numpy_params(init_clip_text, JCLIPConfig(**kw), seed=8)
    root = tmp_path / "te"
    write_part(root / "text_encoder", p, name="model.safetensors", prefix="text_model.",
               extra={"text_model.embeddings.position_ids": np.arange(77)[None]})
    for sub, src in (("unet", init_unet), ("vae", init_vae)):
        cfg = JUNetConfig(**TINY_UNET) if sub == "unet" else JVAEConfig(**TINY_VAE)
        write_part(root / sub, numpy_params(src, cfg, seed=9),
                   config=unet_config_json(cfg) if sub == "unet" else
                   {"block_out_channels": list(cfg.block_out_channels)})
    monkeypatch.setattr(tck, "CLIPTextModel", lambda: CLIPTextModel(CLIPTextConfig(**kw)))
    ours = load_genpercept_checkpoint(str(root), device="cpu")
    ref = jax_load(str(root))
    ref_state = state_dict_from_jax(ref.clip)  # both below text_model.
    got = ours.clip.state_dict()
    assert set(got) == set(ref_state)
    for k, v in got.items():
        np.testing.assert_array_equal(v.numpy(), ref_state[k].numpy(), err_msg=k)
    assert ours.text_embed is None and ref.text_embed is None


def test_loader_casts_to_dtype(ckpts):
    models = load_genpercept_checkpoint(str(ckpts["plain"][0]), dtype=torch.bfloat16,
                                        device="cpu")
    params = [*models.unet.parameters(), *models.vae.parameters()]
    assert all(p.dtype == torch.bfloat16 for p in params)
    assert models.text_embed.dtype == torch.bfloat16


def test_loader_defaults_to_the_card(ckpts, monkeypatch):
    import inspect

    sig = inspect.signature(load_genpercept_checkpoint)
    assert sig.parameters["device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device"):
        load_genpercept_checkpoint(str(ckpts["plain"][0]))


def test_loader_names_missing_base(tmp_path):
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError, match="BASE_CKPT_DIR"):
        load_genpercept_checkpoint(str(tmp_path / "empty"), device="cpu")


# ------------------------------------------------------------- safetensors

def sample_arrays(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {
        "f32": rng.normal(size=(3, 5)).astype(np.float32),
        "f16": rng.normal(size=(4, 2, 3)).astype(np.float16),
        "bf16": rng.normal(size=(7,)).astype(ml_dtypes.bfloat16),
        "i64": rng.integers(-2 ** 40, 2 ** 40, size=(2, 3)),
        "scalar": np.float32(1.5).reshape(()),
        "empty": np.zeros((0, 4), np.float32),
        "text_model.embeddings.position_ids": np.arange(77)[None],
    }


def as_numpy(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def test_reader_matches_safe_open(tmp_path):
    """Files the JAX side writes (the safetensors package): every tensor equal,
    bit for bit, dtype for dtype; position_ids dropped."""
    path = str(tmp_path / "a.safetensors")
    jax_save(sample_arrays(0), path)
    ours = load_safetensors(path)
    with safe_open(path, framework="numpy") as f:
        keys = [k for k in f.keys() if not k.endswith("position_ids")]
        assert sorted(ours) == sorted(keys)
        for k in keys:
            ref = f.get_tensor(k)
            got = as_numpy(ours[k])
            assert got.dtype == ref.dtype and got.shape == ref.shape, k
            np.testing.assert_array_equal(got.view(np.uint8), ref.view(np.uint8), err_msg=k)


def test_writer_read_by_safe_open(tmp_path):
    path = str(tmp_path / "b.safetensors")
    arrays = sample_arrays(1)
    tensors = {k: torch.from_numpy(v.view(np.int16)).view(torch.bfloat16)
               if v.dtype == ml_dtypes.bfloat16 else torch.from_numpy(np.asarray(v))
               for k, v in arrays.items()}
    save_safetensors(tensors, path)
    with safe_open(path, framework="pt") as f:
        assert f.metadata() == {"format": "pt"}
        assert sorted(f.keys()) == sorted(tensors)
        for k, t in tensors.items():
            got = f.get_tensor(k)
            assert got.dtype == t.dtype and got.shape == t.shape, k
            assert torch.equal(got, t), k


def test_writer_takes_numpy_and_refuses_unknown_dtypes(tmp_path):
    path = str(tmp_path / "c.safetensors")
    save_safetensors({"a": np.arange(6, dtype=np.int64).reshape(2, 3)}, path)
    assert torch.equal(load_safetensors(path)["a"], torch.arange(6).reshape(2, 3))
    with pytest.raises(ValueError, match="dtype"):
        save_safetensors({"c": torch.zeros(2, dtype=torch.int32)}, path)
    jax_save({"i32": np.zeros(2, np.int32)}, path)
    with pytest.raises(ValueError, match="I32"):
        load_safetensors(path)


# ----------------------------------------------------- what the port imports

FORBIDDEN = ("jax", "jaxlib", "genpercept_tpu", "safetensors", "transformers", "diffusers",
             "pandas")
# cv2 only inside the function that decodes .exr files, as the JAX module
LAZY_CV2 = {"genpercept_tpu_torch/data/datasets.py": "_read_image"}


def imported(node) -> list:
    return ([a.name.split(".")[0] for a in node.names] if isinstance(node, ast.Import)
            else [(node.module or "").split(".")[0]] if isinstance(node, ast.ImportFrom) else [])


def test_port_imports_no_jax_safetensors_or_reference():
    """No module of the port (nor chip_smoke.py) imports jax, safetensors,
    transformers, diffusers, pandas or the JAX package, and cv2 only lazily
    where LAZY_CV2 says: statically, and in a fresh interpreter that imports
    every module of the port (which then holds none of them, nor cv2)."""
    files = [*(REPO / "genpercept_tpu_torch").rglob("*.py"), REPO / "chip_smoke.py"]
    cv2_at = set()
    for path in files:
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            for n in imported(node):
                assert n not in FORBIDDEN, f"{path}: imports {n}"
        for fn in ast.walk(tree):
            if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)) and any(
                    "cv2" in imported(n) for n in ast.walk(fn)):
                cv2_at.add((str(path.relative_to(REPO)), fn.name))
        top = [n for n in ast.walk(tree) if "cv2" in imported(n)]
        inside = sum("cv2" in imported(n) for fn in ast.walk(tree)
                     if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef))
                     for n in ast.walk(fn))
        assert len(top) == inside, f"{path}: imports cv2 outside a function"
    assert cv2_at == set(LAZY_CV2.items()), cv2_at
    modules = sorted(".".join(p.relative_to(REPO).with_suffix("").parts)
                     for p in (REPO / "genpercept_tpu_torch").rglob("*.py"))
    code = ("import importlib, sys\n"
            f"before = set(sys.modules)\n"
            f"for m in {modules!r}: importlib.import_module(m.removesuffix('.__init__'))\n"
            f"print(sorted({{m.split('.')[0] for m in set(sys.modules) - before}}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, check=True, timeout=300).stdout
    roots = set(ast.literal_eval(out.strip().splitlines()[-1]))
    assert "genpercept_tpu_torch" in roots
    assert not roots & {*FORBIDDEN, "cv2"}, roots & {*FORBIDDEN, "cv2"}


# ------------------------------------------- the golden's route, small width

def oracle_golden(seed: int, res: int) -> tuple:
    """The oracles at their files' own widths (seeds 0 and 1, as the golden)
    and their forward on a seeded input, as scripts/make_torch_golden.py's
    run_torch computes it (NHWC z and v)."""
    import chip_smoke

    unet, vae = chip_smoke.oracle_modules()
    rng = np.random.default_rng(seed)
    rgb = rng.uniform(size=(1, res, res, 3)).astype(np.float32)
    ctx = rng.normal(size=(1, 77, chip_smoke.oracle_namespace("unet")["CTX"])).astype(np.float32)
    with torch.no_grad():
        z = vae.encode(torch.from_numpy(rgb).permute(0, 3, 1, 2) * 2.0 - 1.0)
        v, _ = unet(z, torch.tensor([1]), torch.from_numpy(ctx))
        pred = (vae.decode(-v).mean(dim=1).clamp(-1.0, 1.0) + 1.0) / 2.0
    golden = {"rgb": rgb, "ctx": ctx, "z": z.permute(0, 2, 3, 1).numpy(),
              "v": v.permute(0, 2, 3, 1).numpy(), "pred": pred.numpy()}
    return unet, vae, golden


def test_oracle_checkpoint_matches_oracle_forward(tmp_path):
    """The golden's route at the oracles' small width (C=(32, 64, 96, 96)):
    their state dicts written as a checkpoint with the port's writer, loaded
    with the port's loader, run through build_single_infer; pred within 1e-4
    mean of the oracle's forward (tests/test_golden_768.py:63's bar)."""
    import chip_smoke

    unet, vae, golden = oracle_golden(51, 64)
    ckpt = chip_smoke.write_oracle_checkpoint(
        tmp_path / "ckpt", unet, vae, chip_smoke.oracle_namespace("unet"),
        chip_smoke.oracle_namespace("vae"), golden["ctx"])
    with safe_open(str(ckpt / "unet" / "diffusion_pytorch_model.safetensors"), "pt") as f:
        assert sorted(f.keys()) == sorted(unet.state_dict())
    models = load_genpercept_checkpoint(str(ckpt), device="cpu")
    assert models.unet.cfg.block_out_channels == (32, 64, 96, 96)
    assert models.unet.cfg.attention_heads == (1, 2, 3, 3)
    reading = chip_smoke.golden_reading(models, golden, torch.float32)
    assert reading["pred"]["mean"] <= 1e-4, reading
    # z and v: tests/test_unet_oracle.py's atol for the oracle's outputs
    assert reading["z"]["max"] <= 5e-4 and reading["v"]["max"] <= 5e-4, reading


def test_int8_on_a_dpt_checkpoint_runs(ckpts):
    """int8 on a DPT-head checkpoint, as the JAX pipeline runs it: the first
    batch calibrates the encoder and the UNet, no decoder runs so its group
    stays empty, and the next batch runs int8 (held to JAX by
    tests/test_torch_quant_gptq.py::test_dpt_int8_pipeline_matches_jax)."""
    from genpercept_tpu_torch.pipeline import GenPerceptPipeline, PipelineConfig

    models = load_genpercept_checkpoint(str(ckpts["dpt_identity"][0]), device="cpu")
    pipe = GenPerceptPipeline(models, PipelineConfig(mode="disparity_dpt_head", processing_res=64,
                                                     int8_vae=True, int8_unet=True),
                              device="cpu")
    images = [np.random.default_rng(i).uniform(size=(64, 64, 3)).astype(np.float32)
              for i in range(2)]
    first = pipe.batch(images, batch_size=2)
    assert pipe.vae_quant["dec"] == {} and pipe.vae_quant["enc"] and pipe.vae_quant["unet"]
    for out in first + pipe.batch(images, batch_size=2):
        assert out.pred_np.shape == (64, 64) and np.isfinite(out.pred_np).all()
