"""The port's DDIM archs (marigold, rgb_blending), fix_timesteps and test-time
ensembling held to the JAX package on tiny checkpoints.

Two published-layout checkpoints share a VAE and an embedding: a 4-channel
UNet (rgb_blending, genpercept) and an 8-channel one (marigold), written by
the JAX side with values from numpy seeds; each package loads them with its
own loader. The same images and the same noise (numpy seeds, JAX layout
(B, h/8, w/8, 4)) go into both; the port's own noise draw (a torch
generator) cannot equal ``jax.random``'s, so where the port draws, it is
held to its own forward on the drawn noise. The bar is the port pipeline
tests' (tests/test_torch_pipeline.py): mean abs deviation <= 1e-4.

Every JAX program here runs at one processing shape, 64x64, in batches of
E = 3 where an ensemble runs: the JAX pipeline compiles once per (config,
batch shape), which is most of this file's time, and the CLIs' runs find
the same programs in the test process's compilation cache.
"""

import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import chip_smoke
from genpercept_tpu.cli import run as jax_run
from genpercept_tpu.io.checkpoints import load_genpercept_checkpoint as jax_load
from genpercept_tpu.models import UNetConfig as JUNetConfig
from genpercept_tpu.models import VAEConfig as JVAEConfig
from genpercept_tpu.models import init_unet, init_vae
from genpercept_tpu.pipeline import GenPerceptPipeline as JPipeline
from genpercept_tpu.pipeline import PipelineConfig as JConfig
from genpercept_tpu.utils.cache import enable_compilation_cache
from genpercept_tpu_torch.cli import run as torch_run
from genpercept_tpu_torch.diffusion import SchedulerConfig
from genpercept_tpu_torch.io import state_dict_from_jax
from genpercept_tpu_torch.io.checkpoints import load_genpercept_checkpoint
from genpercept_tpu_torch.io.weights import save_safetensors
from genpercept_tpu_torch.pipeline import GenPerceptPipeline, PipelineConfig, build_single_infer
from genpercept_tpu_torch.pipeline import pipeline as tp_module
from test_torch_checkpoint import unet_config_json, write_part
from test_torch_cli import assert_outputs_match, files, read_png
from test_torch_models import numpy_params
from test_torch_pipeline import TINY_UNET, TINY_VAE

# one resnet per level (two in the tiny models elsewhere): the JAX programs
# unroll every UNet pass, and their compile time is this file's time
UNET = dict(TINY_UNET, layers_per_block=1)
VAE = dict(TINY_VAE, layers_per_block=1)

torch.set_num_threads(1)

MEAN_TOL = 1e-4
RES, STEPS, E = 64, 2, 3
LATENT = (RES // 8, RES // 8)


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """{"rgb": 4-channel UNet, "marigold": 8-channel UNet}, one VAE."""
    enable_compilation_cache()
    root = tmp_path_factory.mktemp("ddim_ckpts")
    embed = np.random.default_rng(2).normal(size=(1, 77, 48)).astype(np.float32)
    vcfg = JVAEConfig(**VAE)
    vae = numpy_params(init_vae, vcfg, seed=1)
    out = {}
    for name, in_channels, seed in (("rgb", 4, 0), ("marigold", 8, 3)):
        ucfg = JUNetConfig(in_channels=in_channels, **UNET)
        write_part(root / name / "unet", numpy_params(init_unet, ucfg, seed=seed),
                   config=unet_config_json(ucfg))
        write_part(root / name / "vae", vae,
                   config={"block_out_channels": list(vcfg.block_out_channels),
                           "layers_per_block": vcfg.layers_per_block,
                           "latent_channels": 4, "scaling_factor": 0.18215})
        np.save(root / name / "empty_text_embed.npy", embed)
        out[name] = root / name
    return out


def pipelines(ckpt: Path, dtype=torch.float32, **fields):
    """The JAX pipeline and the port's (on the CPU) on one checkpoint."""
    jpipe = JPipeline(jax_load(str(ckpt), "depth"), JConfig(processing_res=RES, **fields))
    tpipe = GenPerceptPipeline(load_genpercept_checkpoint(str(ckpt), dtype=dtype, device="cpu"),
                               PipelineConfig(processing_res=RES, dtype=dtype, **fields),
                               device="cpu")
    return jpipe, tpipe


def rgb_batch(seed: int, n: int = E) -> np.ndarray:
    return np.random.default_rng(seed).uniform(size=(n, RES, RES, 3)).astype(np.float32)


def noise_batch(seed: int, n: int = E) -> np.ndarray:
    return np.random.default_rng(seed).normal(size=(n,) + LATENT + (4,)).astype(np.float32)


def assert_close(ours, ref, tol=MEAN_TOL):
    ours, ref = np.asarray(ours), np.asarray(ref)
    assert ours.shape == ref.shape and np.isfinite(ours).all()
    dev = float(np.mean(np.abs(ours - ref)))
    assert dev <= tol, dev


# ------------------------------------------------------------------ marigold

@pytest.fixture(scope="module")
def marigold(ckpts):
    """The marigold pipelines and one JAX reference run: three images, each
    with its own noise, STEPS DDIM steps (the JAX ``_run`` of an E = 3
    ensemble's batch)."""
    jpipe, tpipe = pipelines(ckpts["marigold"], arch="marigold", denoising_steps=STEPS,
                             ensemble_size=E)
    rgb, noise = rgb_batch(3), noise_batch(4)
    ref = np.asarray(jpipe._run(jnp.asarray(rgb), jnp.asarray(noise)))
    return dict(jpipe=jpipe, tpipe=tpipe, rgb=rgb, noise=noise, ref=ref)


def test_marigold_single_infer_matches_jax(marigold):
    m = marigold
    tpipe = m["tpipe"]
    assert tpipe.models.unet.cfg.in_channels == 8
    ours = build_single_infer(tpipe.models, tpipe.cfg)(
        torch.from_numpy(m["rgb"]), noise=torch.from_numpy(m["noise"]))
    assert ours.dtype == torch.float32 and ours.shape == (E, RES, RES)
    for o, r in zip(ours.numpy(), m["ref"]):
        assert_close(o, r)


def test_run_with_noise_at_e3_matches_jax(marigold):
    m = marigold
    ours = m["tpipe"]._run(torch.from_numpy(m["rgb"]), torch.from_numpy(m["noise"]))
    for o, r in zip(ours.numpy(), m["ref"]):
        assert_close(o, r)
    # each member follows its own noise
    assert float(np.abs(m["ref"][0] - m["ref"][1]).mean()) > 10 * MEAN_TOL


def test_marigold_needs_noise(marigold):
    """As the JAX package asserts: no initial noise, no marigold forward,
    and so no marigold through .batch."""
    tpipe = marigold["tpipe"]
    with pytest.raises(ValueError, match="noise"):
        build_single_infer(tpipe.models, tpipe.cfg)(torch.from_numpy(marigold["rgb"][:1]))
    with pytest.raises(ValueError, match="noise"):
        tpipe.batch([(marigold["rgb"][0] * 255).astype(np.uint8)], batch_size=1)


def test_marigold_call_draws_from_the_generator(marigold, monkeypatch):
    """__call__ draws (E, h/8, w/8, 4) from the generator it is given (one
    seeded 0 without one) and runs the members in one batch; equal seeds
    give equal outputs, uncertainty included."""
    tpipe = marigold["tpipe"]
    image = (marigold["rgb"][0] * 255).astype(np.uint8)
    seen, run = [], tpipe._run
    monkeypatch.setattr(tpipe, "_run", lambda x, noise=None: seen.append((x, noise))
                        or run(x, noise))
    a = tpipe(image, generator=torch.Generator().manual_seed(5))
    b = tpipe(image, generator=torch.Generator().manual_seed(5))
    c = tpipe(image)
    d = tpipe(image, generator=torch.Generator().manual_seed(0))
    x, noise = seen[0]
    assert x.shape == (E, RES, RES, 3) and bool((x == x[:1]).all())
    torch.testing.assert_close(noise, torch.randn((E,) + LATENT + (4,),
                                                  generator=torch.Generator().manual_seed(5)),
                               rtol=0, atol=0)
    for p, q in ((a, b), (c, d)):
        np.testing.assert_array_equal(p.pred_np, q.pred_np)
        np.testing.assert_array_equal(p.uncertainty, q.uncertainty)
    assert float(np.abs(a.pred_np - c.pred_np).mean()) > 0.0
    assert a.pred_np.shape == a.uncertainty.shape == (RES, RES)
    assert a.pred_np.min() >= 0.0 and a.pred_np.max() <= 1.0
    assert np.isfinite(a.uncertainty).all() and a.uncertainty.min() >= 0.0


def test_marigold_one_member_draws_one_noise(ckpts, monkeypatch):
    """E = 1: one noise of (1, h/8, w/8, 4) at a non-square size, whose
    latent halves with the floor three times (64x51 -> 8x6); the output is
    resized back and carries no uncertainty."""
    _, tpipe = pipelines(ckpts["marigold"], arch="marigold", denoising_steps=STEPS)
    seen, run = [], tpipe._run
    monkeypatch.setattr(tpipe, "_run", lambda x, noise=None: seen.append(noise)
                        or run(x, noise))
    image = (np.random.default_rng(8).uniform(size=(100, 80, 3)) * 255).astype(np.uint8)
    out = tpipe(image, generator=torch.Generator().manual_seed(1))
    assert seen[0].shape == (1, 8, 6, 4)
    assert out.pred_np.shape == (100, 80) and out.uncertainty is None
    assert out.pred_colored.shape == (100, 80, 3)


# ------------------------------------------------------ rgb_blending, genpercept

@pytest.fixture(scope="module")
def blending(ckpts):
    return pipelines(ckpts["rgb"], arch="rgb_blending", denoising_steps=STEPS, ensemble_size=E)


def test_rgb_blending_single_infer_matches_jax(blending):
    """The noise that __call__ hands every arch at E > 1 is ignored here."""
    jpipe, tpipe = blending
    rgb, noise = rgb_batch(5), noise_batch(6)
    ref = np.asarray(jpipe._infer(jpipe._params, jnp.asarray(rgb), jnp.asarray(noise)))
    ours = build_single_infer(tpipe.models, tpipe.cfg)(torch.from_numpy(rgb),
                                                      noise=torch.from_numpy(noise))
    np.testing.assert_array_equal(
        ours.numpy(), build_single_infer(tpipe.models, tpipe.cfg)(torch.from_numpy(rgb)).numpy())
    for o, r in zip(ours.numpy(), ref):
        assert_close(o, r)


def test_rgb_blending_call_at_e3_matches_jax(blending):
    """rgb_blending starts from the rgb latent and ignores the noise, so the
    whole ensembled call is comparable: pred, uncertainty, colors."""
    jpipe, tpipe = blending
    image = (np.random.default_rng(6).uniform(size=(96, 96, 3)) * 255).astype(np.uint8)
    ref, ours = jpipe(image), tpipe(image)
    assert ours.pred_np.shape == ours.uncertainty.shape == (96, 96)
    assert_close(ours.pred_np, ref.pred_np)
    assert_close(ours.uncertainty, ref.uncertainty)
    diff = np.abs(ours.pred_colored.astype(int) - ref.pred_colored.astype(int))
    assert diff.max() <= 1


def test_genpercept_fix_timesteps_matches_jax(ckpts):
    """fix_timesteps reaches the genpercept arch's one UNet pass."""
    jpipe, tpipe = pipelines(ckpts["rgb"], fix_timesteps=500)
    rgb = rgb_batch(7, n=1)
    ref = np.asarray(jpipe._infer(jpipe._params, jnp.asarray(rgb), None))
    ours = build_single_infer(tpipe.models, tpipe.cfg)(torch.from_numpy(rgb))
    assert_close(ours.numpy(), ref)
    at_t1 = build_single_infer(tpipe.models, PipelineConfig(processing_res=RES))(
        torch.from_numpy(rgb))
    assert float((ours - at_t1).abs().mean()) > 10 * MEAN_TOL


@pytest.mark.parametrize("arch", ["marigold", "rgb_blending"])
def test_bf16_unet_inputs_and_decode_in_compute_dtype(ckpts, monkeypatch, arch):
    """The DDIM update runs in f32 and is cast back: every UNet pass and
    the decode see bf16, as the JAX package casts at :423-426."""
    seen = []
    for name in ("unet_apply", "vae_decode"):
        fn = getattr(tp_module, name)
        monkeypatch.setattr(tp_module, name,
                            lambda m, x, *a, _fn=fn, _n=name, **k: seen.append((_n, x.dtype,
                                                                                x.shape[1]))
                            or _fn(m, x, *a, **k))
    ckpt = ckpts["marigold" if arch == "marigold" else "rgb"]
    models = load_genpercept_checkpoint(str(ckpt), dtype=torch.bfloat16, device="cpu")
    cfg = PipelineConfig(arch=arch, denoising_steps=3, dtype=torch.bfloat16)
    pred = build_single_infer(models, cfg)(torch.from_numpy(rgb_batch(9, n=1)),
                                           noise=torch.from_numpy(noise_batch(10, n=1)))
    assert pred.dtype == torch.float32 and bool(torch.isfinite(pred).all())
    channels = 8 if arch == "marigold" else 4
    assert seen == [("unet_apply", torch.bfloat16, channels)] * 3 + \
        [("vae_decode", torch.bfloat16, 4)]


# ------------------------------------------------------------------- int8

def test_int8_marigold_calibrates_and_self_checks_with_noise(ckpts, monkeypatch):
    """W8A8 rides along: the calibrating batch's chunks (2 and 1 of 3
    images) each get their slice of the noise and return the full-precision
    prediction; the self-check forward runs with the noise; later batches
    run int8."""
    fields = dict(arch="marigold", denoising_steps=STEPS, int8_vae=True, int8_unet=True,
                  int8_unet_ff=True, int8_vae_attn=True, int8_refine=False)
    _, tpipe = pipelines(ckpts["marigold"], **fields)
    _, fp = pipelines(ckpts["marigold"], arch="marigold", denoising_steps=STEPS)
    rgb, noise = torch.from_numpy(rgb_batch(11)), torch.from_numpy(noise_batch(12))
    chunks, calib = [], tpipe._calib_infer
    monkeypatch.setattr(tpipe, "_calib_infer", lambda x, vq, n: chunks.append(
        (x.shape[0], n.shape[0])) or calib(x, vq, n))
    first = tpipe._run(rgb, noise)
    assert chunks == [(2, 2), (1, 1)]
    full = torch.cat([fp._run(rgb[:2], noise[:2]), fp._run(rgb[2:], noise[2:])])
    torch.testing.assert_close(first, full, rtol=0, atol=0)
    assert tpipe.calibrated and np.isfinite(tpipe.int8_mean_dev)
    second = tpipe._run(rgb, noise)
    assert bool(torch.isfinite(second).all())
    assert float((second - first).abs().mean()) == pytest.approx(tpipe.int8_mean_dev, rel=1e-6)


# -------------------------------------------------------------- checkpoint

def test_eight_channel_checkpoint_loads(ckpts, tmp_path):
    """conv_in's 8 input channels come from config.json's in_channels, from
    the JAX-written checkpoint and from one written by the port's writer;
    both hold the JAX loader's weights exactly."""
    ref = state_dict_from_jax(jax_load(str(ckpts["marigold"]), "depth").unet)
    models = load_genpercept_checkpoint(str(ckpts["marigold"]), device="cpu")
    assert models.unet.cfg.in_channels == 8
    assert models.unet.conv_in.weight.shape == (UNET["block_out_channels"][0], 8, 3, 3)
    state = models.unet.state_dict()
    for k, v in ref.items():
        torch.testing.assert_close(state[k], torch.as_tensor(np.asarray(v)), rtol=0, atol=0)

    root = tmp_path / "port_written"
    (root / "unet").mkdir(parents=True)
    save_safetensors(state, str(root / "unet" / "diffusion_pytorch_model.safetensors"))
    cfg = json.loads((ckpts["marigold"] / "unet" / "config.json").read_text())
    (root / "unet" / "config.json").write_text(json.dumps(cfg))
    (root / "vae").symlink_to(ckpts["marigold"] / "vae")
    (root / "empty_text_embed.npy").symlink_to(ckpts["marigold"] / "empty_text_embed.npy")
    again = load_genpercept_checkpoint(str(root), device="cpu")
    assert again.unet.cfg == models.unet.cfg
    for k, v in again.unet.state_dict().items():
        torch.testing.assert_close(v, state[k], rtol=0, atol=0)


# ------------------------------------------------------------------ CLI

@pytest.fixture(scope="module")
def image_dir(tmp_path_factory):
    """Two 64x64 images, one in a subfolder: one processing shape."""
    root = tmp_path_factory.mktemp("ddim_images")
    (root / "sub").mkdir()
    rng = np.random.default_rng(43)
    for path in (root / "a.png", root / "sub" / "b.png"):
        Image.fromarray((rng.uniform(size=(RES, RES, 3)) * 255).astype(np.uint8)).save(path)
    return root


def cli_argv(ckpt, image_dir, out_dir, *extra):
    return ["--checkpoint", str(ckpt), "--input_rgb_dir", str(image_dir),
            "--output_dir", str(out_dir), "--mode", "depth", "--processing_res", str(RES),
            *extra]


def test_cli_marigold_files_are_the_pipelines(ckpts, image_dir, tmp_path):
    """Every file, _uncert.npy included; each npy equal to the pipeline's
    __call__ with a generator seeded --seed on the decoded image."""
    extra = ["--archs", "marigold", "--denoise_steps", str(STEPS), "--ensemble_size", str(E),
             "--seed", "7", "--device", "cpu"]
    torch_run.main(cli_argv(ckpts["marigold"], image_dir, tmp_path, *extra))
    expect = {f"{d}{n}_pred{s}" for d, n in (("", "a"), ("sub/", "b"))
              for s in (".npy", ".png", "_colored.png", "_uncert.npy")}
    assert set(files(tmp_path)) == expect
    _, tpipe = pipelines(ckpts["marigold"], arch="marigold", denoising_steps=STEPS,
                         ensemble_size=E)
    for path, out_dir in ((image_dir / "a.png", tmp_path), (image_dir / "sub" / "b.png",
                                                            tmp_path / "sub")):
        direct = tpipe(read_png(path)[..., :3], generator=torch.Generator().manual_seed(7))
        assert chip_smoke.check_cli_outputs([path], out_dir, "depth", [direct]) == 0.0


def test_cli_rgb_blending_matches_jax(ckpts, image_dir, tmp_path):
    """rgb_blending with an ensemble: the port's files against the JAX
    CLI's, the uncertainty maps included."""
    extra = ["--archs", "rgb_blending", "--denoise_steps", str(STEPS), "--ensemble_size", str(E)]
    ours, ref = tmp_path / "ours", tmp_path / "ref"
    jax_run.main(cli_argv(ckpts["rgb"], image_dir, ref, *extra))
    torch_run.main(cli_argv(ckpts["rgb"], image_dir, ours, *extra, "--device", "cpu"))
    assert_outputs_match(ours, ref, "depth")
    uncert = [f for f in files(ref) if f.endswith("_uncert.npy")]
    assert len(uncert) == 2
    for f in uncert:
        assert_close(np.load(ours / f), np.load(ref / f))


# ------------------------------------------------------------------ config

def test_config_accepts_the_ddim_fields_as_jax():
    fields = dict(arch="marigold", denoising_steps=10, ensemble_size=3, fix_timesteps=301)
    cfg = PipelineConfig(**fields)
    assert all(getattr(cfg, k) == v for k, v in fields.items())
    assert cfg.scheduler == SchedulerConfig()
    assert JConfig(**fields).scheduler.__dict__ == cfg.scheduler.__dict__
    assert PipelineConfig().scheduler.beta_start == 1.0
    assert PipelineConfig(int8_gptq=True).int8_gptq  # as JAX takes it


@pytest.mark.parametrize("fields", [dict(denoising_steps=2), dict(ensemble_size=3)])
def test_genpercept_arch_is_one_step_without_ensemble(fields):
    with pytest.raises(AssertionError):
        JConfig(**fields)
    with pytest.raises(AssertionError):
        PipelineConfig(**fields)


# ------------------------------------------ the marigold golden's route, small width

def test_marigold_golden_route_at_the_oracles_width(tmp_path):
    """chip_smoke's marigold phase at the oracles' small width on the CPU:
    the oracle UNet's conv_in widened by scripts/make_torch_golden.py's own
    _conv_in_8ch (taken from its syntax tree), written with in_channels 8 by
    the port's writer, loaded, and 10 DDIM steps held to the golden's loop
    (make_torch_golden.py run_torch_marigold: f64 tables, python floats) run
    on the oracles themselves; pred within 1e-4 mean."""
    from genpercept_tpu_torch.diffusion import SchedulerConfig, leading_timesteps

    unet, vae = chip_smoke.oracle_modules()
    unet = chip_smoke.golden_script_function("_conv_in_8ch")(unet)
    rng = np.random.default_rng(52)
    rgb = rng.uniform(size=(1, RES, RES, 3)).astype(np.float32)
    ctx = rng.normal(size=(1, 77, chip_smoke.oracle_namespace("unet")["CTX"])).astype(np.float32)
    noise = rng.normal(size=(1,) + LATENT + (4,)).astype(np.float32)
    steps = chip_smoke.MARIGOLD_STEPS
    acum = np.cumprod(1.0 - np.linspace(0.00085 ** 0.5, 0.012 ** 0.5, 1000) ** 2)
    ratio = 1000 // steps
    timesteps = (np.arange(steps) * ratio).round()[::-1].astype(int) + 1
    assert timesteps.tolist() == leading_timesteps(SchedulerConfig(), steps).tolist()
    with torch.no_grad():
        z = vae.encode(torch.from_numpy(rgb).permute(0, 3, 1, 2) * 2.0 - 1.0)
        x = torch.from_numpy(noise).permute(0, 3, 1, 2)
        for t in timesteps:
            v, _ = unet(torch.cat([z, x], dim=1), torch.tensor([t]), torch.from_numpy(ctx))
            a_t, prev_t = float(acum[t]), t - ratio
            a_prev = float(acum[prev_t]) if prev_t >= 0 else float(acum[0])
            x0 = (a_t ** 0.5) * x - ((1.0 - a_t) ** 0.5) * v
            eps = (a_t ** 0.5) * v + ((1.0 - a_t) ** 0.5) * x
            x = (a_prev ** 0.5) * x0 + ((1.0 - a_prev) ** 0.5) * eps
        pred = (vae.decode(x0).mean(dim=1).clamp(-1.0, 1.0) + 1.0) / 2.0
    golden = {"rgb": rgb, "ctx": ctx, "noise": noise, "z": z.permute(0, 2, 3, 1).numpy(),
              "pred": pred.numpy()}
    ckpt = chip_smoke.write_oracle_checkpoint(
        tmp_path / "ckpt", unet, vae, chip_smoke.oracle_namespace("unet"),
        chip_smoke.oracle_namespace("vae"), ctx, in_channels=8)
    models = load_genpercept_checkpoint(str(ckpt), device="cpu")
    assert models.unet.cfg.in_channels == 8
    reading, ours, again = chip_smoke.marigold_reading(models, golden, torch.float32)
    assert reading["pred"]["mean"] <= MEAN_TOL, reading
    assert reading["z"]["max"] <= 5e-4, reading
    torch.testing.assert_close(again(), ours, rtol=0, atol=0)
