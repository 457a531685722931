"""The UNet's feature taps and the DPT head, held to the JAX package's.

Weights are the JAX ``init_*`` trees filled from numpy seeds
(``numpy_params``), moved with ``state_dict_from_jax`` (strict). Tolerance:
5e-5 absolute in f32, as tests/test_torch_models.py (stacked convolutions
whose f32 sums run in another order).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genpercept_tpu.models import dpt_head as j_dpt
from genpercept_tpu.models import unet as j_unet
from genpercept_tpu_torch.models import dpt_head as t_dpt
from genpercept_tpu_torch.models import unet as t_unet
from genpercept_tpu_torch.ops import quant
from test_torch_models import ATOL, TINY_UNET, load, nchw, nhwc, numpy_params, rand

torch.set_num_threads(1)

SMALL_DPT = dict(neck_hidden_sizes=(8, 16, 24, 24), fusion_hidden_size=16)


@pytest.fixture(scope="module")
def unet_case():
    """A tiny UNet's features at a (6, 6) latent, from the JAX package."""
    jcfg = j_unet.UNetConfig(**TINY_UNET)
    p = numpy_params(j_unet.init_unet, jcfg, seed=21)
    x, ctx = rand((2, 6, 6, 4), 22), rand((2, 77, 48), 23)
    ref, feats = jax.jit(j_unet.unet_apply, static_argnums=(4, 5))(
        p, jnp.asarray(x), jnp.asarray(1), jnp.asarray(ctx), jcfg, True)
    return p, x, ctx, np.asarray(ref), [np.asarray(f) for f in feats]


def run_features(m, x, ctx, **kw):
    with torch.no_grad():
        return t_unet.unet_apply(m, nchw(x), torch.tensor(1), torch.from_numpy(ctx),
                                 return_features=True, **kw)


def test_unet_features_match_jax(unet_case):
    p, x, ctx, ref, feats = unet_case
    m = load(t_unet.UNet2DConditionModel(t_unet.UNetConfig(**TINY_UNET)), p)
    out, ours = run_features(m, x, ctx)
    np.testing.assert_allclose(nhwc(out), ref, atol=ATOL)
    assert len(ours) == len(feats) == 4
    assert [f.shape[1] for f in ours] == [128, 128, 64, 32]
    for o, r in zip(ours, feats):
        np.testing.assert_allclose(nhwc(o), r, atol=ATOL)


def test_unet_without_conv_out_returns_features_only(unet_case):
    p, x, ctx, _, feats = unet_case
    p = {k: v for k, v in p.items() if k not in ("conv_norm_out", "conv_out")}
    m = load(t_unet.UNet2DConditionModel(
        t_unet.UNetConfig(**TINY_UNET, with_conv_out=False)), p)
    assert not hasattr(m, "conv_out") and not hasattr(m, "conv_norm_out")
    out, ours = run_features(m, x, ctx)
    assert out is None
    for o, r in zip(ours, feats):
        np.testing.assert_allclose(nhwc(o), r, atol=ATOL)
    with pytest.raises(ValueError, match="features"):
        with torch.no_grad():
            t_unet.unet_apply(m, nchw(x), torch.tensor(1), torch.from_numpy(ctx))


def test_unet_features_under_int8_calibration_hooks(unet_case):
    """The calibration hooks run the layers at full precision and record
    their stats: with return_features the taps are unchanged and every
    up-block resnet conv is recorded, and the x2 upsamplers' (at the
    (6, 6) latent, 3 -> 6 takes the explicit-size form, which stays full
    precision as in the JAX package)."""
    p, x, ctx, _, feats = unet_case
    m = load(t_unet.UNet2DConditionModel(t_unet.UNetConfig(**TINY_UNET)), p)
    stats, dstats = {}, {}
    _, ours = run_features(m, x, ctx, conv_fn=quant.make_calib_conv_fn(stats),
                           dense_fn=quant.make_calib_dense_fn(dstats))
    for o, r in zip(ours, feats):
        np.testing.assert_allclose(nhwc(o), r, atol=ATOL)
    assert {f"up_blocks.{i}.resnets.{j}.conv{k}" for i in range(4) for j in range(3)
            for k in (1, 2)} <= set(stats)
    assert {"up_blocks.0.upsamplers.0.conv", "up_blocks.2.upsamplers.0.conv"} <= set(stats)
    assert any(k.startswith("up_blocks.3.attentions.") for k in dstats)


VARIANTS = {
    "general": {},
    "identity": dict(final_act="identity"),
    "elu_plus_one": dict(final_act="elu_plus_one"),
    "no_first_upsample": dict(upsample_first_feature=False),
    "no_neck_elu": dict(use_neck=False, final_act="elu_plus_one", head_in_index=0),
    "no_projection_level2": dict(add_projection=False, head_in_index=2),
}


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_dpt_head_matches_jax(variant):
    kw = dict(SMALL_DPT, **VARIANTS[variant])
    jcfg, tcfg = j_dpt.DPTHeadConfig(**kw), t_dpt.DPTHeadConfig(**kw)
    p = numpy_params(j_dpt.init_dpt_head, jcfg, seed=31)
    m = load(t_dpt.DPTHead(tcfg), p)
    hw = 8
    h0 = hw if tcfg.upsample_first_feature else 2 * hw
    feats = [rand((2, h0, h0, 8), 32), rand((2, hw, hw, 16), 33),
             rand((2, hw // 2, hw // 2, 24), 34), rand((2, hw // 4, hw // 4, 24), 35)]
    ref = np.asarray(j_dpt.dpt_head_apply(p, [jnp.asarray(f) for f in feats], jcfg))
    with torch.no_grad():
        out = t_dpt.dpt_head_apply(m, [nchw(f) for f in feats])
    assert out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL)
    if tcfg.final_act == "elu_plus_one":
        assert out.min() >= 0.0


def test_dpt_configs_mirror_jax():
    assert [f.name for f in dataclasses.fields(t_dpt.DPTHeadConfig)] == \
        [f.name for f in dataclasses.fields(j_dpt.DPTHeadConfig)]
    for name in ("DPT_GENERAL", "DPT_IDENTITY", "DPT_ELU"):
        assert dataclasses.asdict(getattr(t_dpt, name)) == \
            dataclasses.asdict(getattr(j_dpt, name))


def test_dpt_head_state_dict_keys():
    """The published names, and the JAX tree's keys exactly (transformers'
    unused fusion unit is not among them)."""
    cfg = t_dpt.DPTHeadConfig(**SMALL_DPT)
    keys = set(t_dpt.DPTHead(cfg).state_dict())
    p = numpy_params(j_dpt.init_dpt_head, j_dpt.DPTHeadConfig(**SMALL_DPT), seed=0)
    from genpercept_tpu_torch.io import state_dict_from_jax

    assert keys == set(state_dict_from_jax(p))
    assert {"feature_upsample_0.conv.weight", "neck.convs.0.weight",
            "neck.fusion_stage.layers.1.residual_layer1.convolution1.bias",
            "head.projection.weight", "head.head.4.bias"} <= keys
    assert not any(k.startswith("neck.fusion_stage.layers.0.residual_layer1") for k in keys)


# ------------------------------------ the DPT golden's route, small width

def transformers_dpt_head(cfg_kw: dict, seed: int):
    """scripts/make_torch_golden.py's build_torch_dpt: the reference head
    assembled from transformers' DPT pieces (tests/test_models.py), seeded
    by the global generator (forked)."""
    from genpercept_tpu.models import DPTHeadConfig
    from test_models import _build_torch_dpt

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return _build_torch_dpt(DPTHeadConfig(**cfg_kw)).eval()


def dpt_golden(unet, vae, head, rgb: np.ndarray, ctx: np.ndarray) -> dict:
    """make_torch_golden.py's run_torch_dpt forward: the oracle UNet's taps
    reversed through the head, then per-image min-max."""
    with torch.no_grad():
        z = vae.encode(torch.from_numpy(rgb).permute(0, 3, 1, 2) * 2.0 - 1.0)
        _, feats = unet(z, torch.tensor([1]), torch.from_numpy(ctx))
        pred = head(list(reversed(feats)))
        lo = pred.amin(dim=(1, 2), keepdim=True)
        hi = pred.amax(dim=(1, 2), keepdim=True)
        pred = (pred - lo) / torch.clamp(hi - lo, min=1e-6)
    return {"rgb": rgb, "ctx": ctx, "z": z.permute(0, 2, 3, 1).numpy(), "pred": pred.numpy()}


def test_dpt_checkpoint_matches_transformers_head(tmp_path):
    """At the oracles' small width: the oracle UNet and VAE and a transformers
    DPT head (with its unused fusion unit) written with the port's writer,
    loaded with the port's loader (conv_out and the unused unit dropped),
    run through build_single_infer; pred within 1e-3 mean of the torch
    forward (tests/test_golden_768.py's DPT bar: the min-max divides by an
    untrained head's range), z within tests/test_unet_oracle.py's 5e-4."""
    import chip_smoke
    from genpercept_tpu_torch.io.checkpoints import load_genpercept_checkpoint
    from test_torch_checkpoint import UNUSED

    cfg_kw = dict(neck_hidden_sizes=chip_smoke.oracle_namespace("unet")["C"],
                  fusion_hidden_size=32, final_act="identity")
    unet, vae = chip_smoke.oracle_modules()
    head = transformers_dpt_head(cfg_kw, 2)
    state = head.state_dict()
    assert any(k.startswith(UNUSED) for k in state)
    rng = np.random.default_rng(61)
    rgb = rng.uniform(size=(1, 64, 64, 3)).astype(np.float32)
    ctx = rng.normal(size=(1, 77, chip_smoke.oracle_namespace("unet")["CTX"])).astype(np.float32)
    golden = dpt_golden(unet, vae, head, rgb, ctx)
    assert golden["pred"].std() > 1e-4
    ckpt = chip_smoke.write_oracle_checkpoint(
        tmp_path / "ckpt", unet, vae, chip_smoke.oracle_namespace("unet"),
        chip_smoke.oracle_namespace("vae"), ctx)
    dpt = chip_smoke.write_dpt_checkpoint(tmp_path / "dpt", ckpt, state,
                                          t_dpt.DPTHeadConfig(**cfg_kw))
    models = load_genpercept_checkpoint(str(dpt), device="cpu")
    assert models.dpt_cfg == t_dpt.DPTHeadConfig(**cfg_kw)
    assert not models.unet.cfg.with_conv_out
    reading = chip_smoke.golden_reading(models, golden, torch.float32)
    assert reading["pred"]["mean"] <= 1e-3, reading
    assert reading["z"]["max"] <= 5e-4, reading
