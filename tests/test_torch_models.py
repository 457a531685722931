"""The port's layers and models held to the JAX package's, at tiny widths.

Weights are the JAX ``init_*`` functions' param trees filled from a numpy
seed (``numpy_params``) and move into the port through
``state_dict_from_jax`` with ``strict=True``.
Tolerance: 5e-5 absolute in f32, a few ulps of the activations' magnitude
summed over stacked convolutions whose f32 sums run in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genpercept_tpu.models import clip_text as j_clip
from genpercept_tpu.models import layers as JL
from genpercept_tpu.models import unet as j_unet
from genpercept_tpu.models import vae as j_vae
from genpercept_tpu_torch.io import state_dict_from_jax
from genpercept_tpu_torch.models import clip_text as t_clip
from genpercept_tpu_torch.models import layers as TL
from genpercept_tpu_torch.models import unet as t_unet
from genpercept_tpu_torch.models import vae as t_vae

torch.set_num_threads(1)

ATOL = 5e-5
TINY_UNET = dict(block_out_channels=(32, 64, 128, 128),
                 attention_heads=(1, 2, 4, 4), cross_attention_dim=48)
TINY_VAE = dict(block_out_channels=(32, 32, 64, 64))


def numpy_params(init_fn, *args, seed=0, **kw):
    """A JAX ``init_*`` function's param tree: keys and shapes from the
    function itself (traced abstractly, which takes a second where drawing
    its JAX random numbers takes minutes on one core), values from a numpy
    seed with the same scheme (weights uniform in +-1/sqrt(fan_in),
    embeddings normal * 0.02) and seeded noise on biases and norm affines
    so that neither is trivially 0 or 1."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda k: init_fn(k, *args, **kw), jax.random.key(0))

    def fill(path, leaf):
        name = "/".join(str(getattr(p, "key", p)) for p in path)
        shape = leaf.shape
        if name.endswith("weight") and "embedding" in name.rsplit("/", 2)[-2]:
            v = rng.normal(size=shape) * 0.02
        elif name.endswith("weight") and len(shape) >= 2:
            fan_in = int(np.prod(shape[:-1]))
            v = rng.uniform(-1, 1, size=shape) / np.sqrt(fan_in)
        elif name.endswith("weight"):  # norm scale
            v = 1.0 + 0.05 * rng.standard_normal(shape)
        else:
            v = 0.05 * rng.standard_normal(shape)
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def load(module, params):
    module.load_state_dict(state_dict_from_jax(params), strict=True)
    return module


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2))))


def nhwc(t):
    return t.permute(0, 2, 3, 1).detach().numpy()


def rand(shape, seed=1):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("cin,cout,temb,eps", [
    (32, 32, None, 1e-6), (32, 64, 40, 1e-5),
])
def test_resnet_block(cin, cout, temb, eps):
    p = numpy_params(JL.init_resnet_block, cin, cout, temb, seed=0)
    m = load(TL.ResnetBlock(cin, cout, temb), p)
    x = rand((2, 6, 5, cin))
    t = rand((2, temb), 2) if temb else None
    ref = JL.resnet_block(p, jnp.asarray(x), None if t is None else jnp.asarray(t), eps)
    out = TL.resnet_block(m, nchw(x), None if t is None else torch.from_numpy(t), eps)
    np.testing.assert_allclose(nhwc(out), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("asym", [False, True])
def test_downsample(asym):
    p = numpy_params(JL.init_downsample, 32, seed=1)
    m = load(TL.Downsample(32), p)
    x = rand((1, 9, 8, 32))
    ref = JL.downsample2d(p, jnp.asarray(x), asymmetric_pad=asym)
    out = TL.downsample2d(m, nchw(x), asymmetric_pad=asym)
    np.testing.assert_allclose(nhwc(out), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("out_hw", [None, (10, 13)])
def test_upsample(out_hw):
    p = numpy_params(JL.init_upsample, 32, seed=2)
    m = load(TL.Upsample(32), p)
    x = rand((1, 5, 7, 32))
    ref = JL.upsample2d(p, jnp.asarray(x), out_hw)
    out = TL.upsample2d(m, nchw(x), out_hw)
    np.testing.assert_allclose(nhwc(out), np.asarray(ref), atol=ATOL)


def test_vae_attention():
    p = numpy_params(JL.init_vae_attention, 64, seed=3)
    m = load(TL.VAEAttention(64), p)
    x = rand((2, 6, 5, 64))
    ref = JL.vae_attention(p, jnp.asarray(x))
    out = TL.vae_attention(m, nchw(x))
    np.testing.assert_allclose(nhwc(out), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("ctx_dim", [None, 48])
def test_cross_attention(ctx_dim):
    p = numpy_params(JL.init_cross_attention, 64, 2, ctx_dim, seed=4)
    m = load(TL.CrossAttention(64, ctx_dim), p)
    x = rand((2, 30, 64))
    ctx = None if ctx_dim is None else rand((2, 77, ctx_dim), 5)
    ref = JL.cross_attention(p, jnp.asarray(x), None if ctx is None else jnp.asarray(ctx), 2)
    out = TL.cross_attention(m, torch.from_numpy(x),
                             None if ctx is None else torch.from_numpy(ctx), 2)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("c,s", [(64, 30), (320, 512)])
def test_feed_forward(c, s):
    """C=320 over 512 rows takes the fused GEGLU route in both packages
    (JAX's on an accelerator): its plain version against JAX's split path."""
    p = numpy_params(JL.init_feed_forward, c, seed=5)
    m = load(TL.FeedForward(c), p)
    x = rand((1, s, c))
    ref = JL.feed_forward(p, jnp.asarray(x))
    out = TL.feed_forward(m, torch.from_numpy(x))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=ATOL)


def test_spatial_transformer():
    p = numpy_params(JL.init_spatial_transformer, 64, 2, 48, seed=6)
    m = load(TL.SpatialTransformer(64, 48), p)
    x = rand((2, 6, 5, 64))
    ctx = rand((2, 77, 48), 7)
    ref = JL.spatial_transformer(p, jnp.asarray(x), jnp.asarray(ctx), 2)
    out = TL.spatial_transformer(m, nchw(x), torch.from_numpy(ctx), 2)
    np.testing.assert_allclose(nhwc(out), np.asarray(ref), atol=ATOL)


def test_transformer_block():
    p = numpy_params(JL.init_transformer_block, 32, 1, 48, seed=7)
    m = load(TL.TransformerBlock(32, 48), p)
    x, ctx = rand((1, 20, 32)), rand((1, 77, 48), 8)
    ref = JL.transformer_block(p, jnp.asarray(x), jnp.asarray(ctx), 1)
    out = TL.transformer_block(m, torch.from_numpy(x), torch.from_numpy(ctx), 1)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=ATOL)


@pytest.fixture(scope="module")
def tiny_vae():
    jcfg = j_vae.VAEConfig(**TINY_VAE)
    p = numpy_params(j_vae.init_vae, jcfg, seed=8)
    return p, jcfg, load(t_vae.AutoencoderKL(t_vae.VAEConfig(**TINY_VAE)), p)


@pytest.mark.parametrize("hw", [(32, 32), (40, 24)])
def test_vae_encode(tiny_vae, hw):
    p, jcfg, m = tiny_vae
    x = np.random.default_rng(9).uniform(-1, 1, size=(2,) + hw + (3,)).astype(np.float32)
    ref = j_vae.vae_encode(p, jnp.asarray(x), jcfg)
    with torch.no_grad():
        out = t_vae.vae_encode(m, nchw(x))
    np.testing.assert_allclose(nhwc(out), np.asarray(ref), atol=ATOL)


def test_vae_decode(tiny_vae):
    p, jcfg, m = tiny_vae
    z = rand((2, 4, 5, 4), 10)
    ref = j_vae.vae_decode(p, jnp.asarray(z), jcfg)
    with torch.no_grad():
        out = t_vae.vae_decode(m, nchw(z))
    np.testing.assert_allclose(nhwc(out), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("hw", [(5, 6)])
def test_unet_apply(hw):
    """(5, 6) latents take both upsampler branches: x2, and the explicit
    size when a skip's side was floored (3 -> 1 -> 2 vs 3)."""
    jcfg = j_unet.UNetConfig(**TINY_UNET)
    p = numpy_params(j_unet.init_unet, jcfg, seed=11)
    m = load(t_unet.UNet2DConditionModel(t_unet.UNetConfig(**TINY_UNET)), p)
    x = rand((2,) + hw + (4,), 12)
    ctx = rand((2, 77, 48), 13)
    ref = jax.jit(j_unet.unet_apply, static_argnums=4)(
        p, jnp.asarray(x), jnp.asarray(1), jnp.asarray(ctx), jcfg)
    with torch.no_grad():
        out = t_unet.unet_apply(m, nchw(x), torch.tensor(1), torch.from_numpy(ctx))
    np.testing.assert_allclose(nhwc(out), np.asarray(ref), atol=ATOL)


def test_clip_text_empty_prompt():
    kw = dict(vocab_size=300, hidden_size=64, num_layers=2, num_heads=4,
              intermediate_size=128)
    jcfg = j_clip.CLIPTextConfig(**kw, bos_token_id=298, eos_token_id=299)
    tcfg = t_clip.CLIPTextConfig(**kw, bos_token_id=298, eos_token_id=299)
    p = numpy_params(j_clip.init_clip_text, jcfg, seed=14)
    m = load(t_clip.CLIPTextModel(tcfg), p)
    ids = t_clip.empty_prompt_ids(tcfg)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(j_clip.empty_prompt_ids(jcfg)))
    ref = j_clip.clip_text_apply(p, j_clip.empty_prompt_ids(jcfg), jcfg)
    with torch.no_grad():
        out = t_clip.clip_text_apply(m, ids)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


def test_sd21_state_dict_keys_match_jax_tree():
    """At the full SD2.1 widths the port's modules hold exactly the JAX
    param tree's keys and shapes (no weights are drawn: shapes only)."""
    from genpercept_tpu.io.weights import flatten_dict

    for j_init, t_cls in ((j_vae.init_vae, t_vae.AutoencoderKL),
                          (j_unet.init_unet, t_unet.UNet2DConditionModel),
                          (j_clip.init_clip_text, t_clip.CLIPTextModel)):
        shapes = jax.eval_shape(j_init, jax.random.key(0))
        jflat = {k: tuple(v.shape) for k, v in flatten_dict(shapes).items()}
        with torch.device("meta"):
            sd = t_cls().state_dict()
        assert set(sd) == set(jflat)
        for k, v in sd.items():
            js = jflat[k]
            embedding = k.endswith(("embedding.weight", "embeddings.weight"))
            want = (js[::-1][:2] + js[:2]) if len(js) == 4 else (
                js[::-1] if len(js) == 2 and not embedding else js)
            assert tuple(v.shape) == want, k


@pytest.mark.parametrize("image_hw,k1,k2", [((768, 768), 17, 5), ((576, 768), 7, 0)])
def test_kernel_launches_per_forward_match_jax_routing(image_hw, k1, k2, monkeypatch):
    """At full SD2.1 width, one forward (VAE encode, UNet, VAE decode) sends
    as many calls to each kernel in the port as JAX sends to its Pallas
    kernel on an accelerator. Shapes only: JAX is traced abstractly and the
    port runs on the meta device, with both kernels stubbed by counters."""
    import genpercept_tpu.ops.flash_attention as jfa
    import genpercept_tpu.ops.fused_ff as jff
    from genpercept_tpu_torch.ops import flash_attention as tfa

    seen = {"jk1": 0, "jk2": 0, "tk1": 0, "tk2": 0}

    def bump(name, result):
        seen[name] += 1
        return result

    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    monkeypatch.setattr(jfa, "flash_attention",
                        lambda q, k, v, scale=None: bump("jk1", jnp.zeros_like(q)))
    monkeypatch.setattr(jff, "fused_geglu_ff",
                        lambda x, *a: bump("jk2", jnp.zeros_like(x)))
    monkeypatch.setattr(tfa, "_flash_bhsd", lambda qh, kh, vh, scale: bump(
        "tk1", (torch.empty_like(qh), torch.empty(qh.shape[:2] + (1,), device=qh.device))))
    monkeypatch.setattr(TL, "fused_geglu_ff", lambda x, *a: bump("tk2", torch.empty_like(x)))

    h, w = image_hw
    lat = (1, h // 8, w // 8, 4)
    jax.eval_shape(lambda p, x: j_vae.vae_encode(p, x),
                   jax.eval_shape(j_vae.init_vae, jax.random.key(0)),
                   jax.ShapeDtypeStruct((1, h, w, 3), jnp.float32))
    jax.eval_shape(lambda p, z, c: j_unet.unet_apply(p, z, jnp.asarray(1), c),
                   jax.eval_shape(j_unet.init_unet, jax.random.key(0)),
                   jax.ShapeDtypeStruct(lat, jnp.float32),
                   jax.ShapeDtypeStruct((1, 77, 1024), jnp.float32))
    jax.eval_shape(lambda p, z: j_vae.vae_decode(p, z),
                   jax.eval_shape(j_vae.init_vae, jax.random.key(0)),
                   jax.ShapeDtypeStruct(lat, jnp.float32))

    with torch.device("meta"), torch.no_grad():
        vae, unet = t_vae.AutoencoderKL(), t_unet.UNet2DConditionModel()
        z = t_vae.vae_encode(vae, torch.empty(1, 3, h, w))
        v = t_unet.unet_apply(unet, z, torch.tensor(1), torch.empty(1, 77, 1024))
        t_vae.vae_decode(vae, -v)

    assert (seen["jk1"], seen["jk2"]) == (k1, k2)
    assert (seen["tk1"], seen["tk2"]) == (k1, k2)


class _AllFF(dict):
    """A quantized tree that holds every feed-forward matmul (routing only)."""

    def get(self, key, default=None):
        return object() if ".ff.net." in key else default


@pytest.mark.parametrize("mode", ["calibrate", "quant"])
@pytest.mark.parametrize("image_hw,quant_counts", [
    ((768, 768), {"k1": 15, "k2": 0, "k5": 10, "k6": 2}),
    ((576, 768), {"k1": 5, "k2": 0, "k5": 0, "k6": 2}),
])
def test_int8_kernel_launches_per_forward_match_jax_routing(image_hw, quant_counts, mode,
                                                             monkeypatch):
    """W8A8 inference at full SD2.1 width (int8_vae, int8_unet,
    int8_unet_ff, int8_vae_attn): one forward sends as many calls to each
    kernel in the port as JAX to its Pallas kernel on an accelerator (JAX
    traced abstractly with its backend reported as "tpu", the port on the
    meta device, kernels stubbed by counters). The calibration pass hooks
    every layer with full-precision calibration functions and keeps the
    attention full precision: K1 as without int8 (17 / 7), no K2 (the FFs
    go through the hooks), no K5 or K6. The quantized pass: the VAE mid
    blocks take K6 from K1, and the level-0 and level-1 FFs (C=320 with
    rows % 512 == 0, C=640 with rows % 256 == 0) take K5."""
    import genpercept_tpu.ops.flash_attention as jfa
    import genpercept_tpu.ops.fused_ff as jff
    from genpercept_tpu.ops.attention import attention_projection as j_proj
    from genpercept_tpu.ops.conv import conv2d as j_conv, nearest_up2_conv3x3 as j_up
    from genpercept_tpu_torch.ops import flash_attention as tfa
    from genpercept_tpu_torch.ops import quant as tq
    from genpercept_tpu_torch.ops.attention import attention_projection as t_proj

    seen = {f"{p}{k}": 0 for p in "jt" for k in ("k1", "k2", "k5", "k6")}

    def bump(name, result):
        seen[name] += 1
        return result

    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    monkeypatch.setattr(jfa, "flash_attention",
                        lambda q, k, v, scale=None: bump("jk1", jnp.zeros_like(q)))
    monkeypatch.setattr(jfa, "flash_attention_int8",
                        lambda q, k, v, scale=None: bump("jk6", jnp.zeros_like(q)))
    monkeypatch.setattr(jff, "fused_geglu_ff", lambda x, *a: bump("jk2", jnp.zeros_like(x)))
    monkeypatch.setattr(jff, "fused_geglu_ff_int8",
                        lambda x, *a, **k: bump("jk5", jnp.zeros_like(x)))
    monkeypatch.setattr(tfa, "_flash_bhsd", lambda qh, kh, vh, scale: bump(
        "tk1", (torch.empty_like(qh), torch.empty(qh.shape[:2] + (1,), device=qh.device))))
    monkeypatch.setattr(TL, "fused_geglu_ff", lambda x, *a: bump("tk2", torch.empty_like(x)))
    monkeypatch.setattr(TL, "fused_geglu_ff_int8",
                        lambda x, *a: bump("tk5", torch.empty_like(x)))
    monkeypatch.setattr(TL, "flash_attention_int8",
                        lambda q, k, v: bump("tk6", torch.empty_like(q)))

    def j_conv_fn(name, p, x, *, kind="3x3", stride=1, padding=1):
        if kind == "up4x4":
            return j_up(x, p["weight"], p.get("bias"))
        return j_conv(x, p["weight"], p.get("bias"), stride=stride, padding=padding)

    def j_dense_fn(name, p, x):
        return j_proj(x, p["weight"], p.get("bias"))

    def t_conv_fn(name, w, b, x, *, kind="3x3", stride=1, padding=1):
        return tq._fp_conv(w, b, x, kind, stride, padding)

    def t_dense_fn(name, w, b, x):
        return t_proj(x, w, b)

    quant = mode == "quant"
    if quant:
        j_dense_fn.qtree = t_dense_fn.qtree = _AllFF()
    hooks_j = dict(conv_fn=j_conv_fn, dense_fn=j_dense_fn)
    hooks_t = dict(conv_fn=t_conv_fn, dense_fn=t_dense_fn)

    h, w = image_hw
    lat = (1, h // 8, w // 8, 4)
    vae_p = jax.eval_shape(j_vae.init_vae, jax.random.key(0))
    jax.eval_shape(lambda p, x: j_vae.vae_encode(p, x, attn_int8=quant, **hooks_j), vae_p,
                   jax.ShapeDtypeStruct((1, h, w, 3), jnp.float32))
    jax.eval_shape(lambda p, z, c: j_unet.unet_apply(p, z, jnp.asarray(1), c, **hooks_j),
                   jax.eval_shape(j_unet.init_unet, jax.random.key(0)),
                   jax.ShapeDtypeStruct(lat, jnp.float32),
                   jax.ShapeDtypeStruct((1, 77, 1024), jnp.float32))
    jax.eval_shape(lambda p, z: j_vae.vae_decode(p, z, attn_int8=quant, **hooks_j), vae_p,
                   jax.ShapeDtypeStruct(lat, jnp.float32))

    with torch.device("meta"), torch.no_grad():
        vae, unet = t_vae.AutoencoderKL(), t_unet.UNet2DConditionModel()
        z = t_vae.vae_encode(vae, torch.empty(1, 3, h, w), attn_int8=quant, **hooks_t)
        v = t_unet.unet_apply(unet, z, torch.tensor(1), torch.empty(1, 77, 1024), **hooks_t)
        t_vae.vae_decode(vae, -v, attn_int8=quant, **hooks_t)

    want = quant_counts if quant else {"k1": quant_counts["k1"] + 2, "k2": 0, "k5": 0, "k6": 0}
    assert {k: seen["j" + k] for k in want} == want
    assert {k: seen["t" + k] for k in want} == want
