"""K8, the fused GroupNorm -> SiLU -> conv3x3 (+ residual), held to the JAX
package's Pallas kernel (interpret mode on the CPU) at small sizes.

The same numpy-seeded inputs go through JAX ``fused_gn_silu_conv3x3`` (NHWC,
HWIO) and the port's (NCHW, OIHW). Tolerances: f32 2e-5 absolute, the JAX
package's own bar for the kernel (tests/test_ops.py); bf16 1e-2 of max|ref|
(both round the activated input to bf16 after f32 math taken in another
order, and one bf16 ulp of an input moves a sum of 9*C products).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from genpercept_tpu.models import layers as JL
from genpercept_tpu.ops import fused_conv as jfc
from genpercept_tpu.ops.norms import group_norm as j_group_norm
from genpercept_tpu_torch.models import layers as TL
from genpercept_tpu_torch.ops import _dispatch
from genpercept_tpu_torch.ops import fused_conv as tfc
from test_torch_models import load, nchw, nhwc, numpy_params

torch.set_num_threads(1)

F32_ATOL = 2e-5
BF16_REL = 1e-2


def conv_case(c, co, with_res, seed=7, n=2, h=16, w=24):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, h, w, c)).astype(np.float32)
    gs = rng.normal(size=(c,)).astype(np.float32)
    gb = rng.normal(size=(c,)).astype(np.float32)
    cw = (rng.normal(size=(3, 3, c, co)) * 0.05).astype(np.float32)
    cb = rng.normal(size=(co,)).astype(np.float32)
    res = rng.normal(size=(n, h, w, co)).astype(np.float32) if with_res else None
    return x, gs, gb, cw, cb, res


def oihw(w):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(w, (3, 2, 0, 1))))


def run_jax(x, gs, gb, cw, cb, res, dtype):
    jd = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    with pltpu.force_tpu_interpret_mode():
        out = jfc.fused_gn_silu_conv3x3(
            jnp.asarray(x, jd), jnp.asarray(gs), jnp.asarray(gb), jnp.asarray(cw, jd),
            jnp.asarray(cb), residual=None if res is None else jnp.asarray(res, jd))
    return np.asarray(out.astype(jnp.float32))


def run_port(x, gs, gb, cw, cb, res, dtype):
    out = tfc.fused_gn_silu_conv3x3(
        nchw(x).to(dtype), torch.from_numpy(gs), torch.from_numpy(gb), oihw(cw).to(dtype),
        torch.from_numpy(cb), residual=None if res is None else nchw(res).to(dtype))
    assert out.dtype == dtype
    return nhwc(out.float())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("co,with_res", [(128, False), (128, True), (256, False),
                                         (256, True)])
def test_plain_matches_pallas_kernel(co, with_res, dtype):
    case = conv_case(128, co, with_res)
    assert jfc.supported(case[0].shape, co) and tfc.supported(nchw(case[0]).shape, co)
    ref = run_jax(*case, dtype)
    out = run_port(*case, dtype)
    if dtype == torch.float32:
        np.testing.assert_allclose(out, ref, atol=F32_ATOL, rtol=0)
    else:
        assert np.abs(out - ref).max() <= BF16_REL * np.abs(ref).max()


def test_plain_keeps_the_padding_zero_after_the_transform():
    """Out-of-image taps contribute 0, not silu(b): the border of a constant
    input differs from its interior by the missing taps' weights."""
    c = co = 128
    x = np.ones((1, 16, 16, c), np.float32)
    gs = np.zeros(c, np.float32)
    gb = np.full(c, 2.0, np.float32)  # every activated value is silu(2)
    cw = np.ones((3, 3, c, co), np.float32) * 1e-3
    out = run_port(x, gs, gb, cw, np.zeros(co, np.float32), None, torch.float32)
    s = 2.0 / (1.0 + np.exp(-2.0))
    np.testing.assert_allclose(out[0, 5, 5], 9 * c * 1e-3 * s, rtol=1e-5)
    np.testing.assert_allclose(out[0, 0, 5], 6 * c * 1e-3 * s, rtol=1e-5)
    np.testing.assert_allclose(out[0, 0, 0], 4 * c * 1e-3 * s, rtol=1e-5)


@pytest.mark.parametrize("shape", [(2, 128, 16, 24), (1, 256, 72, 96), (1, 512, 96, 96)])
def test_gn_affine_matches_group_norm(shape):
    """x*a + b with the wrapper's folded statistics is JAX's GroupNorm."""
    rng = np.random.default_rng(3)
    x = (rng.normal(size=shape) * 2 + 0.5).astype(np.float32)
    c = shape[1]
    gs, gb = rng.normal(size=c).astype(np.float32), rng.normal(size=c).astype(np.float32)
    a, b = tfc.gn_affine(torch.from_numpy(x), torch.from_numpy(gs), torch.from_numpy(gb))
    assert a.shape == b.shape == (shape[0], c) and a.dtype == torch.float32
    ours = torch.from_numpy(x) * a[:, :, None, None] + b[:, :, None, None]
    ref = j_group_norm(jnp.asarray(np.transpose(x, (0, 2, 3, 1))), jnp.asarray(gs),
                       jnp.asarray(gb), 32, 1e-6)
    np.testing.assert_allclose(nhwc(ours), np.asarray(ref), atol=2e-5)


@pytest.mark.parametrize("cin,cout", [(128, 128), (128, 256)])
def test_fused_resnet_block_matches_jax(cin, cout, monkeypatch):
    """resnet_block(fused=True) against JAX's, incl. the 1x1 shortcut; both
    convolutions go through K8's plain version."""
    p = numpy_params(JL.init_resnet_block, cin, cout, None, seed=4)
    m = load(TL.ResnetBlock(cin, cout, None), p)
    x = np.random.default_rng(8).normal(size=(1, 16, 16, cin)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        ref = JL.resnet_block(p, jnp.asarray(x), None, eps=1e-6, fused=True)
    plain, seen = tfc._fused_gn_silu_conv3x3_ref, []
    monkeypatch.setattr(tfc, "_fused_gn_silu_conv3x3_ref",
                        lambda *a: seen.append(a[-1] is not None) or plain(*a))
    out = TL.resnet_block(m, nchw(x), None, eps=1e-6, fused=True)
    assert seen == [False, True]  # conv1 without a residual, conv2 with the skip
    np.testing.assert_allclose(nhwc(out), np.asarray(ref), atol=F32_ATOL)


def test_fused_resnet_block_falls_back_where_jax_does():
    """Where the predicate fails (here 32 channels) the block is the unfused
    composition, as in the JAX package."""
    p = numpy_params(JL.init_resnet_block, 32, 32, None, seed=5)
    m = load(TL.ResnetBlock(32, 32, None), p)
    x = np.random.default_rng(9).normal(size=(1, 16, 16, 32)).astype(np.float32)
    before = tfc.fused_gn_silu_conv3x3.launches
    ref = JL.resnet_block(p, jnp.asarray(x), None, eps=1e-6, fused=True)
    out = TL.resnet_block(m, nchw(x), None, eps=1e-6, fused=True)
    # the unfused block at tests/test_torch_models.py's bar
    np.testing.assert_allclose(nhwc(out), np.asarray(ref), atol=5e-5)
    assert tfc.fused_gn_silu_conv3x3.launches == before


@pytest.mark.parametrize("shape,co", [
    ((2, 128, 16, 24), 128), ((2, 128, 8, 24), 128), ((2, 128, 20, 24), 128),
    ((2, 96, 16, 24), 128), ((2, 128, 16, 20), 128), ((2, 128, 16, 24), 8),
    ((1, 512, 72, 96), 512), ((1, 512, 60, 80), 512),
])
def test_supported_matches_jax(shape, co):
    n, c, h, w = shape
    assert tfc.supported(shape, co) == jfc.supported((n, h, w, c), co)
    assert not tfc.supported(shape, co, temb=object())


def test_cpu_tensors_take_the_plain_version():
    case = conv_case(128, 128, True, n=1)
    before = tfc.fused_gn_silu_conv3x3.launches
    run_port(*case, torch.float32)
    assert tfc.fused_gn_silu_conv3x3.launches == before


def card_args(dtype=torch.float32, c=128, co=128, res=True):
    x = torch.zeros(1, c, 16, 16, dtype=dtype)
    return (x, torch.ones(c), torch.zeros(c), torch.zeros(co, c, 3, 3), torch.zeros(co),
            torch.zeros(1, co, 16, 16, dtype=dtype) if res else None)


def test_card_path_refuses_gradients(monkeypatch):
    """Inference only: with the kernel path taken, an input that requires
    grad under grad mode raises instead of returning a tensor without a
    backward."""
    monkeypatch.setattr(_dispatch, "use_kernel", lambda x: True)
    x, gs, gb, w, b, res = card_args()
    with pytest.raises(RuntimeError, match="inference only"):
        tfc.fused_gn_silu_conv3x3(x, gs, gb, w.requires_grad_(), b, res)
    with pytest.raises(RuntimeError, match="inference only"):
        tfc.fused_gn_silu_conv3x3(x.requires_grad_(), gs, gb, w.detach(), b, res)


@pytest.mark.parametrize("what", ["dtype", "channels", "out_channels", "width", "residual"])
def test_card_path_refuses_what_the_kernel_lacks(what, monkeypatch):
    monkeypatch.setattr(_dispatch, "use_kernel", lambda x: True)
    x, gs, gb, w, b, res = card_args()
    groups = 32
    if what == "dtype":
        x, res = x.half(), res.half()
    elif what == "channels":
        x, gs, gb, w, groups = x[:, :48], gs[:48], gb[:48], w[:, :48], 16
    elif what == "out_channels":
        w, b, res = w[:64], b[:64], res[:, :64]
    elif what == "width":
        x, res = x[..., :12], res[..., :12]
    else:
        res = res.to(torch.bfloat16)
    with torch.no_grad(), pytest.raises(ValueError):
        tfc.fused_gn_silu_conv3x3(x, gs, gb, w, b, res, groups=groups)


@pytest.mark.parametrize("mode", ["fused", "default", "int8"])
@pytest.mark.parametrize("image_hw,fused_calls", [((768, 768), 48), ((576, 768), 48),
                                                  ((480, 640), 30)])
def test_k8_calls_per_forward_match_jax_routing(image_hw, fused_calls, mode, monkeypatch):
    """At full SD2.1 width, one VAE encode and decode sends as many calls to
    the port's K8 as JAX sends to its fused kernel: 48 at 768^2 and at 576x768
    (20 in the encoder, 28 in the decoder); 30 at 480x640, whose 60x80 level
    fails h % 8. None without fused, and none with an int8 conv hook (JAX
    fuses a resblock only without one; the final GN -> SiLU -> conv never
    fuses at Co = 8 or 3). JAX is traced abstractly and the port runs on the
    meta device, with both kernels stubbed by counters."""
    from genpercept_tpu.models import vae as j_vae
    from genpercept_tpu.ops.conv import conv2d as j_conv, nearest_up2_conv3x3 as j_up
    from genpercept_tpu_torch.models import vae as t_vae
    from genpercept_tpu_torch.ops import flash_attention as tfa
    from genpercept_tpu_torch.ops import quant as tq
    from genpercept_tpu_torch.ops import quant_conv as tqc

    seen = {"j": 0, "t": 0, "k7": 0}

    def bump(name, result):
        seen[name] += 1
        return result

    monkeypatch.setattr(jfc, "fused_gn_silu_conv3x3", lambda x, gs, gb, w, b, **k: bump(
        "j", jnp.zeros(x.shape[:-1] + (w.shape[-1],), x.dtype)))
    monkeypatch.setattr(tfc, "fused_gn_silu_conv3x3", lambda x, gs, gb, w, b, **k: bump(
        "t", torch.empty((x.shape[0], w.shape[0]) + tuple(x.shape[2:]), device=x.device)))
    monkeypatch.setattr(tqc, "quantized_conv3x3", lambda x, *a: bump("k7", x))
    monkeypatch.setattr(tfa, "_flash_bhsd", lambda qh, kh, vh, scale: (
        torch.empty_like(qh), torch.empty(qh.shape[:2] + (1,), device=qh.device)))

    def j_conv_fn(name, p, x, *, kind="3x3", stride=1, padding=1):
        if kind == "up4x4":
            return j_up(x, p["weight"], p.get("bias"))
        return j_conv(x, p["weight"], p.get("bias"), stride=stride, padding=padding)

    def t_conv_fn(name, w, b, x, *, kind="3x3", stride=1, padding=1):
        return tq._fp_conv(w, b, x, kind, stride, padding)

    kw_j = dict(fused=mode != "default", conv_fn=j_conv_fn if mode == "int8" else None)
    kw_t = dict(fused=mode != "default", conv_fn=t_conv_fn if mode == "int8" else None)
    h, w = image_hw
    vae_p = jax.eval_shape(j_vae.init_vae, jax.random.key(0))
    jax.eval_shape(lambda p, x: j_vae.vae_encode(p, x, **kw_j), vae_p,
                   jax.ShapeDtypeStruct((1, h, w, 3), jnp.float32))
    jax.eval_shape(lambda p, z: j_vae.vae_decode(p, z, **kw_j), vae_p,
                   jax.ShapeDtypeStruct((1, h // 8, w // 8, 4), jnp.float32))
    with torch.device("meta"), torch.no_grad():
        vae = t_vae.AutoencoderKL()
        z = t_vae.vae_encode(vae, torch.empty(1, 3, h, w), **kw_t)
        out = t_vae.vae_decode(vae, z, **kw_t)
    assert tuple(out.shape) == (1, 3, h, w)
    want = fused_calls if mode == "fused" else 0
    assert (seen["j"], seen["t"], seen["k7"]) == (want, want, 0)


@pytest.mark.parametrize("target", ["chip_smoke.py", "scripts/profile_fused_conv_torch.py",
                                    "scripts/profile_quant_conv_torch.py",
                                    "scripts/tune_k1.py", "scripts/tune_k34.py",
                                    "scripts/tune_k8.py", "scripts/kernel_resources.py",
                                    "scripts/kernel_variants.py"])
def test_card_scripts_leave_jax_out(target):
    """chip_smoke.py and the profiling and tuning scripts (with the kernel
    modules they import) load without JAX or the JAX package."""
    import subprocess
    import sys

    code = (f"import runpy, sys; runpy.run_path({target!r}, run_name='loaded'); "
            "import genpercept_tpu_torch.ops.quant_conv; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
            "or m.startswith('genpercept_tpu.') or m == 'genpercept_tpu']; "
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
