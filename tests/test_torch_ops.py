"""The port's ops (genpercept_tpu_torch.ops) held to the JAX package's ops.

Inputs come from numpy seeds and go through both; JAX runs on the CPU, with
the Pallas kernels in interpret mode, and the port takes its kernels' plain
versions because the tensors lie on the CPU. Tolerances: 2e-5 absolute in
f32 (summation order only); 6e-2 in bf16 for the fused feed-forward, as the
JAX package's own test of that kernel.
"""

import importlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from genpercept_tpu import ops as J
from genpercept_tpu.ops import attention as j_attn
from genpercept_tpu.ops import colorize as j_colorize
from genpercept_tpu.ops import conv as j_conv
from genpercept_tpu.ops import flash_attention as j_fa
from genpercept_tpu.ops import fused_ff as j_ff
from genpercept_tpu_torch import _build
from genpercept_tpu_torch import ops as T
from genpercept_tpu_torch.ops import _dispatch
from genpercept_tpu_torch.ops import attention as t_attn
from genpercept_tpu_torch.ops import colorize as t_colorize
from genpercept_tpu_torch.ops import flash_attention as t_fa
from genpercept_tpu_torch.ops import fused_ff as t_ff

# the ops packages re-export the function resize under the module's name
j_resize = importlib.import_module("genpercept_tpu.ops.resize")
t_resize = importlib.import_module("genpercept_tpu_torch.ops.resize")

torch.set_num_threads(1)

ATOL = 2e-5


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2))))


def nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("shape,groups,eps", [
    ((2, 6, 5, 64), 32, 1e-6),
    ((1, 9, 7, 96), 32, 1e-5),
])
def test_group_norm(shape, groups, eps):
    rng = np.random.default_rng(0)
    x = (rng.normal(size=shape) * 3 + 1).astype(np.float32)
    s = rng.normal(size=shape[-1:]).astype(np.float32)
    b = rng.normal(size=shape[-1:]).astype(np.float32)
    ref = J.group_norm(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b), groups, eps)
    out = T.group_norm(nchw(x), torch.from_numpy(s), torch.from_numpy(b), groups, eps)
    np.testing.assert_allclose(nhwc(out), np.asarray(ref), atol=ATOL)


def test_layer_norm():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 7, 48)).astype(np.float32)
    w = rng.normal(size=(48,)).astype(np.float32)
    b = rng.normal(size=(48,)).astype(np.float32)
    ref = J.layer_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    out = T.layer_norm(*map(torch.from_numpy, (x, w, b)))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("stride,pad", [
    (1, 1), (2, 1), (1, 0), (2, ((0, 1), (0, 1))),
])
def test_conv2d(stride, pad):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 9, 8, 5)).astype(np.float32)
    w = rng.uniform(-0.15, 0.15, size=(3, 3, 5, 7)).astype(np.float32)  # HWIO
    b = rng.normal(size=(7,)).astype(np.float32)
    ref = J.conv2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                   stride=stride, padding=pad)
    out = T.conv2d(nchw(x), torch.from_numpy(np.transpose(w, (3, 2, 0, 1)).copy()),
                   torch.from_numpy(b), stride=stride, padding=pad)
    np.testing.assert_allclose(nhwc(out), np.asarray(ref), atol=ATOL)


def test_conv1x1_rank4_and_rank3():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 4, 4, 6)).astype(np.float32)
    w = rng.uniform(-0.4, 0.4, size=(6, 9)).astype(np.float32)  # (in, out)
    b = rng.normal(size=(9,)).astype(np.float32)
    tw = torch.from_numpy(w.T.copy())
    ref = J.conv1x1(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    out = T.conv1x1(nchw(x), tw, torch.from_numpy(b))
    np.testing.assert_allclose(nhwc(out), np.asarray(ref), atol=ATOL)
    ref3 = J.conv1x1(jnp.asarray(x[:, 0]), jnp.asarray(w), jnp.asarray(b))
    out3 = T.conv1x1(torch.from_numpy(x[:, 0].copy()), tw, torch.from_numpy(b))
    np.testing.assert_allclose(out3.numpy(), np.asarray(ref3), atol=ATOL)


@pytest.mark.parametrize("hw", [(5, 7), (1, 1)])
def test_nearest_up2_conv3x3(hw):
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2,) + hw + (8,)).astype(np.float32)
    w = rng.uniform(-0.12, 0.12, size=(3, 3, 8, 16)).astype(np.float32)
    b = rng.normal(size=(16,)).astype(np.float32)
    ref = j_conv.nearest_up2_conv3x3(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    out = T.nearest_up2_conv3x3(
        nchw(x), torch.from_numpy(np.transpose(w, (3, 2, 0, 1)).copy()),
        torch.from_numpy(b))
    np.testing.assert_allclose(nhwc(out), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("t,atol", [
    ((0, 1, 7), ATOL),  # the one-step path runs at t=1
    # f32 sin/cos of arguments near 1000: XLA's and PyTorch's range
    # reductions differ by ~6e-5 (the JAX package's own test allows 3e-4)
    ((500, 999), 1e-4),
])
def test_timestep_embedding(t, atol):
    t = np.array(t, dtype=np.int32)
    for dim in (320, 33):
        ref = J.timestep_embedding(jnp.asarray(t), dim)
        out = T.timestep_embedding(torch.from_numpy(t), dim)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=atol)


@pytest.mark.parametrize("method,antialias,out_hw", [
    ("bilinear", True, (16, 24)),
    ("bicubic", True, (16, 24)),
    ("bilinear", False, (16, 24)),
    ("bilinear", True, (74, 90)),
    ("bicubic", True, (50, 53)),
    ("nearest_exact", True, (10, 80)),
])
def test_resize(method, antialias, out_hw):
    rng = np.random.default_rng(6)
    x = rng.uniform(size=(2, 37, 53, 3)).astype(np.float32)
    ref = j_resize.resize(jnp.asarray(x), out_hw, method, antialias)
    out = t_resize.resize(torch.from_numpy(x), out_hw, method, antialias)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("out_hw", [(16, 24), (80, 3), (1, 5)])
def test_resize_align_corners(out_hw):
    x = np.random.default_rng(7).uniform(size=(1, 11, 13, 2)).astype(np.float32)
    ref = j_resize.resize_bilinear_align_corners(jnp.asarray(x), out_hw)
    out = t_resize.resize_bilinear_align_corners(torch.from_numpy(x), out_hw)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("hw", [(480, 640), (768, 768), (100, 80), (3, 1000)])
def test_max_res_shape(hw):
    assert t_resize.max_res_shape(*hw, 768) == j_resize.max_res_shape(*hw, 768)


def test_colorize():
    vals = np.linspace(-0.1, 1.1, 90, dtype=np.float32).reshape(9, 10)
    ref = j_colorize.colorize_depth(jnp.asarray(vals))
    out = t_colorize.colorize_depth(torch.from_numpy(vals))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)
    np.testing.assert_allclose(t_colorize.colorize_depth(torch.from_numpy(vals), reverse=True)
                               .numpy(),
                               np.asarray(j_colorize.colorize_depth(jnp.asarray(vals),
                                                                    reverse=True)),
                               atol=ATOL)


def test_math_attention():
    rng = np.random.default_rng(8)
    q, k, v = (rng.normal(size=(2, s, 3, 16)).astype(np.float32) for s in (10, 7, 7))
    ref = j_attn.dot_product_attention(*map(jnp.asarray, (q, k, v)), use_flash=False)
    out = t_attn.dot_product_attention(*map(torch.from_numpy, (q, k, v)))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


# ------------------------------------------------------------ K1: flash


# bf16: p is rounded to bf16 and l is the sum of the rounded p. Readings of
# this test's inputs, out / lse2 max abs: the plain version 1.2e-4 / 2.4e-5
# (d=64) and 9.8e-4 / 2.1e-5 (d=512); a version that skips the rounding of p
# 2.0e-3 / 9.2e-4 and 2.0e-3 / 6.9e-4, so the bounds below refuse it.
@pytest.mark.parametrize("dtype,atol_out,atol_lse", [
    (jnp.float32, ATOL, ATOL),
    (jnp.bfloat16, 1.5e-3, 1e-4),
])
@pytest.mark.parametrize("bh,s,d", [(2, 256, 64), (1, 256, 512)])
def test_flash_plain_matches_pallas_kernel(bh, s, d, dtype, atol_out, atol_lse):
    """K1's plain version vs the Pallas kernel (interpret mode): out and
    the base-2 lse."""
    rng = np.random.default_rng(9)
    jq, jk, jv = (jnp.asarray(rng.normal(size=(bh, s, d)).astype(np.float32), dtype)
                  for _ in range(3))
    scale = d ** -0.5
    with pltpu.force_tpu_interpret_mode():
        ref_o, ref_l = j_fa._flash_bhsd(jq, jk, jv, scale)
    tdt = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    out_o, out_l = t_fa._flash_bhsd(
        *(torch.from_numpy(np.array(x, np.float32)).to(tdt) for x in (jq, jk, jv)),
        scale)
    assert out_o.dtype == tdt and out_l.dtype == torch.float32
    assert out_l.shape == ref_l.shape == (bh, s, 1)
    np.testing.assert_allclose(out_o.float().numpy(), np.asarray(ref_o, np.float32),
                               atol=atol_out)
    np.testing.assert_allclose(out_l.numpy(), np.asarray(ref_l), atol=atol_lse)


def test_flash_attention_bshd_layout():
    """flash_attention's (B, S, H, D) head layout, against JAX's wrapper."""
    rng = np.random.default_rng(10)
    q, k, v = (rng.normal(size=(2, 256, 3, 64)).astype(np.float32) for _ in range(3))
    with pltpu.force_tpu_interpret_mode():
        ref = j_fa.flash_attention(*map(jnp.asarray, (q, k, v)))
    out = t_fa.flash_attention(*map(torch.from_numpy, (q, k, v)))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


def test_flash_kv_valid_not_ported():
    x = torch.zeros(1, 128, 64)
    with pytest.raises(NotImplementedError):
        t_fa._flash_bhsd(x, x, x, 0.125, kv_valid=77)


# 768^2 main-path attention shapes (sq, sk, d), plus ones either side of the
# thresholds and the 480x640 path
ROUTING_SHAPES = [
    (9216, 9216, 64), (2304, 2304, 64), (576, 576, 64), (144, 144, 64),
    (9216, 77, 64), (2304, 77, 64), (576, 77, 64), (144, 77, 64),
    (9216, 9216, 512), (6912, 6912, 512), (6912, 6912, 64), (1728, 1728, 64),
    (432, 432, 64), (2048, 2048, 64), (2200, 2200, 64), (576, 576, 512),
    (4096, 4096, 96),
]


@pytest.mark.parametrize("sq,sk,d", ROUTING_SHAPES)
def test_routing_matches_jax(sq, sk, d, monkeypatch):
    """The port routes to flash exactly where JAX does on an accelerator."""
    import genpercept_tpu.ops.flash_attention as jfa_mod

    monkeypatch.setattr(j_attn.jax, "default_backend", lambda: "tpu")
    monkeypatch.setattr(jfa_mod, "flash_attention", lambda *a, **kw: "flash")
    monkeypatch.setattr(j_attn, "_xla_attention", lambda *a, **kw: "xla")
    q = jax.ShapeDtypeStruct((1, sq, 1, d), jnp.float32)
    k = jax.ShapeDtypeStruct((1, sk, 1, d), jnp.float32)
    jax_route = j_attn.dot_product_attention(q, k, k)
    assert t_attn.routes_to_flash(sq, sk, d) == (jax_route == "flash")
    assert t_fa.supported(sq, sk, d) == j_fa.supported(sq, sk, d)


@pytest.mark.parametrize("d", [128, 256])
def test_flash_head_dims_narrowed(d):
    """The one place the port's routing differs from JAX's: the kernel is
    built for SD2.1's head dims (64, 512) only, so d=128 and d=256, which
    the TPU kernel took, stay on the plain softmax."""
    assert j_fa.supported(4096, 4096, d) and not t_fa.supported(4096, 4096, d)
    assert not t_attn.routes_to_flash(4096, 4096, d)
    with pytest.raises(ValueError):
        t_fa.flash_attention(*(torch.zeros(1, 4096, 1, d),) * 3)


# ------------------------------------------------------------ K2: fused FF


@pytest.mark.parametrize("shape,dtype,atol", [
    ((1, 512, 320), jnp.float32, 2e-5),
    ((2, 512, 64), jnp.float32, 2e-5),
    ((1, 512, 320), jnp.bfloat16, 6e-2),
    ((2, 512, 64), jnp.bfloat16, 6e-2),
])
def test_fused_ff_plain_matches_pallas_kernel(shape, dtype, atol):
    b, s, c = shape
    rng = np.random.default_rng(11)
    x = (rng.normal(size=shape) * 2.0).astype(np.float32)
    w1 = rng.uniform(-1, 1, size=(c, 8 * c)).astype(np.float32) / np.sqrt(c)
    b1 = (rng.normal(size=(8 * c,)) * 0.1).astype(np.float32)
    w2 = rng.uniform(-1, 1, size=(4 * c, c)).astype(np.float32) / np.sqrt(4 * c)
    b2 = (rng.normal(size=(c,)) * 0.1).astype(np.float32)
    jx = jnp.asarray(x, dtype)
    with pltpu.force_tpu_interpret_mode():
        ref = j_ff.fused_geglu_ff(jx, jnp.asarray(w1, dtype), jnp.asarray(b1),
                                  jnp.asarray(w2, dtype), jnp.asarray(b2))
    tdt = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(tdt)
    out = t_ff.fused_geglu_ff(tx, torch.from_numpy(w1.T.copy()).to(tdt),
                              torch.from_numpy(b1),
                              torch.from_numpy(w2.T.copy()).to(tdt),
                              torch.from_numpy(b2))
    assert out.dtype == tdt and out.shape == shape
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32), atol=atol)


@pytest.mark.parametrize("b,s,c", [(1, 9216, 320), (2, 9216, 320), (1, 6912, 320),
                                   (1, 2304, 640), (1, 512, 320), (3, 100, 320)])
def test_fused_ff_routing_matches_jax(b, s, c):
    assert t_ff.supported(b, s, c) == j_ff.supported(b, s, c)


# ------------------------------------------------------------ dispatch


def test_reference_kernels_off_by_default():
    assert not _dispatch.reference_active()
    with T.reference_kernels():
        assert _dispatch.reference_active()
    assert not _dispatch.reference_active()


def test_cpu_tensors_take_plain_versions():
    """On the CPU no kernel is launched and no library is loaded."""
    k1, k2 = t_fa._flash_bhsd.launches, t_ff.fused_geglu_ff.launches
    x = torch.zeros(1, 512, 320)
    t_ff.fused_geglu_ff(x, torch.zeros(2560, 320), None, torch.zeros(320, 1280), None)
    t_fa.flash_attention(torch.zeros(1, 576, 2, 64), torch.zeros(1, 576, 2, 64),
                         torch.zeros(1, 576, 2, 64))
    assert (t_fa._flash_bhsd.launches, t_ff.fused_geglu_ff.launches) == (k1, k2)
    assert not _dispatch.use_kernel(x)
    assert _build._lib is None


def test_import_leaves_jax_out():
    code = ("import sys, genpercept_tpu_torch, genpercept_tpu_torch.pipeline, "
            "genpercept_tpu_torch.io; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
            "or m.startswith('genpercept_tpu.') or m == 'genpercept_tpu']; "
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
