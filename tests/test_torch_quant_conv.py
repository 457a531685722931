"""K7, the W8A8 conv3x3 with in-kernel quantize, held to the JAX package's
Pallas kernel (interpret mode on the CPU) at small sizes.

The JAX QConv (``quantize_conv`` on absmax statistics, symmetric, as the JAX
test and profiling script build it) is carried into the port's layout
(HWIO -> OIHW) by ``test_torch_quant.to_port``, the conversion of
``load_calibration``. Tolerances: f32 1e-5 (the JAX package's bar: the int32
sums are exact); bf16 array-equal at the JAX package's own test shape, as it
requires of its kernel. Elsewhere one bf16 ulp on a few outputs: XLA on the
CPU contracts the epilogue acc * o_scale + bias into one fused multiply-add,
where the port (plain version and kernel alike) rounds the product and the
sum separately, as the source writes them; an f32 value that lands within
one f32 ulp of a bf16 rounding boundary then rounds the other way.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from genpercept_tpu.ops import quant as jq
from genpercept_tpu.ops import quant_conv as jqc
from genpercept_tpu_torch.ops import _dispatch
from genpercept_tpu_torch.ops import quant as tq
from genpercept_tpu_torch.ops import quant_conv as tqc
from test_torch_models import nchw, nhwc
from test_torch_quant import to_port

torch.set_num_threads(1)


def case(c, co, seed=21, shape=(2, 24, 16)):
    rng = np.random.default_rng(seed)
    n, h, w = shape
    x = rng.normal(size=(n, h, w, c)).astype(np.float32)
    p = {"weight": jnp.asarray(rng.normal(size=(3, 3, c, co)) * 0.05, jnp.float32),
         "bias": jnp.asarray(rng.normal(size=(co,)) * 0.1, jnp.float32)}
    return x, jq.quantize_conv(p, jq.absmax_per_channel(jnp.asarray(x)), margin=1.0)


def run_port(x, q, dtype):
    t = to_port(q)
    out = tqc.quantized_conv3x3(nchw(x).to(dtype), t.w_int8, t.inv_a, t.o_scale, t.bias)
    assert out.dtype == dtype
    return nhwc(out.float())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,co", [(128, 128), (128, 256), (256, 128)])
def test_plain_matches_pallas_kernel(c, co, dtype):
    x, q = case(c, co)
    assert jqc.supported(x.shape, co) and tqc.supported(nchw(x).shape, co)
    jd = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    with pltpu.force_tpu_interpret_mode():
        ref = jqc.quantized_conv3x3(jnp.asarray(x, jd), q.w_int8, q.inv_a, q.o_scale, q.bias)
    ref = np.asarray(ref.astype(jnp.float32))
    out = run_port(x, q, dtype)
    if dtype == torch.float32:
        np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-5)
    elif (c, co) == (128, 128):  # tests/test_quant.py's shape
        np.testing.assert_array_equal(out, ref)
    else:
        off = out != ref
        assert off.mean() <= 1e-4
        np.testing.assert_allclose(out[off], ref[off], rtol=2.0 ** -7, atol=0)


def test_plain_is_qconv_apply_of_the_symmetric_qconv():
    """The plain version is the int8 path's own qconv_apply (no zero point,
    padding 1, stride 1), and a missing bias is a zero bias."""
    x, q = case(128, 128, seed=3)
    t = to_port(q)
    ref = tq.qconv_apply(t, nchw(x))
    out = tqc.quantized_conv3x3(nchw(x), t.w_int8, t.inv_a, t.o_scale, t.bias)
    assert torch.equal(out, ref)
    no_bias = tqc.quantized_conv3x3(nchw(x), t.w_int8, t.inv_a, t.o_scale, None)
    zeros = tqc.quantized_conv3x3(nchw(x), t.w_int8, t.inv_a, t.o_scale,
                                  torch.zeros_like(t.bias))
    assert torch.equal(no_bias, zeros)


@pytest.mark.parametrize("shape,co,kind,stride", [
    ((2, 128, 24, 16), 128, "3x3", 1), ((2, 320, 96, 96), 320, "3x3", 1),
    ((2, 128, 8, 16), 128, "3x3", 1), ((2, 128, 24, 16), 128, "3x3", 2),
    ((2, 128, 24, 16), 128, "up4x4", 1), ((2, 512, 96, 96), 512, "3x3", (1, 1)),
])
def test_supported_matches_jax(shape, co, kind, stride):
    n, c, h, w = shape
    assert tqc.supported(shape, co, kind, stride) == jqc.supported((n, h, w, c), co, kind, stride)


def test_cpu_tensors_take_the_plain_version():
    x, q = case(128, 128, shape=(1, 16, 16))
    before = tqc.quantized_conv3x3.launches
    run_port(x, q, torch.float32)
    assert tqc.quantized_conv3x3.launches == before


def test_tap_major_weights_match_oihw():
    """The kernel's weights: (9, Co, C), tap dy * 3 + dx's (Co, C) slice."""
    w = torch.randint(-127, 128, (192, 64, 3, 3), dtype=torch.int8,
                      generator=torch.Generator().manual_seed(5))
    wt = tqc._tap_major_weights(w)
    assert wt.shape == (9, 192, 64) and wt.dtype == torch.int8 and wt.is_contiguous()
    for dy in range(3):
        for dx in range(3):
            assert torch.equal(wt[3 * dy + dx], w[:, :, dy, dx])


@pytest.mark.parametrize("co,tile", [(512, (256, 1)), (256, (256, 1)), (128, (128, 2)),
                                     (384, (128, 2)), (320, (160, 1)), (192, (64, 2)),
                                     (64, (64, 2))])
def test_tiling_per_output_channels(co, tile):
    assert tqc._tiling(co) == tile


@pytest.mark.parametrize("n,co,h,w,clusters", [
    (3, 128, 40, 24, 5), (1, 64, 16, 16, 1), (2, 192, 24, 40, 3), (1, 256, 24, 16, 2),
    (1, 320, 24, 40, 4), (2, 512, 96, 96, 66), (2, 128, 20, 24, 7),
])
def test_tile_walk_covers_every_output_once(n, co, h, w, clusters):
    """Every output pixel and channel is stored by exactly one CTA; both CTAs
    of a cluster take the same channel blocks in the same order (they share
    every weight tap); a CTA that stores nothing is a cluster's second, at
    the end of its walk."""
    bn, mb = tqc._tiling(co)
    th = 8 * mb
    count = np.zeros((n, co, h + th, w + 16), np.int32)
    walks = {}
    for ci, rank, img, co0, h0, w0, stored in tqc.tile_walk(n, co, h, w, clusters):
        walks.setdefault((ci, rank), []).append((co0, stored))
        if stored:
            count[img, co0:co0 + bn, h0:h0 + th, w0:w0 + 16] += 1
    assert (count[:, :, :h, :w] == 1).all()
    for ci in range(clusters):
        first, second = walks.get((ci, 0), []), walks.get((ci, 1), [])
        assert [c for c, _ in first] == [c for c, _ in second]
        assert all(s for _, s in first)
        stored = [s for _, s in second]
        assert stored == sorted(stored, reverse=True)


@pytest.mark.parametrize("shape,co,expect", [
    ((2, 128, 768, 768), 128, 2304 * 9 * 128 * 128),  # 16 x 16 tiles of 128 channels
    ((2, 256, 384, 384), 256, 1152 * 9 * 256 * 256),  # 8 x 16 tiles of 256
    ((2, 512, 192, 192), 512, 288 * 2 * 9 * 512 * 256),
    ((2, 320, 96, 96), 320, 72 * 2 * 9 * 320 * 160),  # 8 x 16 tiles of 160
    ((3, 128, 40, 24), 192, 9 * 3 * 9 * 128 * 64),
])
def test_weight_l2_bytes_from_the_walk(shape, co, expect):
    """A unit of the walk reads its 9 C BN weights once for both CTAs."""
    n, c, h, w = shape
    assert tqc.weight_l2_bytes(n, c, co, h, w) == expect
    if n * h * w <= 3 * 40 * 24:
        bn = tqc._tiling(co)[0]
        units = sum(1 for e in tqc.tile_walk(n, co, h, w, 3) if e[1] == 0)
        assert units * 9 * c * bn == expect


def test_aligned16_copies_only_a_misaligned_start():
    """The kernel's TMA and bulk copies read from 16-byte boundaries: the
    wrapper hands it a copy of a vector that starts elsewhere."""
    base = torch.arange(12, dtype=torch.float32)
    assert base.data_ptr() % 16 == 0
    assert tqc._aligned16(base).data_ptr() == base.data_ptr()
    moved = tqc._aligned16(base[1:])
    assert moved.data_ptr() % 16 == 0 and torch.equal(moved, base[1:])


def card_args(c=128, co=128):
    return (torch.zeros(1, c, 16, 16), torch.zeros(co, c, 3, 3, dtype=torch.int8),
            torch.ones(c), torch.ones(co), torch.zeros(co))


def test_card_path_refuses_gradients(monkeypatch):
    monkeypatch.setattr(_dispatch, "use_kernel", lambda x: True)
    x, w, ia, osc, b = card_args()
    with pytest.raises(RuntimeError, match="inference only"):
        tqc.quantized_conv3x3(x.requires_grad_(), w, ia, osc, b)


@pytest.mark.parametrize("what", ["dtype", "channels", "out_channels", "weight_dtype",
                                  "f32_width", "bf16_width"])
def test_card_path_refuses_what_the_kernel_lacks(what, monkeypatch):
    """Outside the kernel's shapes the wrapper raises; the widths refused
    (rows of x not whole 16-byte units for TMA) lie outside JAX's
    ``supported`` (w % 8)."""
    monkeypatch.setattr(_dispatch, "use_kernel", lambda x: True)
    x, w, ia, osc, b = card_args()
    if what == "dtype":
        x = x.half()
    elif what == "f32_width":
        x = x[..., :14].contiguous()
    elif what == "bf16_width":
        x = torch.zeros(1, 128, 16, 20, dtype=torch.bfloat16)
    elif what == "channels":
        x, w, ia = x[:, :96], w[:, :96], ia[:96]
    elif what == "out_channels":
        w, osc, b = w[:96], osc[:96], b[:96]
    else:
        w = w.float()
    with torch.no_grad(), pytest.raises(ValueError):
        tqc.quantized_conv3x3(x, w, ia, osc, b)
