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


def card_args(c=128, co=128):
    return (torch.zeros(1, c, 16, 16), torch.zeros(co, c, 3, 3, dtype=torch.int8),
            torch.ones(c), torch.ones(co), torch.zeros(co))


def test_card_path_refuses_gradients(monkeypatch):
    monkeypatch.setattr(_dispatch, "use_kernel", lambda x: True)
    x, w, ia, osc, b = card_args()
    with pytest.raises(RuntimeError, match="inference only"):
        tqc.quantized_conv3x3(x.requires_grad_(), w, ia, osc, b)


@pytest.mark.parametrize("what", ["dtype", "channels", "out_channels", "weight_dtype"])
def test_card_path_refuses_what_the_kernel_lacks(what, monkeypatch):
    monkeypatch.setattr(_dispatch, "use_kernel", lambda x: True)
    x, w, ia, osc, b = card_args()
    if what == "dtype":
        x = x.half()
    elif what == "channels":
        x, w, ia = x[:, :96], w[:, :96], ia[:96]
    elif what == "out_channels":
        w, osc, b = w[:96], osc[:96], b[:96]
    else:
        w = w.float()
    with torch.no_grad(), pytest.raises(ValueError):
        tqc.quantized_conv3x3(x, w, ia, osc, b)
