"""The numerics of K2's f32 body: split TF32 (3xTF32) products, on the CPU.

On the card, K2 in f32 (csrc/fused_geglu_ff_fwd.cu,
fused_geglu_ff_f32_kernel) takes its three products (x.Wh, x.Wg and
a.W2) on the tensor cores through split TF32, the arithmetic of K1's and
K3/K4's f32 bodies, which tests/test_torch_flash_f32.py emulates (``split``,
``mm3``, ``mm1``) and whose truncating accumulator it models
(``output_products``). No CUDA kernel runs here, so this file emulates the
body over its own tiles (h and g summed over C in one accumulator, the
down-product per W2 tile of its inner columns, each tile's part added by
f32 adds) and holds it to:

- JAX's ``_fused_geglu_fwd_impl`` in Pallas interpret mode, within
  tests/test_torch_ops.py's f32 2e-5;
- the card's bar for K2 in f32 (2e-5 of max|plain|, tests/test_torch_cuda.py,
  chip_smoke.TOL["K2"]): three passes stay under it, a single TF32 pass does
  not, so the bar separates the two;
- the tensor cores' accumulator over the body's three products: with the
  down-product summed in one accumulator over all 1,280 inner columns, K2
  reads past 1e-5 of max|exact|; summed per W2 tile in accumulators of its
  own (the body's design), under half of that.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from genpercept_tpu.ops import fused_ff as j_ff
from genpercept_tpu_torch import _build
from genpercept_tpu_torch.ops import fused_ff as t_ff
from test_torch_flash_f32 import mm1, mm3, output_products

torch.set_num_threads(1)

ATOL = 2e-5  # tests/test_torch_ops.py's f32 tolerance against JAX
CARD_BAR = 2e-5  # tests/test_torch_cuda.py K2_F32_REL: of max|plain|


def _constant(name: str) -> int:
    """A tile constant of the f32 body (csrc/fused_geglu_ff_fwd.cu)."""
    src = (_build.CSRC / "fused_geglu_ff_fwd.cu").read_text()
    (v,) = re.findall(rf"constexpr int {name} = (\d+);", src)
    return int(v)


K2 = _constant("kF32K2")  # inner columns a W2 tile


def _geglu(h, g):
    return h * (0.5 * g * (1.0 + t_ff._erf_f32(g * 2.0 ** -0.5)))


def k2_emulated(x, w1, b1, w2, b2, mm=mm3):
    """K2's f32 body with products ``mm``. x: (rows, C); w1: (2 inner, C),
    hidden rows then gate rows; w2: (C, inner). The down-product is summed
    over the body's W2 tiles of K2 inner columns, each tile's product added
    by f32 adds."""
    inner = w1.shape[0] // 2
    a = _geglu(mm(x, w1[:inner].T) + b1[:inner], mm(x, w1[inner:].T) + b1[inner:])
    y = sum(mm(a[:, i0:i0 + K2], w2[:, i0:i0 + K2].T) for i0 in range(0, inner, K2))
    return y + b2


def _card_inputs(seed: int, rows: int, c: int = 320):
    """chip_smoke.phase_k2's draws in numpy: x ~ N(0, 1), weights uniform in
    +-1/sqrt(fan in), biases 0.1 N(0, 1); PyTorch's layouts."""
    inner = 4 * c
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((rows, c), dtype=np.float32)
    w1 = (rng.uniform(-1, 1, (2 * inner, c)) / np.sqrt(c)).astype(np.float32)
    b1 = (rng.standard_normal(2 * inner) * 0.1).astype(np.float32)
    w2 = (rng.uniform(-1, 1, (c, inner)) / np.sqrt(inner)).astype(np.float32)
    b2 = (rng.standard_normal(c) * 0.1).astype(np.float32)
    return [torch.from_numpy(a) for a in (x, w1, b1, w2, b2)]


def test_body_constants_tile_c320():
    """The emulation's W2 tiles are the body's, whole over the pipeline's
    inner = 1280."""
    assert K2 == 16 and 1280 % K2 == 0


@pytest.mark.parametrize("shape", [(1, 512, 320), (2, 512, 64)])
def test_k2_split_tf32_matches_pallas_kernel(shape):
    """K2's f32 body, emulated (3xTF32 products over its tiles and chunks),
    against JAX's _fused_geglu_fwd_impl in Pallas interpret mode, with
    tests/test_torch_ops.py's inputs."""
    b, s, c = shape
    rng = np.random.default_rng(11)
    x = (rng.normal(size=shape) * 2.0).astype(np.float32)
    w1 = (rng.uniform(-1, 1, size=(c, 8 * c)).astype(np.float32) / np.sqrt(c)).astype(np.float32)
    b1 = (rng.normal(size=(8 * c,)) * 0.1).astype(np.float32)
    w2 = (rng.uniform(-1, 1, size=(4 * c, c)).astype(np.float32)
          / np.sqrt(4 * c)).astype(np.float32)
    b2 = (rng.normal(size=(c,)) * 0.1).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        ref = j_ff._fused_geglu_fwd_impl(*map(jnp.asarray, (x, w1, b1, w2, b2)))
    got = k2_emulated(torch.from_numpy(x.reshape(b * s, c)), torch.from_numpy(w1.T.copy()),
                      torch.from_numpy(b1), torch.from_numpy(w2.T.copy()),
                      torch.from_numpy(b2))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref).reshape(b * s, c), atol=ATOL)


# Readings (max abs error / max|plain|, the exact-f32 plain version): 3xTF32
# 6.4e-7, one TF32 pass 5.1e-4. Three passes stay ~30x under the card's bar,
# one pass lies ~25x past it.
def test_card_bar_separates_split_from_single_tf32():
    """Emulated K2 at 1024 rows against the plain version
    (_fused_geglu_ff_ref, exact f32), held to the card's bar: 3xTF32 within
    a tenth of it, a single TF32 pass past it."""
    x, w1, b1, w2, b2 = _card_inputs(40, 1024)
    ref = t_ff._fused_geglu_ff_ref(x, w1, b1, w2, b2)

    def rel_err(mm):
        return ((k2_emulated(x, w1, b1, w2, b2, mm) - ref).abs().max() / ref.abs().max()).item()

    three, one = rel_err(mm3), rel_err(mm1)
    assert three <= CARD_BAR / 10, three
    assert one > CARD_BAR, one


def k2_truncated(x, w1, b1, w2, b2, per_tile: bool):
    """K2's f32 body with every sum into a tensor-core accumulator rounded
    toward zero (``output_products``). h and g sum over C in one
    accumulator; the down-product per W2 tile of K2 inner columns in
    accumulators of their own added by f32 adds (per_tile, the body), else
    in one accumulator over all of inner."""
    inner, c = w1.shape[0] // 2, x.shape[1]

    def up(w):
        return output_products(x, w.T.contiguous(), c, True)

    a = _geglu(up(w1[:inner]) + b1[:inner], up(w1[inner:]) + b1[inner:])
    return output_products(a, w2.T.contiguous(), K2, per_tile) + b2


# Readings (max abs error / max|exact|, per W2 tile / one accumulator for
# the down-product), in the order of the cases below: 4.7e-6 / 1.2e-5,
# 5.2e-6 / 1.4e-5. One accumulator over the 160 k steps of inner = 1280
# (480 truncating sums) reads past 1e-5, so the body sums each W2 tile in
# accumulators of its own. Most of what remains is h and g's one
# accumulator over C = 320: summed per W1 tile of 40 as well, the model read
# 7.6e-7 (timed against the body in PERF.md).
@pytest.mark.parametrize("rows,seed", [(64, 41), (128, 42)])
def test_k2_per_tile_accumulators_keep_error_small(rows, seed):
    """The truncation of every sum into a tensor-core accumulator biases a
    product toward zero by up to an ulp of the accumulator per mma: with the
    down-product in one accumulator over all of inner, K2 reads past 1e-5 of
    max|exact|; with the body's per-tile accumulators, under it. Exact from
    float64."""
    x, w1, b1, w2, b2 = _card_inputs(seed, rows)
    inner = w1.shape[0] // 2
    xd, w1d = x.double(), w1.double()
    h = xd @ w1d[:inner].T + b1[:inner].double()
    g = xd @ w1d[inner:].T + b1[inner:].double()
    exact = (h * 0.5 * g * (1 + torch.special.erf(g / 2 ** 0.5))) @ w2.double().T + b2.double()

    def rel_err(per_tile):
        got = k2_truncated(x, w1, b1, w2, b2, per_tile)
        return ((got.double() - exact).abs().max() / exact.abs().max()).item()

    tile, once = rel_err(True), rel_err(False)
    assert tile <= 1e-5, tile
    assert once > 1e-5, once


def _tune_k2():
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parent.parent / "scripts" / "tune_k2.py"
    spec = importlib.util.spec_from_file_location("tune_k2", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _tune_args(tile=(), ctas=(), split=()):
    import argparse
    return argparse.Namespace(dtype="f32", tile=list(tile), ctas=list(ctas), split=list(split),
                              share=[], variant=[], baseline=[])


def test_tune_k2_variants_edit_what_they_name():
    """scripts/tune_k2.py builds each variant from the shipped source with
    only the named edit: the f32 instantiation (and the W1 tile's columns),
    the CTA rule, or the split form in common.cuh."""
    mod = _tune_k2()
    out = mod.variants(_tune_args(tile=["1,4", "2,4,40"], ctas=["blocks", "halves"],
                                  split=["onepass"]))
    src, hdr = out["shipped"]
    (shipped,) = set(mod.SHIPPED_TILE.findall(src))
    launch = f"launch_f32<320, {shipped[0]}, {shipped[1]}>"
    assert out["tile_1_4"] == (src.replace(launch, "launch_f32<320, 1, 4>"), hdr)
    assert out["tile_2_4_40"][0] == mod.SHIPPED_KT.sub(
        "constexpr int kF32KT = 40;", src.replace(launch, "launch_f32<320, 2, 4>"))
    for name, rule in mod.CTAS.items():
        edited = out[f"ctas_{name}"][0]
        head, _, tail = edited.partition("int f32_ctas(int blocks, int chunks) {\n")
        assert head == src.partition("int f32_ctas(")[0]
        assert tail.startswith(rule + "\n}\n") and "sms" not in tail.split("\n}\n")[0]
    assert out["onepass"][0] == src and "lo = 0u;" in out["onepass"][1]
    assert "lo = 0u;" not in hdr
    with pytest.raises(SystemExit):  # MT,NBUF[,KT] only
        mod.variants(_tune_args(tile=["2"]))
