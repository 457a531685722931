"""The numerics of K2's bf16 body at C = 640 and 1280 (wgmma), on the CPU.

On the card, K2 in bf16 at the UNet's level-1 and level-2 widths
(csrc/fused_geglu_ff_fwd.cu, fused_geglu_ff_wide_kernel) gives each CTA 64
rows and 640 output columns. At C = 1280 two CTAs of a cluster take the same
rows and split x . W1's depth: each sums its 640 columns of x in one f32
accumulator per element, they exchange those partial sums, and both add own
+ other (f32 addition commutes: the same bits in both). h and g are rounded
to bf16 after the bias, GEGLU runs in f32 and a is rounded; a . W2 sums over
the inner columns of a CTA's part of its row block in one accumulator per
output element, and every part's f32 sums go to a slab of scratch, added in
the order of the clusters by the part that counts last, before b2 and the
rounding to bf16. No CUDA kernel runs here, so this file emulates that
arithmetic (``k2_wide_emulated``: the depth split, the walk over the card's
clusters and the combine, with the tensor cores' truncating accumulate
modelled as tests/test_torch_fused_ff_f32.py models it) and holds it to:

- JAX's ``_fused_geglu_fwd_impl`` in Pallas interpret mode and the plain
  version (``_fused_geglu_ff_ref``), within one bf16 ulp of max|out|, at
  C = 640 and 1280 with 512 rows (the TPU's row block) and a narrow inner;
- the card's three bars for K2 in bf16 (tests/test_torch_cuda.py,
  chip_smoke.py): 6e-2 absolute, 2^-6 of max|plain| and a mean abs error of
  1e-5 of max|plain|, at the card's inputs: the emulation meets all three,
  a body whose running sum passes through bf16 after each 64-column unit
  fails the mean bar, and one whose depth halves' partial sums are rounded
  to bf16 before the exchange fails it too;

and pins the tile (160 output registers a thread, shared memory within a
CTA's, the cluster's CTAs) and the walk at the UNet's shapes.
"""

import argparse
import importlib.util
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from genpercept_tpu.ops import fused_ff as j_ff
from genpercept_tpu_torch import _build
from genpercept_tpu_torch.ops import fused_ff as t_ff
from test_torch_fused_ff_bf16 import (ABS_BAR, MAX_REL_BAR, MEAN_REL_BAR, _card_inputs,
                                      _products, _ulp_of_max, cta_of, errors)

torch.set_num_threads(1)

_SRC = (_build.CSRC / "fused_geglu_ff_fwd.cu").read_text()
SMEM_PER_CTA = 232448  # an H100 CTA's shared memory (bytes)
# clusters the card runs at once (cudaOccupancyMaxActiveClusters on an H100
# 80GB HBM3, read on the card): 2-CTA clusters of one CTA a SM fill the 132
# SMs; 4-CTA clusters (tune_k2.py rb2) fit 30, as the GPCs' SMs fall
MAX_CLUSTERS = {2: 66, 4: 30}


def _constant(name: str) -> int:
    (v,) = re.findall(rf"constexpr int {name} = (\d+);", _SRC)
    return int(v)


IC = _constant("kWideIC")  # inner columns a chunk
UNIT = _constant("kWideUnitIC")  # inner columns a unit of the walk
MIN_SHARE = _constant("kWideMinShare")
CC = _constant("kWideCC")  # x's columns and output columns a CTA
RB = {c: int(re.search(rf"#define GP_K2_WIDE_RB_{c} (\d+)", _SRC).group(1)) for c in (640, 1280)}


def cluster_ctas(c: int) -> int:
    return RB[c] * (c // CC)


def wide_walk(rows: int, inner: int, c: int, rb: int | None = None):
    """wide_plan: the clusters, and per block of RB 64-row blocks the unit
    ranges of its parts, in the order of the clusters that take them."""
    rb = RB[c] if rb is None else rb
    upb = inner // UNIT
    blocks = -(-rows // (64 * rb))
    units = blocks * upb
    clusters = max(1, min(MAX_CLUSTERS[rb * (c // CC)], units // MIN_SHARE))
    share, rest = divmod(units, clusters)
    begins = [b * share + min(b, rest) for b in range(clusters)] + [units]
    parts = []
    for k in range(blocks):
        lo, hi = k * upb, (k + 1) * upb
        owners = range(cta_of(lo, share, rest), cta_of(hi - 1, share, rest) + 1)
        parts.append([(max(lo, begins[b]) - lo, min(hi, begins[b + 1]) - lo) for b in owners])
    return clusters, parts


def _up(xf, w, c, rz, bf16_halves=False):
    """x . w^T as the body sums it: over each CTA's 640 columns of the depth
    in one accumulator (k steps of 16), the depth halves' sums added in f32;
    bf16_halves: each half's sum rounded to bf16 first (a mutated body)."""
    halves = [_products(xf[:, k:k + CC], w[:, k:k + CC].T, None, rz) for k in range(0, c, CC)]
    if bf16_halves:
        halves = [h.to(torch.bfloat16).float() for h in halves]
    total = halves[0]
    for h in halves[1:]:
        total = total + h
    return total


def k2_wide_emulated(x, w1, b1, w2, b2, rz: bool = True, bf16_partials: bool = False,
                     bf16_halves: bool = False):
    """K2's bf16 body at C = 640 / 1280 over its depth split, walk and
    combine. x: (rows, C) bf16; w1: (2 inner, C) bf16, hidden rows then gate
    rows; w2: (C, inner) bf16; b1, b2 f32. bf16_partials: the running sum
    rounded to bf16 after each unit; bf16_halves: the depth halves' partial
    sums rounded to bf16 before the exchange (mutated bodies)."""
    rows, c = x.shape
    inner = w1.shape[0] // 2
    xf, w1f, w2f = x.float(), w1.float(), w2.float()
    bf = torch.bfloat16
    h = (_up(xf, w1f[:inner], c, rz, bf16_halves) + b1[:inner]).to(bf).float()
    g = (_up(xf, w1f[inner:], c, rz, bf16_halves) + b1[inner:]).to(bf).float()
    a = (h * (0.5 * g * (1.0 + t_ff._erf_f32(g * 2.0 ** -0.5)))).to(bf).float()
    _, parts = wide_walk(rows, inner, c)
    y = torch.empty(rows, c, dtype=bf)
    br = 64 * RB[c]
    for k, block in enumerate(parts):
        r = slice(k * br, min((k + 1) * br, rows))
        if r.start >= rows:
            continue
        sums = []
        for u0, u1 in block:  # one cluster's part: its units, in order
            out = torch.zeros(r.stop - r.start, c)
            for col in range(0, c, CC):  # each CTA's output columns, its own accumulator
                cols = slice(col, col + CC)
                acc = torch.zeros(r.stop - r.start, CC)
                for c0 in range(u0 * UNIT, u1 * UNIT, IC):
                    cs = slice(c0, c0 + IC)
                    acc = _products(a[r, cs], w2f[cols, cs].T, acc, rz)
                    if bf16_partials and (c0 + IC) % UNIT == 0:
                        acc = acc.to(bf).float()
                out[:, cols] = acc
            sums.append(out)
        total = sums[0]
        for s in sums[1:]:  # the combine: the slabs in the order of the clusters
            total = total + s
        y[r] = (total + b2).to(bf)
    return y


def test_body_constants_tile_wide():
    """The emulation's tiles are the ones the dispatch instantiates: chunks
    of 32 inner columns in units of 64, 640 columns a CTA; each consumer
    thread holds 160 output accumulators (two m64n160 of its warpgroup's
    320 columns); a CTA's shared memory (x, the W1 and W2 slots, the a
    tiles, at C = 1280 the partials received, barriers) within the card's;
    clusters of 2 CTAs at both widths: at C = 640 two row blocks sharing
    every weight load, at C = 1280 the two depth halves of one row block."""
    assert (IC, UNIT, MIN_SHARE, CC) == (32, 64, 5, 640)
    (acc,) = re.findall(r"float out\[(\d+)\]\[(\d+)\]\[4\];  // output columns col0", _SRC)
    assert int(acc[0]) * int(acc[1]) * 4 == 160
    assert RB == {640: 2, 1280: 1}
    assert cluster_ctas(640) == 2 and cluster_ctas(1280) == 2 and 1280 // CC == 2
    for c in (640, 1280):
        xs = CC // 64 * 64 * 128  # x: 10 atoms of 64 rows x 128 B
        w1 = 2 * (CC // 64 // 2) * (2 * IC * 128)  # two slots of half the depth
        w2 = CC * IC * 2  # one slot: 640 rows x 32 inner columns
        at = 2 * 64 * IC * 2  # two a tiles
        xch = 256 * 16 * 4 if c // CC > 1 else 0  # 16 f32 partials a consumer thread
        total = 1024 + xs + w1 + w2 + at + xch + 8 * 11 + 32
        assert total <= SMEM_PER_CTA, (c, total)
    assert re.search(r"static_assert\(BYTES <= 232448", _SRC)


@pytest.mark.parametrize("shape,clusters,most", [
    ((2, 2304, 640), 66, 3), ((8, 2304, 640), 66, 2),
    ((2, 576, 1280), 66, 5), ((8, 576, 1280), 66, 2)])
def test_walk_plan_at_the_unet_shapes(shape, clusters, most):
    """The walk at the UNet's level-1 and level-2 shapes (batch 2: the
    pipeline's; batch 8): one cluster a pair of SMs, and at most `most`
    parts a block. At (2, 576, 1280) the 18 row blocks fall into up to 5
    parts each: without the split of the inner dimension only 18 of the 66
    clusters would have work."""
    b, s, c = shape
    got, parts = wide_walk(b * s, 4 * c, c)
    assert got == clusters and max(map(len, parts)) == most
    upb = 4 * c // UNIT
    assert all(p[0][0] == 0 and p[-1][1] == upb and all(q[1] == r[0] for q, r in zip(p, p[1:]))
               for p in parts)
    assert len(parts) == -(-b * s // (64 * RB[c]))


def test_walk_with_four_cta_clusters():
    """tune_k2.py's rb2 variant (C = 1280 with two row blocks of two CTAs a
    cluster): 30 clusters fit at once, not 132 / 4 = 33, so a grid sized by
    the SM count would run a second wave; the plan takes 30."""
    clusters, _ = wide_walk(4608, 5120, 1280, rb=2)
    assert clusters == 30 and MAX_CLUSTERS[4] == 30


@pytest.mark.parametrize("c", [640, 1280])
def test_k2_wide_emulated_matches_pallas_kernel(c):
    """K2's bf16 body at C = 640 / 1280, emulated (its depth split, walk and
    combine, truncating accumulators), against JAX's _fused_geglu_fwd_impl
    in Pallas interpret mode and the plain version, on 512 rows with an
    inner of 256: within one bf16 ulp of max|out| (the same rounding
    points; the f32 sums run in another order)."""
    rows, inner = 512, 256
    rng = np.random.default_rng(12)
    x = (rng.normal(size=(1, rows, c)) * 2.0).astype(np.float32)
    w1 = (rng.uniform(-1, 1, size=(c, 2 * inner)) / np.sqrt(c)).astype(np.float32)
    b1 = (rng.normal(size=(2 * inner,)) * 0.1).astype(np.float32)
    w2 = (rng.uniform(-1, 1, size=(inner, c)) / np.sqrt(inner)).astype(np.float32)
    b2 = (rng.normal(size=(c,)) * 0.1).astype(np.float32)
    jb = jnp.bfloat16
    with pltpu.force_tpu_interpret_mode():
        ref = j_ff._fused_geglu_fwd_impl(jnp.asarray(x, jb), jnp.asarray(w1, jb), jnp.asarray(b1),
                                         jnp.asarray(w2, jb), jnp.asarray(b2))
    ref = torch.from_numpy(np.array(ref.astype(jnp.float32))).reshape(rows, c)
    tb = torch.bfloat16
    args = (torch.from_numpy(x.reshape(rows, c)).to(tb), torch.from_numpy(w1.T.copy()).to(tb),
            torch.from_numpy(b1), torch.from_numpy(w2.T.copy()).to(tb), torch.from_numpy(b2))
    _, parts = wide_walk(rows, inner, c)
    assert max(map(len, parts)) > 1  # blocks in parts: the combine runs
    got = k2_wide_emulated(*args)
    plain = t_ff._fused_geglu_ff_ref(*args)
    tol = _ulp_of_max(ref)
    assert (got.float() - ref).abs().max().item() <= tol
    assert (got.float() - plain.float()).abs().max().item() <= tol


# Readings (max abs, max rel, mean rel against the plain version, the
# card's inputs, seed 42): C = 640, 256 rows: the emulation 2.0e-3, 2.7e-3,
# 4.8e-6 (1.1e-6 with sums rounded to nearest); the running sum in bf16
# after each unit 3.9e-3, 5.3e-3, 3.6e-4. C = 1280, 128 rows: 3.9e-3,
# 5.3e-3, 6.2e-6 (1.7e-6 to nearest); in bf16 after each unit 3.9e-3,
# 5.3e-3, 3.7e-4; the depth halves rounded to bf16 before the exchange
# 3.9e-3, 5.3e-3, 5.6e-4. The card read 2.6e-6 to 5.1e-6 mean rel at the
# UNet's shapes (tune_k2.py --shapes wide, PERF.md).
@pytest.mark.parametrize("c,rows", [(640, 256), (1280, 128)])
def test_card_bars_see_bf16_sums(c, rows):
    """At the card's inputs (inner = 4 C), emulated K2 meets the card's three
    bars; the body with its running sum rounded to bf16 after each unit,
    and at C = 1280 the one whose depth halves' partial sums are rounded to
    bf16 before the exchange, fail the mean bar by more than 10x while
    their max errors stay within the max bars."""
    args = _card_inputs(42, rows, c)
    ref = t_ff._fused_geglu_ff_ref(*args)
    _, parts = wide_walk(rows, 4 * c, c)
    assert max(map(len, parts)) > 1
    mx, rel, mean = errors(k2_wide_emulated(*args), ref)
    assert mx <= ABS_BAR and rel <= MAX_REL_BAR and mean <= MEAN_REL_BAR, (mx, rel, mean)
    mutants = [dict(bf16_partials=True)] + ([dict(bf16_halves=True)] if c > CC else [])
    for mutant in mutants:
        mx_m, rel_m, mean_m = errors(k2_wide_emulated(*args, **mutant), ref)
        assert mean_m > 10 * MEAN_REL_BAR and mx_m <= ABS_BAR and rel_m <= MAX_REL_BAR, (
            mutant, mx_m, rel_m, mean_m)


def _tune_k2():
    path = Path(__file__).resolve().parent.parent / "scripts" / "tune_k2.py"
    spec = importlib.util.spec_from_file_location("tune_k2", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_tune_k2_wide_variants_edit_what_they_name():
    """scripts/tune_k2.py --shapes wide builds each variant from the shipped
    source with its edits applied: rb1 and rb2 change only the clusters'
    row blocks, and the probes (noexch, nogeglu, noup, rings) each find every
    line they edit; the C = 320 options are refused there."""
    mod = _tune_k2()
    names = ["rb1", "rb2", "noexch", "nogeglu", "noup", "rings"]
    out = mod.variants(argparse.Namespace(dtype="bf16", shapes="wide", tile=[], ctas=[],
                                          split=[], share=[], variant=names, baseline=[]))
    src, _ = out["shipped"]
    assert set(out) == {"shipped", *names} and all(out[n][0] != src for n in names)
    assert out["rb1"][0] == src.replace("#define GP_K2_WIDE_RB_640 2",
                                        "#define GP_K2_WIDE_RB_640 1")
    assert out["rb2"][0] == src.replace("#define GP_K2_WIDE_RB_1280 1",
                                        "#define GP_K2_WIDE_RB_1280 2")
    assert "send_partials(xch, hg" not in out["noexch"][0].split("fused_geglu_ff_wide_kernel(")[1]
    with pytest.raises(SystemExit):
        mod.variants(argparse.Namespace(dtype="bf16", shapes="wide", tile=[], ctas=[], split=[],
                                        share=[], variant=["onebuf"], baseline=[]))
    assert mod.kernels_of("bf16", "fused_geglu_ff_wide_kernel", wide=True)
    assert not mod.kernels_of("bf16", "fused_geglu_ff_wide_kernel")
    assert not mod.kernels_of("bf16", "fused_geglu_ff_wgmma_kernel", wide=True)
