"""The numerics of K2's bf16 body at C = 320 (wgmma), on the CPU.

On the card, K2 in bf16 (csrc/fused_geglu_ff_fwd.cu,
fused_geglu_ff_wgmma_kernel) takes x . W1 per chunk of IC inner columns on
wgmma, rounds h and g to bf16 after the bias, runs GEGLU in f32 and rounds a,
and sums a . W2 over the chunks into one f32 accumulator per row block; of
a row block that its one-wave walk splits between CTAs, the CTA of the first
part adds the later parts' f32 sums in the order of the CTAs before b2 and
the rounding to bf16. No CUDA kernel runs here, so this file emulates that arithmetic
(``k2_bf16_emulated``: the body's chunks, its walk over the card's 132 SMs
and its combine, with the tensor cores' truncating accumulate modelled as
tests/test_torch_fused_ff_f32.py models it) and holds it to:

- JAX's ``_fused_geglu_fwd_impl`` in Pallas interpret mode and the plain
  version (``_fused_geglu_ff_ref``), within one bf16 ulp of max|out|: both
  round at the same points, and only the order of the f32 sums differs,
  which can move an output across one rounding boundary;
- the card's three bars for K2 in bf16 (tests/test_torch_cuda.py,
  chip_smoke.py): 6e-2 absolute, 2^-6 of max|plain| and a mean abs error of
  K2_BF16_MEAN_REL of max|plain|. The emulation meets all three; a body whose
  running sum passes through bf16 after each 64-column unit fails the mean
  bar by more than 10x, and one that drops an inner chunk fails the max bars.
"""

import math
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from genpercept_tpu.ops import fused_ff as j_ff
from genpercept_tpu_torch import _build
from genpercept_tpu_torch.ops import fused_ff as t_ff
from test_torch_flash_f32 import rz_f32

torch.set_num_threads(1)

SMS = 132  # the H100's SMs: the walk's grid
ABS_BAR = 6e-2  # chip_smoke.TOL["K2"][bf16]: max abs
MAX_REL_BAR = 2.0 ** -6  # K2_BF16_REL: max abs over max|plain|
MEAN_REL_BAR = 1e-5  # K2_BF16_MEAN_REL: mean abs over max|plain|

_SRC = (_build.CSRC / "fused_geglu_ff_fwd.cu").read_text()


def _constant(name: str) -> int:
    """A constant of the bf16 body (csrc/fused_geglu_ff_fwd.cu)."""
    (v,) = re.findall(rf"constexpr int {name} = (\d+);", _SRC)
    return int(v)


# the instantiation the dispatch launches: consumer warpgroups, W1 and W2 ring slots
NWG, NB1, NB2 = map(int, re.search(r"#define GP_K2_BF16 320, (\d+), (\d+), (\d+)",
                                    _SRC).groups())
IC = _constant("kWgIC")  # inner columns a chunk
UNIT = _constant("kWgUnitIC")  # inner columns a unit of the walk
MIN_SHARE = _constant("kWgMinShare")
BR = 64 * NWG  # rows a CTA


def cta_of(u: int, share: int, rest: int) -> int:
    big = rest * (share + 1)
    return u // (share + 1) if u < big else rest + (u - big) // share


def walk(rows: int, inner: int, sms: int = SMS):
    """wg_plan: the grid, and per row block the unit ranges of its parts, in
    the order of the CTAs that take them."""
    upb = inner // UNIT
    blocks = -(-rows // BR)
    units = blocks * upb
    grid = max(1, min(sms, units // MIN_SHARE))
    share, rest = divmod(units, grid)
    begins = [b * share + min(b, rest) for b in range(grid)] + [units]
    parts = []
    for k in range(blocks):
        lo, hi = k * upb, (k + 1) * upb
        ctas = range(cta_of(lo, share, rest), cta_of(hi - 1, share, rest) + 1)
        parts.append([(max(lo, begins[b]) - lo, min(hi, begins[b + 1]) - lo) for b in ctas])
    return grid, parts


def _products(a: torch.Tensor, b: torch.Tensor, acc: torch.Tensor | None, rz: bool):
    """acc + a @ b in k steps of 16 (wgmma's k), each step's exact sum added to
    the f32 accumulator and rounded toward zero (rz, the tensor cores) or to
    nearest."""
    out = torch.zeros(a.shape[0], b.shape[1]) if acc is None else acc
    ad, bd = a.double(), b.double()
    for k0 in range(0, a.shape[1], 16):
        s = out.double() + ad[:, k0:k0 + 16] @ bd[k0:k0 + 16]
        out = rz_f32(s) if rz else s.float()
    return out


def k2_bf16_emulated(x, w1, b1, w2, b2, rz: bool = True, bf16_partials: bool = False,
                     drop_chunk: int | None = None, sms: int = SMS):
    """K2's bf16 body at C = 320 over its chunks, walk and combine. x: (rows,
    C) bf16; w1: (2 inner, C) bf16, hidden rows then gate rows; w2: (C,
    inner) bf16; b1, b2 f32. bf16_partials: the running sum rounded to bf16
    after each unit (a mutated body); drop_chunk: one inner chunk left out."""
    rows, c = x.shape
    inner = w1.shape[0] // 2
    xf, w1f, w2f = x.float(), w1.float(), w2.float()
    bf = torch.bfloat16
    h = (_products(xf, w1f[:inner].T, None, rz) + b1[:inner]).to(bf).float()
    g = (_products(xf, w1f[inner:].T, None, rz) + b1[inner:]).to(bf).float()
    a = (h * (0.5 * g * (1.0 + t_ff._erf_f32(g * 2.0 ** -0.5)))).to(bf).float()
    _, parts = walk(rows, inner, sms)
    y = torch.empty(rows, c, dtype=bf)
    for k, block in enumerate(parts):
        r = slice(k * BR, min((k + 1) * BR, rows))
        sums = []
        for u0, u1 in block:  # one CTA's part: its units, in order
            out = torch.zeros(r.stop - r.start, c)
            for c0 in range(u0 * UNIT, u1 * UNIT, IC):
                if c0 // IC == drop_chunk:
                    continue
                cs = slice(c0, c0 + IC)
                out = _products(a[r, cs], w2f[:, cs].T, out, rz)
                if bf16_partials and (c0 + IC) % UNIT == 0:
                    out = out.to(bf).float()
            sums.append(out)
        total = sums[0]
        for s in sums[1:]:  # the combine, in the order of the CTAs
            total = total + s
        y[r] = (total + b2).to(bf)
    return y


def _card_inputs(seed: int, rows: int, c: int = 320):
    """chip_smoke.phase_k2's draws in numpy: x ~ N(0, 1), weights uniform in
    +-1/sqrt(fan in), biases 0.1 N(0, 1); PyTorch's layouts; x and the
    weights in bf16."""
    inner = 4 * c
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((rows, c), dtype=np.float32)
    w1 = (rng.uniform(-1, 1, (2 * inner, c)) / np.sqrt(c)).astype(np.float32)
    b1 = (rng.standard_normal(2 * inner) * 0.1).astype(np.float32)
    w2 = (rng.uniform(-1, 1, (c, inner)) / np.sqrt(inner)).astype(np.float32)
    b2 = (rng.standard_normal(c) * 0.1).astype(np.float32)
    bf = torch.bfloat16
    return (torch.from_numpy(x).to(bf), torch.from_numpy(w1).to(bf), torch.from_numpy(b1),
            torch.from_numpy(w2).to(bf), torch.from_numpy(b2))


def _ulp_of_max(y: torch.Tensor) -> float:
    """One bf16 ulp at the largest |y|."""
    return 2.0 ** (math.floor(math.log2(y.float().abs().max().item())) - 7)


def errors(got: torch.Tensor, ref: torch.Tensor) -> tuple[float, float, float]:
    """max abs error, and max and mean abs error over max|ref|."""
    d = (got.float() - ref.float()).abs()
    top = ref.float().abs().max().item()
    return d.max().item(), d.max().item() / top, d.mean().item() / top


def test_body_constants_tile_c320():
    """The emulation's tiles are the ones the dispatch instantiates: 128-row
    CTAs of two consumer warpgroups, chunks of 32 inner columns in units of
    64 (the pipeline's inner = 1280 in whole units), W1/W2 rings of 2 and 3
    slots; and the walk at the main shapes: one CTA a SM, at most 3 parts a
    row block at 9216 rows (one image), 2 at 18432 (the pipeline's batch of
    2) and 38400 (the training recipe)."""
    assert (NWG, NB1, NB2, IC, UNIT, MIN_SHARE) == (2, 2, 3, 32, 64, 5)
    assert 1280 % UNIT == 0 and UNIT % IC == 0
    for rows, most in ((9216, 3), (18432, 2), (38400, 2)):
        grid, parts = walk(rows, 1280)
        assert grid == SMS and max(map(len, parts)) == most
        # every unit of every block lies with exactly one part
        assert all(b[0][0] == 0 and b[-1][1] == 1280 // UNIT and
                   all(p[1] == q[0] for p, q in zip(b, b[1:])) for b in parts)
    assert walk(96, 1280) == (4, [[(0, 5), (5, 10), (10, 15), (15, 20)]])


@pytest.mark.parametrize("shape", [(1, 512, 320), (2, 512, 320)])
def test_k2_bf16_emulated_matches_pallas_kernel(shape):
    """K2's bf16 body, emulated (its chunks, walk and combine, truncating
    accumulators), against JAX's _fused_geglu_fwd_impl in Pallas interpret
    mode with tests/test_torch_ops.py's inputs in bf16, and against the plain
    version: within one bf16 ulp of max|out| (the same rounding points; the
    f32 sums run in another order, which can move an output across one
    rounding boundary)."""
    b, s, c = shape
    rng = np.random.default_rng(11)
    x = (rng.normal(size=shape) * 2.0).astype(np.float32)
    w1 = (rng.uniform(-1, 1, size=(c, 8 * c)) / np.sqrt(c)).astype(np.float32)
    b1 = (rng.normal(size=(8 * c,)) * 0.1).astype(np.float32)
    w2 = (rng.uniform(-1, 1, size=(4 * c, c)) / np.sqrt(4 * c)).astype(np.float32)
    b2 = (rng.normal(size=(c,)) * 0.1).astype(np.float32)
    jb = jnp.bfloat16
    with pltpu.force_tpu_interpret_mode():
        ref = j_ff._fused_geglu_fwd_impl(jnp.asarray(x, jb), jnp.asarray(w1, jb), jnp.asarray(b1),
                                         jnp.asarray(w2, jb), jnp.asarray(b2))
    ref = torch.from_numpy(np.array(ref.astype(jnp.float32))).reshape(b * s, c)
    tb = torch.bfloat16
    args = (torch.from_numpy(x.reshape(b * s, c)).to(tb), torch.from_numpy(w1.T.copy()).to(tb),
            torch.from_numpy(b1), torch.from_numpy(w2.T.copy()).to(tb), torch.from_numpy(b2))
    got = k2_bf16_emulated(*args)
    plain = t_ff._fused_geglu_ff_ref(*args)
    tol = _ulp_of_max(ref)
    assert (got.float() - ref).abs().max().item() <= tol
    assert (got.float() - plain.float()).abs().max().item() <= tol


# Readings (max abs, max rel, mean rel against the plain version, 1024 rows
# of the card's inputs, seed 40; 8 row blocks split over 32 CTAs): the
# emulation 2.0e-3, 2.8e-3, 1.5e-6 (4.2e-7 with sums rounded to nearest);
# the running sum in bf16 after each unit 3.9e-3, 5.6e-3, 3.7e-4 (within
# both max bars, 37x past the mean bar); one chunk dropped 1.5e-1, 2.1e-1
# (past both max bars). The card read the parent mma.sync body and the wgmma
# body at 0.8e-6 to 1.4e-6 mean rel (PERF.md).
def test_card_bars_see_bf16_partials_and_a_dropped_chunk():
    """At the card's inputs, emulated K2 meets the card's three bars; the
    body with its running sum rounded to bf16 after each unit fails the mean
    bar by more than 10x, and the body without one inner chunk fails both
    max bars."""
    args = _card_inputs(40, 1024)
    ref = t_ff._fused_geglu_ff_ref(*args)
    _, parts = walk(1024, 1280)
    assert max(map(len, parts)) > 1  # the walk splits blocks: the combine runs
    mx, rel, mean = errors(k2_bf16_emulated(*args), ref)
    assert mx <= ABS_BAR and rel <= MAX_REL_BAR and mean <= MEAN_REL_BAR, (mx, rel, mean)
    _, _, mean_bf = errors(k2_bf16_emulated(*args, bf16_partials=True), ref)
    assert mean_bf > 10 * MEAN_REL_BAR, mean_bf
    mx_drop, rel_drop, _ = errors(k2_bf16_emulated(*args, drop_chunk=17), ref)
    assert mx_drop > ABS_BAR and rel_drop > MAX_REL_BAR, (mx_drop, rel_drop)


def test_combine_order_is_the_ctas():
    """A split row block's parts summed in the order of the CTAs, not
    all at once: the emulation over a walk of 132 CTAs and over one CTA a
    block (no split, one running sum) agree within one bf16 ulp of max|out|,
    and both meet the card's bars."""
    args = _card_inputs(41, 512)
    ref = t_ff._fused_geglu_ff_ref(*args)
    split = k2_bf16_emulated(*args)
    whole = k2_bf16_emulated(*args, sms=1)
    assert (split.float() - whole.float()).abs().max().item() <= _ulp_of_max(ref)
    for got in (split, whole):
        mx, rel, mean = errors(got, ref)
        assert mx <= ABS_BAR and rel <= MAX_REL_BAR and mean <= MEAN_REL_BAR


def _tune_k2():
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parent.parent / "scripts" / "tune_k2.py"
    spec = importlib.util.spec_from_file_location("tune_k2", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_tune_k2_bf16_variants_edit_what_they_name():
    """scripts/tune_k2.py --dtype bf16 builds each variant from the shipped
    source with only the named edit: the instantiation (warpgroups and ring
    slots), the walk's grid, its least share, or the stage's form."""
    import argparse
    mod = _tune_k2()
    out = mod.variants(argparse.Namespace(
        dtype="bf16", tile=["1,3,3"], ctas=["blocks"], split=[], share=[10],
        variant=["onebuf", "regs40", "onebuf+regs40"], baseline=[]))
    src, hdr = out["shipped"]
    assert all(h == hdr for _, h in out.values())
    define = f"#define GP_K2_BF16 320, {NWG}, {NB1}, {NB2}"
    assert out["tile_1_3_3"][0] == src.replace(define, "#define GP_K2_BF16 320, 1, 3, 3")
    head, _, tail = out["ctas_blocks"][0].partition("int wg_grid(int blocks, int units) {\n")
    assert head == src.partition("int wg_grid(")[0] and tail.startswith("  return blocks;\n}\n")
    assert out["share_10"][0] == src.replace(
        f"constexpr int kWgMinShare = {MIN_SHARE};", "constexpr int kWgMinShare = 10;")
    regs = src.replace("PRODUCER_REGS = 24;", "PRODUCER_REGS = 40;")
    assert out["regs40"][0] == regs and regs != src
    onebuf = out["onebuf"][0]
    code = re.sub(r"//[^\n]*", "", onebuf)  # one buffer, and no product in flight over GEGLU
    assert "af[1" not in code and "wgmma_wait<1>" not in code
    assert out["onebuf+regs40"][0] == onebuf.replace("PRODUCER_REGS = 24;", "PRODUCER_REGS = 40;")
    with pytest.raises(SystemExit):  # NWG,NB1,NB2 only
        mod.variants(argparse.Namespace(dtype="bf16", tile=["2,3"], ctas=[], split=[], share=[],
                                        variant=[], baseline=[]))
    with pytest.raises(SystemExit):  # the f32 body's CTA rules are not the bf16 walk's
        mod.variants(argparse.Namespace(dtype="bf16", tile=[], ctas=["halves"], split=[],
                                        share=[], variant=[], baseline=[]))
