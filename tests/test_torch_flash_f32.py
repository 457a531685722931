"""The numerics of the f32 bodies of K1 and of K3/K4: split TF32 (3xTF32)
products, on the CPU.

On the card, K1 in f32 (csrc/flash_attn_fwd.cu, flash_attn_fwd_f32_kernel)
takes both of its products on the tensor cores through split TF32: each f32
operand x is split into hi = tf32(x), rounded to nearest with ties away from
zero (the rounding of cvt.rna.tf32.f32, which the kernel does as an add and
a mask of the bits: csrc/common.cuh split_tf32), and lo = x - hi truncated
to tf32; a product is lo.hi + hi.lo + hi.hi with f32 accumulation, and lo.lo
is dropped. No CUDA kernel runs here, so this file emulates that arithmetic
in torch (``tf32_rna`` and ``tf32_rz`` on the int32 view, ``mm3``) and holds
it to:

- an independent rounding of the mantissa to 10 bits, at edge bit patterns;
- JAX's ``_flash_kernel`` in Pallas interpret mode, as K1's online softmax
  over the kernel's key tiles with the emulated products, within
  tests/test_torch_ops.py's f32 ATOL;
- the card's bar for K1 in f32 (1e-4 max abs, out and lse2, against the
  plain version) at the card's shapes scaled down: three passes stay under
  it, a single TF32 pass does not, so the bar separates the two.

K3 and K4 in f32 (csrc/flash_attn_bwd.cu, flash_attn_bwd_f32_kernel) take
all of their products (three for K3, four for K4) the same way, over the
kernel's column tiles; the last section holds their emulation to JAX's
_flash_bwd_dq_kernel and _flash_bwd_dkv_kernel in Pallas interpret mode
(ragged keys included) and to the card's bar for K3/K4 (1e-4 of max|plain|).
It also models the tensor cores' accumulator, which rounds every sum toward
zero: summed in one accumulator over thousands of columns the output
products drift with the length, in accumulators of their own per column
tile (the kernel's design) they do not.

K1's plain version, ``_flash_bhsd_ref``, stays exact f32: it is the JAX
package's function, which the TPU computes with f32 products. Its card
tolerance of 1e-4 covers the split-TF32 kernel because the dropped lo.lo
term and the truncation of lo leave each product ~2^-21 relative from exact,
which moves out and lse2 by ~1e-6 here (the readings below), two orders under
the bar; a single TF32 pass, ~2^-11 relative, moves them past it.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from genpercept_tpu.ops import flash_attention as j_fa
from genpercept_tpu_torch import _build
from genpercept_tpu_torch.ops import flash_attention as t_fa

torch.set_num_threads(1)

ATOL = 2e-5  # tests/test_torch_ops.py's f32 tolerance against JAX
CARD_BAR = 1e-4  # chip_smoke.TOL["K1"][f32]: max abs, out and lse2
_LOG2E = 1.4426950408889634
NEG_INF = -1e30


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """f32 -> the nearest tf32 value (10 mantissa bits), ties away from zero,
    as cvt.rna.tf32.f32: add half of the dropped 13 bits to the magnitude and
    clear them (a carry runs into the exponent). inf stays inf; NaN stays NaN."""
    bits = x.contiguous().view(torch.int32)
    r = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return torch.where(torch.isnan(x), x, r)


def tf32_rz(x: torch.Tensor) -> torch.Tensor:
    """f32 -> tf32 rounded toward zero: the 13 low bits cleared."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def split(x: torch.Tensor):
    hi = tf32_rna(x)
    return hi, tf32_rz(x - hi)  # x - hi is exact in f32


def mm3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b by split TF32: lo.hi + hi.lo + hi.hi, small terms first."""
    ah, al = split(a)
    bh, bl = split(b)
    return torch.matmul(al, bh) + torch.matmul(ah, bl) + torch.matmul(ah, bh)


def mm1(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b by a single TF32 pass."""
    return torch.matmul(tf32_rna(a), tf32_rna(b))


def k1_emulated(q, k, v, scale: float, bk: int, mm=mm3):
    """K1's f32 body with products ``mm``: online softmax over key tiles of
    bk keys, the max on raw logits, -1e30 past Sk. -> (out, lse2)."""
    c = scale * _LOG2E
    bh, sq, _ = q.shape
    sk = k.shape[1]
    m = torch.full((bh, sq, 1), NEG_INF)
    l = torch.zeros((bh, sq, 1))
    acc = torch.zeros_like(q)
    for k0 in range(0, sk, bk):
        kt, vt = k[:, k0:k0 + bk], v[:, k0:k0 + bk]
        s = mm(q, kt.transpose(1, 2))
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp2(s * c - m_new * c)
        alpha = torch.exp2((m - m_new) * c)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + mm(p, vt)
        m = m_new
    return acc / l, m * c + torch.log2(l)


def _bk(d: int) -> int:
    return 64 if d == 64 else 32  # the kernel's keys a tile


def _inputs(seed: int, bh: int, sq: int, sk: int, d: int):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((bh, sq, d), dtype=np.float32)
    k, v = (rng.standard_normal((bh, sk, d), dtype=np.float32) for _ in range(2))
    return q, k, v


def _bits(*xs: int) -> torch.Tensor:
    return torch.tensor(np.array(xs, dtype=np.uint32).view(np.int32)).view(torch.float32)


def _rna_reference(x: np.ndarray) -> np.ndarray:
    """Round the significand to 11 bits (10 stored), ties away from zero, in
    float64 arithmetic: independent of the bit trick above."""
    m, e = np.frexp(x.astype(np.float64))  # x = m * 2^e, 0.5 <= |m| < 1
    r = np.sign(m) * np.floor(np.abs(m) * 2.0 ** 11 + 0.5)
    return np.ldexp(r, e - 11).astype(np.float32)


def test_tf32_rna_edge_bit_patterns():
    cases = [  # (input bits, rounded bits)
        (0x3F800000, 0x3F800000),  # 1.0: exact
        (0x3F800FFF, 0x3F800000),  # just below the tie: down
        (0x3F801000, 0x3F802000),  # a tie on an even last bit: away (to even: down)
        (0xBF801000, 0xBF802000),  # negative tie: away from zero (more negative)
        (0xBF800FFF, 0xBF800000),  # negative, below the tie: toward zero
        (0x3FFFF000, 0x40000000),  # carry into the exponent: 1.99951... -> 2.0
        (0x7F800000, 0x7F800000),  # +inf
        (0xFF800000, 0xFF800000),  # -inf
        (0x00000000, 0x00000000),  # +0
        (0x80000000, 0x80000000),  # -0
    ]
    got = tf32_rna(_bits(*(a for a, _ in cases))).view(torch.int32).numpy().view(np.uint32)
    assert [hex(x) for x in got] == [hex(b) for _, b in cases]
    rz = tf32_rz(_bits(0x3F801FFF, 0xBF801FFF, 0x3FFFF000)).view(torch.int32).numpy()
    assert [hex(x) for x in rz.view(np.uint32)] == ["0x3f800000", "0xbf800000", "0x3fffe000"]
    nan = torch.tensor([float("nan"), -float("nan")])
    assert bool(torch.isnan(tf32_rna(nan)).all())


def test_tf32_rna_matches_float64_rounding():
    rng = np.random.default_rng(30)
    x = (rng.standard_normal(200_000) * np.exp(rng.uniform(-20, 20, 200_000))).astype(np.float32)
    x[:1000] = _bits(*(0x3F800000 + 0x2000 * i + 0x1000 for i in range(1000))).numpy()  # ties
    got = tf32_rna(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, _rna_reference(x))
    assert not (got.view(np.int32) & 0x1FFF).any()


def test_split_keeps_21_bits():
    """hi + lo is x to 2^-21 relative: both tf32, lo the truncated rest
    (|x - hi| <= 2^-11 |x|, and truncation keeps lo to 2^-10 of itself)."""
    rng = np.random.default_rng(31)
    x = torch.from_numpy(rng.standard_normal(100_000).astype(np.float32) * 7)
    hi, lo = split(x)
    assert not (hi.view(torch.int32) & 0x1FFF).any()
    assert not (lo.view(torch.int32) & 0x1FFF).any()
    rel = ((hi.double() + lo.double() - x.double()).abs() / x.double().abs()).max().item()
    assert rel <= 2.0 ** -21, rel


@pytest.mark.parametrize("bh,s,d", [(2, 256, 64), (1, 256, 512)])
def test_k1_split_tf32_matches_pallas_kernel(bh, s, d):
    """K1's f32 body, emulated (online softmax over its key tiles, 3xTF32
    products), against JAX's _flash_kernel in Pallas interpret mode."""
    q, k, v = _inputs(32, bh, s, s, d)
    scale = d ** -0.5
    with pltpu.force_tpu_interpret_mode():
        ref_o, ref_l = j_fa._flash_bhsd(*map(jnp.asarray, (q, k, v)), scale)
    out, lse = k1_emulated(*map(torch.from_numpy, (q, k, v)), scale, _bk(d))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_o), atol=ATOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_l), atol=ATOL)


# Readings (max abs against the exact-f32 plain version, out / lse2; N(0, 1)
# inputs as chip_smoke.py draws them), in the order of the cases below:
# 3xTF32 4.8e-7 / 9.5e-7, 2.7e-7 / 9.5e-7, 4.5e-7 / 9.5e-7, 4.5e-7 / 9.5e-7;
# one TF32 pass 2.3e-4 / 3.2e-4, 1.0e-4 / 3.3e-4, 1.1e-4 / 1.3e-4, 1.4e-4 /
# 1.1e-4. Both held: three passes stay >100x under the card's bar, and one
# pass lies past it at every shape, by 1.3-3.3x (thinnest at d=512).
@pytest.mark.parametrize("bh,sq,sk,d", [
    (1, 576, 576, 64),     # (20,576,64), one head
    (1, 2304, 2304, 64),   # (10,2304,64), one head
    (1, 1152, 1152, 512),  # (1,9216,512), an eighth of the tokens
    (1, 1000, 1000, 512),  # the ragged card test's: no length a multiple of 32
])
def test_card_bar_separates_split_from_single_tf32(bh, sq, sk, d):
    q, k, v = map(torch.from_numpy, _inputs(33, bh, sq, sk, d))
    scale = d ** -0.5
    ref_o, ref_l = t_fa._flash_bhsd_ref(q, k, v, scale)

    def err(mm):
        o, lse = k1_emulated(q, k, v, scale, _bk(d), mm)
        return max((o - ref_o).abs().max().item(), (lse - ref_l).abs().max().item())

    three, one = err(mm3), err(mm1)
    assert three <= CARD_BAR / 10, three
    assert one > CARD_BAR, one


# ------------------------------------------------------------ K3/K4: backward


def k34_emulated(q, k, v, do, lse, dsum, scale: float, bc: int, mm=mm3):
    """K3's and K4's f32 body with products ``mm``, over the kernel's column
    tiles of bc: K3's columns are keys (X = S, Y = dP of the tile, then dq +=
    dS K), K4's are queries (X = S^T, Y = dP^T, then dk += dS^T Q and dv +=
    P^T dO). In f32 the roundings of dS and P to the inputs' dtype are the
    identity. -> (dq, dk, dv)."""
    c = scale * _LOG2E
    sq, sk = q.shape[1], k.shape[1]
    dq = torch.zeros_like(q)
    for c0 in range(0, sk, bc):
        kt, vt = k[:, c0:c0 + bc], v[:, c0:c0 + bc]
        p = torch.exp2(mm(q, kt.transpose(1, 2)) * c - lse)
        ds = p * (mm(do, vt.transpose(1, 2)) - dsum) * scale
        dq = dq + mm(ds, kt)
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    lse_t, dsum_t = lse.transpose(1, 2), dsum.transpose(1, 2)
    for c0 in range(0, sq, bc):
        qt, dot = q[:, c0:c0 + bc], do[:, c0:c0 + bc]
        p = torch.exp2(mm(k, qt.transpose(1, 2)) * c - lse_t[:, :, c0:c0 + bc])
        ds = p * (mm(v, dot.transpose(1, 2)) - dsum_t[:, :, c0:c0 + bc]) * scale
        dk = dk + mm(ds, qt)
        dv = dv + mm(p, dot)
    return dq, dk, dv


def _bc(d: int) -> int:
    """The kernel's columns a tile at head dim d: BC of the f32 instantiations
    in csrc/flash_attn_bwd.cu's dispatch (K3's and K4's agree)."""
    src = (_build.CSRC / "flash_attn_bwd.cu").read_text()
    bcs = set(re.findall(rf"launch_f32<{d}, \d+, \d+, (\d+), \d+, \w+, \w+>", src))
    assert len(bcs) == 1, bcs
    return int(bcs.pop())


@pytest.mark.parametrize("bh,sq,sk,d", [
    (2, 256, 256, 64), (1, 256, 256, 512),
    (2, 256, 77, 64),  # ragged: JAX pads K and V to 128 rows and masks (kv_valid)
])
def test_k34_split_tf32_matches_pallas_kernels(bh, sq, sk, d):
    """K3/K4's f32 body, emulated (3xTF32 products over its column tiles),
    against JAX's _flash_bwd_dq_kernel and _flash_bwd_dkv_kernel in Pallas
    interpret mode, from the Pallas forward's out and lse2."""
    q, k, v = _inputs(34, bh, sq, sk, d)
    do = np.random.default_rng(35).standard_normal((bh, sq, d), dtype=np.float32)
    scale = d ** -0.5
    pad = 128 - sk if sk % 128 else 0
    kp, vp = (np.pad(x, ((0, 0), (0, pad), (0, 0))) for x in (k, v))
    kv_valid = sk if pad else None
    with pltpu.force_tpu_interpret_mode():
        jq, jk, jv, jdo = map(jnp.asarray, (q, kp, vp, do))
        o, lse = j_fa._flash_bhsd(jq, jk, jv, scale, kv_valid=kv_valid)
        ref = j_fa._flash_bwd_bhsd(jq, jk, jv, o, jdo, lse, scale, kv_valid=kv_valid)
    tq, tk, tv, tdo, to, tl = (torch.from_numpy(np.array(x, np.float32))
                               for x in (q, k, v, do, o, lse))
    dsum = (tdo * to).sum(dim=-1, keepdim=True)
    got = k34_emulated(tq, tk, tv, tdo, tl, dsum, scale, _bc(d))
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b)[:, :a.shape[1]], atol=ATOL,
                                   err_msg=name)


# Readings (max over dq, dk, dv of max abs error / max|plain|; N(0, 1) inputs
# as chip_smoke.py draws them), in the order of the cases below: 3xTF32
# 1.43e-6, 1.49e-6, 1.57e-6, 2.47e-6; one TF32 pass 8.64e-4, 7.81e-4,
# 9.12e-4, 6.33e-4. Three passes stay 40-70x under the card's bar, and one
# pass lies past it at every shape, by 6.3-9.1x: the bar separates the two.
@pytest.mark.parametrize("bh,s,d", [
    (1, 576, 64),    # (40,576,64), one head
    (1, 2304, 64),   # (20,2304,64), one head
    (1, 1200, 64),   # the recipe's (40,4800,64), a quarter of the tokens
    (1, 1152, 512),  # (2,9216,512), an eighth of the tokens
])
def test_k34_card_bar_separates_split_from_single_tf32(bh, s, d):
    """Emulated K3/K4 against the exact-f32 plain version, held to the card's
    bar (chip_smoke.K34_TOL[f32], 1e-4 of max|plain|): 3xTF32 within a tenth
    of it, a single TF32 pass past it."""
    q, k, v = map(torch.from_numpy, _inputs(36, bh, s, s, d))
    do = torch.from_numpy(np.random.default_rng(37).standard_normal((bh, s, d),
                                                                    dtype=np.float32))
    scale = d ** -0.5
    out, lse = t_fa._flash_bhsd_ref(q, k, v, scale)
    dsum = (do * out).sum(dim=-1, keepdim=True)
    ref = t_fa._flash_bwd_bhsd_ref(q, k, v, do, lse, dsum, scale)

    def rel_err(mm):
        got = k34_emulated(q, k, v, do, lse, dsum, scale, _bc(d), mm)
        return max(((a - b).abs().max() / b.abs().max()).item() for a, b in zip(got, ref))

    three, one = rel_err(mm3), rel_err(mm1)
    assert three <= CARD_BAR / 10, three
    assert one > CARD_BAR, one


def rz_f32(x: torch.Tensor) -> torch.Tensor:
    """float64 -> f32 rounded toward zero."""
    t = x.to(torch.float32)
    return torch.where(t.double().abs() > x.abs(), torch.nextafter(t, torch.zeros_like(t)), t)


def output_products(e, b, bc: int, per_tile: bool):
    """e @ b as K3's output products (dq = dS K) sum it on the tensor cores:
    for each k step of 8 columns, three mma (lo.hi, hi.lo, hi.hi), each of
    which adds its 8 products (exact: tf32 times tf32 fits f32) to the
    accumulator and rounds the sum toward zero, as the tensor cores do.
    per_tile: each tile of bc columns sums from zero in accumulators of its
    own, added to the running sums by f32 adds (the kernel); else one
    accumulator takes the whole column loop."""
    (eh, el), (bh, bl) = ((x.double() for x in split(y)) for y in (e, b))
    out = torch.zeros(e.shape[0], b.shape[1])
    for c0 in range(0, e.shape[1], bc):
        acc = torch.zeros_like(out) if per_tile else out
        for k0 in range(c0, min(c0 + bc, e.shape[1]), 8):
            ks = slice(k0, k0 + 8)
            for x, y in ((el, bh), (eh, bl), (eh, bh)):
                acc = rz_f32(acc.double() + x[:, ks] @ y[ks])
        out = out + acc if per_tile else acc
    return out


LONG_BAR = 2e-5  # tests/test_torch_cuda.py's bar for K3/K4 f32 at 9216 tokens


# Readings (max abs error / max|exact|, per-tile / one accumulator), in the
# order of the cases below: 5.5e-7 / 5.1e-5, 6.0e-7 / 7.9e-5, 8.2e-7 /
# 9.4e-5; at 576 columns the one accumulator reads 7.7e-6, under the bar.
# The card read 5.4e-5 at 4800 tokens and 1.2e-4 / 1.1e-4 at 9216 (d=64 /
# 512) with one accumulator, 2.0e-6-6.9e-6 with the per-tile ones.
@pytest.mark.parametrize("rows,s,d", [(64, 4800, 64), (64, 9216, 64), (16, 9216, 512)])
def test_k34_per_tile_accumulators_keep_long_error_flat(rows, s, d):
    """The truncation of every sum into a tensor-core accumulator biases the
    sum toward zero by up to an ulp of the accumulator per mma; over one
    accumulator for the whole column loop that grows with the length, past
    the card's long-sequence bar, while per-tile accumulators stay under it.
    dS of ``rows`` queries against ``s`` keys, exact from float64."""
    rng = np.random.default_rng(38)
    q, do = (torch.from_numpy(rng.standard_normal((rows, d), dtype=np.float32)).double()
             for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((s, d), dtype=np.float32)) for _ in range(2))
    scale = d ** -0.5
    p = torch.softmax(q @ k.double().T * scale, dim=-1)
    dp = do @ v.double().T
    ds = (p * (dp - (p * dp).sum(-1, keepdim=True)) * scale).float()
    exact = ds.double() @ k.double()

    def rel_err(per_tile):
        got = output_products(ds, k, _bc(d), per_tile)
        return ((got.double() - exact).abs().max() / exact.abs().max()).item()

    tile, once = rel_err(True), rel_err(False)
    assert tile <= LONG_BAR / 10, tile
    assert once > LONG_BAR, once


def _tune_k34():
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parent.parent / "scripts" / "tune_k34.py"
    spec = importlib.util.spec_from_file_location("tune_k34", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _tune_args(dtype, tile=(), variant=()):
    import argparse
    return argparse.Namespace(dtype=dtype, tile=list(tile), variant=list(variant), baseline=None)


@pytest.mark.parametrize("dtype,tile,line", [
    ("f32", "dkv512:1,8,8,2,true", "launch_f32<512, 1, 8, 8, 2, true, true>"),
    ("f32", "dq64:4,1,32,3,true", "launch_f32<64, 4, 1, 32, 3, true, false>"),
    ("bf16", "dq64:4,2", "launch_mma<64, 4, 2, false>"),
])
def test_tune_k34_replaces_one_instantiation(dtype, tile, line):
    """scripts/tune_k34.py builds a variant from the shipped source with the
    named kernel's template arguments replaced and nothing else changed."""
    mod = _tune_k34()
    out = mod.variants(_tune_args(dtype, [tile]))
    shipped = out["shipped"][0].splitlines()
    (name,) = [n for n in out if n != "shipped"]
    edited = out[name][0].splitlines()
    changed = [(a, b) for a, b in zip(shipped, edited) if a != b]
    assert len(shipped) == len(edited) and len(changed) == 1, changed
    assert line in changed[0][1] and line not in changed[0][0]
    with pytest.raises(SystemExit):  # no such instantiation
        mod.variants(_tune_args(dtype, ["dq128:4,2"]))


def test_tune_k34_one_accumulator_variant():
    """--variant oneacc sums each column tile's output products into dq (dk,
    dv) directly, the design whose error grew with the length: the tile's
    own accumulators and the add into the running sums are its only edits."""
    mod = _tune_k34()
    out = mod.variants(_tune_args("f32", variant=["oneacc"]))
    shipped, edited = out["shipped"][0], out["oneacc"][0]
    assert "float part[kOutTiles][4];" in shipped and "+= part[n][e]" in shipped
    assert "float part[kOutTiles][4];" not in edited and "+= part[n][e]" not in edited
    assert edited.count("float(*part)[4] = (m ? acc2 : acc1) + n0;") == 1
    assert len(shipped.splitlines()) - len(edited.splitlines()) == 7
    with pytest.raises(SystemExit):  # f32 only
        mod.variants(_tune_args("bf16", variant=["oneacc"]))
