"""The numerics of K1's f32 body: split TF32 (3xTF32) products, on the CPU.

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

K1's plain version, ``_flash_bhsd_ref``, stays exact f32: it is the JAX
package's function, which the TPU computes with f32 products. Its card
tolerance of 1e-4 covers the split-TF32 kernel because the dropped lo.lo
term and the truncation of lo leave each product ~2^-21 relative from exact,
which moves out and lse2 by ~1e-6 here (the readings below), two orders under
the bar; a single TF32 pass, ~2^-11 relative, moves them past it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from genpercept_tpu.ops import flash_attention as j_fa
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
