"""The schedule of K6's d=64 body (int8 wgmma), on the CPU.

On the card, K6 at d=64 (csrc/flash_attn_int8.cu, flash_int8_d64_kernel)
takes a CTA of D64_NWG consumer warpgroups, each owning 64 query rows over
every key, and, per k block of the TPU's partition, runs Q K^T twice over
D64_BK-key tiles (64-key tiles where the block is an odd multiple of 64): a
max pass that keeps only the row maxima, then a pass that recomputes the
int32 logits, rounds pq against the block's max and feeds P V from
registers, int32 over the whole block, folded into the f32 running output
once a block. Its per-logit chain takes f32(s32) and pq by magic numbers,
and P's codes stay where S's accumulator leaves them: the keys are relabelled
and the wrapper lays V^T out in that order (flash_attention._int8_vt). No
CUDA kernel runs here, so this file emulates that schedule, with the tile
constants and the key order read from the source, and holds it to:

- the plain version ``_flash_int8_ref`` bit for bit (the card's bar is 0.0),
  at k blocks 64, 576, 1536, 2304 and 4608 (past the 2304 that the mma.sync
  body's logits buffer allowed) with rows past Sq;
- JAX's ``flash_attention_int8`` in Pallas interpret mode at the bars and
  pq-flip count of tests/test_torch_quant.py's d=64 plain-version test;
- the two magic-number identities, over every s32 a d=64 logit can take and
  at every half-integer of p * 127 and its neighbours;
- teeth: a max per key tile and an f32 fold per tile past 2^24 both differ
  from the plain version, and a V^T in plain key order gives another P V;
- the design's reckoning: its floors and its L2 bytes against the mma.sync
  body's it replaced.
"""

import math
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from genpercept_tpu.ops.flash_attention import flash_attention_int8 as j_flash_int8
from genpercept_tpu_torch import _build
from genpercept_tpu_torch.ops import flash_attention as tfa

torch.set_num_threads(1)

_SRC = (_build.CSRC / "flash_attn_int8.cu").read_text()
_COMMON = (_build.CSRC / "common.cuh").read_text()


def _constant(name: str) -> int:
    (v,) = re.findall(rf"constexpr int {name} = (\d+);", _SRC)
    return int(v)


NWG = _constant("D64_NWG")  # consumer warpgroups of a CTA, 64 query rows each
BK = _constant("D64_BK")  # keys of a K or V^T tile
NBUF = _constant("D64_NBUF")  # ring stages
D = 64
F32_BAR, BF16_BAR = 2e-3, 2e-2  # tests/test_torch_quant.py at d=64: of max|out|
FLIP_BAR = 1e-4  # pq codes that torch's and XLA's exp2 round apart
MAGIC = 12582912.0  # 1.5 * 2^23, bits 0x4B400000


def _key_order() -> list[int]:
    """The key of each A position of a 32-key k step of P V, as the body's
    pack64 builds its registers: register a[2h + r] of thread t holds, in
    byte i, the code of S's column 8n + 2t + (i & 1) with n = 2h + i // 2
    (S's accumulator layout), and the 8-bit A layout puts that byte at k
    position 16h + 4t + i."""
    assert "pf[kk][2 * h + r] = __byte_perm(lo, hi, 0x5410);" in _SRC
    assert "__byte_perm(s[n][2 * r], s[n][2 * r + 1], 0x0040)" in _SRC
    assert "__byte_perm(s[n + 1][2 * r], s[n + 1][2 * r + 1], 0x0040)" in _SRC
    order = [-1] * 32
    for t in range(4):
        for h in range(2):
            for i in range(4):
                order[16 * h + 4 * t + i] = 8 * (2 * h + i // 2) + 2 * t + (i & 1)
    assert sorted(order) == list(range(32))
    return order


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact int8 x int8 sums (in float64: every |sum| here is below 2^53)."""
    return (a.double() @ b.double().T).to(torch.int64)


def _f32_of_s32(s32: torch.Tensor) -> torch.Tensor:
    """f32(s32) as the body takes it: the bits of s32 + 0x4B400000 as a float,
    less 1.5 * 2^23 (exact for |s32| < 2^22)."""
    return (s32.to(torch.int32) + 0x4B400000).view(torch.float32) - MAGIC


def _code_of(x: torch.Tensor) -> torch.Tensor:
    """pq as the body takes it: the low byte of the bits of x + 1.5 * 2^23."""
    return ((x + MAGIC).view(torch.int32) & 0xFF).to(torch.uint8).view(torch.int8)


def k6_d64_emulated(q8, k8, v8, qs, ks, vs, scale: float, k_blk: int, dtype,
                    max_per_tile: bool = False, fold_per_tile: bool = False,
                    vt=None, args: list | None = None):
    """K6's d=64 body over its warpgroups' 64-row tiles, passes, key tiles and
    folds: operands as _flash_int8_ref's -> (BH, Sq, D) in dtype.

    max_per_tile: every key tile is rounded against the running max up to
    that tile (the block partition lost); fold_per_tile: each tile's int32
    P V converted to f32 and added to the running output tile by tile (the
    block's int32 sum lost); vt: the V^T the body reads (default the
    wrapper's, _int8_vt). args collects each tile's exp2 arguments."""
    bh, sq, _ = q8.shape
    sk = k8.shape[1]
    c = scale * tfa._LOG2E
    bk = BK if k_blk % BK == 0 else 64
    vt = tfa._int8_vt(v8) if vt is None else vt
    order = torch.tensor(_key_order())
    nwg = -(-sq // 64)  # the warpgroups' 64-row tiles; rows past Sq are zero
    out = torch.empty((bh, sq, D), dtype=dtype)
    for b in range(bh):
        qt = torch.zeros((nwg * 64, D), dtype=torch.int8)
        qt[:sq] = q8[b]
        qst = torch.zeros((nwg * 64, 1))
        qst[:sq] = qs[b]
        m = torch.full((nwg * 64, 1), -1e30)
        l = torch.zeros((nwg * 64, 1))
        acc = torch.zeros((nwg * 64, D))

        def logits(w, k0):
            """Warpgroup w's logits of the key tile at k0."""
            rows = slice(64 * w, 64 * w + 64)
            x = _f32_of_s32(_mm(qt[rows], k8[b, k0:k0 + bk]))
            return x * (qst[rows] * ks[b, k0:k0 + bk, 0][None, :])

        for kb0 in range(0, sk, k_blk):
            tiles = list(range(kb0, kb0 + k_blk, bk))
            for group in ([[t0] for t0 in tiles] if max_per_tile else [tiles]):
                bm = torch.full((nwg * 64, 1), -1e30)  # each warpgroup's max pass
                for w in range(nwg):
                    for k0 in group:
                        bm[64 * w:64 * w + 64] = torch.maximum(
                            bm[64 * w:64 * w + 64], logits(w, k0).amax(-1, keepdim=True))
                m_new = torch.maximum(m, bm)
                # alpha of rows [0, Sq) as one (Sq, 1) tensor, as the plain
                # version lays it out: torch's CPU exp2 takes a vector or a
                # scalar path by an element's place, which can differ in the
                # last bit (on the card both are exp2f, element by element)
                alpha = torch.exp2((m - m_new) * c)
                alpha[:sq] = torch.exp2((m[:sq] - m_new[:sq]) * c)
                m = m_new
                for w in range(nwg):  # each warpgroup's second pass and fold
                    rows = slice(64 * w, 64 * w + 64)
                    pv = torch.zeros((64, D), dtype=torch.int64)
                    rs = torch.zeros((64, 1), dtype=torch.int64)
                    parts = []
                    for k0 in group:
                        arg = logits(w, k0) * c - m_new[rows] * c
                        if args is not None:
                            args.append(arg[:max(0, min(64, sq - 64 * w))])
                        pq = _code_of(torch.exp2(arg) * 127.0)
                        rs += pq.to(torch.int64).sum(-1, keepdim=True)
                        # P's registers: each 32 keys at their A positions
                        p_pos = pq.reshape(64, bk // 32, 32)[:, :, order].reshape(64, bk)
                        part = _mm(p_pos, vt[b, :, k0:k0 + bk])
                        pv += part
                        parts.append(part)
                    l[rows] = l[rows] * alpha[rows] + rs.float()
                    if fold_per_tile:
                        acc[rows] = acc[rows] * alpha[rows]
                        for part in parts:
                            acc[rows] = acc[rows] + part.float()
                    else:
                        acc[rows] = acc[rows] * alpha[rows] + pv.float()
        out[b] = (acc * vs[b] / l)[:sq].to(dtype)
    return out


def _operands(rng, bh, sq, sk, q_scale=0.5, k_scale=0.5, v_fn=None):
    q = torch.from_numpy((rng.standard_normal((bh, sq, D)) * q_scale).astype(np.float32))
    k = torch.from_numpy((rng.standard_normal((bh, sk, D)) * k_scale).astype(np.float32))
    v = (torch.from_numpy(rng.standard_normal((bh, sk, D)).astype(np.float32)) if v_fn is None
         else torch.from_numpy(v_fn(rng, (bh, sk, D)).astype(np.float32)))
    return tfa.int8_operands(q, k, v)


def test_body_constants():
    """The emulation's tiles are the body's: warpgroups of 64 rows, 128-key
    (or 64-key) tiles, a ring of at least 2 stages; S by halves of a tile on
    m64n64k32 (m64n32k32 at 64 keys), P V on m64n64k32 with A from
    registers; the body's name starts with "wgmma"; the mma.sync body and
    its logits buffer's cap are gone."""
    assert 1 <= NWG <= 3 and BK in (64, 128) and NBUF >= 2
    assert "m64n64k32.s32.s8.s8" in _COMMON and "m64n32k32.s32.s8.s8" in _COMMON
    assert "sw64_desc(ring + (p % NBUF) * L::STAGE + h * (BK / 2) * D)" in _SRC
    assert re.search(r"wgmma_s8_rs\(pv, pf\[kk\], dv \+ 2 \* kk", _SRC)
    (name,) = re.findall(r'flash_attn_int8_d64_body\(\) \{\n  return "([^"]*)"', _SRC)
    assert name.startswith("wgmma")
    assert "flash_int8_kernel<" not in _SRC and not re.search(r"\bmma_s8\(", _SRC)
    assert tfa._INT8_MAX_K_BLK == {64: None, 512: None}


def test_magic_int_to_float():
    """f32(s32) = __int_as_float(s32 + 0x4B400000) - 12582912.f, bit for bit
    cvt.rn.f32.s32 (torch's .float()), over every s32 a d=64 logit can take:
    |s32| <= 64 * 127^2 = 1,032,256 < 2^22."""
    bound = 64 * 127 * 127
    assert bound == 1_032_256 and bound < 2 ** 22
    s32 = torch.arange(-bound, bound + 1, dtype=torch.int32)
    assert torch.equal(_f32_of_s32(s32), s32.float())


def test_magic_round():
    """pq = the low byte of the bits of p * 127 + 12582912.f equals
    torch.round(p * 127) (half to even) cast to int8: at every half-integer
    and integer of [0, 127] and at their f32 neighbours on both sides, and
    at p * 127 for p over [0, 1]."""
    base = torch.arange(0, 255, dtype=torch.float32) / 2  # 0, 0.5, ..., 127
    x = torch.cat([base, torch.nextafter(base, torch.tensor(-1.0)),
                   torch.nextafter(base, torch.tensor(200.0))]).clamp(0.0, 127.0)
    p = torch.from_numpy(np.random.default_rng(3).uniform(0, 1, 200_000).astype(np.float32))
    x = torch.cat([x, p * 127.0, torch.tensor([127.0])])
    assert torch.equal(_code_of(x), torch.round(x).to(torch.int8))


def test_key_order_is_the_wrappers():
    """The wrapper's V^T (_int8_vt) holds each 32 keys in the order the
    body's P registers take them, so P (in S's accumulator layout, packed by
    pack64) times that V^T is P V; a V^T in plain key order gives another
    product. At d=512 _int8_vt is the plain transpose."""
    rng = np.random.default_rng(1)
    v8 = torch.from_numpy(rng.integers(-127, 128, (2, 128, D)).astype(np.int8))
    p = torch.from_numpy(rng.integers(0, 128, (64, 128)).astype(np.int8))
    vt = tfa._int8_vt(v8)
    assert vt.shape == (2, D, 128) and vt.is_contiguous()
    order = torch.tensor(_key_order())
    p_pos = p.reshape(64, 4, 32)[:, :, order].reshape(64, 128)
    assert torch.equal(_mm(p_pos, vt[1]), _mm(p, v8[1].T))
    assert not torch.equal(_mm(p_pos, v8[1].T.contiguous()), _mm(p, v8[1].T))
    w8 = torch.from_numpy(rng.integers(-127, 128, (1, 64, 512)).astype(np.int8))
    assert torch.equal(tfa._int8_vt(w8), w8.transpose(1, 2))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sq,sk,k_blk", [(100, 256, 64), (130, 1152, 576), (130, 3072, 1536),
                                         (100, 2304, 2304), (130, 4608, 4608)])
def test_schedule_matches_plain_bit_for_bit(sq, sk, k_blk, dtype):
    """The schedule gives the plain version's bits at k blocks 64 (one tile),
    576 (64-key tiles), 1536 and 2304 (the script's; 1536 over two blocks)
    and 4608 (past the mma.sync body's cap of 2304), with rows past Sq in the last
    warpgroup's tile."""
    if k_blk in (1536, 2304):
        assert tfa._int8_k_block(sq, sk, D) == k_blk
    ops = _operands(np.random.default_rng(sk + sq), 1, sq, sk)
    ours = k6_d64_emulated(*ops, D ** -0.5, k_blk, dtype)
    ref = tfa._flash_int8_ref(*ops, D ** -0.5, k_blk, dtype)
    assert torch.equal(ours, ref)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_schedule_matches_pallas(dtype):
    """The schedule against JAX's flash_attention_int8 (Pallas, interpret
    mode) on the inputs of tests/test_torch_quant.py's d=64 plain-version
    test (two heads, q at 256 tokens, k/v at 2048: two k blocks of 1024), at
    its bars: f32 2e-3, bf16 2e-2 of max|out|; and at most 1e-4 of the pq
    codes round apart between torch's exp2 and XLA's, counted on the
    schedule's own exp2 arguments."""
    rng = np.random.default_rng(15)
    q = (rng.standard_normal((2, 256, 2, D)) * 0.5).astype(np.float32)
    k = (rng.standard_normal((2, 2048, 2, D)) * 0.5).astype(np.float32)
    v = rng.standard_normal((2, 2048, 2, D)).astype(np.float32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(j_flash_int8(*(jnp.asarray(a, jdt) for a in (q, k, v))), np.float32)
    bhsd = lambda a: torch.from_numpy(a).to(tdt).permute(0, 2, 1, 3).reshape(4, a.shape[1], D)
    k_blk = tfa._int8_k_block(256, 2048, D)
    assert k_blk == 1024
    args = []
    ours = k6_d64_emulated(*tfa.int8_operands(bhsd(q), bhsd(k), bhsd(v)), D ** -0.5, k_blk, tdt,
                           args=args)
    ours = ours.float().reshape(2, 2, 256, D).permute(0, 2, 1, 3).numpy()
    err = np.abs(ours - ref).max() / np.abs(ref).max()
    assert err <= (F32_BAR if dtype == "float32" else BF16_BAR), err
    flips = total = 0
    for arg in args:
        p_t = torch.round(torch.exp2(arg) * 127.0).numpy()
        p_j = np.round(np.asarray(jnp.exp2(jnp.asarray(arg.numpy()))) * np.float32(127.0))
        flips += int((p_t != p_j).sum())
        total += p_t.size
    assert total == 4 * 256 * 2048 and flips <= FLIP_BAR * total, (flips, total)


def test_max_per_tile_differs():
    """A schedule that rounds pq against the running max of the key tiles
    seen so far, not of the whole k block, is another function: the block
    partition is part of K6's function, so the body runs a max pass."""
    ops = _operands(np.random.default_rng(5), 1, 64, 3072)
    ref = tfa._flash_int8_ref(*ops, D ** -0.5, 1536, torch.float32)
    assert torch.equal(k6_d64_emulated(*ops, D ** -0.5, 1536, torch.float32), ref)
    wrong = k6_d64_emulated(*ops, D ** -0.5, 1536, torch.float32, max_per_tile=True)
    assert not torch.equal(wrong, ref)
    assert (wrong - ref).abs().max().item() > 1e-3 * ref.abs().max().item()


def test_fold_per_tile_differs_past_2_24():
    """Where a block's |pv| passes 2^24 (logits near equal, so pq ~127, and
    v near constant, so its codes ~120: ~127 * 120 * 1536 per column), int32
    sums folded into f32 tile by tile round where the block's one int32 sum
    does not: the body keeps the block's sums in int32."""
    ops = _operands(np.random.default_rng(9), 1, 64, 3072, q_scale=0.02, k_scale=0.02,
                    v_fn=lambda rng, shape: 1.0 + 0.05 * rng.standard_normal(shape))
    v8 = ops[2]
    pv_block = _mm(torch.full((1, 1536), 127, dtype=torch.int8), v8[0, :1536].T)
    assert pv_block.abs().max().item() > 2 ** 24
    ref = tfa._flash_int8_ref(*ops, D ** -0.5, 1536, torch.float32)
    assert torch.equal(k6_d64_emulated(*ops, D ** -0.5, 1536, torch.float32), ref)
    wrong = k6_d64_emulated(*ops, D ** -0.5, 1536, torch.float32, fold_per_tile=True)
    assert not torch.equal(wrong, ref)


def test_plain_key_order_differs():
    """The body reads P in its relabelled key order: fed V^T in plain key
    order, the same schedule gives another output."""
    ops = _operands(np.random.default_rng(6), 1, 64, 256)
    ref = tfa._flash_int8_ref(*ops, D ** -0.5, 256, torch.float32)
    plain_vt = ops[2].transpose(1, 2).contiguous()
    wrong = k6_d64_emulated(*ops, D ** -0.5, 256, torch.float32, vt=plain_vt)
    assert not torch.equal(wrong, ref)


# The design's reckoning at the script's (10, 9216, 64), k block 1536: 849.3 M
# logits; the function's two products 217.4 G int8 operations, with the max
# pass 326.1 G (0.165 ms at 1,979 TOPS); one exp2f a logit on the 16-a-clock
# MUFU of 132 SMs at 1.98 GHz, 0.203 ms. K and V^T come from L2 once per CTA
# of 64 * D64_NWG query rows (K twice, V^T once): 2.55 GB over the shipped
# tile's 1440 CTAs of one warpgroup (1.27 GB where two warpgroups share a
# ring), against the mma.sync body's 5760 CTAs of 16 rows (K and V^T once
# each): 6.79 GB.
def test_design_reckoning():
    """Floors and L2 bytes as PERF.md states them, and the shared memory of
    the CTAs of a SM within its 228 KB."""
    bh, s = 10, 9216
    logits = bh * s * s
    ops = 4.0 * logits * D
    assert (round(logits / 1e6, 1), round(ops / 1e9, 1), round(1.5 * ops / 1e9, 1)) == (
        849.3, 217.4, 326.1)
    assert round(1.5 * ops / 1979e12 * 1e3, 3) == 0.165
    assert round(logits / (16 * 132 * 1.98e9) * 1e3, 3) == 0.203
    kv = s * D  # bytes of one head's K or V^T codes
    l2 = {nwg: bh * math.ceil(s / (64 * nwg)) * 3 * kv for nwg in (1, 2)}
    assert (round(l2[1] / 1e9, 2), round(l2[2] / 1e9, 2)) == (2.55, 1.27)
    assert round(bh * math.ceil(s / 16) * 2 * kv / 1e9, 2) == 6.79
    ctas = _constant("D64_CTAS")
    smem = 1024 + NWG * 64 * D + NBUF * (BK * D + BK * 4) + 8 * (1 + 2 * NBUF)
    assert ctas * (smem + 1024) <= 233472
