"""The schedule of K6's d=512 body (int8 wgmma), on the CPU.

On the card, K6 at d=512 (csrc/flash_attn_int8.cu, flash_int8_wgmma_kernel)
takes a CTA of 64 query rows and, per k block of the TPU's partition, runs
Q K^T twice: a max pass over the block's 128-key tiles that keeps only the
row maxima, then a pass that recomputes the int32 logits, rounds pq against
the block's max and feeds P V. Two consumer warpgroups split each tile's keys
for S (64 and 64, or 32 and 32 on the 64-key tile that ends a block whose
k_blk is an odd multiple of 64) and the 512 output columns for P V (256
each, int32 sums over the whole block); the f32 running output is parked in
device memory and folded once a block (at the start of the next). No CUDA
kernel runs here, so this file emulates that schedule, with the tile
constants read from the source, and holds it to:

- the plain version ``_flash_int8_ref`` bit for bit (the card's bar for K6
  is 0.0 as well), at k_blk 1536, 1152, 576 and 64 and with rows past Sq;
- JAX's ``flash_attention_int8`` in Pallas interpret mode at the bars and
  pq-flip count of tests/test_torch_quant.py's plain-version test;
- teeth: a schedule that takes the max per key tile instead of per k block,
  and one that folds the int32 sums into f32 tile by tile where a block's
  |pv| passes 2^24, both differ from the plain version;
- the design's reckoning: its products (1.5x the function's) and floor, its
  shared memory, and the K/V^T bytes its CTAs read against PR 3's body's.
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


def _constant(name: str) -> int:
    (v,) = re.findall(rf"constexpr int {name} = (\d+);", _SRC)
    return int(v)


BQ = _constant("BQ")  # query rows of a CTA
BK = _constant("BK")  # keys of a key tile
NBUF = _constant("NBUF")  # ring stages
UNIT = 128 * 128  # bytes of a ring stage (a K atom or a V^T unit)
assert re.search(r"constexpr int UNIT = 128 \* 128;", _SRC)
D = 512
HALF_COLS = D // 2  # output columns of a consumer warpgroup
F32_BAR, BF16_BAR = 1e-5, 2e-2  # tests/test_torch_quant.py: of max|out|
FLIP_BAR = 1e-4  # pq codes that torch's and XLA's exp2 round apart


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact int8 x int8 sums (in float64: every |sum| here is below 2^53)."""
    return (a.double() @ b.double().T).to(torch.int64)


def _tiles(k_blk: int) -> list[tuple[int, int]]:
    """A block's key tiles as (first key, keys): 128-key tiles, and a 64-key
    one at the end where k_blk is an odd multiple of 64."""
    full = [(i * BK, BK) for i in range(k_blk // BK)]
    return full + ([(k_blk // BK * BK, k_blk % BK)] if k_blk % BK else [])


def k6_wgmma_emulated(q8, k8, v8, qs, ks, vs, scale: float, k_blk: int, dtype,
                      max_per_tile: bool = False, fold_per_tile: bool = False,
                      args: list | None = None):
    """K6's d=512 body over its CTAs, passes, warpgroups and folds: operands
    as _flash_int8_ref's -> (BH, Sq, D) in dtype.

    max_per_tile: every key tile is rounded against the running max up to
    that tile (the block partition lost); fold_per_tile: each tile's int32
    P V converted to f32 and added to the running output tile by tile (the
    block's int32 sum lost). args collects each block's exp2 arguments."""
    bh, sq, _ = q8.shape
    c = scale * tfa._LOG2E
    out = torch.empty((bh, sq, D), dtype=dtype)
    for b in range(bh):
        for q0 in range(0, sq, BQ):
            rows = min(BQ, sq - q0)
            # rows past Sq arrive as zero codes with a zero scale
            qt = torch.zeros((BQ, D), dtype=torch.int8)
            qt[:rows] = q8[b, q0:q0 + rows]
            qst = torch.zeros((BQ, 1))
            qst[:rows] = qs[b, q0:q0 + rows]
            m = torch.full((BQ, 1), -1e30)
            l = torch.zeros((BQ, 1))
            park = torch.zeros((BQ, D))  # the parked f32 output
            nblk = k8.shape[1] // k_blk
            for blk in range(nblk):
                kb0 = blk * k_blk
                tiles = _tiles(k_blk)
                if max_per_tile:  # each tile a block of its own
                    groups = [[(kb0 + t0, n)] for t0, n in tiles]
                else:
                    groups = [[(kb0 + t0, n) for t0, n in tiles]]
                for group in groups:
                    first = blk == 0 and group is groups[0]
                    last = blk == nblk - 1 and group is groups[-1]

                    def logits(k0, n, w):
                        """Warpgroup w's logits of the tile (its n / 2 keys)."""
                        lo = k0 + w * n // 2
                        s32 = _mm(qt, k8[b, lo:lo + n // 2])
                        return s32.float() * (qst * ks[b, lo:lo + n // 2, 0][None, :])

                    # the max pass: each warpgroup's maxima, then m_new in one order
                    red = [torch.full((BQ, 1), -1e30) for _ in range(2)]
                    for k0, n in group:
                        for w in range(2):
                            red[w] = torch.maximum(red[w], logits(k0, n, w).amax(-1, keepdim=True))
                    m_new = torch.maximum(m, torch.maximum(red[0], red[1]))
                    alpha = torch.exp2((m - m_new) * c)
                    m = m_new
                    # the second pass: pq into P, int32 P V per column half
                    pv = [torch.zeros((BQ, HALF_COLS), dtype=torch.int64) for _ in range(2)]
                    rs = [torch.zeros((BQ, 1), dtype=torch.int64) for _ in range(2)]
                    tile_sums = []
                    for k0, n in group:
                        p_tile = torch.empty((BQ, n), dtype=torch.int8)
                        for w in range(2):
                            s = logits(k0, n, w)
                            arg = s * c - m_new * c
                            if args is not None:
                                args.append(arg)
                            pq = torch.round(torch.exp2(arg) * 127.0).to(torch.int8)
                            p_tile[:, w * n // 2:(w + 1) * n // 2] = pq
                            rs[w] += pq.to(torch.int64).sum(-1, keepdim=True)
                        for w in range(2):  # each warpgroup all keys, its columns
                            vt = v8[b, k0:k0 + n, w * HALF_COLS:(w + 1) * HALF_COLS].T
                            part = _mm(p_tile, vt)
                            pv[w] += part
                            if fold_per_tile:
                                tile_sums.append((w, part))
                    pv_all = torch.cat(pv, dim=1)
                    l = l * alpha + (rs[0] + rs[1]).float()
                    if fold_per_tile:
                        acc = park * alpha if not first else torch.zeros((BQ, D))
                        for w, part in tile_sums:
                            cols = slice(w * HALF_COLS, (w + 1) * HALF_COLS)
                            acc[:, cols] = acc[:, cols] + part.float()
                    else:
                        # the first fold is f32(pv) as it stands: 0 * alpha + f32(pv)
                        acc = pv_all.float() if first else park * alpha + pv_all.float()
                    if last:
                        out[b, q0:q0 + rows] = (acc * vs[b] / l)[:rows].to(dtype)
                    else:
                        park = acc
    return out


def _operands(rng, bh, sq, sk, q_scale=0.5, k_scale=0.5, v_fn=None):
    q = torch.from_numpy((rng.standard_normal((bh, sq, D)) * q_scale).astype(np.float32))
    k = torch.from_numpy((rng.standard_normal((bh, sk, D)) * k_scale).astype(np.float32))
    v = (torch.from_numpy(rng.standard_normal((bh, sk, D)).astype(np.float32)) if v_fn is None
         else torch.from_numpy(v_fn(rng, (bh, sk, D)).astype(np.float32)))
    return tfa.int8_operands(q, k, v)


def test_body_constants():
    """The emulation's tiles are the body's: 64 query rows, 128-key tiles,
    an even ring of at least 8 stages of 16 KB (a warpgroup's two V^T units
    on consecutive stages; a tile's K atoms beside the V^T units of the tile
    before), two warpgroups of 256 output columns; a fold group's parked
    values (64 rows x 32 columns of f32 a warpgroup) one stage."""
    assert (BQ, BK, NBUF % 2, NBUF >= 8) == (64, 128, 0, True)
    (fg,) = map(int, re.findall(r"constexpr int FOLD_GROUP = (\d+);", _SRC))
    assert 2 * BQ * 8 * fg * 4 == UNIT
    assert re.search(r"wgmma_s8\(pv, dp \+ 2 \* kk, dv \+ 2 \* kk", _SRC)
    assert "m64n256k32.s32.s8.s8" in (_build.CSRC / "common.cuh").read_text()
    assert [n for _, n in _tiles(576)] == [128] * 4 + [64] and _tiles(64) == [(0, 64)]
    assert [n for _, n in _tiles(1536)] == [128] * 12 and [n for _, n in _tiles(1152)] == [128] * 9


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sq,sk", [(130, 3072), (70, 2304), (64, 1728), (100, 192)])
def test_schedule_matches_plain_bit_for_bit(sq, sk, dtype):
    """The schedule gives the plain version's bits at the wrapper's k blocks
    1536, 1152, 576 (a 64-key tile ends each block) and 64, with rows past
    Sq in the last q tile where sq is no multiple of 64."""
    k_blk = tfa._int8_k_block(sq, sk, D)
    assert k_blk == {3072: 1536, 2304: 1152, 1728: 576, 192: 64}[sk]
    assert sk // k_blk > 1  # the running max and the parked output carry over
    ops = _operands(np.random.default_rng(sk + sq), 1, sq, sk)
    ours = k6_wgmma_emulated(*ops, D ** -0.5, k_blk, dtype)
    ref = tfa._flash_int8_ref(*ops, D ** -0.5, k_blk, dtype)
    assert torch.equal(ours, ref)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_schedule_matches_pallas(dtype):
    """The schedule against JAX's flash_attention_int8 (Pallas, interpret
    mode) on the inputs of tests/test_torch_quant.py's plain-version test (q
    at 512 tokens, k/v at 2048: two k blocks of 1024), at its bars: f32 1e-5,
    bf16 2e-2 of max|out|; and at most 1e-4 of the pq codes round apart
    between torch's exp2 and XLA's, counted on the schedule's own exp2
    arguments. (A flipped code moves a row's output by ~|v| / l, up to a few
    1e-4 of max|out| at 1728 keys: the plain version reads the same there.)"""
    rng = np.random.default_rng(14)
    sq, sk = 512, 2048
    q = (rng.standard_normal((2, sq, 1, D)) * 0.5).astype(np.float32)
    k = (rng.standard_normal((2, sk, 1, D)) * 0.5).astype(np.float32)
    v = rng.standard_normal((2, sk, 1, D)).astype(np.float32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(j_flash_int8(*(jnp.asarray(a, jdt) for a in (q, k, v))), np.float32)
    qt, kt, vt = (torch.from_numpy(a).to(tdt).reshape(2, a.shape[1], D) for a in (q, k, v))
    k_blk = tfa._int8_k_block(sq, sk, D)
    assert k_blk == 1024
    args = []
    ours = k6_wgmma_emulated(*tfa.int8_operands(qt, kt, vt), D ** -0.5, k_blk, tdt, args=args)
    err = np.abs(ours.float().numpy()[:, :, None, :] - ref).max() / np.abs(ref).max()
    assert err <= (F32_BAR if dtype == "float32" else BF16_BAR), err
    flips = total = 0
    for arg in args:
        p_t = torch.round(torch.exp2(arg) * 127.0).numpy()
        p_j = np.round(np.asarray(jnp.exp2(jnp.asarray(arg.numpy()))) * np.float32(127.0))
        flips += int((p_t != p_j).sum())
        total += p_t.size
    assert total == 2 * sq * sk and flips <= FLIP_BAR * total, (flips, total)


def test_max_per_tile_differs():
    """A schedule that rounds pq against the running max of the key tiles
    seen so far, not of the whole k block, is another function: its output
    and the plain version's differ (the block partition is part of K6's
    function, so the body runs a max pass)."""
    ops = _operands(np.random.default_rng(5), 1, 64, 3072)
    ref = tfa._flash_int8_ref(*ops, D ** -0.5, 1536, torch.float32)
    assert torch.equal(k6_wgmma_emulated(*ops, D ** -0.5, 1536, torch.float32), ref)
    wrong = k6_wgmma_emulated(*ops, D ** -0.5, 1536, torch.float32, max_per_tile=True)
    assert not torch.equal(wrong, ref)
    assert (wrong - ref).abs().max().item() > 1e-3 * ref.abs().max().item()


def test_fold_per_tile_differs_past_2_24():
    """Where a block's |pv| passes 2^24 (logits near equal, so pq ~127, and
    v near constant, so its codes ~120: ~127 * 120 * 1536 per column), int32
    sums folded into f32 tile by tile round where the block's one int32 sum
    does not: the output differs from the plain version's, and the body
    keeps the block's sums in int32."""
    ops = _operands(np.random.default_rng(9), 1, 64, 3072, q_scale=0.02, k_scale=0.02,
                    v_fn=lambda rng, shape: 1.0 + 0.05 * rng.standard_normal(shape))
    q8, k8, v8 = ops[:3]
    pq_min = torch.round(torch.exp2(torch.tensor(-1.0)) * 127)  # the logits' spread is < 1
    pv_block = _mm(torch.full((1, 1536), 127, dtype=torch.int8), v8[0, :1536].T)
    assert pv_block.abs().max().item() > 2 ** 24 and pq_min > 60
    ref = tfa._flash_int8_ref(*ops, D ** -0.5, 1536, torch.float32)
    assert torch.equal(k6_wgmma_emulated(*ops, D ** -0.5, 1536, torch.float32), ref)
    wrong = k6_wgmma_emulated(*ops, D ** -0.5, 1536, torch.float32, fold_per_tile=True)
    assert not torch.equal(wrong, ref)


# The design's reckoning at the pipeline's (2, 9216, 512), k block 1536: the
# function's two products are 4 * 2 * 9216^2 * 512 = 347.9 G int8 operations
# (0.176 ms at 1,979 TOPS); the max pass adds a third Q K^T, 521.8 G (a floor
# of 0.264 ms). The body's 288 CTAs take K twice and V^T once into shared
# memory: 4.08 GB, of which the 2-CTA clusters read 2.04 GB from L2 (each
# stage loaded once for both), against 10.87 GB for PR 3's 1152 CTAs of 16
# rows (K and V^T once each).
def test_design_reckoning():
    """Products, floor and L2 bytes as PERF.md states them, and the body's
    shared memory within a CTA's 227 KB."""
    bh, s = 2, 9216
    ops = 4.0 * bh * s * s * D
    design = 1.5 * ops
    assert (round(ops / 1e9, 1), round(design / 1e9, 1)) == (347.9, 521.8)
    assert (round(ops / 1979e12 * 1e3, 3), round(design / 1979e12 * 1e3, 3)) == (0.176, 0.264)
    kv = s * D  # bytes of one head's K or V^T codes
    ctas = bh * math.ceil(s / BQ)
    (cluster,) = map(int, re.findall(r"constexpr int CLUSTER = (\d+);", _SRC))
    assert (ctas, round(ctas * 3 * kv / 1e9, 2), cluster) == (288, 4.08, 2)
    assert round(ctas * 3 * kv / cluster / 1e9, 2) == 2.04
    assert round(bh * math.ceil(s / 16) * 2 * kv / 1e9, 2) == 10.87
    smem = (1024 + 4 * BQ * 128 + 2 * BQ * BK + NBUF * (UNIT + 4 * BK) + 4 * BQ * 4
            + 8 * (1 + 2 * NBUF))
    assert smem <= 232448
