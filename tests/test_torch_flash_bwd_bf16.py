"""The numerics of K3/K4's bf16 body at d=64 (wgmma), on the CPU.

On the card, K3 and K4 in bf16 at head dim 64 (csrc/flash_attn_bwd.cu,
flash_attn_bwd_wgmma_kernel) loop over column tiles of kBC columns: keys in
K3, whose CTA owns query rows, and queries in K4, whose CTA owns key rows.
Per tile, S (K4: S^T) and dP (dP^T) in f32 from bf16 operands, P =
exp2(S c - lse2) with lse2 and dsum of the query (K3: the row's; K4: the
column's, from flat maps over bh * sq), 0 past the columns' end; dS = P (dP
- dsum) scale rounded to bf16, P rounded to bf16 for dv; the tile's output
products summed from zero in f32 and added to the running sums by f32
adds; the outputs rounded to bf16 at the end. Rows and columns past their
length are zero rows of the 3-D tensor maps. No CUDA kernel runs here, so
this file emulates that tile order (``k34_bf16_emulated``) and holds it to:

- JAX's ``_flash_bwd_bhsd`` (the TPU's _flash_bwd_dq_kernel and
  _flash_bwd_dkv_kernel) in Pallas interpret mode at tests/test_ops.py's
  d=64 shapes, in bf16, within one bf16 ulp of max|out|: the same rounding
  points, the f32 sums in another order;
- the card's bars for K3/K4 in bf16 (chip_smoke.py, tests/test_torch_cuda.py)
  against the plain version at the card's inputs: 2e-2 and 2^-6 of
  max|plain| for the max abs error, MEAN_REL_BAR of max|plain| for the mean
  abs error. The emulation meets them; each of these faults fails at least
  one (the test says which): dS not rounded to bf16, dK/dV summed through
  bf16 after each tile, a dropped column tile, K4 taking lse2/dsum by row
  (key) instead of by column (query), and queries past Sq unmasked where
  their rows are the next head's (as a 2-D map over bh * sq rows would
  read them). With the 3-D maps' zero rows an unmasked column adds nothing:
  its P meets zero rows of Q and dO (K4) or of K and V (K3), so the mask
  guards the body's arithmetic, not its sums.
"""

from __future__ import annotations

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

_LOG2E = 1.4426950408889634
OLD_BAR = 2e-2  # chip_smoke.K34_TOL[bf16]: max abs over max|plain|
MAX_REL_BAR = 2.0 ** -6  # chip_smoke.K34_BF16_REL_TOL: max abs over max|plain|
MEAN_REL_BAR = 2e-5  # chip_smoke.K34_BF16_MEAN_REL_TOL: mean abs over max|plain|


def card_column_tile() -> int:
    """kBC of csrc/flash_attn_bwd.cu: the columns a tile of the bf16 bodies."""
    (bc,) = re.findall(r"constexpr int kBC = (\d+);",
                       (_build.CSRC / "flash_attn_bwd.cu").read_text())
    return int(bc)


BC = card_column_tile()


def _rows(x: torch.Tensor, n: int, next_head: bool) -> torch.Tensor:
    """x (BH, S, ...) padded to n rows: zeros past S (a 3-D map), or the
    next head's first rows and zeros past the last head (a 2-D map over
    BH * S rows)."""
    bh, s = x.shape[:2]
    if not next_head:
        return torch.cat([x, x.new_zeros((bh, n - s) + x.shape[2:])], dim=1)
    flat = torch.cat([x.reshape((bh * s,) + x.shape[2:]),
                      x.new_zeros((n - s,) + x.shape[2:])])
    return torch.stack([flat[b * s:b * s + n] for b in range(bh)])


def k34_bf16_emulated(q, k, v, do, lse, dsum, scale: float, bc: int = BC, *,
                      round_ds: bool = True, bf16_parts: bool = False,
                      drop_tile: int | None = None, lse_by_row: bool = False,
                      mask: bool = True, next_head_rows: bool = False):
    """K3 and K4's bf16 body over column tiles of bc. q, do (BH, Sq, D) and
    k, v (BH, Sk, D) bf16; lse, dsum (BH, Sq, 1) f32 -> dq, dk, dv bf16.
    The keywords make the faults the card's bars must see: dS unrounded
    (round_ds False), the running sums rounded to bf16 after each tile
    (bf16_parts), column tile drop_tile skipped, K4's lse2/dsum taken by its
    rows (lse_by_row), no mask of columns past their length (mask False),
    and the padded columns' rows read from the next head (next_head_rows)."""
    c = scale * _LOG2E
    bh, sq, d = q.shape
    sk = k.shape[1]

    def tiles(n):
        return range(0, -(-n // bc) * bc, bc)

    def accumulate(acc, part):
        acc = acc + part
        return acc.to(torch.bfloat16).float() if bf16_parts else acc

    # K3: rows are queries; column tiles of keys, each row's lse2 and dsum
    kp, vp = (_rows(x, -(-sk // bc) * bc, next_head_rows).float() for x in (k, v))
    qf, dof = q.float(), do.float()
    dq = torch.zeros(bh, sq, d)
    for j, c0 in enumerate(tiles(sk)):
        if j == drop_tile:
            continue
        kt, vt = kp[:, c0:c0 + bc], vp[:, c0:c0 + bc]
        p = torch.exp2(torch.matmul(qf, kt.transpose(1, 2)) * c - lse)
        if mask:
            p = torch.where(torch.arange(c0, c0 + bc) < sk, p, torch.zeros(()))
        ds = p * (torch.matmul(dof, vt.transpose(1, 2)) - dsum) * scale
        if round_ds:
            ds = ds.to(torch.bfloat16).float()
        dq = accumulate(dq, torch.matmul(ds, kt))

    # K4: rows are keys; column tiles of queries, each column's lse2 and dsum
    # from the flat (BH * Sq) arrays (past Sq: the next head's, then zeros)
    n = -(-sq // bc) * bc
    qp, dop = (_rows(x, n, next_head_rows).float() for x in (q, do))
    lcol, dcol = (_rows(x[..., 0], n, True) for x in (lse, dsum))
    lrow, drow = (_rows(x[..., 0], max(n, sk), True)[:, :sk, None] for x in (lse, dsum))
    kf, vf = k.float(), v.float()
    dk, dv = torch.zeros(bh, sk, d), torch.zeros(bh, sk, d)
    for j, c0 in enumerate(tiles(sq)):
        if j == drop_tile:
            continue
        qt, dot = qp[:, c0:c0 + bc], dop[:, c0:c0 + bc]
        l2, ds_ = ((lrow, drow) if lse_by_row else
                   (lcol[:, None, c0:c0 + bc], dcol[:, None, c0:c0 + bc]))
        pt = torch.exp2(torch.matmul(kf, qt.transpose(1, 2)) * c - l2)
        if mask:
            pt = torch.where(torch.arange(c0, c0 + bc) < sq, pt, torch.zeros(()))
        dst = pt * (torch.matmul(vf, dot.transpose(1, 2)) - ds_) * scale
        if round_ds:
            dst = dst.to(torch.bfloat16).float()
        dv = accumulate(dv, torch.matmul(pt.to(torch.bfloat16).float(), dot))
        dk = accumulate(dk, torch.matmul(dst, qt))
    return tuple(x.to(torch.bfloat16) for x in (dq, dk, dv))


def _ulp_of_max(x: torch.Tensor) -> float:
    """One bf16 ulp of max|x| (8 significant bits)."""
    return 2.0 ** (np.floor(np.log2(x.abs().max().item())) - 7)


def errors(got, ref) -> tuple[float, float]:
    """max and mean abs error over max|ref|, the worst of dq, dk, dv"""
    mx = mean = 0.0
    for a, b in zip(got, ref):
        top = b.float().abs().max().item()
        diff = (a.float() - b.float()).abs()
        mx, mean = max(mx, diff.max().item() / top), max(mean, diff.mean().item() / top)
    return mx, mean


@pytest.mark.parametrize("sq,sk,h", [(256, 256, 2), (256, 128, 2), (256, 77, 2)])
def test_k34_bf16_emulated_matches_pallas_kernels(sq, sk, h):
    """The emulated body against JAX's _flash_bwd_bhsd in Pallas interpret
    mode at tests/test_ops.py's d=64 shapes (keys padded to 128 and masked
    where the TPU needs it), bf16 inputs, from the Pallas forward's out and
    lse2: within one bf16 ulp of max|out| for dq, dk and dv."""
    rng = np.random.default_rng(6)
    d = 64
    q, do = (rng.normal(size=(h, sq, d)).astype(np.float32) for _ in range(2))
    k, v = (rng.normal(size=(h, sk, d)).astype(np.float32) for _ in range(2))
    scale = d ** -0.5
    pad = 128 - sk if sk % 128 else 0
    kv_valid = sk if pad else None
    jb = jnp.bfloat16
    with pltpu.force_tpu_interpret_mode():
        jq, jdo = jnp.asarray(q, jb), jnp.asarray(do, jb)
        jk, jv = (jnp.asarray(np.pad(x, ((0, 0), (0, pad), (0, 0))), jb) for x in (k, v))
        o, lse = j_fa._flash_bhsd(jq, jk, jv, scale, kv_valid=kv_valid)
        ref = j_fa._flash_bwd_bhsd(jq, jk, jv, o, jdo, lse, scale, kv_valid=kv_valid)
    tq, tk, tv, tdo, to = (torch.from_numpy(np.array(jnp.asarray(x, jnp.float32)))
                           .to(torch.bfloat16) for x in (jq, jk[:, :sk], jv[:, :sk], jdo, o))
    tl = torch.from_numpy(np.array(lse, np.float32))
    dsum = (tdo.float() * to.float()).sum(dim=-1, keepdim=True)
    got = k34_bf16_emulated(tq, tk, tv, tdo, tl, dsum, scale)
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        b = torch.from_numpy(np.array(jnp.asarray(b, jnp.float32)))[:, :a.shape[1]]
        assert (a.float() - b).abs().max().item() <= _ulp_of_max(b), name


def _card_inputs(seed: int, bh: int, sq: int, sk: int, d: int = 64):
    """chip_smoke.py's K3/K4 inputs: N(0, 1) q, k, v, dO in bf16; out and
    lse2 from K1's plain version; dsum = rowsum(dO * out) in f32."""
    rng = np.random.default_rng(seed)
    q, do = (torch.from_numpy(rng.standard_normal((bh, sq, d), dtype=np.float32))
             .to(torch.bfloat16) for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((bh, sk, d), dtype=np.float32))
            .to(torch.bfloat16) for _ in range(2))
    scale = d ** -0.5
    out, lse = t_fa._flash_bhsd_ref(q, k, v, scale)
    dsum = (do.float() * out.float()).sum(dim=-1, keepdim=True)
    return q, k, v, do, lse, dsum, scale


def test_card_column_tile_is_the_emulated_one():
    """The body's column tile is what this file emulates: 64 columns, the n
    of X and Y (wgmma m64n64k16) and four k steps of the output products."""
    assert BC == 64


# Readings against the plain version (max abs over max|plain|, mean abs over
# max|plain|; the worst of dq, dk, dv), card inputs of seed 50: (2, 576)
# body 1.9e-3, 5.3e-8; dS unrounded 4.5e-3, 2.1e-4; bf16 sums 9.1e-3,
# 3.7e-4; tile 3 dropped 0.75, 4.0e-2; K4's lse2/dsum by row 0.39, 2.3e-2.
# (1, 2304): body 1.6e-3, 2.0e-8; dS unrounded 6.2e-3, 1.9e-4; bf16 sums
# 1.6e-2, 7.2e-4; dropped 0.68, 1.9e-2; by row 0.26, 1.7e-2. The mean bar
# sits 9x under the least fault and 15x over the card's readings of both
# bodies (1e-7 to 1.3e-6 of max|plain|, PERF.md).
FAULTS = {  # keywords of k34_bf16_emulated -> the bars it must fail
    "ds_unrounded": (dict(round_ds=False), ("mean",)),
    "bf16_sums": (dict(bf16_parts=True), ("mean",)),
    "dropped_tile": (dict(drop_tile=3), ("max", "old", "mean")),
    "k4_lse_by_row": (dict(lse_by_row=True), ("max", "old", "mean")),
}


def _bars(got, ref) -> dict[str, bool]:
    """which of the card's bars got fails against ref"""
    mx, mean = errors(got, ref)
    return {"old": mx > OLD_BAR, "max": mx > MAX_REL_BAR, "mean": mean > MEAN_REL_BAR}


@pytest.mark.parametrize("bh,s", [(2, 576), (1, 2304)])
def test_emulated_body_meets_the_card_bars(bh, s):
    """At the card's inputs (a 9-tile and a 36-tile column loop), the
    emulated body meets all three bars against the plain version, the mean
    one with room: a tenth of MEAN_REL_BAR."""
    args = _card_inputs(50, bh, s, s)
    mx, mean = errors(k34_bf16_emulated(*args), t_fa._flash_bwd_bhsd_ref(*args))
    assert mx <= MAX_REL_BAR and mx <= OLD_BAR and mean <= MEAN_REL_BAR / 10, (mx, mean)


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("bh,s", [(2, 576), (1, 2304)])
def test_card_bars_see_the_faults(bh, s, fault):
    """Each fault fails the bars named for it in FAULTS: the mean bar by 5x
    or more, both max bars. dS unrounded and sums through bf16 stay within
    the max bars at 576 tokens; only the mean bar sees them there."""
    args = _card_inputs(50, bh, s, s)
    ref = t_fa._flash_bwd_bhsd_ref(*args)
    kwargs, bars = FAULTS[fault]
    mx, mean = errors(k34_bf16_emulated(*args, **kwargs), ref)
    failed = {"old": mx > OLD_BAR, "max": mx > MAX_REL_BAR, "mean": mean > 5 * MEAN_REL_BAR}
    assert all(failed[b] for b in bars), (fault, mx, mean)


@pytest.mark.parametrize("bh,sq,sk", [(3, 200, 77), (2, 130, 300)])
def test_unmasked_columns_meet_zero_rows(bh, sq, sk):
    """Columns past their length (keys past Sk in K3, queries past Sq in K4)
    are zero rows of the 3-D tensor maps: the body without its mask gives
    the same bits, the P there meeting only zero rows. Read from the next
    head instead (a 2-D map over BH * S rows), unmasked columns fail both max
    bars, and the mask alone brings the body back."""
    args = _card_inputs(51, bh, sq, sk)
    ref = t_fa._flash_bwd_bhsd_ref(*args)
    body = k34_bf16_emulated(*args)
    for a, b in zip(k34_bf16_emulated(*args, mask=False), body):
        assert torch.equal(a, b)
    assert not any(_bars(body, ref).values())
    assert not any(_bars(k34_bf16_emulated(*args, next_head_rows=True), ref).values())
    bad = _bars(k34_bf16_emulated(*args, mask=False, next_head_rows=True), ref)
    assert bad["max"] and bad["old"], bad
