"""The numerics of K3/K4's bf16 body at d=512 (wgmma), on the CPU.

On the card, K3 and K4 in bf16 at head dim 512 (csrc/flash_attn_bwd.cu,
flash_attn_bwd_wgmma_d512_kernel) run CTAs of 64 rows that loop over column
tiles of kBC columns: keys in K3, queries in K4. Two warpgroups split X and Y
of a tile by columns and write their halves of E, rounded to bf16, into one
E tile; each then adds E B over its half of d (256 columns) into one f32
accumulator over the whole column loop: no per-tile parts (there is no room
for them at d=512). K4 runs as two passes of the body, the dk pass (S^T,
dP^T, dk += dS^T Q, lse2 and dsum of the column from flat maps over bh * sq)
and the dv pass (S^T, dv += round(P^T) dO). No CUDA kernel runs here, so this
file emulates that tile order and accumulation (``k34_d512_emulated``, the
output products summed as the tensor cores sum a chain of m64nNk16: each k
step of 16 adds its exact products to the accumulator and rounds toward
zero) and holds it to:

- JAX's ``_flash_bwd_bhsd`` (the TPU's _flash_bwd_dq_kernel and
  _flash_bwd_dkv_kernel) in Pallas interpret mode at d=512, bf16, within one
  bf16 ulp of max|out| for dq, dk and dv;
- the card's bars for K3/K4 in bf16 (chip_smoke.K34_TOL,
  K34_BF16_REL_TOL, K34_BF16_MEAN_REL_TOL) against the plain version at the
  card's inputs, the mean bar with room; and each fault of this design fails
  at least one of them: one warpgroup's half of the output built from the
  other E tile (the last tile's), the dv pass with P unrounded, the dk pass
  reading lse2/dsum by row (key) instead of by column (query), a dropped
  column tile;
- the body's source: dispatch sends every bf16 d=512 call to it.
"""

from __future__ import annotations

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import chip_smoke
from genpercept_tpu.ops import flash_attention as j_fa
from genpercept_tpu_torch import _build
from genpercept_tpu_torch.ops import flash_attention as t_fa
from test_torch_flash_bwd_bf16 import BC, _card_inputs, _rows, _ulp_of_max, errors

torch.set_num_threads(1)

_LOG2E = 1.4426950408889634
D = 512
HALF = 256  # the columns of d each consumer warpgroup owns
SOURCE = (_build.CSRC / "flash_attn_bwd.cu").read_text()


def _rz_f32(x: torch.Tensor) -> torch.Tensor:
    """float64 -> f32 rounded toward zero."""
    t = x.to(torch.float32)
    return torch.where(t.double().abs() > x.abs(), torch.nextafter(t, torch.zeros_like(t)), t)


def wgmma_accumulate(acc: torch.Tensor, e: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """acc (f32) + e @ b for bf16 values e (..., rows, k) and b (..., k, n),
    as the tensor cores take a chain of m64nNk16: each k step adds its 16
    products (exact in float64) to the accumulator and rounds the sum toward
    zero."""
    out, e, b = acc.double(), e.double(), b.double()
    for k0 in range(0, e.shape[-1], 16):
        out = _rz_f32(out + e[..., k0:k0 + 16] @ b[..., k0:k0 + 16, :]).double()
    return out.float()


def _pass(a1, a2, b1, b2, l2, ds, n_cols: int, scale: float, *, dv: bool,
          round_p: bool = True, stale_half: bool = False, drop_tile: int | None = None,
          per_tile: bool = False):
    """One pass of the body over column tiles of BC: rows a1, a2 (BH, R, D)
    f32 of bf16 values, columns b1, b2 (BH, C, D) padded with zero rows to
    whole tiles; l2, ds the lse2 and dsum of each (row, column) pair's query,
    (BH, R, C) or broadcastable. The dq and dk passes: E = round(P (Y - ds)
    scale), out += E B1; the dv pass: E = P rounded (round_p), out += E B2.
    stale_half: the second warpgroup's half of d takes the other E tile (tile
    j - 1's, zeros at j = 0); per_tile: each tile's products sum from zero,
    added to out in f32 (the d=64 body's form)."""
    c = scale * _LOG2E
    out = torch.zeros(a1.shape)
    e_last = torch.zeros(a1.shape[:2] + (BC,))
    for j, c0 in enumerate(range(0, b1.shape[1], BC)):
        if j == drop_tile:
            continue
        cols = slice(c0, c0 + BC)
        lt, dt = (x if x.shape[-1] == 1 else x[..., cols] for x in (l2, ds))
        p = torch.exp2(torch.matmul(a1, b1[:, cols].transpose(1, 2)) * c - lt)
        p = torch.where(torch.arange(c0, c0 + BC) < n_cols, p, torch.zeros(()))
        if dv:
            e = p.to(torch.bfloat16).float() if round_p else p
            b = b2[:, cols]
        else:
            e = (p * (torch.matmul(a2, b2[:, cols].transpose(1, 2)) - dt) * scale)
            e = e.to(torch.bfloat16).float()
            b = b1[:, cols]
        for h, eh in enumerate((e, e_last if stale_half else e)):
            d = slice(h * HALF, (h + 1) * HALF)
            if per_tile:
                out[..., d] += wgmma_accumulate(torch.zeros(out[..., d].shape), eh, b[..., d])
            else:
                out[..., d] = wgmma_accumulate(out[..., d], eh, b[..., d])
        e_last = e
    return out


def k34_d512_emulated(q, k, v, do, lse, dsum, scale: float, *, dv_round_p: bool = True,
                      stale_half: bool = False, dk_lse_by_row: bool = False,
                      drop_tile: int | None = None, per_tile: bool = False):
    """K3, K4's dk pass and K4's dv pass of the bf16 d=512 body. q, do (BH,
    Sq, D) and k, v (BH, Sk, D) bf16; lse, dsum (BH, Sq, 1) f32 -> dq, dk, dv
    bf16. The keywords make the faults the card's bars must see (``_pass``;
    dk_lse_by_row: the dk pass takes lse2 and dsum of its rows, the keys)."""
    bh, sq, _ = q.shape
    sk = k.shape[1]
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    kw = dict(stale_half=stale_half, drop_tile=drop_tile, per_tile=per_tile)
    nk, nq = -(-sk // BC) * BC, -(-sq // BC) * BC
    kp, vp = (_rows(x, nk, False) for x in (kf, vf))
    dq = _pass(qf, dof, kp, vp, lse, dsum, sk, scale, dv=False, **kw)
    # K4: the columns' lse2 and dsum from the flat (BH * Sq) arrays (past Sq:
    # the next head's, then zeros), as its 1-D maps read them
    qp, dop = (_rows(x, nq, False) for x in (qf, dof))
    lcol, dcol = (_rows(x[..., 0], nq, True)[:, None, :] for x in (lse, dsum))
    if dk_lse_by_row:
        lrow, drow = (_rows(x[..., 0], max(nq, sk), True)[:, :sk, None] for x in (lse, dsum))
        dk = _pass(kf, vf, qp, dop, lrow.expand(-1, -1, nq), drow.expand(-1, -1, nq), sq,
                   scale, dv=False, **kw)
    else:
        dk = _pass(kf, vf, qp, dop, lcol, dcol, sq, scale, dv=False, **kw)
    dv = _pass(kf, None, qp, dop, lcol, dcol, sq, scale, dv=True, round_p=dv_round_p, **kw)
    return tuple(x.to(torch.bfloat16) for x in (dq, dk, dv))


@pytest.mark.parametrize("h,sq,sk", [(1, 128, 256), (1, 256, 77)])
def test_k34_d512_emulated_matches_pallas_kernels(h, sq, sk):
    """The emulated body against JAX's _flash_bwd_bhsd in Pallas interpret
    mode at d=512 (tests/test_ops.py's VAE mid-block shape, and keys padded
    to 128 and masked where the TPU needs it), bf16 inputs, from the Pallas
    forward's out and lse2: within one bf16 ulp of max|out| for dq, dk and
    dv."""
    rng = np.random.default_rng(7)
    q, do = (rng.normal(size=(h, sq, D)).astype(np.float32) for _ in range(2))
    k, v = (rng.normal(size=(h, sk, D)).astype(np.float32) for _ in range(2))
    scale = D ** -0.5
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
    got = k34_d512_emulated(tq, tk, tv, tdo, tl, dsum, scale)
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        b = torch.from_numpy(np.array(jnp.asarray(b, jnp.float32)))[:, :a.shape[1]]
        assert (a.float() - b).abs().max().item() <= _ulp_of_max(b), name


def _bars(got, ref, mean_room: float = 1.0) -> dict[str, bool]:
    """which of the card's bars (chip_smoke's) got fails against ref; the mean
    bar divided by mean_room"""
    mx, mean = errors(got, ref)
    return {"old": mx > chip_smoke.K34_TOL[torch.bfloat16],
            "max": mx > chip_smoke.K34_BF16_REL_TOL,
            "mean": mean > chip_smoke.K34_BF16_MEAN_REL_TOL / mean_room}


@pytest.mark.parametrize("bh,sq,sk", [(2, 576, 576), (1, 1152, 1152), (2, 40, 300),
                                      (1, 300, 77), (1, 77, 200)])
def test_emulated_body_meets_the_card_bars(bh, sq, sk):
    """At the card's inputs (a 9- and an 18-tile column loop, and
    chip_smoke.K34_RAGGED's d=512 lengths), the emulated body, one
    accumulator over the column loop, meets all three bars against the
    plain version, the mean one with room: a tenth of it."""
    args = _card_inputs(60, bh, sq, sk, D)
    got = k34_d512_emulated(*args)
    assert not any(_bars(got, t_fa._flash_bwd_bhsd_ref(*args), mean_room=10).values()), \
        errors(got, t_fa._flash_bwd_bhsd_ref(*args))


def test_one_accumulator_error_stays_under_the_mean_bar():
    """One accumulator over the 18 column tiles: the truncation of each k
    step's sum into the running sum is an error that per-tile parts (summed
    from zero, added in f32) do not have, and the model sees it (1.6e-7 of
    max|plain| mean against 2.4e-8); it stays a twentieth of the card's mean
    bar, which the card also checks at 9216 columns."""
    args = _card_inputs(61, 1, 1152, 1152, D)
    ref = t_fa._flash_bwd_bhsd_ref(*args)
    _, one = errors(k34_d512_emulated(*args), ref)
    _, parts = errors(k34_d512_emulated(*args, per_tile=True), ref)
    assert parts < one <= chip_smoke.K34_BF16_MEAN_REL_TOL / 20, (one, parts)


# Readings against the plain version (max abs, mean abs over max|plain|; the
# worst of dq, dk, dv), card inputs of seed 60 at (2, 576): see CHANGES.md
# and PERF.md for the figures of each fault.
FAULTS = {  # keywords of k34_d512_emulated -> the bars it must fail
    "stale_e_half": (dict(stale_half=True), ("max", "old", "mean")),
    "dv_p_unrounded": (dict(dv_round_p=False), ("mean",)),
    "dk_lse_by_row": (dict(dk_lse_by_row=True), ("max", "old", "mean")),
    "dropped_tile": (dict(drop_tile=3), ("max", "old", "mean")),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_card_bars_see_the_faults(fault):
    """Each fault of the d=512 design fails the bars named for it in FAULTS,
    the mean bar by 5x or more."""
    args = _card_inputs(60, 2, 576, 576, D)
    kwargs, bars = FAULTS[fault]
    got = k34_d512_emulated(*args, **kwargs)
    failed = _bars(got, t_fa._flash_bwd_bhsd_ref(*args), mean_room=1 / 5)
    assert all(failed[b] for b in bars), (fault, errors(got, t_fa._flash_bwd_bhsd_ref(*args)))


def _dispatch() -> str:
    m = re.search(r"cudaError_t dispatch\(.*?\n\}\n", SOURCE, re.S)
    assert m is not None, "dispatch not found"
    return m.group(0)


def test_dispatch_sends_bf16_d512_to_the_wgmma_body():
    """Every bf16 (dtype 1) call at d=512 goes to launch_wgmma_d512, K3's
    and K4's instantiations, and the mma.sync body it replaced is gone."""
    line = re.search(r"if \(dtype == 1 && d == 512\)\s*return ([^;]*);", _dispatch())
    assert line is not None
    assert re.fullmatch(r"DKV \? launch_wgmma_d512<\d+, \w+, true>\(a, bh, s\)\s*"
                        r": launch_wgmma_d512<\d+, \w+, false>\(a, bh, s\)",
                        line.group(1)), line
    for gone in ("launch_mma", "flash_attn_bwd_mma_kernel", "MmaTiling", "kPartLD"):
        assert gone not in SOURCE, gone


def test_d512_body_is_named_wgmma():
    """flash_attn_bwd_bf16_d512_body(), which chip_smoke.py and the card
    tests read, names a wgmma body, and the library binds it."""
    m = re.search(r'flash_attn_bwd_bf16_d512_body\(\) \{\s*return "([^"]*)"', SOURCE)
    assert m is not None and m.group(1).startswith("wgmma")
    assert "flash_attn_bwd_bf16_d512_body" in (_build.CSRC.parent / "_build.py").read_text()


def test_k4_runs_two_passes_in_one_call():
    """K4 at d=512 is one wrapper call (one count of _flash_bwd_dkv.launches)
    that launches its dk pass, then its dv pass, each a kernel of its own
    (one kernel for both serialized every wgmma): the dk pass lets the dv
    pass start early (PDL), and the dv pass ends after it."""
    launcher = re.search(r"cudaError_t launch_wgmma_d512\(.*?\n\}\n", SOURCE, re.S).group(0)
    passes = re.findall(r"launch_d512_pass<NBUF, (kPass\w+)>\(m, a, bh, (\w+),", launcher)
    assert passes == [("kPassDq", "false"), ("kPassDk", "false"), ("kPassDv", "PDL")], passes
    one = re.search(r"cudaError_t launch_d512_pass\(.*?\n\}\n", SOURCE, re.S).group(0)
    assert one.count("cudaLaunchKernelEx(") == 1
    kernel = re.search(r"flash_attn_bwd_wgmma_d512_kernel\(.*?\n\}\n", SOURCE, re.S).group(0)
    assert "if constexpr (PASS == kPassDk) griddep_launch_dependents();" in kernel
    assert "if constexpr (PASS == kPassDv) griddep_wait();" in kernel
    assert "blockIdx.z" not in kernel


def _tune_k34():
    import importlib.util
    path = _build.CSRC.parent.parent / "scripts" / "tune_k34.py"
    spec = importlib.util.spec_from_file_location("tune_k34", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _changed(mod, tile=(), variant=()) -> list[tuple[str, str]]:
    """(shipped, edited) lines of the one variant tune_k34 builds"""
    import argparse
    out = mod.variants(argparse.Namespace(dtype="bf16", tile=list(tile), variant=list(variant),
                                          baseline=None))
    (name,) = [n for n in out if n != "shipped"]
    shipped, edited = out["shipped"][0].splitlines(), out[name][0].splitlines()
    assert len(shipped) == len(edited)
    return [(a, b) for a, b in zip(shipped, edited) if a != b]


@pytest.mark.parametrize("tile,k3,k4", [
    ("dq512:8,true", "launch_wgmma_d512<8, true, false>", None),
    ("dkv512:10,false", None, "launch_wgmma_d512<10, false, true>"),
    ("dq512:9,true+dkv512:8,false", "launch_wgmma_d512<9, true, false>",
     "launch_wgmma_d512<8, false, true>"),
])
def test_tune_k34_d512_tiles_edit_what_they_name(tile, k3, k4):
    """scripts/tune_k34.py --tile dq512:N,PDL / dkv512:N,PDL rewrites the bf16
    d=512 body's instantiation in dispatch (its ring of N atom stages, K4's
    dv pass launched to overlap its dk pass or after it) and nothing else."""
    changed = _changed(_tune_k34(), tile=[tile])
    text = "\n".join(b for _, b in changed)
    assert changed and all("launch_wgmma_d512<" in b for _, b in changed), changed
    for want in (k3, k4):
        if want is not None:
            assert want in text, (want, text)


@pytest.mark.parametrize("name,old,new", [
    ("dkpass", "launch_d512_pass<NBUF, kPassDv>", "return err;"),
    ("dvpass", "launch_d512_pass<NBUF, kPassDk>", "cudaSuccess;"),
])
def test_tune_k34_d512_probes_drop_one_pass(name, old, new):
    """--variant dkpass / dvpass time K4 at d=512 with one of its two
    launches alone: one line of the launcher changes."""
    (change,) = _changed(_tune_k34(), variant=[name])
    assert old in change[0] and old not in change[1] and change[1].endswith(new), change
