"""The numerics of K1's bf16 body at d=512 on the card, on the CPU.

On the card, K1 in bf16 at head dim 512 (csrc/flash_attn_fwd.cu,
flash_attn_fwd_wgmma_d512_kernel) runs the online softmax over key tiles of
BK keys (the tile its dispatch, dispatch_bf16_d512, instantiates), split
between two warpgroups by keys: both take the running max over the whole
tile, so the rounding of p follows the BK-key partition, as at d=64, and the
halves differ from one pass in the order of f32 sums only. Where the grid of
q tiles would leave its last wave mostly idle (d512_splits), the key axis is
also split into S runs of whole tiles, split z taking tiles [n z / S,
n (z + 1) / S) of n: each run starts its own running max, writes its output
normalized by its own l in f32 with its lse2, and the combine pass adds them
(plain version ``_lse_combine_ref``). The grids of these tests' shapes split
in 4 on the card. No CUDA kernel runs here, so this file emulates that
partition in torch (``k1_bf16_d512_emulated``) and holds it, on inputs whose
row max rises across the key tiles, to:

- JAX's ``_flash_bhsd`` in Pallas interpret mode (one k block of all keys at
  these lengths) at every split count: out within one bf16 ulp of max|out|
  and 2e-4 mean abs, lse2 within 2e-3, the bars of the d=64 body's test;
- the unedited scripts/profile_attn_boundary.py part "sweep512" ``build`` at
  the card's key tile, unsplit: the two round the same p and differ in the
  order of f32 sums alone, so out within one bf16 ulp and 1e-6 mean abs, a
  bar that the emulation without the rounding of p, over one tile of all
  keys, over 64-key tiles, or split, fails by 10x or more;
- itself without the rounding of p, split and unsplit: with p in f32 the
  splits' combine is exact up to f32 rounding.
"""

from __future__ import annotations

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from genpercept_tpu.ops import flash_attention as j_fa
from genpercept_tpu.ops.flash_attention import _flash_kernel
from genpercept_tpu_torch import _build
from genpercept_tpu_torch.ops import flash_attention as t_fa
from test_torch_flash_bf16 import _out_errors, _rising_inputs, _torch, k1_online
from test_torch_flash_variants import _part_defs

torch.set_num_threads(1)

SCALE = 512 ** -0.5


def card_key_tile() -> int:
    """BK of the launch_wgmma_d512 in dispatch_bf16_d512 (csrc/flash_attn_fwd.cu),
    the keys a tile of K1's bf16 d=512 body at every length."""
    src = (_build.CSRC / "flash_attn_fwd.cu").read_text()
    body = re.search(r"cudaError_t dispatch_bf16_d512\([^)]*\) \{\n(.*?)\n\}\n", src, re.S)
    assert body is not None, "dispatch_bf16_d512 not found"
    bks = {int(b) for b in re.findall(r"launch_wgmma_d512<(\d+),", body.group(1))}
    assert len(bks) == 1, bks
    return bks.pop()


def _online(q, k, v, bk: int, round_p: bool):
    """One run of K1's online softmax (``k1_online``) at d=512 -> (acc / l
    in f32, lse2 (BH, Sq, 1))."""
    return k1_online(q, k, v, SCALE, bk, round_p)[:2]


def split_bounds(n: int, splits: int) -> list[tuple[int, int]]:
    """The key tiles [t0, t1) of each split, as the kernel divides n tiles."""
    return [(n * z // splits, n * (z + 1) // splits) for z in range(splits)]


def split_parts(q, k, v, bk: int, splits: int, round_p: bool = True):
    """Each split's run over its key tiles -> (f32 outputs (S, BH, Sq, 512),
    lse2 (S, BH, Sq, 1)), stacked as the combine pass reads them."""
    parts = [_online(q, k[:, t0 * bk:t1 * bk], v[:, t0 * bk:t1 * bk], bk, round_p)
             for t0, t1 in split_bounds(-(-k.shape[1] // bk), splits)]
    return torch.stack([o for o, _ in parts]), torch.stack([l for _, l in parts])


def k1_bf16_d512_emulated(q, k, v, bk: int, splits: int = 1, round_p: bool = True):
    """K1's bf16 d=512 body over key tiles of bk in `splits` runs, combined
    by the plain version of the combine pass -> (out bf16, lse2 f32)."""
    if splits == 1:
        out, lse = _online(q, k, v, bk, round_p)
        return out.to(q.dtype), lse
    return t_fa._lse_combine_ref(*split_parts(q, k, v, bk, splits, round_p), q.dtype)


def test_card_key_tile_is_the_emulated_one():
    """The body takes one key tile, 128: a warpgroup's Q K^T is wgmma
    m64n64k16 over its 64 keys."""
    assert card_key_tile() == 128


def test_split_bounds_are_unequal_where_the_tiles_do_not_divide():
    """11 tiles over 4 splits: runs of 2, 3, 3 and 3 tiles, each non-empty,
    together every tile once."""
    bounds = split_bounds(11, 4)
    assert bounds == [(0, 2), (2, 5), (5, 8), (8, 11)]
    for n in range(1, 40):
        for s in range(1, min(n, 4) + 1):
            b = split_bounds(n, s)
            assert b[0][0] == 0 and b[-1][1] == n and all(t1 > t0 for t0, t1 in b)
            assert all(b[i][1] == b[i + 1][0] for i in range(s - 1))


# Readings against _flash_bhsd, BK 128, out max (of max|out|) / mean, lse2
# max: (1, 1024) at S 1, 2, 4: 7.8e-3 (3.6e-3) / 8.4e-5, 8.4e-5, 9.3e-5;
# 6.4e-4, 6.4e-4, 8.4e-4. (1, 1536): 7.8e-3 (3.9e-3) / 7.7e-5, 7.7e-5,
# 8.3e-5; 7.1e-4, 7.9e-4, 6.6e-4.
@pytest.mark.parametrize("splits", [1, 2, 4])
@pytest.mark.parametrize("s", [1024, 1536])
def test_k1_bf16_d512_key_partition_matches_pallas_kernel(s, splits):
    q, k, v = _rising_inputs(40 + s, 1, s, d=512)
    with pltpu.force_tpu_interpret_mode():
        ref_o, ref_l = j_fa._flash_bhsd(q, k, v, SCALE)
    top = float(np.abs(np.asarray(ref_o, np.float32)).max())
    out, lse = k1_bf16_d512_emulated(*map(_torch, (q, k, v)), card_key_tile(), splits)
    assert out.dtype == torch.bfloat16 and lse.shape == (1, s, 1)
    err_max, err_mean = _out_errors(out, ref_o)
    assert err_max <= 2.0 ** -7 * top and err_mean <= 2e-4, (err_max, err_mean)
    assert (lse - torch.from_numpy(np.array(ref_l))).abs().max().item() <= 2e-3


# Readings against build(256, 128, False) on (x * 0.05, x, x), max / mean:
# the emulation 2.0e-3 / 1.4e-7 at 1024 keys, 9.8e-4 / 1.1e-7 at 1536;
# without the rounding of p 3.9e-3 / 5.3e-5, 2.0e-3 / 4.3e-5; over one tile
# of all keys 3.0e-5, 2.7e-5 mean; over 64-key tiles 1.7e-5, 1.3e-5; split
# in 2 3.4e-5, 2.9e-5; in 4 5.0e-5, 4.2e-5.
@pytest.mark.parametrize("s", [1024, 1536])
def test_k1_bf16_d512_key_partition_matches_pallas_at_its_tile(s):
    """The script's fn(p, x) is the attention of (x * p, x, x); p = 0.05 keeps
    the diagonal logit from taking each row's whole weight, and the keys'
    rising scale raises the row max across the tiles."""
    ns = _part_defs("profile_attn_boundary", "sweep512", {"build"},
                    _flash_kernel=_flash_kernel, d=512)
    x = _rising_inputs(40 + s, 1, s, d=512)[1]
    p = jnp.asarray(0.05, jnp.bfloat16)
    bk = card_key_tile()
    with pltpu.force_tpu_interpret_mode():
        ref = ns["build"](256, bk, False)(p, x)
    qt, xt = _torch(x * p), _torch(x)
    err_max, err_mean = _out_errors(k1_bf16_d512_emulated(qt, xt, xt, bk)[0], ref)
    assert err_max <= 2.0 ** -7 * float(np.abs(np.asarray(ref, np.float32)).max())
    assert err_mean <= 1e-6, (err_max, err_mean)
    for mutant in (k1_bf16_d512_emulated(qt, xt, xt, bk, round_p=False),
                   k1_bf16_d512_emulated(qt, xt, xt, s),
                   k1_bf16_d512_emulated(qt, xt, xt, 64),
                   k1_bf16_d512_emulated(qt, xt, xt, bk, 2)):
        assert _out_errors(mutant[0], ref)[1] > 1e-5


# Readings, max, at 2, 3, 4 splits: out 3.6e-7, 4.8e-7, 6.0e-7 (max|out| 2.24:
# a few f32 ulps, the sums taken in another order), lse2 1.9e-6, 9.5e-7,
# 9.5e-7. Bars: 2e-6 and 1e-5.
@pytest.mark.parametrize("splits", [2, 3, 4])
def test_k1_bf16_d512_split_combine_is_exact_without_rounding(splits):
    """With p kept in f32, the splits' outputs and lse2 combined are one
    pass's, up to f32 rounding: the combine pass adds no error of its own."""
    q, k, v = map(_torch, _rising_inputs(43, 2, 1300, d=512))
    bk = card_key_tile()
    one = _online(q, k, v, bk, round_p=False)
    out, lse = t_fa._lse_combine_ref(*split_parts(q, k, v, bk, splits, round_p=False),
                                     torch.float32)
    assert (out - one[0]).abs().max().item() <= 2e-6
    assert (lse - one[1]).abs().max().item() <= 1e-5


CARD_REL = 2.0 ** -6  # the card's bar on K1's bf16 out, of max|plain|


def _randn_inputs(s: int, sq: int = 128):
    """q (1, sq, 512) and k, v (1, s, 512) in bf16 from standard normals, as
    the card tests draw them (fewer q rows: each row is its own softmax)."""
    rng = np.random.default_rng(7)
    return tuple(torch.from_numpy(rng.standard_normal((1, n, 512)).astype(np.float32))
                 .to(torch.bfloat16) for n in (sq, s, s))


# Readings, out error of max|plain| (max|plain| 0.104 and 0.085): 4.7e-3 at
# 4800 keys and 2.9e-3 at 9216, unsplit and split in 4.
@pytest.mark.parametrize("s", [4800, 9216])
def test_k1_bf16_d512_meets_the_card_bar_on_randn_inputs(s):
    """The card holds K1's bf16 out to 2^-6 of max|plain| beside 2e-2
    absolute. On randn inputs over the VAE mid block's key lengths (the
    recipe's 4800, 768^2's 9216) the body's partition meets it against the
    plain version, unsplit and split in 4."""
    q, k, v = _randn_inputs(s)
    ref = t_fa._flash_bhsd_ref(q, k, v, SCALE)[0].float()
    top = ref.abs().max().item()
    bk = card_key_tile()
    for splits in (1, 4):
        out = k1_bf16_d512_emulated(q, k, v, bk, splits)[0]
        assert (out.float() - ref).abs().max().item() <= CARD_REL * top, splits


# Readings at 4800 keys, out error of max|plain| (abs): one half of O not
# rescaled 1.6 (0.17); the combine without its last split 0.62 (0.065);
# weighted by e^(lse2_z - max) in place of 2^ 3.5e-2 (3.6e-3).
def test_k1_bf16_d512_card_bar_catches_a_fraction_of_the_output():
    """Faults that fail nothing loudly: the second warpgroup's half of O
    left unrescaled when the max rises, a combine that drops a split, and
    one whose weights take the wrong base. Each misses 2^-6 of max|plain|;
    the last stays under 2e-2 absolute, which |out| ~0.02 makes blind to
    an error of a fraction of the output."""
    q, k, v = _randn_inputs(4800)
    ref = t_fa._flash_bhsd_ref(q, k, v, SCALE)[0].float()
    top = ref.abs().max().item()
    bk = card_key_tile()
    o, lse = split_parts(q, k, v, bk, 4)
    w = torch.exp(lse - lse.amax(dim=0))
    mutants = {
        "half unrescaled": k1_online(q, k, v, SCALE, bk, stale_cols=256)[0].to(torch.bfloat16),
        "split dropped": t_fa._lse_combine_ref(o[:3], lse[:3], torch.bfloat16)[0],
        "base e": ((w / w.sum(dim=0)) * o).sum(dim=0).to(torch.bfloat16)}
    errs = {name: (m.float() - ref).abs().max().item() for name, m in mutants.items()}
    assert all(e > CARD_REL * top for e in errs.values()), (errs, top)
    assert errs["base e"] <= 2e-2, errs


def test_tune_k1_replaces_the_d512_dispatch():
    """scripts/tune_k1.py --tile 512:K,N[,S] builds the d=512 body as one
    launch_wgmma_d512<K, N> for every length, and with S also replaces
    the split rule by S splits (at most the key tiles): two edits, nothing
    else."""
    import argparse

    from test_torch_flash_bf16 import _script
    mod = _script("tune_k1")
    out = mod.variants(argparse.Namespace(dtype="bf16", split=[], baseline=[],
                                          tile=["512:128,4", "512:128,8,3"]))
    def rest(src):  # the source outside the two regions the edits may touch
        for pattern in (mod.D512_SPLITS, mod.BF16_DISPATCH[512]):
            src = pattern.sub(lambda mm: mm.group(1) + mm.group(2), src)
        return src

    shipped = out["shipped"][0]
    for name, launch, rule in (("tile_512_128_4", "launch_wgmma_d512<128, 4>(", None),
                               ("tile_512_128_8_3", "launch_wgmma_d512<128, 8>(",
                                "return n < 3 ? n : 3;")):
        edited = out[name][0]
        assert launch in edited and rest(edited) == rest(shipped)
        assert (mod.D512_SPLITS.search(edited).group(0) ==
                mod.D512_SPLITS.search(shipped).group(0)) == (rule is None)
        assert rule is None or rule in edited
    for bad in ("512:128", "512:128,8,true", "512:128,8,12", "512:64,16"):
        with pytest.raises(SystemExit):
            mod.variants(argparse.Namespace(dtype="bf16", split=[], tile=[bad], baseline=[]))
