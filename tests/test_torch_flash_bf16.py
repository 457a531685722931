"""The numerics of K1's bf16 body at d=64 on the card, on the CPU.

On the card, K1 in bf16 at head dim 64 (csrc/flash_attn_fwd.cu,
flash_attn_fwd_wgmma_kernel) runs the online softmax over key tiles of BK
keys (the tile its dispatch, dispatch_bf16_d64, instantiates): per tile the
logits in f32, the running max m of the tiles seen so far, p = exp2(s*c -
m*c) rounded to bf16 against that running max, l the f32 sum of the rounded
p, and the accumulator and l rescaled by alpha = exp2((m_prev - m_new)*c)
when a tile raises the max. The key partition is part of the function: p is
rounded against another max in each partition. No CUDA kernel runs here, so
this file emulates that key partition in torch (``k1_bf16_emulated``) and
holds it, on inputs where the max rises across the card's key tiles, to:

- JAX's ``_flash_bhsd`` in Pallas interpret mode, whose TPU kernel rounds p
  against the running max of its own k blocks (one block of 512 or 1024
  keys at these shapes): out within one bf16 ulp of max|out| and 2e-4 mean
  abs, lse2 within 2e-3. The two partitions round p against different
  maxima, and where a few p carry a row's weight those roundings move l by
  up to ~2^-9 relative (lse2 by ~1e-3) and an output by a bf16 ulp;
- the same Pallas kernel at the card's partition (k blocks of BK; the
  unedited scripts/profile_unet.py ``flash_with_blocks``, out only): the two
  round the same p and differ in f32 summation order alone, so out within
  one bf16 ulp (1e-3 here) and 2e-6 mean abs, bounds that the emulation
  without the rounding of p, or at another key partition, fails by 20x.
"""

from __future__ import annotations

import importlib.util
import re
from pathlib import Path

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
NEG_INF = -1e30
SCRIPTS = Path(__file__).resolve().parent.parent / "scripts"


def card_key_tiles() -> list[int]:
    """BK of every launch_wgmma in dispatch_bf16_d64 (csrc/flash_attn_fwd.cu),
    the keys a tile of K1's bf16 d=64 body at the lengths it dispatches."""
    src = (_build.CSRC / "flash_attn_fwd.cu").read_text()
    body = re.search(r"cudaError_t dispatch_bf16_d64\([^)]*\) \{\n(.*?)\n\}\n", src, re.S)
    assert body is not None, "dispatch_bf16_d64 not found"
    bks = sorted({int(b) for b in re.findall(r"launch_wgmma<\d+, (\d+),", body.group(1))})
    assert bks, "no launch_wgmma in dispatch_bf16_d64"
    return bks


def k1_bf16_emulated(q, k, v, scale: float, bk: int, round_p: bool = True):
    """K1's bf16 body over key tiles of bk: f32 logits, the running max,
    p rounded to bf16 against it (round_p), l the sum of the rounded p, alpha
    rescales. q/k/v bf16 -> (out bf16, lse2 f32 (BH, Sq, 1), the number of
    tiles after the first that raised some row's max)."""
    c = scale * _LOG2E
    bh, sq, _ = q.shape
    qf = q.float()
    m = torch.full((bh, sq, 1), NEG_INF)
    l = torch.zeros((bh, sq, 1))
    acc = torch.zeros((bh, sq, v.shape[2]))
    raised = 0
    for k0 in range(0, k.shape[1], bk):
        s = torch.matmul(qf, k[:, k0:k0 + bk].float().transpose(1, 2))
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        raised += int(k0 > 0 and bool((m_new > m).any()))
        p = torch.exp2(s * c - m_new * c)
        if round_p:
            p = p.to(torch.bfloat16).float()
        alpha = torch.exp2((m - m_new) * c)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.matmul(p, v[:, k0:k0 + bk].float())
        m = m_new
    return (acc / l).to(q.dtype), m * c + torch.log2(l), raised


def _rising_inputs(seed: int, bh: int, s: int, d: int = 64):
    """q, k, v in bf16 whose logits grow in spread along the keys, so that
    the row max rises across key tiles (key j scaled by 0.5 + 1.5 j / s)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((bh, s, d))
    k = rng.standard_normal((bh, s, d)) * (0.5 + 1.5 * np.arange(s) / s)[None, :, None]
    v = rng.standard_normal((bh, s, d))
    return tuple(jnp.asarray(x.astype(np.float32), jnp.bfloat16) for x in (q, k, v))


def _torch(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, np.float32)).to(torch.bfloat16)


def _out_errors(out: torch.Tensor, ref) -> tuple[float, float]:
    """max and mean abs error of a bf16 output against a JAX array"""
    d = np.abs(out.float().numpy() - np.asarray(ref, np.float32))
    return float(d.max()), float(d.mean())


def test_card_key_tiles_are_the_emulated_ones():
    """The dispatch instantiates key tiles that the tests below emulate:
    wgmma m64nBKk16 takes BK a multiple of 16, and the body 64 or 128."""
    assert set(card_key_tiles()) <= {64, 128}


# Readings against _flash_bhsd, out max (of max|out|) / mean, lse2 max:
# (2, 512) at BK 64 3.9e-3 (1.6e-3) / 1.1e-4, 9.4e-4; at BK 128 3.9e-3
# (1.6e-3) / 8.6e-5, 7.3e-4; (1, 1024) at BK 64 7.8e-3 (4.5e-3) / 9.1e-5,
# 6.3e-4; at BK 128 7.8e-3 (4.5e-3) / 8.4e-5, 6.8e-4.
@pytest.mark.parametrize("bh,s", [(2, 512), (1, 1024)])
def test_k1_bf16_key_partition_matches_pallas_kernel(bh, s):
    q, k, v = _rising_inputs(40 + s, bh, s)
    scale = 64 ** -0.5
    with pltpu.force_tpu_interpret_mode():
        ref_o, ref_l = j_fa._flash_bhsd(q, k, v, scale)
    top = float(np.abs(np.asarray(ref_o, np.float32)).max())
    qt, kt, vt = map(_torch, (q, k, v))
    for bk in card_key_tiles():
        out, lse, raised = k1_bf16_emulated(qt, kt, vt, scale, bk)
        assert raised >= s // bk // 2, raised  # the max rose in most later tiles
        assert out.dtype == torch.bfloat16 and lse.shape == (bh, s, 1)
        err_max, err_mean = _out_errors(out, ref_o)
        assert err_max <= 2.0 ** -7 * top and err_mean <= 2e-4, (bk, err_max, err_mean)
        assert (lse - torch.from_numpy(np.array(ref_l))).abs().max().item() <= 2e-3


# Readings against flash_with_blocks(128, BK), max / mean: the emulation
# 9.8e-4 / 1.0e-7-2.3e-7 at (2, 512) and (1, 1024), BK 64 and 128; without
# the rounding of p 3.9e-3-7.8e-3 / 8.9e-5-1.2e-4; over one tile of all keys
# 3.9e-3-7.8e-3 / 8.4e-5-1.1e-4; over tiles of 192 (for BK 64) or 64 (for
# BK 128) 3.9e-3 / 4.4e-5-7.6e-5.
@pytest.mark.parametrize("bh,s", [(2, 512), (1, 1024)])
def test_k1_bf16_key_partition_matches_pallas_at_its_tiles(bh, s):
    spec = importlib.util.spec_from_file_location("_profile_unet", SCRIPTS / "profile_unet.py")
    pu = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(pu)
    q, k, v = _rising_inputs(40 + s, bh, s)
    scale = 64 ** -0.5
    qt, kt, vt = map(_torch, (q, k, v))
    for bk in card_key_tiles():
        with pltpu.force_tpu_interpret_mode():
            ref = pu.flash_with_blocks(128, bk)(q, k, v, scale)
        err_max, err_mean = _out_errors(k1_bf16_emulated(qt, kt, vt, scale, bk)[0], ref)
        assert err_max <= 1e-3 and err_mean <= 2e-6, (bk, err_max, err_mean)
        for mutant in (k1_bf16_emulated(qt, kt, vt, scale, bk, round_p=False),
                       k1_bf16_emulated(qt, kt, vt, scale, s),
                       k1_bf16_emulated(qt, kt, vt, scale, 192 if bk == 64 else 64)):
            assert _out_errors(mutant[0], ref)[1] > 2e-5, bk


def test_k1_bf16_one_tile_is_the_plain_version():
    """With one key tile the running max is the row max, and the emulation
    is K1's plain version, _flash_bhsd_ref, to within f32 summation order."""
    q, k, v = map(_torch, _rising_inputs(41, 2, 256))
    scale = 64 ** -0.5
    out, lse, _ = k1_bf16_emulated(q, k, v, scale, 256)
    ref_o, ref_l = t_fa._flash_bhsd_ref(q, k, v, scale)
    assert (out.float() - ref_o.float()).abs().max().item() <= 2e-3  # one bf16 ulp
    assert (lse - ref_l).abs().max().item() <= 1e-5


def test_wrapper_refuses_unaligned_tensors():
    """The kernels read 16 bytes a thread and TMA takes 16-byte-aligned bases
    only; the check runs on the tensors the kernel would get, so a base 2
    bytes off raises, and an aligned one passes."""
    flat = torch.zeros(64 * 64 + 8, dtype=torch.bfloat16)
    t_fa._check_aligned("flash_attention", flat[:-8].view(1, 64, 64), flat[8:].view(1, 64, 64))
    with pytest.raises(ValueError, match="16-byte"):
        t_fa._check_aligned("flash_attention", flat[1:-7].view(1, 64, 64))


def _script(name: str):
    spec = importlib.util.spec_from_file_location(name, SCRIPTS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_tune_k1_replaces_the_bf16_dispatch():
    """scripts/tune_k1.py --tile W,K,N builds the d=64 body as one
    launch_wgmma<W, K, N> for every length: the body of dispatch_bf16_d64 is
    its only edit, and this file reads the new key tile from it."""
    import argparse
    mod = _script("tune_k1")
    args = argparse.Namespace(dtype="bf16", split=[], tile=["3,64,3"], baseline=[])
    out = mod.variants(args)
    shipped, edited = out["shipped"][0], out["tile_3_64_3"][0]
    changed = [(a, b) for a, b in zip(shipped.splitlines(), edited.splitlines()) if a != b]
    assert len(changed) == 1 and "launch_wgmma<3, 64, 3>(" in changed[0][1], changed
    assert edited.replace(changed[0][1], changed[0][0]) == shipped
    for bad in ("3,64", "a,b,c"):
        with pytest.raises(SystemExit):
            mod.variants(argparse.Namespace(dtype="bf16", split=[], tile=[bad], baseline=[]))
    with pytest.raises(SystemExit):  # the split forms are f32's
        mod.variants(argparse.Namespace(dtype="bf16", split=["cvt"], tile=[], baseline=[]))


def test_kernel_resources_reads_wgmma():
    """scripts/kernel_resources.py keeps ptxas's wgmma advisories, which ptxas
    prints before the function's "Compiling entry" line, and counts HGMMA by
    shape and types as it does HMMA."""
    mod = _script("kernel_resources")
    fn = "_Z6kernelv"
    info = mod.ptxas_info(
        "ptxas info    : (C7519) warpgroup.arrive is injected in around line 9 by compiler "
        f"to allow use of registers in GMMA in function '{fn}'\n"
        "ptxas info    : (C7514) Potential Performance Loss: wgmma.mma_async instructions "
        f"are serialized due to ... in the function '{fn}'\n"
        f"ptxas info    : Compiling entry function '{fn}' for 'sm_90a'\n"
        "ptxas info    : Used 128 registers, 0 bytes smem\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n")
    assert info[fn]["registers"] == 128 and info[fn]["spill_stores"] == 0
    assert [a.split()[3] for a in info[fn]["advisories"]] == ["(C7519)", "(C7514)"]
    sass = mod.sass_counts(
        f"        Function : {fn}\n"
        "        /*0860*/                   HGMMA.64x128x16.F32.BF16 R24, gdesc[UR16], RZ, !UPT, gsb0 ;\n"
        "        /*0870*/                   HGMMA.64x64x16.F32.BF16 R88, R120, gdesc[UR16].tnspB, R88 ;\n"
        "        /*0880*/                   WARPGROUP.DEPBAR.LE gsb0, 0x0 ;\n"
        "        /*0890*/              @P0  HMMA.16816.F32.BF16 R4, R8, R12, R4 ;\n")[fn]
    assert sass == {"HGMMA.64x128x16.F32.BF16": 1, "HGMMA.64x64x16.F32.BF16": 1, "WARPGROUP": 1,
                    "HMMA.16816.F32.BF16": 1, "total": 4}
