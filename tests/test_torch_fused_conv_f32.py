"""The numerics of K8's f32 body: split TF32 (3xTF32) products on wgmma, on
the CPU.

On the card, K8 in f32 (csrc/fused_gn_silu_conv3x3.cu,
gn_silu_conv_tf32_kernel) takes its nine shifted-window products on the
tensor cores through split TF32, the arithmetic of K1's, K2's and K3/K4's f32
bodies, which tests/test_torch_flash_f32.py emulates (``split``, ``mm3``,
``mm1``) and whose truncating accumulator it models (``output_products``).
No CUDA kernel runs here, so this file emulates the body over its own tiles:
8 x 16-pixel tiles whose activated halo is zero outside the image by
position (after the transform), C in chunks of 32 channels, each chunk's
nine taps summed from zero and added to the tile's sums by f32 adds, then
+ bias and + residual. It holds the emulation to:

- JAX's ``fused_gn_silu_conv3x3`` in Pallas interpret mode, within
  tests/test_torch_fused_conv.py's f32 2e-5, and the port's plain version at
  ragged shapes (h % 8 and w % 16 not 0), where a halo zeroed before the
  transform (silu(b) at the border) fails the card's bar;
- the card's bar for K8 in f32 (2e-5 of max|plain|, tests/test_torch_cuda.py,
  chip_smoke.K8_TOL): three passes stay under it, a single TF32 pass does
  not, so the bar separates the two;
- the tensor cores' accumulator over K = 9 C: with one accumulator over all
  chunks the error grows from C = 128 to C = 512 past the bar; with the
  body's per-chunk sums it stays flat;
- the wrapper's split of the weights, and scripts/tune_k8.py's variants.
"""

import argparse
import importlib.util
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from genpercept_tpu_torch import _build
from genpercept_tpu_torch.ops import fused_conv as tfc
from test_torch_flash_f32 import mm1, mm3, output_products, split
from test_torch_fused_conv import conv_case, oihw, run_jax
from test_torch_models import nchw, nhwc

torch.set_num_threads(1)

ATOL = 2e-5  # tests/test_torch_fused_conv.py's f32 tolerance against JAX
CARD_BAR = 2e-5  # tests/test_torch_cuda.py K8_F32_REL: of max|plain|
_SRC = (_build.CSRC / "fused_gn_silu_conv3x3.cu").read_text()


def _constant(pattern: str) -> tuple:
    (v,) = re.findall(pattern, _SRC)
    return tuple(map(int, v)) if isinstance(v, tuple) else (int(v),)


TH, TW = _constant(r"constexpr int TH = (\d+), TW = (\d+);")  # the body's output tile
(KC,) = _constant(r"constexpr int kFKC = (\d+);")  # input channels a chunk


def activate(x, a, b):
    """The plain version's transform: y = x a + b, y sigmoid(y), in f32."""
    y = x * a[:, :, None, None] + b[:, :, None, None]
    return y * torch.sigmoid(y)


def k8_emulated(x, a, b, w, bias, res=None, mm=mm3, zero_after=True):
    """K8's f32 body with products ``mm`` over its tiles: NCHW x, a, b (N,
    C) from gn_affine, OIHW w. zero_after=False zeroes the halo's raw x
    outside the image instead of the activated values (silu(b) there)."""
    n, c, h, wd = x.shape
    co = w.shape[0]
    act = activate(x, a, b)
    wt = w.permute(2, 3, 1, 0)  # (3, 3, C, Co)
    out = torch.empty(n, co, h, wd)
    for img in range(n):
        for h0 in range(0, h, TH):
            for w0 in range(0, wd, TW):
                r0, r1 = max(h0 - 1, 0), min(h0 + TH + 1, h)
                c0, c1 = max(w0 - 1, 0), min(w0 + TW + 1, wd)
                if zero_after:
                    halo = torch.zeros(c, TH + 2, TW + 2)
                else:  # raw zeros past the image, then the transform
                    halo = activate(torch.zeros(1, c, TH + 2, TW + 2), a[img:img + 1],
                                    b[img:img + 1])[0]
                inside = act[img, :, r0:r1, c0:c1]
                halo[:, r0 - h0 + 1:r1 - h0 + 1, c0 - w0 + 1:c1 - w0 + 1] = inside
                acc = torch.zeros(TH * TW, co)
                for k0 in range(0, c, KC):
                    part = torch.zeros(TH * TW, co)
                    for dy in range(3):
                        for dx in range(3):
                            win = halo[k0:k0 + KC, dy:dy + TH, dx:dx + TW].reshape(KC, -1).T
                            part = part + mm(win.contiguous(), wt[dy, dx, k0:k0 + KC])
                    acc = acc + part
                tile = acc.T.reshape(co, TH, TW)
                hh, ww = min(TH, h - h0), min(TW, wd - w0)
                out[img, :, h0:h0 + hh, w0:w0 + ww] = tile[:, :hh, :ww]
    out = out + bias[None, :, None, None]
    return out if res is None else out + res


def _port_inputs(x, gs, gb, cw, cb, res):
    """conv_case's numpy inputs as the port's tensors, with a, b folded."""
    xt = nchw(x)
    a, b = tfc.gn_affine(xt, torch.from_numpy(gs), torch.from_numpy(gb))
    return (xt, a, b, oihw(cw), torch.from_numpy(cb), None if res is None else nchw(res))


def test_body_constants_tile_the_k8_shapes():
    """The emulation's tiles are the body's: 8 x 16 pixels, chunks of 32
    channels, which divide every K8 channel count (128, 256, 512)."""
    assert (TH, TW, KC) == (8, 16, 32)
    assert all(c % KC == 0 for c in (128, 256, 512))


@pytest.mark.parametrize("co,with_res", [(128, False), (128, True), (256, False), (256, True)])
def test_f32_body_matches_pallas_kernel(co, with_res):
    """K8's f32 body, emulated (3xTF32 products over its tiles, chunks and
    taps), against JAX's fused_gn_silu_conv3x3 in Pallas interpret mode on
    tests/test_torch_fused_conv.py's inputs (w = 24: a ragged second tile)."""
    case = conv_case(128, co, with_res)
    ref = run_jax(*case, torch.float32)
    got = k8_emulated(*_port_inputs(*case))
    np.testing.assert_allclose(nhwc(got), ref, atol=ATOL, rtol=0)


def _card_inputs(seed: int, n: int, c: int, h: int, w: int, co: int, res: bool):
    """chip_smoke.phase_k8's draws in numpy: x ~ 2 N(0, 1) + 0.5, GN scale
    1 + 0.1 N, shift 0.1 N, weights uniform in +-1/sqrt(9 C), bias 0.1 N,
    residual N(0, 1); a, b folded by gn_affine."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy((rng.standard_normal((n, c, h, w)) * 2 + 0.5).astype(np.float32))
    gs = torch.from_numpy((1 + 0.1 * rng.standard_normal(c)).astype(np.float32))
    gb = torch.from_numpy((0.1 * rng.standard_normal(c)).astype(np.float32))
    cw = torch.from_numpy((rng.uniform(-1, 1, (co, c, 3, 3)) / np.sqrt(9 * c)).astype(np.float32))
    cb = torch.from_numpy((0.1 * rng.standard_normal(co)).astype(np.float32))
    r = torch.from_numpy(rng.standard_normal((n, co, h, w)).astype(np.float32)) if res else None
    a, b = tfc.gn_affine(x, gs, gb)
    return x, a, b, cw, cb, r


def _border(t):
    return torch.cat([t[..., 0, :], t[..., -1, :], t[..., :, 0], t[..., :, -1]], dim=-1)


# Readings (max abs error / max|plain|, whole output and border alike):
# (1,128,20,40,256) with a residual 9.5e-8, (2,128,20,24,128) 3.4e-7; with
# the halo zeroed before the transform 3.1e-2 and 9.6e-2 at the border.
@pytest.mark.parametrize("n,c,h,w,co,res", [(1, 128, 20, 40, 256, True),
                                            (2, 128, 20, 24, 128, False)])
def test_f32_body_zeroes_the_halo_after_the_transform_at_ragged_edges(n, c, h, w, co, res):
    """At the card tests' ragged shapes (h % 8 and w % 16 not 0) the
    emulated body is the plain version within the card's bar, border pixels
    included; a halo zeroed before the transform (silu(b) at the border, what
    a TMA box past the image reads) fails the bar at the border."""
    x, a, b, cw, cb, r = _card_inputs(5, n, c, h, w, co, res)
    ref = tfc._fused_gn_silu_conv3x3_ref(x, a, b, cw, cb, r)
    top = ref.abs().max().item()
    got = k8_emulated(x, a, b, cw, cb, r)
    assert (got - ref).abs().max().item() <= CARD_BAR * top
    assert (_border(got) - _border(ref)).abs().max().item() <= CARD_BAR * top
    before = k8_emulated(x, a, b, cw, cb, r, zero_after=False)
    assert (_border(before) - _border(ref)).abs().max().item() > 100 * CARD_BAR * top


def test_f32_body_pads_a_constant_input_by_position():
    """A constant activated input s = silu(2): the interior sums nine taps,
    an edge six, a corner four, at every edge of a ragged image (20 x 24:
    the last tile row holds 4 rows, the last tile column 8)."""
    c = co = 128
    x = torch.ones(1, c, 20, 24)
    a, b = torch.zeros(1, c), torch.full((1, c), 2.0)
    w = torch.full((co, c, 3, 3), 1e-3)
    got = k8_emulated(x, a, b, w, torch.zeros(co))[0, 0]
    s = 2.0 / (1.0 + np.exp(-2.0)) * c * 1e-3
    for (i, j), taps in {(5, 5): 9, (0, 5): 6, (19, 5): 6, (5, 0): 6, (5, 23): 6,
                         (0, 0): 4, (19, 23): 4, (0, 23): 4, (19, 0): 4}.items():
        np.testing.assert_allclose(got[i, j].item(), taps * s, rtol=1e-5)


# Readings (max abs error / max|plain|, the exact-f32 plain version), at
# C = 128 / 512: 3xTF32 5.3e-7 / 2.9e-7, one TF32 pass 2.7e-4 / 2.6e-4.
# Three passes stay ~40x under the card's bar, one pass lies ~13x past it.
@pytest.mark.parametrize("c", [128, 512])
def test_card_bar_separates_split_from_single_tf32(c):
    """Emulated K8 at chip_smoke's input draws against the plain version
    (exact f32 on the CPU), held to the card's bar: 3xTF32 within a tenth
    of it, a single TF32 pass past it."""
    x, a, b, cw, cb, _ = _card_inputs(40, 1, c, 8, 16, 128, False)
    ref = tfc._fused_gn_silu_conv3x3_ref(x, a, b, cw, cb)

    def rel_err(mm):
        return ((k8_emulated(x, a, b, cw, cb, mm=mm) - ref).abs().max()
                / ref.abs().max()).item()

    three, one = rel_err(mm3), rel_err(mm1)
    assert three <= CARD_BAR / 10, three
    assert one > CARD_BAR, one


def _im2col_tile(act, w):
    """One 8 x 16 tile's activated halo act (C, 10, 18) and OIHW w as the
    body's A (128 pixels x 9 C) and B (9 C x Co), K ordered as the body walks
    it: chunk of KC channels, then tap, then channel."""
    c = act.shape[0]
    cols, rows = [], []
    for k0 in range(0, c, KC):
        for dy in range(3):
            for dx in range(3):
                cols.append(act[k0:k0 + KC, dy:dy + TH, dx:dx + TW].reshape(KC, -1).T)
                rows.append(w[:, k0:k0 + KC, dy, dx].T)
    return torch.cat(cols, dim=1), torch.cat(rows, dim=0)


# Readings (max abs error / max|exact|, per-chunk sums / one accumulator):
# C = 128: 2.6e-6 / 1.2e-5; C = 512: 2.8e-6 / 4.8e-5. The card read 1.0e-6 -
# 5.4e-6 against the plain version with per-chunk sums at every K8 shape,
# and 9.3e-6 at C = 128 up to 3.7e-5 at C = 512 with one accumulator
# (scripts/tune_k8.py --variant oneacc; PERF.md).
def test_per_chunk_sums_keep_the_error_flat_in_c():
    """The tensor cores round every sum into an accumulator toward zero. One
    accumulator over the whole K = 9 C grows its error with C (x4 from
    C = 128 to C = 512, past the card's bar); the body's per-chunk sums, each
    from zero over 9 x 32 terms and added by f32 adds, stay flat, at a
    seventh of the bar. One tile of 8 x 16 pixels, 128 output channels,
    exact from float64."""
    def rel_errs(c):
        rng = np.random.default_rng(44)
        y = torch.from_numpy(rng.standard_normal((c, TH + 2, TW + 2)).astype(np.float32))
        act = y * torch.sigmoid(y)
        w = torch.from_numpy((rng.uniform(-1, 1, (128, c, 3, 3)) / np.sqrt(9 * c))
                             .astype(np.float32))
        e, bm = _im2col_tile(act, w)
        exact = e.double() @ bm.double()
        top = exact.abs().max().item()
        return [(output_products(e, bm, 9 * KC, per_chunk).double() - exact).abs().max().item()
                / top for per_chunk in (True, False)]

    (chunk128, once128), (chunk512, once512) = rel_errs(128), rel_errs(512)
    assert once512 > 2 * once128 and once512 > CARD_BAR, (once128, once512)
    assert chunk512 <= 1.5 * chunk128 and chunk512 <= CARD_BAR / 4, (chunk128, chunk512)


def test_wrapper_splits_the_weights_as_the_body_splits_its_input():
    """fused_conv_apply's f32 weights: (2, 9, Co, C), hi and lo of each tap's
    (Co, C) slice as split_tf32 takes them (test_torch_flash_f32.split: hi to
    nearest with ties away, lo = w - hi truncated), hi + lo within 2^-21 of w."""
    rng = np.random.default_rng(6)
    w = torch.from_numpy(rng.standard_normal((128, 64, 3, 3)).astype(np.float32))
    got = tfc._split_tf32_weights(w)
    assert got.shape == (2, 9, 128, 64) and got.dtype == torch.float32 and got.is_contiguous()
    hi, lo = split(w.permute(2, 3, 0, 1).reshape(9, 128, 64).contiguous())
    assert torch.equal(got[0], hi) and torch.equal(got[1], lo)
    taps = w.permute(2, 3, 0, 1).reshape(9, 128, 64)
    assert ((got[0] + got[1] - taps).abs() <= 2.0 ** -21 * taps.abs()).all()


def _tune_k8():
    path = Path(__file__).resolve().parent.parent / "scripts" / "tune_k8.py"
    spec = importlib.util.spec_from_file_location("tune_k8", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _args(tile=(), variant=(), baseline=()):
    return argparse.Namespace(tile=list(tile), variant=list(variant), baseline=list(baseline))


def test_tune_k8_variants_edit_what_they_name(tmp_path):
    """scripts/tune_k8.py builds each variant from the shipped source with
    only the named edit: the instantiation, one pass, one accumulator, the
    timing probes; a baseline is another file with its own common.cuh."""
    mod = _tune_k8()
    old = tmp_path / "fused_gn_silu_conv3x3.cu"
    old.write_text("// an older body\n")
    (tmp_path / "common.cuh").write_text("// its header\n")
    out = mod.variants(_args(tile=["2,4"], variant=["onepass", "oneacc", "onepass+oneacc"],
                             baseline=[f"old={old}"]))
    src, hdr = out["shipped"]
    (shipped,) = set(mod.SHIPPED_TILE.findall(src))
    assert out["tile_2_4"] == (src.replace(shipped, "#define GP_K8_F32 2, 4"), hdr)
    passes = src.count("wgmma_rs_tf32(part, ")
    assert passes == 3 and out["onepass"][0].count("wgmma_rs_tf32(part, ") == 1
    assert "dl + step" not in out["onepass"][0]
    acc = out["oneacc"][0]
    assert "__fadd_rn(acc[n][j], part[n][j])" not in acc and "acc[n][j] = part[n][j];" in acc
    assert "gi > 0 || k > 0" not in acc and acc.count("wgmma_rs_tf32(part, ") == 3
    assert out["onepass+oneacc"][0].count("wgmma_rs_tf32(part, ") == 1
    assert all(h == hdr for name, (_, h) in out.items() if name != "old")
    assert out["old"] == ("// an older body\n", "// its header\n")
    probes = mod.variants(_args(variant=["nosilu", "hionly", "rcp", "regs80"]))
    assert "silu_affine(v0" not in probes["nosilu"][0]
    assert "dst + kFBHalf" not in probes["hionly"][0]
    assert "__frcp_rn" in probes["rcp"][0] and "silu_affine(v0" not in probes["rcp"][0]
    assert "PRODUCER_REGS = 80;" in probes["regs80"][0]
    for name, (text, _) in probes.items():
        if name != "shipped":
            assert text != src


@pytest.mark.parametrize("bad", [{"tile": ["3"]}, {"tile": ["3,3"]}, {"variant": ["fast"]}])
def test_tune_k8_refuses_what_it_cannot_build(bad):
    with pytest.raises(SystemExit):
        _tune_k8().variants(_args(**bad))
