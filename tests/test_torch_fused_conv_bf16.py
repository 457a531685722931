"""The numerics of K8's bf16 body (wgmma), on the CPU.

On the card, K8 in bf16 (csrc/fused_gn_silu_conv3x3.cu,
gn_silu_conv_wgmma_kernel) stages each 32-channel chunk of a pixel tile's
halo once as bf16 activated values (silu(x a + b) in f32, rounded, zero
outside the image after the transform), runs the nine shifted-window
products of every chunk on wgmma in k steps of 16 channels into one f32
accumulator per output, and adds the bias and the residual in f32 before one
rounding to bf16. Its tiles are 8 x 16 pixels x 256 output channels, or 16 x
16 x 128 where Co is no multiple of 256. No CUDA kernel runs here, so this
file emulates the body over those tiles, chunks, taps and k steps, with the
tensor cores' truncating accumulate modelled as
tests/test_torch_fused_ff_bf16.py models it (each k step's exact sum added to
the accumulator and rounded toward zero), and holds it to:

- JAX's ``fused_gn_silu_conv3x3`` in Pallas interpret mode in bf16 and the
  port's plain version, within one bf16 ulp of max|out|, at h and w that the
  tiles do not divide and at C up to 512: both round at the same points, and
  only the order of the f32 sums differs;
- the card's bars for K8 in bf16 (tests/test_torch_cuda.py, chip_smoke.py):
  2e-2 and 2^-6 of max|plain| and a mean abs error of K8_BF16_MEAN_REL of
  max|plain|, over the whole output and over its border pixels. The
  emulation meets them; a halo zeroed before the transform and a dropped tap
  or chunk fail the max bars, a running sum that passes through bf16 after
  each chunk fails the mean bar;
- its one accumulator over K = 9 C: the truncation's drift stays far under a
  bf16 ulp at C = 512, so the body keeps no per-chunk sums;
- the design's reckoning at chip_smoke's shapes: how often the tiles stage
  the halo (silu_affine evaluations) and how many weight bytes they read;
- the wrapper's weight layout and scripts/tune_k8.py's bf16 variants.
"""

import argparse
import importlib.util
import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from genpercept_tpu_torch import _build
from genpercept_tpu_torch.ops import fused_conv as tfc
from test_torch_flash_f32 import rz_f32
from test_torch_fused_conv import conv_case, oihw, run_jax
from test_torch_models import nchw, nhwc

torch.set_num_threads(1)

MAX_BAR = 2e-2  # chip_smoke.K8_TOL[bf16]: of max|plain|
MAX_REL_BAR = 2.0 ** -6  # K8_BF16_REL: of max|plain|
MEAN_REL_BAR = 1e-5  # K8_BF16_MEAN_REL: mean abs error, of max|plain|
_SRC = (_build.CSRC / "fused_gn_silu_conv3x3.cu").read_text()


def _constant(pattern: str) -> tuple:
    (v,) = re.findall(pattern, _SRC)
    return tuple(map(int, v)) if isinstance(v, tuple) else (int(v),)


(_, TW) = _constant(r"constexpr int TH = (\d+), TW = (\d+);")  # tile columns
(KC,) = _constant(r"constexpr int kBKC = (\d+);")  # input channels a chunk
(BN_TIMES_MB,) = _constant(r"static constexpr int BN = (\d+) / MB;")
(TH_PER_MB,) = _constant(r"static constexpr int TH = (\d+) \* MB;")
(DISPATCH_CO,) = _constant(r"auto launch = co % (\d+) == 0 \? launch_wgmma<1> : launch_wgmma<2>;")
KSTEP = 16  # wgmma's k for bf16


def tile_of(co: int) -> tuple[int, int, int]:
    """(tile rows, tile columns, output channels) of the body's tile for Co."""
    mb = 1 if co % DISPATCH_CO == 0 else 2
    return TH_PER_MB * mb, TW, BN_TIMES_MB // mb


def activate(x, a, b):
    """The transform: y = x a + b, y sigmoid(y), in f32."""
    y = x * a[:, :, None, None] + b[:, :, None, None]
    return y * torch.sigmoid(y)


def k8_bf16_emulated(x, a, b, w, bias, res=None, zero_after=True, drop_tap=None,
                     drop_chunk=None, bf16_sums=False, rz=True):
    """K8's bf16 body over its tiles: NCHW x (bf16), a, b (N, C) from
    gn_affine, OIHW w (bf16), bias f32, residual bf16 or None -> bf16.
    zero_after=False zeroes the halo's raw x outside the image instead of the
    activated values (silu(b) there); drop_tap / drop_chunk leave one tap
    (0..8) / one chunk out; bf16_sums rounds the running sum to bf16 after
    each chunk; rz=False rounds each k step's sum to nearest."""
    n, c, h, wd = x.shape
    co = w.shape[0]
    th, tw, bn = tile_of(co)
    act = activate(x.float(), a, b).to(torch.bfloat16).double()
    wt = w.double().permute(2, 3, 1, 0)  # (3, 3, C, Co)
    out = torch.empty(n, co, h, wd)
    for img in range(n):
        if zero_after:
            pad = torch.zeros(c, h + th + 2, wd + tw + 2, dtype=torch.float64)
        else:  # raw zeros past the image, then the transform
            pad = activate(torch.zeros(1, c, 1, 1), a[img:img + 1], b[img:img + 1])[0]
            pad = pad.to(torch.bfloat16).double().expand(c, h + th + 2, wd + tw + 2).clone()
        pad[:, 1:h + 1, 1:wd + 1] = act[img]
        for h0 in range(0, h, th):
            for w0 in range(0, wd, tw):
                halo = pad[:, h0:h0 + th + 2, w0:w0 + tw + 2]
                for co0 in range(0, co, bn):
                    acc = torch.zeros(th * tw, bn)
                    for ch, k0 in enumerate(range(0, c, KC)):
                        if ch == drop_chunk:
                            continue
                        for tap in range(9):
                            if tap == drop_tap:
                                continue
                            dy, dx = divmod(tap, 3)
                            win = halo[k0:k0 + KC, dy:dy + th, dx:dx + tw].reshape(KC, -1).T
                            for ks in range(0, KC, KSTEP):
                                s = acc.double() + win[:, ks:ks + KSTEP] @ \
                                    wt[dy, dx, k0 + ks:k0 + ks + KSTEP, co0:co0 + bn]
                                acc = rz_f32(s) if rz else s.float()
                        if bf16_sums:
                            acc = acc.to(torch.bfloat16).float()
                    tile = acc.T.reshape(bn, th, tw)
                    hh, ww = min(th, h - h0), min(tw, wd - w0)
                    out[img, co0:co0 + bn, h0:h0 + hh, w0:w0 + ww] = tile[:, :hh, :ww]
    out = out + bias[None, :, None, None]
    if res is not None:
        out = out + res.float()
    return out.to(torch.bfloat16)


def _border(t):
    return torch.cat([t[..., 0, :], t[..., -1, :], t[..., :, 0], t[..., :, -1]], dim=-1)


def _ulp_of_max(y: torch.Tensor) -> float:
    """One bf16 ulp at the largest |y|."""
    return 2.0 ** (math.floor(math.log2(y.float().abs().max().item())) - 7)


def errors(got: torch.Tensor, ref: torch.Tensor) -> dict[str, float]:
    """max and mean abs error over max|ref|, whole output and border pixels."""
    d = (got.float() - ref.float()).abs()
    db = (_border(got.float()) - _border(ref.float())).abs()
    top = ref.float().abs().max().item()
    return {"max": d.max().item() / top, "mean": d.mean().item() / top,
            "max_border": db.max().item() / top, "mean_border": db.mean().item() / top}


def within_bars(e: dict[str, float]) -> bool:
    """The card's bars: 2e-2 and 2^-6 of max|plain| (max), the mean bar, over
    the whole output and the border."""
    return (max(e["max"], e["max_border"]) <= min(MAX_BAR, MAX_REL_BAR)
            and max(e["mean"], e["mean_border"]) <= MEAN_REL_BAR)


def test_body_constants_tile_the_k8_shapes():
    """The emulation's tiles are the body's: 8 x 16 pixels x 256 channels
    where Co is a multiple of 256, else 16 x 16 x 128; chunks of 32
    channels, which divide every K8 channel count."""
    assert (KC, TW, BN_TIMES_MB, TH_PER_MB, DISPATCH_CO) == (32, 16, 256, 8, 256)
    assert tile_of(128) == (16, 16, 128) and tile_of(256) == tile_of(512) == (8, 16, 256)
    assert tile_of(384) == (16, 16, 128)
    assert all(c % KC == 0 for c in (128, 256, 512))


# The design's reckoning at chip_smoke.K8_SHAPES (the 48 convs of a 768^2
# forward of 2 images, 2.98 G values of x): 4.70 G silu_affine evaluations
# (each tile stages its (TH + 2) x 18 halo once a block of output channels)
# against 7.54 G with the mma.sync body's 8 x 16 x 128 tiles, and 81.5 GB of weights read
# from L2 (every tile reads 9 C x BN of them) against 96.5 GB.
def test_design_reckoning_per_forward():
    """The body's tiles stage the halo at most 5.0 G times a forward (the
    aim), and their weight reads from L2 are the 81.5 GB PERF.md states."""
    import chip_smoke

    def reckon(tile):
        silu = weight_bytes = x_values = 0
        for (hw, c, co, _), n in chip_smoke.K8_SHAPES:
            th, tw, bn = tile(co)
            tiles = 2 * math.ceil(hw / th) * math.ceil(hw / tw) * (co // bn)
            silu += n * tiles * (th + 2) * (tw + 2) * c
            weight_bytes += n * tiles * 9 * c * bn * 2
            x_values += n * 2 * c * hw * hw
        return silu / 1e9, weight_bytes / 1e9, x_values / 1e9

    silu, weight_gb, x_g = reckon(tile_of)
    old_silu, old_weight_gb, _ = reckon(lambda co: (8, 16, 128))
    assert silu <= 5.0 and (round(silu, 2), round(old_silu, 2)) == (4.70, 7.54)
    assert (round(weight_gb, 1), round(old_weight_gb, 1), round(x_g, 2)) == (81.5, 96.5, 2.98)


def _port_inputs(x, gs, gb, cw, cb, res):
    """conv_case's numpy inputs as the port's bf16 tensors, a, b folded."""
    bf = torch.bfloat16
    xt = nchw(x).to(bf)
    a, b = tfc.gn_affine(xt, torch.from_numpy(gs), torch.from_numpy(gb))
    return (xt, a, b, oihw(cw).to(bf), torch.from_numpy(cb),
            None if res is None else nchw(res).to(bf))


# Readings (max abs error over one bf16 ulp of max|out|; share of outputs
# that differ), against JAX / the plain version, in the order of the cases:
# 0.5 (0.09%) / 0.5 (0.09%); 0.5 (0.22%) / 0.5 (0.07%); 0.5 (0.78%) / 0.5
# (0.33%): one bf16 step of an output below the largest, at most.
@pytest.mark.parametrize("c,co,with_res,h,w", [
    (128, 128, False, 24, 24),  # 16 x 16 tiles: a ragged second tile row and column
    (128, 256, True, 16, 24),   # 8 x 16 tiles of 256 channels, a ragged column
    (512, 512, True, 16, 40),   # K = 4608, two channel blocks, a ragged column
])
def test_bf16_body_matches_pallas_kernel(c, co, with_res, h, w):
    """K8's bf16 body, emulated (its tiles, chunks, taps and k steps, the
    bf16 activated halo, truncating f32 accumulation), against JAX's
    fused_gn_silu_conv3x3 in Pallas interpret mode in bf16 and against the
    plain version: within one bf16 ulp of max|out|."""
    case = conv_case(c, co, with_res, n=1, h=h, w=w)
    ref = torch.from_numpy(np.array(run_jax(*case, torch.bfloat16)))
    args = _port_inputs(*case)
    got = torch.from_numpy(nhwc(k8_bf16_emulated(*args).float()))
    plain = torch.from_numpy(nhwc(tfc._fused_gn_silu_conv3x3_ref(*args).float()))
    tol = _ulp_of_max(ref)
    assert (got - ref).abs().max().item() <= tol
    assert (got - plain).abs().max().item() <= tol


def _card_inputs(seed: int, n: int, c: int, h: int, w: int, co: int, res: bool):
    """chip_smoke.phase_k8's draws in numpy, in bf16: x ~ 2 N(0, 1) + 0.5, GN
    scale 1 + 0.1 N, shift 0.1 N, weights uniform in +-1/sqrt(9 C), bias
    0.1 N, residual N(0, 1); a, b folded by gn_affine from the bf16 x."""
    rng = np.random.default_rng(seed)
    bf = torch.bfloat16
    x = torch.from_numpy((rng.standard_normal((n, c, h, w)) * 2 + 0.5).astype(np.float32)).to(bf)
    gs = torch.from_numpy((1 + 0.1 * rng.standard_normal(c)).astype(np.float32))
    gb = torch.from_numpy((0.1 * rng.standard_normal(c)).astype(np.float32))
    cw = torch.from_numpy((rng.uniform(-1, 1, (co, c, 3, 3)) / np.sqrt(9 * c))
                          .astype(np.float32)).to(bf)
    cb = torch.from_numpy((0.1 * rng.standard_normal(co)).astype(np.float32))
    r = torch.from_numpy(rng.standard_normal((n, co, h, w)).astype(np.float32)).to(bf) \
        if res else None
    a, b = tfc.gn_affine(x, gs, gb)
    return x, a, b, cw, cb, r


# Readings (max / mean abs error over max|plain|) at (1, 512, 16, 32) -> 256
# with a residual, seed 50: the emulation 1.6e-3 / 3.3e-7 (border 2.0e-4 /
# 3.3e-8); the halo zeroed before the transform 4.0e-2 at the border; tap 4
# dropped 1.3e-1; chunk 7 dropped 8.6e-2; the running sum in bf16 after each
# chunk 6.3e-3 (within both max bars), mean 2.3e-4, 23x past the mean bar.
# The card read the wgmma body at <= 5.2e-3 max, <= 6.6e-7 mean at
# chip_smoke's 12 K8 shapes, border pixels too (PERF.md).
def test_card_bars_see_the_faults():
    """At the card's input draws, emulated K8 bf16 meets the card's bars over
    the whole output and the border; a halo zeroed before the transform fails
    the max bars at the border, a dropped tap or chunk the max bars, and a
    running sum through bf16 after each chunk the mean bar by more than 10x
    while its max stays under the max bars."""
    args = _card_inputs(50, 1, 512, 16, 32, 256, True)
    ref = tfc._fused_gn_silu_conv3x3_ref(*args)
    good = errors(k8_bf16_emulated(*args), ref)
    assert within_bars(good), good
    before = errors(k8_bf16_emulated(*args, zero_after=False), ref)
    assert before["max_border"] > MAX_REL_BAR, before
    for fault in ({"drop_tap": 4}, {"drop_chunk": 7}):
        e = errors(k8_bf16_emulated(*args, **fault), ref)
        assert e["max"] > MAX_REL_BAR, (fault, e)
    sums = errors(k8_bf16_emulated(*args, bf16_sums=True), ref)
    assert sums["max"] <= MAX_REL_BAR and sums["mean"] > 10 * MEAN_REL_BAR, sums


# Readings (max abs difference over one bf16 ulp of max|out|; share of outputs
# that differ), truncating against nearest rounding of each k step's sum at
# C = 512: 1 ulp, 0.28% of outputs; mean abs error over max|plain| 1.6e-6
# truncating, 2.2e-7 to nearest, both under the mean bar.
def test_one_accumulator_drifts_under_a_bf16_ulp():
    """The tensor cores truncate every k step's sum into the accumulator. Over
    one accumulator for all K = 9 x 512 products that drift moves an output
    by at most one bf16 ulp of max|out| against round-to-nearest sums, and
    the emulated body stays within the card's bars either way: the body needs
    no per-chunk sums (which would take another 128 registers a thread)."""
    args = _card_inputs(51, 1, 512, 8, 16, 256, False)
    ref = tfc._fused_gn_silu_conv3x3_ref(*args)
    trunc, near = k8_bf16_emulated(*args), k8_bf16_emulated(*args, rz=False)
    assert (trunc.float() - near.float()).abs().max().item() <= _ulp_of_max(ref)
    assert within_bars(errors(trunc, ref)) and within_bars(errors(near, ref))


def test_bf16_body_pads_a_constant_input_by_position():
    """A constant activated input s = bf16(silu(2)) at C = 128 -> Co = 128
    (16 x 16 tiles) over a 24 x 24 image: the interior sums nine taps, an
    edge six, a corner four, at the image's edges inside ragged tiles."""
    c = co = 128
    x = torch.ones(1, c, 24, 24, dtype=torch.bfloat16)
    a, b = torch.zeros(1, c), torch.full((1, c), 2.0)
    w = torch.full((co, c, 3, 3), 2.0 ** -10, dtype=torch.bfloat16)
    got = k8_bf16_emulated(x, a, b, w, torch.zeros(co))[0, 0].float()
    s = float(torch.tensor(2.0 / (1.0 + math.exp(-2.0))).to(torch.bfloat16)) * c * 2.0 ** -10
    for (i, j), taps in {(5, 5): 9, (0, 5): 6, (23, 5): 6, (5, 0): 6, (5, 23): 6,
                         (0, 0): 4, (23, 23): 4, (0, 23): 4, (23, 0): 4}.items():
        expect = float(torch.tensor(taps * s).to(torch.bfloat16))
        assert got[i, j].item() == expect, ((i, j), got[i, j].item(), expect)


def test_wrapper_lays_the_weights_out_tap_major():
    """fused_conv_apply's bf16 weights: (9, Co, C), tap dy * 3 + dx's (Co, C)
    slice, input channels contiguous (the body's weight map)."""
    rng = np.random.default_rng(8)
    w = torch.from_numpy(rng.standard_normal((256, 64, 3, 3)).astype(np.float32)) \
        .to(torch.bfloat16)
    got = tfc._tap_major_weights(w)
    assert got.shape == (9, 256, 64) and got.dtype == torch.bfloat16 and got.is_contiguous()
    for tap in range(9):
        assert torch.equal(got[tap], w[:, :, tap // 3, tap % 3])


def _tune_k8():
    path = Path(__file__).resolve().parent.parent / "scripts" / "tune_k8.py"
    spec = importlib.util.spec_from_file_location("tune_k8", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _args(tile=(), variant=(), baseline=()):
    return argparse.Namespace(dtype="bf16", tile=list(tile), variant=list(variant),
                              baseline=list(baseline))


def test_tune_k8_bf16_variants_edit_what_they_name(tmp_path):
    """scripts/tune_k8.py --dtype bf16 builds each variant from the shipped
    source with only the named edit to the bf16 body: the weight ring's
    slots, the staging without silu_affine, the approximate sigmoid; a
    baseline is another file with its own common.cuh."""
    mod = _tune_k8()
    old = tmp_path / "fused_gn_silu_conv3x3.cu"
    old.write_text("// an older body\n")
    (tmp_path / "common.cuh").write_text("// its header\n")
    out = mod.variants(_args(tile=["4"], variant=["nosilu", "fastsilu", "divrn", "regs72",
                                                  "unroll4"], baseline=[f"old={old}"]))
    src, hdr = out["shipped"]
    assert src.count(mod.SHIPPED_NB) == 1
    assert out["tile_4"] == (src.replace(mod.SHIPPED_NB, "constexpr int kBNB = 4;"), hdr)
    assert src.count("silu_affine_nb(x") == 2 and "silu_affine(x" not in src
    assert "silu_affine_nb(x" not in out["nosilu"][0] and "silu_affine(v0" in out["nosilu"][0]
    fast = out["fastsilu"][0]
    assert "silu_affine_nb(x" not in fast and fast.count("__expf(") == 2
    assert out["divrn"][0].count("silu_affine(x") == 2
    assert "silu_affine_nb(x" not in out["divrn"][0]
    assert "PRODUCER_REGS = 72;" in out["regs72"][0] and "PRODUCER_REGS = 96;" in out["regs72"][0]
    assert out["unroll4"][0].count("#pragma unroll 4\n        for (int m = 0;") == 1
    # the f32 body is untouched by the bf16 edits
    mark = "// " + "-" * 65 + " f32 body"
    f32 = src[src.index(mark):]
    assert all(text[text.index(mark):] == f32 for name, (text, _) in out.items()
               if name != "old")
    assert out["old"] == ("// an older body\n", "// its header\n")


@pytest.mark.parametrize("bad", [{"tile": ["7"]}, {"tile": ["2,2"]}, {"variant": ["onepass"]}])
def test_tune_k8_bf16_refuses_what_it_cannot_build(bad):
    with pytest.raises(SystemExit):
        _tune_k8().variants(_args(**bad))
