"""The attention profiling scripts' Pallas kernels S1-S4 against the port's
plain versions, on the CPU (Pallas in interpret mode), bf16, at small sizes.

S1 is ``flash_with_blocks`` of scripts/profile_unet.py, loaded with
importlib. S2, S3 and S4 are defined inside those scripts' ``main()``, under
the ``if`` that tests ``args.part``; they are taken from the unedited
scripts by parsing them with ``ast``, picking the nested function
definitions by name, and executing them in a namespace that holds what they
refer to (jax, jnp, pl, pltpu, functools as ``functools`` and ``ft``, and for
S3 the package's ``_flash_kernel`` and the part's ``d = 512``).

Every output here is bf16, so one rounding flip of an output moves it by a
whole bf16 ulp (2e-3 at |out| in [0.25, 0.5)); the bounds are on the max and
the mean absolute error over the output, and each test also builds a
mutated plain version (the rounding point that makes the function what it
is, dropped) and shows that it fails the same bounds.
"""

from __future__ import annotations

import ast
import functools
import importlib.util
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from genpercept_tpu.ops.flash_attention import _flash_kernel
from genpercept_tpu_torch.ops import flash_attention as tfa

REPO = Path(__file__).resolve().parent.parent
SCRIPTS = REPO / "scripts"
BF = jnp.bfloat16
_LOG2E = 1.4426950408889634

torch.set_num_threads(1)


def _load_script(name: str):
    spec = importlib.util.spec_from_file_location(f"_{name}", SCRIPTS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _part_defs(script: str, part: str, names: set, **extra) -> dict:
    """The function definitions named ``names`` in ``main()`` of a script,
    directly inside the ``if`` whose test names ``part``, executed in a
    namespace of what they refer to."""
    path = SCRIPTS / f"{script}.py"
    tree = ast.parse(path.read_text())
    main = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")
    for node in ast.walk(main):
        if isinstance(node, ast.If) and any(
                isinstance(c, ast.Constant) and c.value == part for c in ast.walk(node.test)):
            defs = [n for n in node.body if isinstance(n, ast.FunctionDef) and n.name in names]
            assert {d.name for d in defs} == names, (part, [d.name for d in defs])
            ns = {"jax": jax, "jnp": jnp, "pl": pl, "pltpu": pltpu, "functools": functools,
                  "ft": functools, **extra}
            exec(compile(ast.Module(body=defs, type_ignores=[]), str(path), "exec"), ns)
            return ns
    raise KeyError(f"{script}: no part {part!r}")


def _torch(x) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)


def _errors(out: torch.Tensor, ref) -> tuple[float, float]:
    d = np.abs(out.float().numpy() - np.asarray(ref, np.float32))
    return float(d.max()), float(d.mean())


def _within(errs, bounds) -> bool:
    return errs[0] <= bounds[0] and errs[1] <= bounds[1]


def _unrounded_p(qh, kh, vh, scale):
    """K1's function with p left in f32 (the mutation for S1 and S3)."""
    s = torch.matmul(qh.float(), kh.float().transpose(1, 2)) * (scale * _LOG2E)
    p = torch.exp2(s - s.amax(dim=-1, keepdim=True))
    return (torch.matmul(p, vh.float()) / p.sum(dim=-1, keepdim=True)).to(qh.dtype)


# S1 and S3: p rounded to bf16 against the block's running max on the TPU
# and the global max in the plain version, then bf16 outputs. Readings of
# these random inputs, max / mean abs: the plain version 1.95e-3 / <= 7.7e-5
# (S1) and 1.95e-3 / 5.3e-5 (S3); a version without the rounding of p reads
# about 1.1e-4 (S1) and 7.2e-5 (S3) mean, too close to tell apart, because
# the output's own bf16 rounding is as coarse as p's. The rounding of p is
# shown on inputs where it decides every output (test_s1_rounds_p).
K1_BOUNDS = (2e-3, 1e-4)


def _rounding_inputs(d: int, n: int = 256):
    """(q, k, v), bf16, on which the rounding of p decides every output:
    each query is 8 * e0; key 0 has the row's max logit and keys 1.. one
    shared lower logit (p in 0.01-0.1) where rounding p to bf16 flips the
    bf16 output; v is e0 on key 0 and 0 elsewhere, so every output
    element of column 0 is 1 / (1 + (n - 1) p) and the rest are 0."""
    c = d ** -0.5 * _LOG2E
    b0 = torch.arange(-12.0, 0.0, 2.0 ** -5).to(torch.bfloat16).unique()
    p = torch.exp2((8.0 * b0.float() - 16.0) * c)
    outs = [1.0 / (1.0 + (n - 1) * x) for x in (p, p.to(torch.bfloat16).float())]

    def margin(x):  # distance to the nearest bf16 rounding midpoint, in ulps
        ulp = 2.0 ** (torch.floor(torch.log2(x)) - 7)
        return 0.5 - (x.to(torch.bfloat16).float() - x).abs() / ulp

    # a shared logit where rounding p flips the bf16 output, both outputs
    # as far from a rounding midpoint as the scan finds
    score = torch.minimum(margin(outs[0]), margin(outs[1]))
    flips = outs[0].to(torch.bfloat16) != outs[1].to(torch.bfloat16)
    score[~flips | (p < 0.01) | (p > 0.1)] = -1.0
    pick = b0[int(score.argmax())]
    q = torch.zeros(1, 64, d)
    q[..., 0] = 8.0
    k = torch.zeros(1, n, d)
    k[0, 0, 0], k[0, 1:, 0] = 2.0, pick
    v = torch.zeros(1, n, d)
    v[0, 0, 0] = 1.0
    return tuple(jnp.asarray(t.numpy(), BF) for t in (q, k, v))


@pytest.mark.parametrize("d", [64, 512])
def test_s1_rounds_p(d):
    """On _rounding_inputs the plain version equals S1 exactly, and the
    version without the rounding of p differs in every output of column 0.
    S1 folds the row sum at d=64 and sums it apart at d=512, so this covers
    both branches of _flash_kernel, the body S3 runs too (S3's script feeds
    the kernel (x * p, x, x) only, which cannot make these inputs)."""
    q, k, v = _rounding_inputs(d)
    qt, kt, vt = map(_torch, (q, k, v))
    scale = d ** -0.5
    ours = tfa.flash_with_blocks(qt, kt, vt, scale, *tfa.K1_TILES[d])
    mutant = _unrounded_p(qt, kt, vt, scale)
    with pltpu.force_tpu_interpret_mode():
        ref = _load_script("profile_unet").flash_with_blocks(32, 64)(q, k, v, scale)
    assert _errors(ours, ref) == (0.0, 0.0)
    diff = mutant.float().numpy() != np.asarray(ref, np.float32)
    assert diff[..., 0].all() and not diff[..., 1:].any()


@pytest.mark.parametrize("bh,s,d,blocks", [
    (2, 256, 64, ((128, 64), (64, 128))),
    (1, 256, 512, ((128, 64), (256, 128))),
])
def test_s1_plain_matches_pallas(bh, s, d, blocks):
    """S1, flash_with_blocks of scripts/profile_unet.py, at two block pairs
    each (fold = d <= 128, as the script)."""
    pu = _load_script("profile_unet")
    rng = np.random.default_rng(20)
    q, k, v = (jnp.asarray(rng.standard_normal((bh, s, d)), BF) for _ in range(3))
    qt, kt, vt = map(_torch, (q, k, v))
    ours = tfa.flash_with_blocks(qt, kt, vt, d ** -0.5, *tfa.K1_TILES[d])
    assert ours.dtype == torch.bfloat16 and ours.shape == qt.shape
    for q_blk, k_blk in blocks:
        with pltpu.force_tpu_interpret_mode():
            ref = pu.flash_with_blocks(q_blk, k_blk)(q, k, v, d ** -0.5)
        assert _within(_errors(ours, ref), K1_BOUNDS), _errors(ours, ref)


@pytest.mark.parametrize("fold", [True, False])
def test_s3_plain_matches_pallas(fold):
    """S3, ``build`` of scripts/profile_attn_boundary.py part "sweep512",
    with both row sums, at two block pairs: the script's fn(p, x) is the
    attention of (x * p, x, x); p = 0.1 keeps the diagonal logit (22.6 * p)
    from taking every row's whole weight, d = 512."""
    ns = _part_defs("profile_attn_boundary", "sweep512", {"build"},
                    _flash_kernel=_flash_kernel, d=512)
    rng = np.random.default_rng(21)
    x = jnp.asarray(rng.standard_normal((1, 256, 512)), BF)
    p = jnp.asarray(0.1, BF)
    qt, xt = _torch(x * p), _torch(x)
    scale = 512 ** -0.5
    ours = tfa.flash_d512_blocks(qt, xt, xt, scale, *tfa.K1_TILES[512], fold)
    for q_blk, k_blk in ((128, 64), (64, 128)):
        with pltpu.force_tpu_interpret_mode():
            ref = ns["build"](q_blk, k_blk, fold)(p, x)
        assert _within(_errors(ours, ref), K1_BOUNDS), _errors(ours, ref)


# S2: readings of these inputs, max / mean abs: the plain version with the
# TPU's k block 1.95e-3 / 1.4e-5; with the whole row as one block (the wrong
# partition) 1.95e-3 / 1.3e-4; K1's f32 softmax chain 3.9e-3 / 3.0e-4.
S2_BOUNDS = (2e-3, 5e-5)


@pytest.mark.parametrize("q_blk,k_blk", [(256, 128), (128, 256)])
def test_s2_plain_matches_pallas(q_blk, k_blk):
    """S2, ``kernel_bf``/``flash_bf`` of scripts/profile_unet.py part
    "bf16softmax", over 4 and 2 k blocks of the TPU's partition."""
    ns = _part_defs("profile_unet", "bf16softmax", {"kernel_bf", "flash_bf"})
    rng = np.random.default_rng(22)
    q, k, v = (jnp.asarray(rng.standard_normal((2, 512, 64)), BF) for _ in range(3))
    qt, kt, vt = map(_torch, (q, k, v))
    with pltpu.force_tpu_interpret_mode():
        ref = ns["flash_bf"](q_blk, k_blk)(q, k, v, 0.125)
    ours = tfa._flash_bf16_softmax_ref(qt, kt, vt, 0.125, k_blk)
    assert ours.dtype == torch.bfloat16 and ours.shape == qt.shape
    assert _within(_errors(ours, ref), S2_BOUNDS), _errors(ours, ref)
    for mutant in (tfa._flash_bf16_softmax_ref(qt, kt, vt, 0.125, 512),
                   tfa._flash_bhsd_ref(qt, kt, vt, 0.125)[0]):
        assert not _within(_errors(mutant, ref), S2_BOUNDS), _errors(mutant, ref)


@pytest.mark.parametrize("k_blk", sorted({bk for _, bk in tfa.D64_TILES}))
def test_s2_card_bar_separates_softmax_chains(k_blk):
    """The card holds S2's kernel to a mean abs error of 1e-4 of max|plain|
    beside one bf16 ulp at most (tests/test_torch_cuda.py). At 2304 keys and
    the card's key tiles, K1's f32 chain and S2's chain over another key
    partition lie past that bar from S2's plain version (readings 7.2e-4
    and 4.4e-4 of max|plain|), so a kernel that took either would fail."""
    g = torch.Generator().manual_seed(25)
    q, k, v = (torch.randn(1, 2304, 64, generator=g).to(torch.bfloat16) for _ in range(3))
    s2 = tfa._flash_bf16_softmax_ref(q, k, v, 0.125, k_blk).float()
    bar = 1e-4 * s2.abs().max().item()
    for mutant in (tfa._flash_bhsd_ref(q, k, v, 0.125)[0],
                   tfa._flash_bf16_softmax_ref(q, k, v, 0.125, 2304)):
        assert (mutant.float() - s2).abs().mean().item() > 3 * bar


def test_s2_exp2_is_jax_bf16_lowering():
    """The fact S2's plain version and kernel rest on: JAX's exp2 of a bf16
    array is exp(bf16(ln 2) * x), the product rounded to bf16, and not
    exp2 taken in f32 and rounded."""
    x = jnp.asarray(-np.random.default_rng(23).uniform(0, 12, 4096), BF)
    got = np.asarray(jnp.exp2(x), np.float32)
    ln2 = torch.tensor(np.log(2.0), dtype=torch.bfloat16)
    ours = torch.exp((_torch(x) * ln2).float()).to(torch.bfloat16).float().numpy()
    f32 = np.asarray(jnp.exp2(x.astype(jnp.float32)).astype(BF), np.float32)
    assert (ours != got).mean() <= 1e-3
    assert (f32 != got).mean() >= 0.5


# S4: p rounded once from f32 logits; readings max / mean abs 3.9e-3 /
# 1.2e-7 (x ~ N(0, 1)) and 0.0 / 0.0 (x * 4: every diagonal logit past the
# clamp); without the rounding of p the mean is 1.0e-3 and 1.4e-5, without
# the clamp the output is not finite.
S4_BOUNDS = (4e-3, 1e-6)


@pytest.mark.parametrize("xscale", [1.0, 4.0])
def test_s4_plain_matches_pallas(xscale):
    """S4, ``kernel``/``build`` of scripts/profile_attn_boundary.py part
    "nomax": attention of (x * p, x, x) with p = 1, at block pair (128, 64);
    xscale 4 puts every row's diagonal logit past the clamp of 110."""
    ns = _part_defs("profile_attn_boundary", "nomax", {"kernel", "build"})
    rng = np.random.default_rng(24)
    x = jnp.asarray(rng.standard_normal((2, 256, 64)) * xscale, BF)
    xt = _torch(x)
    logits = torch.matmul(xt.float(), xt.float().transpose(1, 2)) * (0.125 * _LOG2E)
    assert bool((logits > 110).any()) == (xscale > 1)
    with pltpu.force_tpu_interpret_mode():
        ref = ns["build"](128, 64, 64)(jnp.ones((), BF), x)
    ours = tfa.flash_nomax(xt, xt, xt, 0.125, *tfa.K1_TILES[64])
    assert _within(_errors(ours, ref), S4_BOUNDS), _errors(ours, ref)
    unrounded = tfa._flash_nomax_ref(xt.float(), xt.float(), xt.float(), 0.125)
    assert not _within(_errors(unrounded, ref), S4_BOUNDS), _errors(unrounded, ref)
    if xscale > 1:
        p = torch.exp2(logits).to(torch.bfloat16).float()  # no clamp
        unclamped = (torch.matmul(p, xt.float()) / p.sum(dim=-1, keepdim=True))
        assert not bool(torch.isfinite(unclamped).all())


# ------------------------------------- the tile sets against the CUDA source

FWD_CU = REPO / "genpercept_tpu_torch" / "csrc" / "flash_attn_fwd.cu"


def _macro_tiles(src: str, name: str) -> tuple:
    """The (query rows, keys, ring stages) a tile macro of the source lists."""
    line = re.search(rf"#define {name}\(X\) (.*)", src).group(1)
    return tuple(tuple(map(int, t)) for t in re.findall(r"X\((\d+), (\d+), (\d+)\)", line))


def test_tile_sets_are_the_sources():
    """D64_TILES / D512_TILES are the tiles flash_attn_fwd_tiled and the S2/S4
    entries instantiate on K1's wgmma bodies, K1_TILES names K1's own
    launches (and at d=512 S1's tile there is K1's instantiation, ring and
    all), and no mma.sync tiled body is left in the source."""
    src = FWD_CU.read_text()
    d64, d512 = _macro_tiles(src, "GP_D64_TILES"), _macro_tiles(src, "GP_D512_TILES")
    assert tuple(t[:2] for t in d64) == tfa.D64_TILES
    assert tuple(t[:2] for t in d512) == tfa.D512_TILES
    assert all(bq % 64 == 0 and bk in (32, 64, 128) for bq, bk, _ in d64)
    assert all(bq == 64 and bk in (64, 128) for bq, bk, _ in d512)
    k1 = re.search(r"dispatch_bf16_d64\([^)]*\) \{\n\s*return launch_wgmma<(\d+), (\d+), (\d+)>\(",
                   src)
    k1_512 = re.search(r"dispatch_bf16_d512\([^)]*\) \{\n\s*return launch_wgmma_d512<(\d+), "
                       r"(\d+)>\(", src)
    nwg, bk, _ = map(int, k1.groups())
    bk512, nbuf512 = map(int, k1_512.groups())
    assert tfa.K1_TILES == {64: (64 * nwg, bk), 512: (64, bk512)}
    assert tfa.K1_TILES[64] in tfa.D64_TILES
    assert (64, bk512, nbuf512) in d512
    assert "launch_wgmma<BQ / 64, BK, NBUF, SOFTMAX, true>" in src
    assert "launch_wgmma_d512<BK, NBUF, FOLD>" in src
    for gone in ("flash_attn_fwd_mma_kernel", "flash_attn_fwd_split_kernel", "launch_mma",
                 "launch_split", "mma_bf16(", "ldsm_x4"):
        assert gone not in src, gone


# ------------------------------------------------- the two scripts' ports


def _jax_parts(script: str) -> tuple[set, set]:
    """The part names a JAX script's main() tests ``args.part`` against, and
    those that run under "all"."""
    tree = ast.parse((SCRIPTS / f"{script}.py").read_text())
    parts, under_all = set(), set()
    for node in ast.walk(tree):
        if (isinstance(node, ast.Compare) and isinstance(node.left, ast.Attribute)
                and node.left.attr == "part"):
            names = {c.value for c in ast.walk(node.comparators[0])
                     if isinstance(c, ast.Constant) and isinstance(c.value, str)}
            parts |= names
            if "all" in names:
                under_all |= names
    return parts - {"all"}, under_all - {"all"}


@pytest.mark.parametrize("script", ["profile_unet", "profile_attn_boundary"])
def test_torch_scripts_have_the_jax_parts(script):
    parts, under_all = _jax_parts(script)
    ported = _load_script(f"{script}_torch")
    assert set(ported.PARTS) == parts
    assert set(ported.ALL) == under_all


@pytest.mark.parametrize("script", ["profile_unet_torch", "profile_attn_boundary_torch"])
def test_torch_scripts_leave_jax_out_and_need_a_card(script, tmp_path):
    """Run as a program without a CUDA device, each port exits 1 before
    printing anything, having loaded neither JAX nor the JAX package."""
    path = str(SCRIPTS / f"{script}.py")
    code = ("import runpy, sys\n"
            f"sys.argv = [{path!r}, '--part', 'all']\n"
            "try:\n"
            "    runpy.run_path(sys.argv[0], run_name='__main__')\n"
            "    code = 0\n"
            "except SystemExit as e:\n"
            "    code = e.code\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
            "or m.startswith('genpercept_tpu.') or m == 'genpercept_tpu']\n"
            "sys.stderr.write(f'exit {code!r} jax {bad}')\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120, cwd=tmp_path)
    assert proc.stdout == "", proc.stdout
    # a SystemExit carrying a message exits with status 1
    assert re.fullmatch(r"exit 'chip_smoke: torch\.cuda\.is_available\(\) is False' jax \[\]",
                        proc.stderr), proc.stderr
