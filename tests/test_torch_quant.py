"""The port's W8A8 int8 path held to the JAX package's, on the CPU.

Inputs come from numpy seeds and go to both packages. Layouts differ (the
port keeps conv weights OIHW and dense weights (out, in)); trees built by
one package are moved to the other's layout with ``to_port`` /
``to_jax``. The JAX package's Pallas kernels (K5, K6) run in interpret mode.

Tolerances and why:
- int8 codes and int32 sums: equal (integer arithmetic, exact in both);
- stats and scales: 1 ulp (the same IEEE f32 operations, apart from the
  order of the means behind the clip search, which only picks a candidate);
- quantized outputs: 1e-6 relative to max|y| (the f32 epilogue of equal
  int32 sums; the asymmetric bias folds a sum taken in another order);
- K5 plain vs JAX: bf16 6e-2 absolute (the JAX package's own bar,
  tests/test_ops.py), f32 see the test;
- K6 plain vs JAX: see the test (p is rounded to int8 against exp2 values of
  two libraries, which may put a code on the other side of .5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from genpercept_tpu.ops import fused_ff as jff
from genpercept_tpu.ops import quant as jq
from genpercept_tpu.ops.flash_attention import flash_attention_int8 as j_flash_int8
from genpercept_tpu.models import layers as JL
from genpercept_tpu_torch.models import layers as TL
from genpercept_tpu_torch.ops import flash_attention as tfa
from genpercept_tpu_torch.ops import fused_ff as tff
from genpercept_tpu_torch.ops import quant as tq
from test_torch_models import load, nchw, nhwc, numpy_params

torch.set_num_threads(1)


def skewed(shape, seed):
    """Post-SiLU-like activations: bounded below, long upper tail, per-channel
    scales that differ."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape) * rng.uniform(0.3, 3.0, shape[-1]) + 0.5
    return (x / (1.0 + np.exp(-x))).astype(np.float32)


def to_port(q):
    """A JAX QConv / QDense in the port's layout."""
    t = lambda a: None if a is None else torch.from_numpy(np.array(a))
    if isinstance(q, jq.QConv):
        return tq.QConv(t(q.w_int8).permute(3, 2, 0, 1).contiguous(), t(q.inv_a),
                        t(q.o_scale), t(q.bias), q.kind, tuple(q.stride),
                        tuple(tuple(p) for p in q.padding), t(q.zp))
    return tq.QDense(t(q.w_int8).t().contiguous(), t(q.inv_a), t(q.o_scale), t(q.bias),
                     t(q.zp))


def port_w(q):
    """The port's int8 weight in the JAX package's layout (numpy)."""
    w = q.w_int8.permute(2, 3, 1, 0) if isinstance(q, tq.QConv) else q.w_int8.t()
    return w.numpy()


def assert_same_q(ours, ref):
    """Equal codes; scales and zero-points to 1 ulp; bias to 1e-6 of its
    largest entry (a sum taken in another order when asymmetric)."""
    np.testing.assert_array_equal(port_w(ours), np.asarray(ref.w_int8))
    for a, b in ((ours.inv_a, ref.inv_a), (ours.o_scale, ref.o_scale), (ours.zp, ref.zp)):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_max_ulp(a.numpy(), np.asarray(b), maxulp=1)
    assert (ours.bias is None) == (ref.bias is None)
    if ours.bias is not None:
        b = np.asarray(ref.bias)
        np.testing.assert_allclose(ours.bias.numpy(), b, rtol=0, atol=1e-6 * np.abs(b).max())


# ------------------------------------------------------------- primitives

STATS = [("absmax", "absmax_per_channel"), ("clip", "mse_optimal_clip"),
         ("clip_asym", "mse_optimal_clip_asym"), ("minmax_asym", "minmax_asym")]


@pytest.mark.parametrize("label,fn", STATS)
def test_calibration_stats_match_jax(label, fn):
    x = skewed((2, 9, 7, 24), seed=0)
    ours = getattr(tq, fn)(torch.from_numpy(x)).numpy()
    ref = np.asarray(getattr(jq, fn)(jnp.asarray(x)))
    assert ours.shape == ref.shape
    np.testing.assert_array_max_ulp(ours, ref, maxulp=1)


def test_merge_stats_match_jax():
    a, b = (skewed((4, 6, 12), s) for s in (1, 2))
    for fn in (jq.absmax_per_channel, jq.mse_optimal_clip_asym):
        ja, jb = fn(jnp.asarray(a)), fn(jnp.asarray(b))
        ref = np.asarray(jq.merge_stats({"k": ja}, {"k": jb})["k"])
        ours = tq.merge_stats({"k": torch.from_numpy(np.array(ja))},
                              {"k": torch.from_numpy(np.array(jb))})["k"].numpy()
        np.testing.assert_array_equal(ours, ref)


CONV_KINDS = [  # (kind, stride, padding)
    ("3x3", 1, 1), ("3x3", 2, ((0, 1), (0, 1))), ("3x3", 2, 1), ("up4x4", 1, 1),
]


def conv_params(cin, cout, seed):
    rng = np.random.default_rng(seed)
    w = (rng.uniform(-1, 1, (3, 3, cin, cout)) / np.sqrt(9 * cin)).astype(np.float32)
    b = (0.05 * rng.standard_normal(cout)).astype(np.float32)
    return w, b


@pytest.mark.parametrize("asym", [False, True])
@pytest.mark.parametrize("kind,stride,padding", CONV_KINDS)
@pytest.mark.parametrize("weight_clip", [False, True])
def test_quantize_conv_matches_jax(kind, stride, padding, asym, weight_clip):
    x = skewed((2, 8, 8, 16), seed=3)
    w, b = conv_params(16, 24, seed=4)
    stat = (jq.mse_optimal_clip_asym if asym else jq.mse_optimal_clip)(jnp.asarray(x))
    ref = jq.quantize_conv({"weight": jnp.asarray(w), "bias": jnp.asarray(b)}, stat,
                           kind=kind, stride=stride, padding=padding, margin=1.1,
                           weight_clip=weight_clip)
    ours = tq.quantize_conv(torch.from_numpy(w.transpose(3, 2, 0, 1).copy()),
                            torch.from_numpy(b), torch.from_numpy(np.array(stat)),
                            kind=kind, stride=stride, padding=padding, margin=1.1,
                            weight_clip=weight_clip)
    assert (ours.kind, ours.stride, ours.padding) == (ref.kind, ref.stride, ref.padding)
    assert_same_q(ours, ref)


@pytest.mark.parametrize("asym", [False, True])
@pytest.mark.parametrize("weight_clip", [False, True])
def test_quantize_dense_matches_jax(asym, weight_clip):
    x = skewed((40, 32), seed=5)
    rng = np.random.default_rng(6)
    w = (rng.uniform(-1, 1, (32, 48)) / np.sqrt(32)).astype(np.float32)
    b = (0.05 * rng.standard_normal(48)).astype(np.float32)
    stat = (jq.mse_optimal_clip_asym if asym else jq.absmax_per_channel)(jnp.asarray(x))
    ref = jq.quantize_dense({"weight": jnp.asarray(w), "bias": jnp.asarray(b)}, stat,
                            weight_clip=weight_clip)
    ours = tq.quantize_dense(torch.from_numpy(w.T.copy()), torch.from_numpy(b),
                             torch.from_numpy(np.array(stat)), weight_clip=weight_clip)
    assert_same_q(ours, ref)


def unit_scales(q):
    """The same tree with o_scale 1 and no bias: the output is the int32 sum."""
    import dataclasses

    if isinstance(q, jq.QConv):
        return jq.QConv(q.w_int8, q.inv_a, jnp.ones_like(q.o_scale), None, q.kind,
                        q.stride, q.padding, q.zp)
    if isinstance(q, jq.QDense):
        return jq.QDense(q.w_int8, q.inv_a, jnp.ones_like(q.o_scale), None, q.zp)
    return dataclasses.replace(q, o_scale=torch.ones_like(q.o_scale), bias=None)


@pytest.mark.parametrize("asym", [False, True])
@pytest.mark.parametrize("kind,stride,padding", CONV_KINDS)
def test_qconv_apply_matches_jax(kind, stride, padding, asym):
    """One QConv (JAX-built) in both packages: equal int32 sums, f32 outputs
    to 1e-6 of max|y|. Odd sizes take the stride-2 paddings' ragged edge."""
    x = skewed((2, 9, 7, 16), seed=7)
    w, b = conv_params(16, 24, seed=8)
    stat = (jq.mse_optimal_clip_asym if asym else jq.mse_optimal_clip)(jnp.asarray(x))
    jqc = jq.quantize_conv({"weight": jnp.asarray(w), "bias": jnp.asarray(b)}, stat,
                           kind=kind, stride=stride, padding=padding, margin=1.1)
    for jqq, exact in ((unit_scales(jqc), True), (jqc, False)):
        ref = np.asarray(jq.qconv_apply(jqq, jnp.asarray(x)))
        ours = nhwc(tq.qconv_apply(to_port(jqq), nchw(x)))
        assert ours.shape == ref.shape
        if exact:
            np.testing.assert_array_equal(ours, ref)
        else:
            np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-6 * np.abs(ref).max())


def test_qconv_im2col_chunks_change_nothing(monkeypatch):
    """Row chunks of the im2col (the memory bound) give the same sums."""
    x = skewed((2, 9, 7, 16), seed=9)
    w, b = conv_params(16, 24, seed=10)
    q = tq.quantize_conv(torch.from_numpy(w.transpose(3, 2, 0, 1).copy()), torch.from_numpy(b),
                         tq.mse_optimal_clip_asym(torch.from_numpy(x)))
    whole = tq.qconv_apply(q, nchw(x))
    monkeypatch.setattr(tq, "_IM2COL_BYTES", 7 * 144 * 2)  # two output rows a chunk
    assert torch.equal(tq.qconv_apply(q, nchw(x)), whole)


@pytest.mark.parametrize("asym", [False, True])
def test_qdense_apply_matches_jax(asym):
    x = skewed((3, 20, 32), seed=11)
    rng = np.random.default_rng(12)
    w = (rng.uniform(-1, 1, (32, 48)) / np.sqrt(32)).astype(np.float32)
    stat = (jq.minmax_asym if asym else jq.absmax_per_channel)(jnp.asarray(x))
    jqd = jq.quantize_dense({"weight": jnp.asarray(w), "bias": None}, stat)
    for jqq, exact in ((unit_scales(jqd), True), (jqd, False)):
        ref = np.asarray(jq.qdense_apply(jqq, jnp.asarray(x)))
        ours = tq.qdense_apply(to_port(jqq), torch.from_numpy(x)).numpy()
        if exact:
            np.testing.assert_array_equal(ours, ref)
        else:
            np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-6 * np.abs(ref).max())


# ---------------------------------------------------------------- K5 plain


def ff_trees(c, asym, dtype, seed):
    """JAX QDense trees of one GEGLU feed-forward calibrated on its own
    activations (as make_calib_dense_fn does), and the input."""
    rng = np.random.default_rng(seed)
    inner = 4 * c
    w1 = (rng.uniform(-1, 1, (c, 2 * inner)) / np.sqrt(c)).astype(np.float32)
    b1 = (0.05 * rng.standard_normal(2 * inner)).astype(np.float32)
    w2 = (rng.uniform(-1, 1, (inner, c)) / np.sqrt(inner)).astype(np.float32)
    b2 = (0.05 * rng.standard_normal(c)).astype(np.float32)
    x = jnp.asarray(rng.standard_normal((1, 512, c)) + 0.3, dtype)
    stat = jq.minmax_asym if asym else jq.absmax_per_channel
    half = lambda sl: {"weight": jnp.asarray(w1[:, sl], dtype), "bias": jnp.asarray(b1[sl], dtype)}
    qh = jq.quantize_dense(half(slice(0, inner)), stat(x))
    qg = jq.quantize_dense(half(slice(inner, None)), stat(x))
    a = jq.qdense_apply(qh, x) * jax.nn.gelu(jq.qdense_apply(qg, x), approximate=False)
    q2 = jq.quantize_dense({"weight": jnp.asarray(w2, dtype), "bias": jnp.asarray(b2, dtype)},
                           stat(a))
    return x, (qh, qg, q2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("asym", [False, True])
def test_fused_ff_int8_plain_matches_pallas(asym, dtype):
    """K5's plain version against JAX's fused_geglu_ff_int8 (Pallas,
    interpret mode) and against the port's unfused qdense composition.
    bf16: 6e-2 absolute, the JAX package's bar for its kernel against the
    composition (read 1.2e-4). f32: 1e-5 of max|y| (read 7.9e-8: both take
    every step in rounded f32; an a-code on the other side of .5 would move
    an output by one step of the down-projection's grid, ~1e-4 of max|y|)."""
    x, jtrees = ff_trees(64, asym, jnp.dtype(dtype), seed=13)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jff.fused_geglu_ff_int8(x, *jtrees), np.float32)
    tdt = getattr(torch, dtype)
    xt = torch.from_numpy(np.array(x, np.float32)).to(tdt)
    trees = [to_port(q) for q in jtrees]
    ours = tff.fused_geglu_ff_int8(xt, *trees)
    assert ours.dtype == tdt and ours.shape == xt.shape
    tol = 6e-2 if dtype == "bfloat16" else 1e-5 * np.abs(ref).max()
    np.testing.assert_allclose(ours.float().numpy(), ref, rtol=0, atol=tol)
    # every row is computed alone: blocks of rows change no value (JAX:
    # tests/test_ops.py, row_blk; the kernel takes 32-row blocks)
    blocks = [tff.fused_geglu_ff_int8(xt[:, i:i + 96], *trees) for i in range(0, 512, 96)]
    assert torch.equal(torch.cat(blocks, dim=1), ours)
    # the unfused composition of the same trees (the dense-hook path)
    qh, qg, q2 = trees
    comp = tq.qdense_apply(q2, tq.qdense_apply(qh, xt)
                           * torch.nn.functional.gelu(tq.qdense_apply(qg, xt)))
    np.testing.assert_allclose(ours.float().numpy(), comp.float().numpy(), rtol=0,
                               atol=6e-2 if dtype == "bfloat16" else 2e-3 * np.abs(ref).max())


def test_supported_int8_matches_jax():
    for b, s, c in [(2, 9216, 320), (2, 2304, 640), (1, 6912, 320), (1, 1728, 640),
                    (2, 576, 1280), (1, 256, 640), (1, 512, 64)]:
        assert tff.supported_int8(b, s, c) == jff.supported_int8(b, s, c)


# ---------------------------------------------------------------- K6 plain


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_int8_plain_matches_pallas(dtype):
    """K6's plain version against JAX's flash_attention_int8 (Pallas,
    interpret mode) with q at 512 tokens and k/v at 2048: two k blocks of
    1024, so pq is rounded against a running max that the second block
    raises. The pq codes of the two packages are counted against each other
    (the same logits, exp2 of torch and of XLA): a flip moves one row's
    output by ~|v|/l. Bars: f32 1e-5 of max|out| (read 1.6e-7), bf16 2e-2
    of max|out| (read 5.4e-3: the output is rounded to bf16); flips at most
    1e-4 of the codes."""
    rng = np.random.default_rng(14)
    d = 512
    q = (rng.standard_normal((2, 512, 1, d)) * 0.5).astype(np.float32)
    k = (rng.standard_normal((2, 2048, 1, d)) * 0.5).astype(np.float32)
    v = rng.standard_normal((2, 2048, 1, d)).astype(np.float32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(j_flash_int8(*(jnp.asarray(a, jdt) for a in (q, k, v))), np.float32)
    qt, kt, vt = (torch.from_numpy(a).to(tdt) for a in (q, k, v))
    assert tfa._int8_k_block(512, 2048, d) == 1024
    ours = tfa.flash_attention_int8(qt, kt, vt)
    assert ours.dtype == tdt and ours.shape == qt.shape
    scale = np.abs(ref).max()
    err = np.abs(ours.float().numpy() - ref).max() / scale
    assert err <= (1e-5 if dtype == "float32" else 2e-2), err

    # pq flips between torch's exp2 and XLA's, block by block, on the
    # port's own logits and running max
    bh = lambda a: a.reshape(2, a.shape[1], d)
    q8, qs = tfa._rowq(bh(qt), -1)
    k8, ks = tfa._rowq(bh(kt), -1)
    c = d ** -0.5 * tfa._LOG2E
    flips, total = 0, 0
    for b in range(2):
        m = torch.full((512, 1), -1e30)
        for k0 in (0, 1024):
            s32 = tq.int8_matmul(q8[b], k8[b, k0:k0 + 1024])
            s = s32.float() * (qs[b] * ks[b, k0:k0 + 1024, 0][None, :])
            m = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            arg = s * c - m * c
            p_t = torch.round(torch.exp2(arg) * 127.0)
            p_j = np.round(np.asarray(jnp.exp2(jnp.asarray(arg.numpy()))) * np.float32(127.0))
            flips += int((p_t.numpy() != p_j).sum())
            total += p_t.numel()
    assert flips <= 1e-4 * total, (flips, total)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_int8_plain_matches_pallas_d64(dtype):
    """K6's plain version at the UNet's head dim (d=64, two heads), q at 256
    tokens and k/v at 2048: two k blocks of 1024, as at d=512 above. At d=64
    the logits are small, so p*127 crosses a .5 boundary more often and a pq
    code can flip between torch's exp2 and XLA's; one flip moves a row's
    output by about max|v| / l. Flips are counted as above (at most 1e-4 of
    the codes) and the bars are f32 2e-3 of max|out| (a few flips at these
    inputs' l) and bf16 2e-2 of max|out|."""
    rng = np.random.default_rng(15)
    d = 64
    q = (rng.standard_normal((2, 256, 2, d)) * 0.5).astype(np.float32)
    k = (rng.standard_normal((2, 2048, 2, d)) * 0.5).astype(np.float32)
    v = rng.standard_normal((2, 2048, 2, d)).astype(np.float32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(j_flash_int8(*(jnp.asarray(a, jdt) for a in (q, k, v))), np.float32)
    assert tfa._int8_k_block(256, 2048, d) == 1024
    ours = tfa.flash_attention_int8(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)))
    assert ours.dtype == tdt and ours.shape == q.shape
    err = np.abs(ours.float().numpy() - ref).max() / np.abs(ref).max()
    assert err <= (2e-3 if dtype == "float32" else 2e-2), err

    bhsd = lambda a: torch.from_numpy(a).to(tdt).permute(0, 2, 1, 3).reshape(4, a.shape[1], d)
    q8, qs = tfa._rowq(bhsd(q), -1)
    k8, ks = tfa._rowq(bhsd(k), -1)
    c = d ** -0.5 * tfa._LOG2E
    flips, total = 0, 0
    for b in range(4):
        m = torch.full((256, 1), -1e30)
        for k0 in (0, 1024):
            s = tq.int8_matmul(q8[b], k8[b, k0:k0 + 1024]).float() * (
                qs[b] * ks[b, k0:k0 + 1024, 0][None, :])
            m = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            arg = s * c - m * c
            p_t = torch.round(torch.exp2(arg) * 127.0)
            p_j = np.round(np.asarray(jnp.exp2(jnp.asarray(arg.numpy()))) * np.float32(127.0))
            flips += int((p_t.numpy() != p_j).sum())
            total += p_t.numel()
    assert flips <= 1e-4 * total, (flips, total)


# ------------------------------------------------- VAE attention with hooks


def test_vae_attention_int8_and_dense_hooks_match_jax():
    """Calibration through the dense hooks records the same stats for the
    four projections and returns the full-precision output; the quantized
    trees are equal; int8 attention with the quantized projections agrees
    with JAX's (Pallas K6 in interpret mode) to 2e-3 of max|out|."""
    c, name = 64, "encoder.mid_block.attentions.0"
    p = numpy_params(JL.init_vae_attention, c, seed=15)
    m = load(TL.VAEAttention(c), p)
    x = skewed((1, 16, 16, c), seed=16)
    jstats, tstats = {}, {}
    kw = dict(clip_search=True, asymmetric=True)
    ref_fp = JL.vae_attention(p, jnp.asarray(x))
    j_cal = JL.vae_attention(p, jnp.asarray(x), dense_fn=jq.make_calib_dense_fn(jstats, **kw),
                             name=name)
    with torch.no_grad():
        t_cal = TL.vae_attention(m, nchw(x), dense_fn=tq.make_calib_dense_fn(tstats, **kw),
                                 name=name)
    np.testing.assert_allclose(np.asarray(j_cal), np.asarray(ref_fp), rtol=0, atol=1e-6)
    np.testing.assert_allclose(nhwc(t_cal), np.asarray(ref_fp), rtol=0, atol=5e-5)
    assert set(tstats) == set(jstats) == {f"{name}.{n}" for n in
                                          ("to_q", "to_k", "to_v", "to_out.0")}
    for k in jstats:
        np.testing.assert_allclose(tstats[k].numpy(), np.asarray(jstats[k]), rtol=1e-5,
                                   atol=1e-6)
    jtree = jq.quantize_from_stats({"encoder": {"mid_block": {"attentions": {"0": p}}}},
                                   jstats, 1.0)
    ttree = {k: to_port(v) for k, v in jtree.items()}
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(JL.vae_attention(p, jnp.asarray(x), int8=True,
                                          dense_fn=jq.make_quant_dense_fn(jtree), name=name))
    with torch.no_grad():
        ours = nhwc(TL.vae_attention(m, nchw(x), int8=True,
                                     dense_fn=tq.make_quant_dense_fn(ttree), name=name))
    assert np.abs(ours - ref).max() <= 2e-3 * np.abs(ref).max()


# -------------------------------------------------------- calibration file


def small_jax_tree():
    x = skewed((2, 8, 8, 16), seed=17)
    w, b = conv_params(16, 16, seed=18)
    cp = {"weight": jnp.asarray(w), "bias": jnp.asarray(b)}
    asym = jq.mse_optimal_clip_asym(jnp.asarray(x))
    sym = jq.mse_optimal_clip(jnp.asarray(x))
    dense = {"weight": jnp.asarray(w.reshape(-1, 16)[:16]), "bias": None}
    return {
        "enc": {"encoder.down_blocks.2.downsamplers.0.conv":
                jq.quantize_conv(cp, asym, stride=2, padding=((0, 1), (0, 1))),
                "encoder.mid_block.attentions.0.to_q": jq.quantize_dense(dense, asym)},
        "dec": {"decoder.up_blocks.0.upsamplers.0.conv": jq.quantize_conv(cp, asym,
                                                                          kind="up4x4"),
                "decoder.up_blocks.0.resnets.0.conv1": jq.quantize_conv(cp, sym)},
    }


def test_load_calibration_reads_jax_file_and_back(tmp_path):
    jtree = small_jax_tree()
    jq.save_calibration(tmp_path / "jax.npz", jtree)
    ours = tq.load_calibration(tmp_path / "jax.npz")
    assert {g: set(t) for g, t in ours.items()} == {g: set(t) for g, t in jtree.items()}
    for g in jtree:
        for k, ref in jtree[g].items():
            q = ours[g][k]
            assert isinstance(q, tq.QConv) == isinstance(ref, jq.QConv)
            if isinstance(q, tq.QConv):
                assert (q.kind, q.stride, q.padding) == (ref.kind, ref.stride, ref.padding)
            np.testing.assert_array_equal(port_w(q), np.asarray(ref.w_int8))
            for a, b in ((q.inv_a, ref.inv_a), (q.o_scale, ref.o_scale), (q.bias, ref.bias),
                         (q.zp, ref.zp)):
                assert (a is None) == (b is None)
                if a is not None:
                    np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    tq.save_calibration(tmp_path / "port.npz", ours)
    back = jq.load_calibration(tmp_path / "port.npz")
    x = skewed((1, 8, 8, 16), seed=19)
    for g in jtree:
        for k, ref in jtree[g].items():
            q = back[g][k]
            np.testing.assert_array_equal(np.asarray(q.w_int8), np.asarray(ref.w_int8))
            if isinstance(ref, jq.QConv):
                np.testing.assert_array_equal(np.asarray(jq.qconv_apply(q, jnp.asarray(x))),
                                              np.asarray(jq.qconv_apply(ref, jnp.asarray(x))))


def test_calibrate_chunked_matches_jax():
    """Chunks of 2 over 5 images (a ragged tail): range stats union, the
    bias-correction residuals average weighted by chunk size, predictions
    concatenate, in both packages."""
    x = skewed((5, 6, 8), seed=20)

    def j_fn(rgb):
        return rgb * 2.0, {"enc": {"a": jq.mse_optimal_clip_asym(rgb)},
                           "dec": {"b": jq.absmax_per_channel(rgb)},
                           "corr": {"enc": {"a": rgb.mean(axis=(0, 1))}}}

    def t_fn(rgb):
        return rgb * 2.0, {"enc": {"a": tq.mse_optimal_clip_asym(rgb)},
                           "dec": {"b": tq.absmax_per_channel(rgb)},
                           "corr": {"enc": {"a": rgb.mean(dim=(0, 1))}}}

    jpred, jst = jq.calibrate_chunked(lambda p, r: j_fn(r), None, jnp.asarray(x), chunk=2)
    tpred, tst = tq.calibrate_chunked(t_fn, torch.from_numpy(x), chunk=2)
    np.testing.assert_array_equal(tpred.numpy(), np.asarray(jpred))
    for g, k in (("enc", "a"), ("dec", "b")):
        np.testing.assert_array_max_ulp(tst[g][k].numpy(), np.asarray(jst[g][k]), maxulp=1)
    np.testing.assert_allclose(tst["corr"]["enc"]["a"].numpy(),
                               np.asarray(jst["corr"]["enc"]["a"]), rtol=1e-6)


# ------------------------------------------------------- the tiny pipeline

# The slice's config, but with int8_refine off: JAX's calibration program
# with the refined stats (a 19-candidate search per layer) takes ~2 minutes
# to compile on one core, ~25 s without. The refinement is held to JAX per
# layer by test_refined_calibration_hooks_match_jax.
SLICE = dict(mode="depth", processing_res=64, int8_vae=True, int8_unet=True,
             int8_unet_ff=True, int8_vae_attn=True, int8_refine=False)


@pytest.fixture(scope="module")
def int8_pipes(tmp_path_factory):
    """The slice's config (asymmetric stats, the default placement) on the
    tiny models of tests/test_torch_pipeline.py in both
    packages: the calibrating first batch, a quantized second, the JAX
    calibration file, and a full-precision port pipeline."""
    from genpercept_tpu.models import UNetConfig as JU, VAEConfig as JV, init_unet, init_vae
    from genpercept_tpu.pipeline import GenPerceptModels as JModels
    from genpercept_tpu.pipeline import GenPerceptPipeline as JPipe
    from genpercept_tpu.pipeline import PipelineConfig as JCfg
    from genpercept_tpu_torch.io import state_dict_from_jax
    from genpercept_tpu_torch.models import (AutoencoderKL, UNet2DConditionModel, UNetConfig,
                                             VAEConfig)
    from genpercept_tpu_torch.pipeline import GenPerceptModels, GenPerceptPipeline, PipelineConfig
    from genpercept_tpu_torch.utils.synthetic import natural_like_images
    from test_torch_pipeline import TINY_UNET, TINY_VAE

    unet_p = numpy_params(init_unet, JU(**TINY_UNET), seed=0)
    vae_p = numpy_params(init_vae, JV(**TINY_VAE), seed=1)
    embed = np.random.default_rng(2).normal(size=(1, 77, 48)).astype(np.float32)
    jmodels = JModels(unet=unet_p, vae=vae_p, unet_cfg=JU(**TINY_UNET), vae_cfg=JV(**TINY_VAE),
                      text_embed=jnp.asarray(embed))

    def tmodels():
        unet = UNet2DConditionModel(UNetConfig(**TINY_UNET))
        unet.load_state_dict(state_dict_from_jax(unet_p), strict=True)
        vae = AutoencoderKL(VAEConfig(**TINY_VAE))
        vae.load_state_dict(state_dict_from_jax(vae_p), strict=True)
        return GenPerceptModels(unet=unet, vae=vae, text_embed=torch.from_numpy(embed))

    images = list(natural_like_images(3, 2, 64))
    jpipe = JPipe(jmodels, JCfg(**SLICE))
    with pltpu.force_tpu_interpret_mode():
        j_first = [o.pred_np for o in jpipe.batch(images, batch_size=2)]
        j_second = [o.pred_np for o in jpipe.batch(images, batch_size=2)]
    path = tmp_path_factory.mktemp("calib") / "jax.npz"
    jpipe.save_calibration(path)
    tpipe = GenPerceptPipeline(tmodels(), PipelineConfig(**SLICE), device="cpu")
    t_first = [o.pred_np for o in tpipe.batch(images, batch_size=2)]
    t_second = [o.pred_np for o in tpipe.batch(images, batch_size=2)]
    fp = GenPerceptPipeline(tmodels(), PipelineConfig(mode="depth", processing_res=64),
                            device="cpu")
    t_fp = [o.pred_np for o in fp.batch(images, batch_size=2)]
    loaded = GenPerceptPipeline(tmodels(), PipelineConfig(**SLICE), device="cpu")
    loaded.load_calibration(path)
    t_loaded = [o.pred_np for o in loaded.batch(images, batch_size=2)]
    return dict(jpipe=jpipe, tpipe=tpipe, j_first=j_first, j_second=j_second,
                t_first=t_first, t_second=t_second, t_fp=t_fp, t_loaded=t_loaded)


def mean_dev(a, b):
    return max(float(np.mean(np.abs(x - y))) for x, y in zip(a, b))


def test_int8_pipeline_first_call_is_full_precision(int8_pipes):
    """The calibrating batch returns the full-precision prediction: equal to
    the port's fp pipeline, and to JAX's first batch at the golden bar
    (mean |depth| deviation <= 1e-4)."""
    p = int8_pipes
    for a, b in zip(p["t_first"], p["t_fp"]):
        np.testing.assert_array_equal(a, b)
    assert mean_dev(p["t_first"], p["j_first"]) <= 1e-4
    assert p["tpipe"].int8_mean_dev is not None and np.isfinite(p["tpipe"].int8_mean_dev)


def test_int8_pipeline_qtrees_match_jax(int8_pipes):
    """Same groups and paths (the default placement). The activations behind
    the stats differ by float rounding between the packages, which moves a
    scale by a few ulps and, rarely, a code across .5. Bars: at most 1% of
    the channels' scales off by more than 1e-4 relative and 1e-3 of the
    codes different (read with the refined stats: no scale, 3e-4 of the
    codes)."""
    ours = int8_pipes["tpipe"].vae_quant
    ref = int8_pipes["jpipe"]._params["vae_quant"]
    assert {g: set(t) for g, t in ours.items()} == {g: set(t) for g, t in ref.items()}
    assert sum(len(t) for t in ours.values()) > 100
    n_codes = n_diff = n_ch = n_off = 0
    for g in ref:
        for k, r in ref[g].items():
            q = ours[g][k]
            assert isinstance(q, tq.QConv) == isinstance(r, jq.QConv), k
            w, wr = port_w(q), np.asarray(r.w_int8)
            n_codes += w.size
            n_diff += int((w != wr).sum())
            for a, b in ((q.o_scale, r.o_scale), (q.inv_a, r.inv_a)):
                b = np.asarray(b)
                n_ch += b.size
                n_off += int((np.abs(a.numpy() - b) > 1e-4 * np.abs(b)).sum())
    assert n_off <= 1e-2 * n_ch, (n_off, n_ch)
    assert n_diff <= 1e-3 * n_codes, (n_diff, n_codes)


def test_int8_pipeline_matches_jax(int8_pipes):
    """The quantized batch, port against JAX, mean |depth| deviation: with
    the port's own calibration and with JAX's loaded from its .npz file, at
    most 1.5e-2 and at most 0.75 of the port's own deviation between int8
    and full precision (read: 1.12e-2 and 1.15e-2, against 2.08e-2). At these
    tiny widths one activation code flipped across .5 by float rounding moves
    a layer's output by a whole quantization step, and the ~30 quantized
    layers of the decoder amplify it. Per layer, on equal inputs, the
    packages agree exactly (test_qconv_apply_matches_jax,
    test_qdense_apply_matches_jax)."""
    p = int8_pipes
    int8_dev = mean_dev(p["t_second"], p["t_fp"])
    for ours in (p["t_second"], p["t_loaded"]):
        dev = mean_dev(ours, p["j_second"])
        assert dev <= 1.5e-2 and dev <= 0.75 * int8_dev, (dev, int8_dev)


@pytest.mark.parametrize("layer", ["conv", "dense"])
def test_refined_calibration_hooks_match_jax(layer):
    """int8_refine's two parts through the calibration hooks: the asymmetric
    MSE clip search and the bias correction (the mean of y_fp - y_int8,
    folded into the quantized bias). Stats to 1 ulp; residuals and corrected
    biases to 1e-6 absolute (y_fp ~ 1 is a float product whose sums run in
    another order in the two packages: read 2.4e-7); equal codes."""
    kw = dict(clip_search=True, asymmetric=True, margin=1.0)
    js, jc, ts, tc = {}, {}, {}, {}
    if layer == "conv":
        x = skewed((2, 8, 8, 16), seed=21)
        w, b = conv_params(16, 24, seed=22)
        jp = {"weight": jnp.asarray(w), "bias": jnp.asarray(b)}
        jq.make_calib_conv_fn(js, corr=jc, **kw)("l", jp, jnp.asarray(x))
        tq.make_calib_conv_fn(ts, corr=tc, **kw)(
            "l", torch.from_numpy(w.transpose(3, 2, 0, 1).copy()), torch.from_numpy(b), nchw(x))
        jtree = {"l": jq.quantize_conv(jp, js["l"], margin=1.0)}
        ttree = {"l": tq.quantize_conv(torch.from_numpy(w.transpose(3, 2, 0, 1).copy()),
                                       torch.from_numpy(b), ts["l"], margin=1.0)}
    else:
        x = skewed((2, 30, 32), seed=23)
        rng = np.random.default_rng(24)
        w = (rng.uniform(-1, 1, (32, 40)) / np.sqrt(32)).astype(np.float32)
        jp = {"weight": jnp.asarray(w), "bias": None}
        jq.make_calib_dense_fn(js, corr=jc, **kw)("l", jp, jnp.asarray(x))
        tq.make_calib_dense_fn(ts, corr=tc, **kw)("l", torch.from_numpy(w.T.copy()), None,
                                                  torch.from_numpy(x))
        jtree = {"l": jq.quantize_dense(jp, js["l"], margin=1.0)}
        ttree = {"l": tq.quantize_dense(torch.from_numpy(w.T.copy()), None, ts["l"], margin=1.0)}
    np.testing.assert_array_max_ulp(ts["l"].numpy(), np.asarray(js["l"]), maxulp=1)
    c = np.asarray(jc["l"])
    np.testing.assert_allclose(tc["l"].numpy(), c, rtol=0, atol=1e-6)
    jt = jq.apply_bias_correction(jtree, jc)["l"]
    tt = tq.apply_bias_correction(ttree, tc)["l"]
    np.testing.assert_array_equal(port_w(tt), np.asarray(jt.w_int8))
    jb = np.asarray(jt.bias)
    np.testing.assert_allclose(tt.bias.numpy(), jb, rtol=0, atol=1e-6)
