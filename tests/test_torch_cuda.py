"""The port's CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA GPU with nvcc (a CUDA kernel has no CPU mode)
and skip elsewhere. They import no JAX, so on a machine without it run them
without the repository's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: f32 1e-4 absolute (kernel and plain version differ in
summation order only); bf16 2e-2 (flash attention: p is rounded to bf16
against the running max in the kernel, the global max in the plain
version) and 6e-2 (feed-forward, as the JAX package's bf16 test); K1's bf16
output also within 2^-6 of max|plain|, a few bf16 ulps of the largest
output (with randn inputs over thousands of keys |out| is ~0.02, so 2e-2
alone passes an error as large as the output, such as one half of the
d=512 body's O rescaled apart from the other, or a combine weight off).
K2's bf16 output is also held to 2^-6 of max|plain| and its mean abs error to
1e-5 of max|plain| (|out| is ~0.9: the mean bar sees a running sum that
passes through bf16 between chunks of the inner dimension, whose max error
stays under both max bars; tests/test_torch_fused_ff_bf16.py).
K1's f32 output at 9216 keys and K2's f32 output are also held to 2e-5 of
max|plain|: both bodies run split TF32 on the tensor cores, which truncate
every sum into an accumulator, and an error that grows with the length
stays under 1e-4 absolute where |out| is ~0.1. The
backward kernels K3/K4 are held to 1e-4 (f32) and 2e-2 (bf16) relative to
max|plain| (bf16: dS and P are rounded after sums taken in another order),
and in f32 at 9216 tokens to 2e-5 as well, which catches an error that grows
with the length; in bf16 also to 2^-6 of max|plain| and a mean abs error of
2e-5 of max|plain|, which sees dS left unrounded and dK/dV summed through
bf16 per tile where the max bars do not (tests/test_torch_flash_bwd_bf16.py).
The int8 kernels: K5 1e-4 of max|plain| in f32 and 6e-2 absolute in bf16,
K6 1e-4 (f32) and 2e-2 (bf16) of max|plain| (both take every f32 step as one
rounded operation, as their plain versions; bf16 rounds the output), and K5
and K6 at d=512 also 0.0: their int32 sums are exact in any order and their
f32 steps are the plain version's, so their output is the plain version's
bits. The
int8 convolution's int32 sums are exact: card and CPU agree bit for bit.
K8, the fused GroupNorm -> SiLU -> conv3x3: 1e-4 (f32) and 2e-2 (bf16) of
max|plain|, over the whole output and over its border pixels alone (the
kernel and its plain version sum 9*C products in another order; in bf16 an
activated input that rounds the other way moves a sum by one bf16 ulp of
that input); in f32 also 2e-5 of max|plain|: the body runs split TF32 on
wgmma, and a single TF32 pass (~3e-4) or one tensor-core accumulator over
all of K = 9*C (3.7e-5 at C = 512) reads past it
(tests/test_torch_fused_conv_f32.py); in bf16 also 2^-6 of max|plain| and a
mean abs error of 1e-5 of max|plain|, whole output and border: a halo zeroed
before the transform or a dropped tap or chunk reads past the max bars, a
running sum that passes through bf16 after each chunk past the mean bar
(tests/test_torch_fused_conv_bf16.py). K7, the W8A8 conv3x3: bit-identical
to its plain version.
The profiling scripts' kernels: S1, S3 and S4 2e-2 of max|plain|. S1 and
S3 are K1's function at other CTA tiles: p is rounded against the running
max, in the plain version against the global max. S4 (no running max)
rounds p once from the same f32 logits, up to summation order. S2, the bf16
softmax chain, takes each bf16 step as one rounded operation and its
exponential as an f32 exp rounded once, on the same key partition as its
plain version: the two differ only in the order of f32 sums, so an output
moves by one bf16 ulp at most, 2^-7 of max|plain| (its max bar), and only
where a sum lies at a rounding midpoint, so the mean abs error stays far
under 1e-4 of max|plain| (its mean bar). K1's f32 chain, or S2's over
another key partition, reads a mean of 4e-4 to 9e-4 of max|plain| against
S2's plain version at 1000-9216 keys on the CPU, past the mean bar
(tests/test_torch_flash_variants.py holds them apart). K6 at d=64 is held
as at d=512, K2 at C=640 and 1280 (bf16) as at C=320.
"""

import numpy as np
import pytest
import torch

from genpercept_tpu_torch.ops import flash_attention as fa
from genpercept_tpu_torch.ops import fused_conv as fc
from genpercept_tpu_torch.ops import fused_ff as ff
from genpercept_tpu_torch.ops import quant as tq
from genpercept_tpu_torch.ops import quant_conv as qc
from genpercept_tpu_torch.ops import reference_kernels

pytestmark = pytest.mark.cuda

K1_BF16_REL = 2.0 ** -6  # K1's bf16 output, of max|plain|
K1_F32_LONG_REL = 2e-5  # K1's f32 output at 9216 keys, of max|plain|
K2_F32_REL = 2e-5  # K2's f32 output, of max|plain|
K8_F32_REL = 2e-5  # K8's f32 output and its border pixels, of max|plain|
K8_BF16_REL = 2.0 ** -6  # K8's bf16 output and its border pixels, of max|plain|
K8_BF16_MEAN_REL = 1e-5  # K8's bf16 mean abs error, whole and border, of max|plain|
K2_BF16_REL = 2.0 ** -6  # K2's bf16 output, of max|plain|
K2_BF16_MEAN_REL = 1e-5  # K2's bf16 mean abs error, of max|plain|
K34_BF16_REL = 2.0 ** -6  # K3/K4's bf16 outputs, of max|plain|
K34_BF16_MEAN_REL = 2e-5  # K3/K4's bf16 mean abs error, of max|plain|


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("bh,sq,sk,d", [
    (2, 256, 256, 64), (3, 200, 77, 64), (1, 130, 300, 64),
    (2, 100, 150, 512), (1, 300, 200, 512),
    (40, 4800, 4800, 64), (8, 4800, 4800, 512),  # the training recipe's
    # ragged: a partial last key tile (its columns take the -1e30 logit) and
    # q rows past Sq (computed on zeros, not stored): JAX's padded-KV test
    # (tests/test_ops.py:265, 2 x 3 heads, 77 keys), and d=512 at a length
    # that is no multiple of 32 keys or of a q tile
    (6, 256, 77, 64), (2, 1000, 1000, 512),
    # the bf16 d=64 body's tile edges: fewer q rows than one warpgroup's 64
    # with keys over several key tiles (the last partial), and both lengths
    # off the tiles (TMA fills rows past Sq and Sk with zeros)
    (4, 40, 300, 64), (2, 4800, 1000, 64),
    # and the d=512 body's: fewer q rows than its 64 with keys over several
    # 128-key tiles, and keys off the tile and no multiple of 8
    (2, 40, 300, 512), (1, 300, 77, 512),
])
def test_flash_kernel_matches_plain(gen, bh, sq, sk, d, dtype, tol):
    q = torch.randn(bh, sq, d, device="cuda", generator=gen).to(dtype)
    k, v = (torch.randn(bh, sk, d, device="cuda", generator=gen).to(dtype)
            for _ in range(2))
    before = fa._flash_bhsd.launches
    out, lse = fa._flash_bhsd(q, k, v, d ** -0.5)
    ref, ref_lse = fa._flash_bhsd_ref(q, k, v, d ** -0.5)
    torch.cuda.synchronize()
    assert fa._flash_bhsd.launches == before + 1
    assert out.dtype == dtype and lse.shape == (bh, sq, 1)
    err, top = (out.float() - ref.float()).abs().max().item(), ref.float().abs().max().item()
    assert err <= tol
    assert dtype == torch.float32 or err <= K1_BF16_REL * top, (err, top)
    assert (lse - ref_lse).abs().max().item() <= tol


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 6e-2)])
@pytest.mark.parametrize("rows", [512, 96, 1000, 8 * 4800])  # last: the training recipe's
def test_fused_ff_kernel_matches_plain(gen, rows, dtype, tol):
    c, inner = 320, 1280
    x = torch.randn(1, rows, c, device="cuda", generator=gen).to(dtype)
    w1 = ((torch.rand(2 * inner, c, device="cuda", generator=gen) * 2 - 1) / c ** 0.5).to(dtype)
    b1 = torch.randn(2 * inner, device="cuda", generator=gen) * 0.1
    w2 = ((torch.rand(c, inner, device="cuda", generator=gen) * 2 - 1) / inner ** 0.5).to(dtype)
    y = ff.fused_geglu_ff(x, w1, b1, w2, None)
    ref = ff._fused_geglu_ff_ref(x, w1, b1, w2, None)
    torch.cuda.synchronize()
    diff = (y.float() - ref.float()).abs()
    err, top = diff.max().item(), ref.float().abs().max().item()
    assert err <= tol
    if dtype == torch.float32:
        assert err <= K2_F32_REL * top
    else:
        assert err <= K2_BF16_REL * top and diff.mean().item() <= K2_BF16_MEAN_REL * top


def _ff_f32_inputs(gen, rows):
    c, inner = 320, 1280
    x = torch.randn(1, rows, c, device="cuda", generator=gen)
    w1 = (torch.rand(2 * inner, c, device="cuda", generator=gen) * 2 - 1) / c ** 0.5
    b1 = torch.randn(2 * inner, device="cuda", generator=gen) * 0.1
    w2 = (torch.rand(c, inner, device="cuda", generator=gen) * 2 - 1) / inner ** 0.5
    b2 = torch.randn(c, device="cuda", generator=gen) * 0.1
    return x, w1, b1, w2, b2


def test_fused_ff_f32_body_is_split_tf32(gen):
    """K2's f32 body runs its three products on the tensor cores through
    split TF32 (3xTF32 mma.sync), which the library names."""
    from genpercept_tpu_torch import _build
    assert _build.load().fused_geglu_ff_f32_body().decode().startswith("split TF32")


@pytest.mark.parametrize("rows", [9216, 2 * 9216, 8 * 4800])  # an image, the batch of 2, the recipe
def test_fused_ff_f32_matches_plain_and_repeats_bit_for_bit(gen, rows):
    """K2's f32 body at the main paths' row counts: within 2e-5 of max|plain|
    (and the shared 1e-4), and two calls give the same bits. At 9216 rows a
    row block's inner dimension is split over two CTAs whose outputs are
    added into zeros by atomics: two addends onto zero land on the same bits
    in either order."""
    args = _ff_f32_inputs(gen, rows)
    before = ff._fused_geglu_ff_fwd.launches
    first = ff.fused_geglu_ff(*args)
    second = ff.fused_geglu_ff(*args)
    ref = ff._fused_geglu_ff_ref(*args)
    torch.cuda.synchronize()
    assert ff._fused_geglu_ff_fwd.launches == before + 2
    assert torch.equal(first, second)
    err = (first - ref).abs().max().item()
    assert err <= 1e-4 and err <= K2_F32_REL * ref.abs().max().item(), err


def test_fused_ff_bf16_body_is_wgmma(gen):
    """K2's bf16 body at C=320 runs its three products on wgmma, which the
    library names."""
    from genpercept_tpu_torch import _build
    assert _build.load().fused_geglu_ff_bf16_body().decode().startswith("wgmma")


@pytest.mark.parametrize("rows", [96, 1000, 2 * 9216, 8 * 4800])
def test_fused_ff_bf16_repeats_bit_for_bit(gen, rows):
    """No atomics, a fixed order of products and sums, and where the walk
    splits a row block, its f32 parts combined in the order of the CTAs: two
    calls of K2's bf16 body on the same inputs give the same bits, within
    the three bars of the plain version."""
    x, w1, b1, w2, b2 = _ff_f32_inputs(gen, rows)
    args = (x.to(torch.bfloat16), w1.to(torch.bfloat16), b1, w2.to(torch.bfloat16), b2)
    first = ff.fused_geglu_ff(*args)
    second = ff.fused_geglu_ff(*args)
    ref = ff._fused_geglu_ff_ref(*args)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    diff = (first.float() - ref.float()).abs()
    err, top = diff.max().item(), ref.float().abs().max().item()
    assert err <= 6e-2 and err <= K2_BF16_REL * top, (err, top)
    assert diff.mean().item() <= K2_BF16_MEAN_REL * top, (diff.mean().item(), top)


def _bwd_inputs(gen, bh, sq, sk, d, dtype):
    q, do = (torch.randn(bh, sq, d, device="cuda", generator=gen).to(dtype) for _ in range(2))
    k, v = (torch.randn(bh, sk, d, device="cuda", generator=gen).to(dtype) for _ in range(2))
    out, lse = fa._flash_bhsd(q, k, v, d ** -0.5)
    dsum = (do.float() * out.float()).sum(dim=-1, keepdim=True)
    return q, k, v, do, lse, dsum, d ** -0.5


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("bh,sq,sk,d", [
    (2, 256, 256, 64), (3, 200, 77, 64), (1, 130, 300, 64),
    (2, 100, 150, 512), (1, 300, 200, 512),
    (40, 4800, 4800, 64), (8, 4800, 4800, 512),  # the training recipe's
    # K4's bf16 d=64 body reads lse2/dsum of 64 queries from a flat map over
    # BH * Sq values: Sq = 77 puts a head's first column off 16 bytes
    (3, 77, 200, 64),
    # the bf16 d=512 body's too (64-query tiles, the same maps), and K3 at
    # fewer rows than its 64-row CTA
    (1, 77, 200, 512), (2, 40, 300, 512),
])
def test_flash_bwd_kernels_match_plain(gen, bh, sq, sk, d, dtype, tol):
    args = _bwd_inputs(gen, bh, sq, sk, d, dtype)
    before = (fa._flash_bwd_dq.launches, fa._flash_bwd_dkv.launches)
    dq = fa._flash_bwd_dq(*args)
    dk, dv = fa._flash_bwd_dkv(*args)
    ref = fa._flash_bwd_bhsd_ref(*args)
    torch.cuda.synchronize()
    assert (fa._flash_bwd_dq.launches, fa._flash_bwd_dkv.launches) == (before[0] + 1,
                                                                       before[1] + 1)
    for a, b in zip((dq, dk, dv), ref):
        assert a.dtype == dtype and a.shape == b.shape
        diff, top = (a.float() - b.float()).abs(), b.float().abs().max().item()
        assert diff.max().item() <= tol * top
        if dtype == torch.bfloat16:
            assert diff.max().item() <= K34_BF16_REL * top, (diff.max().item(), top)
            assert diff.mean().item() <= K34_BF16_MEAN_REL * top, (diff.mean().item(), top)


def test_flash_bwd_bf16_d64_body_is_wgmma(gen):
    """K3/K4's bf16 body at d=64 runs its products on wgmma, which the
    library names."""
    from genpercept_tpu_torch import _build
    assert _build.load().flash_attn_bwd_bf16_body().decode().startswith("wgmma")


def test_flash_bwd_bf16_d512_body_is_wgmma(gen):
    """K3/K4's bf16 body at d=512 runs its products on wgmma, which the
    library names."""
    from genpercept_tpu_torch import _build
    assert _build.load().flash_attn_bwd_bf16_d512_body().decode().startswith("wgmma")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bh,sq,sk,d", [(3, 200, 77, 64), (1, 300, 200, 512),
                                        (8, 1200, 1200, 64), (40, 4800, 4800, 64),
                                        (8, 4800, 4800, 512), (2, 9216, 9216, 512)])
def test_flash_bwd_kernels_repeat_bit_for_bit(gen, bh, sq, sk, d, dtype):
    """No atomics: every output element is summed by one thread in one
    order, so two calls on the same inputs give the same bits."""
    args = _bwd_inputs(gen, bh, sq, sk, d, dtype)
    first = (fa._flash_bwd_dq(*args), *fa._flash_bwd_dkv(*args))
    second = (fa._flash_bwd_dq(*args), *fa._flash_bwd_dkv(*args))
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("bh,s,d", [(10, 9216, 64), (2, 9216, 512)])  # chip_smoke.K34_768's longest
def test_flash_bwd_f32_error_stays_flat_at_length(gen, bh, s, d):
    """The f32 body sums each column tile's output products in accumulators
    of its own: the tensor cores round every sum into an accumulator toward
    zero, and with one accumulator over the column loop the error grew with
    the length (1.2e-4 / 1.1e-4 of max|plain| at 9216 tokens, d=64 / 512,
    against 2.0e-6-6.9e-6 per tile). Held to 2e-5 of max|plain| here, a fifth
    of the shared bar, which per-tile sums keep and one accumulator does not
    (tests/test_torch_flash_f32.py models both)."""
    args = _bwd_inputs(gen, bh, s, s, d, torch.float32)
    got = (fa._flash_bwd_dq(*args), *fa._flash_bwd_dkv(*args))
    ref = fa._flash_bwd_bhsd_ref(*args)
    torch.cuda.synchronize()
    for a, b in zip(got, ref):
        assert (a - b).abs().max().item() <= 2e-5 * b.abs().max().item()


@pytest.mark.parametrize("bh,s,d", [(5, 9216, 64), (1, 9216, 512)])  # chip_smoke.K1_SHAPES' longest
def test_flash_fwd_f32_error_stays_flat_at_length(gen, bh, s, d):
    """K1's f32 body sums each key tile's P V in accumulators of its own: the
    tensor cores round every sum into an accumulator toward zero, and with
    one accumulator over the key loop the error grew with the length (7.8e-5
    of max|plain| at 9216 keys, d=64 and 512). out held to 2e-5 of
    max|plain| here, which per-tile sums keep and one accumulator does not
    (tests/test_torch_flash_f32.py models both); lse2 to the shared 1e-4."""
    q, k, v = (torch.randn(bh, s, d, device="cuda", generator=gen) for _ in range(3))
    out, lse = fa._flash_bhsd(q, k, v, d ** -0.5)
    ref, ref_lse = fa._flash_bhsd_ref(q, k, v, d ** -0.5)
    torch.cuda.synchronize()
    assert (out - ref).abs().max().item() <= K1_F32_LONG_REL * ref.abs().max().item()
    assert (lse - ref_lse).abs().max().item() <= 1e-4


def test_flash_bf16_d64_body_is_wgmma(gen):
    """K1's bf16 body at d=64 runs both products on wgmma, which the library
    names."""
    from genpercept_tpu_torch import _build
    assert _build.load().flash_attn_fwd_bf16_body().decode().startswith("wgmma")


@pytest.mark.parametrize("bh,sq,sk", [(40, 4800, 4800), (6, 256, 77)])
def test_flash_bf16_d64_repeats_bit_for_bit(gen, bh, sq, sk):
    """No atomics and a fixed order of products and sums: two calls of K1's
    bf16 d=64 body on the same inputs give the same bits."""
    q = torch.randn(bh, sq, 64, device="cuda", generator=gen).to(torch.bfloat16)
    k, v = (torch.randn(bh, sk, 64, device="cuda", generator=gen).to(torch.bfloat16)
            for _ in range(2))
    first = fa._flash_bhsd(q, k, v, 0.125)
    second = fa._flash_bhsd(q, k, v, 0.125)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_flash_bf16_d512_body_is_wgmma(gen):
    """K1's bf16 body at d=512 runs both products on wgmma, which the library
    names."""
    from genpercept_tpu_torch import _build
    assert _build.load().flash_attn_fwd_bf16_d512_body().decode().startswith("wgmma")


@pytest.mark.parametrize("bh,sq,sk", [(8, 4800, 4800), (2, 1000, 1000)])
def test_flash_bf16_d512_repeats_bit_for_bit(gen, bh, sq, sk):
    """No atomics and a fixed order of products, sums and, where the key axis
    is split, of the combine pass: two calls of K1's bf16 d=512 body on the
    same inputs give the same bits."""
    q = torch.randn(bh, sq, 512, device="cuda", generator=gen).to(torch.bfloat16)
    k, v = (torch.randn(bh, sk, 512, device="cuda", generator=gen).to(torch.bfloat16)
            for _ in range(2))
    first = fa._flash_bhsd(q, k, v, 512 ** -0.5)
    second = fa._flash_bhsd(q, k, v, 512 ** -0.5)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_flash_bf16_d512_unequal_key_splits_match_plain(gen):
    """A grid of 133 q tiles splits the key axis (the scratch a call takes
    holds S f32 partial outputs and lse2), here 11 128-key tiles over S > 1
    splits of unequal length, the last tile partial (1300 keys, no multiple
    of 8) and the last q tile too: held to the plain version at K1's bars."""
    from genpercept_tpu_torch import _build
    bh, sq, sk = 1, 8500, 1300
    splits = _build.load().flash_attn_fwd_scratch_bytes(bh, sq, sk, 512, 1) // (
        bh * sq * 513 * 4)
    assert splits > 1 and 11 % splits, splits
    q = torch.randn(bh, sq, 512, device="cuda", generator=gen).to(torch.bfloat16)
    k, v = (torch.randn(bh, sk, 512, device="cuda", generator=gen).to(torch.bfloat16)
            for _ in range(2))
    out, lse = fa._flash_bhsd(q, k, v, 512 ** -0.5)
    ref, ref_lse = fa._flash_bhsd_ref(q, k, v, 512 ** -0.5)
    torch.cuda.synchronize()
    err, top = (out.float() - ref.float()).abs().max().item(), ref.float().abs().max().item()
    assert err <= 2e-2 and err <= K1_BF16_REL * top, (err, top)
    assert (lse - ref_lse).abs().max().item() <= 2e-2


def test_flash_f32_bodies_are_split_tf32(gen):
    """K1's and K3/K4's f32 bodies run on the tensor cores through split
    TF32 (3xTF32 mma.sync), which the library names."""
    from genpercept_tpu_torch import _build
    lib = _build.load()
    assert lib.flash_attn_fwd_f32_body().decode().startswith("split TF32")
    assert lib.flash_attn_bwd_f32_body().decode().startswith("split TF32")


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
def test_wrappers_carry_gradients_on_the_card(gen, dtype, tol):
    """Autograd through both wrappers on CUDA tensors (K1-K4) equals the same
    computation under reference_kernels(): before the wrappers were autograd
    Functions, the kernels' outputs had no grad_fn and these gradients were
    dropped without an error."""
    q, k, v = (torch.randn(2, 2304, 3, 64, device="cuda", generator=gen).to(dtype)
               for _ in range(3))
    x = torch.randn(1, 1024, 320, device="cuda", generator=gen).to(dtype)
    w1 = ((torch.rand(2560, 320, device="cuda", generator=gen) * 2 - 1) / 320 ** 0.5).to(dtype)
    w2 = ((torch.rand(320, 1280, device="cuda", generator=gen) * 2 - 1) / 1280 ** 0.5).to(dtype)
    g_att = torch.randn(2, 2304, 3, 64, device="cuda", generator=gen).to(dtype)
    g_ff = torch.randn(1, 1024, 320, device="cuda", generator=gen).to(dtype)

    def grads():
        ins = [t.detach().clone().requires_grad_() for t in (q, k, v, x, w1, w2)]
        att = fa.flash_attention(*ins[:3])
        y = ff.fused_geglu_ff(ins[3], ins[4], None, ins[5], None)
        return torch.autograd.grad((att, y), ins, (g_att, g_ff))

    counts = (fa._flash_bhsd.launches, fa._flash_bwd_dq.launches, fa._flash_bwd_dkv.launches,
              ff._fused_geglu_ff_fwd.launches)
    got = grads()
    after = (fa._flash_bhsd.launches, fa._flash_bwd_dq.launches, fa._flash_bwd_dkv.launches,
             ff._fused_geglu_ff_fwd.launches)
    assert [b - a for a, b in zip(counts, after)] == [1, 1, 1, 1]
    with reference_kernels():  # forward and backward: the backward runs on
        want = grads()          # the autograd engine's own device thread
    assert (fa._flash_bhsd.launches, fa._flash_bwd_dq.launches, fa._flash_bwd_dkv.launches,
            ff._fused_geglu_ff_fwd.launches) == after
    for a, b in zip(got, want):
        assert bool(torch.isfinite(a).all()) and a.abs().max().item() > 0
        assert (a.float() - b.float()).abs().max().item() <= tol * b.float().abs().max().item()


def test_kernels_refuse_what_they_do_not_take(gen):
    x = torch.zeros(1, 64, 64, device="cuda", dtype=torch.float16)
    with pytest.raises(ValueError):
        fa._flash_bhsd(x, x, x, 0.125)
    for d in (96, 128, 256):  # no kernel body outside SD2.1's head dims
        y = torch.zeros(1, 64, d, device="cuda")
        with pytest.raises(ValueError):
            fa._flash_bhsd(y, y, y, 0.1)
    q = torch.zeros(1, 64, 128, device="cuda")
    with pytest.raises(ValueError):
        fa._flash_bwd_dq(q, q, q, q, q[..., :1], q[..., :1], 0.1)
    with pytest.raises(ValueError):
        fa._flash_bwd_dkv(x, x, x, x, x[..., :1].float(), x[..., :1].float(), 0.125)
    flat = torch.zeros(64 * 64 + 1, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte"):  # a base 2 bytes off: TMA takes none
        fa._flash_bhsd(flat[1:].view(1, 64, 64), flat[:-1].view(1, 64, 64),
                       flat[:-1].view(1, 64, 64), 0.125)
    z = torch.zeros(1, 512, 640, device="cuda")
    with pytest.raises(ValueError):  # f32 has a body at C=320 only
        ff.fused_geglu_ff(z, torch.zeros(5120, 640, device="cuda"), None,
                          torch.zeros(640, 2560, device="cuda"), None)
    zb = z.to(torch.bfloat16)  # bf16 runs at C=640
    y = ff.fused_geglu_ff(zb, torch.zeros(5120, 640, device="cuda", dtype=torch.bfloat16),
                          None, torch.zeros(640, 2560, device="cuda", dtype=torch.bfloat16),
                          None)
    torch.cuda.synchronize()
    assert y.shape == zb.shape and not y.float().abs().max().item()
    w = torch.zeros(1, 512, 96, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError):  # no body at C=96
        ff.fused_geglu_ff(w, torch.zeros(768, 96, device="cuda", dtype=torch.bfloat16), None,
                          torch.zeros(96, 384, device="cuda", dtype=torch.bfloat16), None)


def test_reference_kernels_launch_nothing(gen):
    q = torch.randn(1, 576, 2, 64, device="cuda", generator=gen)
    before = fa._flash_bhsd.launches
    with reference_kernels():
        fa.flash_attention(q, q, q)
    assert fa._flash_bhsd.launches == before


def test_tiny_pipeline_on_card_matches_cpu(gen):
    """The whole slice at tiny width on the card (kernels where routed) equals
    the same port on the CPU (plain versions)."""
    from genpercept_tpu_torch.models import (
        AutoencoderKL, UNet2DConditionModel, UNetConfig, VAEConfig, init_params_)
    from genpercept_tpu_torch.pipeline import (
        GenPerceptModels, GenPerceptPipeline, PipelineConfig)

    def pipe(device):
        g = torch.Generator().manual_seed(1)
        unet = init_params_(UNet2DConditionModel(UNetConfig(
            block_out_channels=(64, 64, 128, 128), attention_heads=(1, 1, 2, 2),
            cross_attention_dim=48)), g)
        vae = init_params_(AutoencoderKL(VAEConfig(block_out_channels=(32, 32, 64, 64))), g)
        embed = torch.randn(1, 77, 48, generator=g)
        return GenPerceptPipeline(GenPerceptModels(unet, vae, text_embed=embed),
                                  PipelineConfig(processing_res=512), device=device)

    img = (np.random.default_rng(0).uniform(size=(300, 400, 3)) * 255).astype(np.uint8)
    before = fa._flash_bhsd.launches
    on_card = pipe("cuda")(img).pred_np
    # 384x512 -> 48x64 latent: 3072 tokens of head dim 64 in the five
    # level-0 transformers and the two VAE mid blocks
    assert fa._flash_bhsd.launches - before == 7
    on_cpu = pipe("cpu")(img).pred_np
    assert float(np.mean(np.abs(on_card - on_cpu))) <= 1e-4


def _ff_trees(gen, c, asym, dtype, x):
    inner = 4 * c
    w1 = ((torch.rand(2 * inner, c, device="cuda", generator=gen) * 2 - 1) / c ** 0.5).to(dtype)
    b1 = torch.randn(2 * inner, device="cuda", generator=gen) * 0.1
    w2 = ((torch.rand(c, inner, device="cuda", generator=gen) * 2 - 1) / inner ** 0.5).to(dtype)
    stat = tq.mse_optimal_clip_asym if asym else tq.absmax_per_channel
    qh = tq.quantize_dense(w1[:inner], b1[:inner], stat(x))
    qg = tq.quantize_dense(w1[inner:], b1[inner:], stat(x))
    a = tq.qdense_apply(qh, x) * torch.nn.functional.gelu(tq.qdense_apply(qg, x))
    return qh, qg, tq.quantize_dense(w2, None, stat(a))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("asym", [False, True])
@pytest.mark.parametrize("c,rows", [(320, 512), (320, 1000), (640, 256), (640, 96),
                                    (320, 18432), (640, 4608)])  # last two: 768^2, batch 2
def test_fused_ff_int8_kernel_matches_plain(gen, c, rows, asym, dtype):
    x = (torch.randn(1, rows, c, device="cuda", generator=gen) + 0.3).to(dtype)
    trees = _ff_trees(gen, c, asym, dtype, x)
    before = ff.fused_geglu_ff_int8.launches
    y = ff.fused_geglu_ff_int8(x, *trees)
    with reference_kernels():
        ref = ff.fused_geglu_ff_int8(x, *trees)
    torch.cuda.synchronize()
    assert ff.fused_geglu_ff_int8.launches == before + 1
    assert y.dtype == dtype and y.shape == x.shape
    err = (y.float() - ref.float()).abs().max().item()
    bar = 1e-4 * ref.float().abs().max().item() if dtype == torch.float32 else 6e-2
    assert err <= bar


def test_fused_ff_int8_body_is_wgmma(gen):
    """K5 runs its three products on int8 wgmma, which the library names."""
    from genpercept_tpu_torch import _build
    assert _build.load().fused_geglu_ff_int8_body().decode().startswith("wgmma")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("asym", [False, True])
@pytest.mark.parametrize("c,rows", [(320, 18432), (640, 4608), (320, 1000), (640, 96)])
def test_fused_ff_int8_bit_for_bit(gen, c, rows, asym, dtype):
    """K5 gives its plain version's bits (error 0.0), and a second call the
    same bits, at the 768^2 forward's shapes and ragged ones: its int32
    sums are exact in any order and split, and each f32 step is the plain
    version's rounded operation (erf's division included). Tightens, and
    does not replace, test_fused_ff_int8_kernel_matches_plain."""
    x = (torch.randn(1, rows, c, device="cuda", generator=gen) + 0.3).to(dtype)
    trees = _ff_trees(gen, c, asym, dtype, x)
    y = ff.fused_geglu_ff_int8(x, *trees)
    again = ff.fused_geglu_ff_int8(x, *trees)
    with reference_kernels():
        ref = ff.fused_geglu_ff_int8(x, *trees)
    torch.cuda.synchronize()
    assert (y.float() - ref.float()).abs().max().item() == 0.0
    assert torch.equal(y, again)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bh,sq,sk,d", [(1, 100, 1024, 512), (2, 512, 2048, 512),
                                        (1, 6912, 6912, 512), (2, 9216, 9216, 512),
                                        (1, 100, 1536, 64), (2, 512, 2048, 64),
                                        (1, 2304, 2304, 64), (10, 9216, 9216, 64)])
def test_flash_int8_kernel_matches_plain(gen, bh, sq, sk, d, dtype):
    """K6 against its plain version on the same int8 operands; (2, 512, 2048)
    spans two k blocks of 1024, the 768^2 shape six of 1536; at d=64 2304
    keys are one block of 2304 and the script's (10, 9216, 64) six of 1536."""
    q = (torch.randn(bh, sq, d, device="cuda", generator=gen) * 0.5).to(dtype)
    k = (torch.randn(bh, sk, d, device="cuda", generator=gen) * 0.5).to(dtype)
    v = torch.randn(bh, sk, d, device="cuda", generator=gen).to(dtype)
    ops = fa.int8_operands(q, k, v)
    k_blk = fa._int8_k_block(sq, sk, d)
    before = fa._flash_int8_codes.launches
    out = fa._flash_int8_codes(*ops, d ** -0.5, k_blk, dtype)
    ref = fa._flash_int8_ref(*ops, d ** -0.5, k_blk, dtype)
    torch.cuda.synchronize()
    assert fa._flash_int8_codes.launches == before + 1
    assert out.dtype == dtype and out.shape == (bh, sq, d)
    err = (out.float() - ref.float()).abs().max().item()
    bar = (1e-4 if dtype == torch.float32 else 2e-2) * ref.float().abs().max().item()
    assert err <= bar


def test_flash_int8_d512_body_is_wgmma(gen):
    """K6's body at d=512 runs both products on int8 wgmma, which the library
    names."""
    from genpercept_tpu_torch import _build
    assert _build.load().flash_attn_int8_d512_body().decode().startswith("wgmma")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bh,sq,sk,k_blk", [
    (1, 100, 1024, None), (2, 512, 2048, None), (1, 6912, 6912, None), (2, 9216, 9216, None),
    (1, 130, 1152, 576), (2, 200, 1728, None), (1, 70, 256, 64), (1, 64, 64, None)])
def test_flash_int8_d512_bit_for_bit(gen, bh, sq, sk, k_blk, dtype):
    """K6's d=512 body gives its plain version's bits (error 0.0) at the
    existing d=512 cases and at k blocks that end on a 64-key tile (576: the
    wrapper's at 1728 keys, and forced at 1152) or are one (64), with rows
    past Sq: the max pass, the recompute and the parked output are the same
    function."""
    q = (torch.randn(bh, sq, 512, device="cuda", generator=gen) * 0.5).to(dtype)
    k = (torch.randn(bh, sk, 512, device="cuda", generator=gen) * 0.5).to(dtype)
    v = torch.randn(bh, sk, 512, device="cuda", generator=gen).to(dtype)
    ops = fa.int8_operands(q, k, v)
    k_blk = k_blk or fa._int8_k_block(sq, sk, 512)
    if sk == 1728:
        assert k_blk == 576
    out = fa._flash_int8_codes(*ops, 512 ** -0.5, k_blk, dtype)
    ref = fa._flash_int8_ref(*ops, 512 ** -0.5, k_blk, dtype)
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == (bh, sq, 512)
    assert (out.float() - ref.float()).abs().max().item() == 0.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_int8_d512_repeats_bit_for_bit(gen, dtype):
    """Two calls of K6 at the pipeline's (2, 9216, 512) give the same bits:
    nothing in the body depends on the order in which CTAs or warpgroups
    run."""
    q, k, v = (torch.randn(2, 9216, 512, device="cuda", generator=gen).to(dtype)
               for _ in range(3))
    ops = fa.int8_operands(q, k, v)
    k_blk = fa._int8_k_block(9216, 9216, 512)
    first = fa._flash_int8_codes(*ops, 512 ** -0.5, k_blk, dtype)
    second = fa._flash_int8_codes(*ops, 512 ** -0.5, k_blk, dtype)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.parametrize("asym", [False, True])
@pytest.mark.parametrize("kind,stride,padding", [
    ("3x3", 1, 1), ("3x3", 2, ((0, 1), (0, 1))), ("3x3", 2, 1), ("up4x4", 1, 1)])
def test_qconv_on_card_matches_cpu(gen, kind, stride, padding, asym):
    """The int8 convolution (im2col + torch._int_mm, cuBLASLt) on the card
    equals the same function on the CPU bit for bit."""
    x = torch.randn(2, 64, 19, 24, device="cuda", generator=gen)
    w = torch.randn(128, 64, 3, 3, device="cuda", generator=gen) * 0.05
    b = torch.randn(128, device="cuda", generator=gen) * 0.1
    stat = (tq.mse_optimal_clip_asym if asym else tq.mse_optimal_clip)(x.movedim(1, -1))
    q = tq.quantize_conv(w, b, stat, kind=kind, stride=stride, padding=padding)
    on_card = tq.qconv_apply(q, x)
    q_cpu = tq.QConv(*(t.cpu() if isinstance(t, torch.Tensor) else t
                       for t in (q.w_int8, q.inv_a, q.o_scale, q.bias, q.kind, q.stride,
                                 q.padding, q.zp)))
    assert torch.equal(on_card.cpu(), tq.qconv_apply(q_cpu, x.cpu()))


def test_int8_pipeline_launches_on_card(gen):
    """A small int8 pipeline (the slice's config) whose widths route the
    kernels: C=320/640 UNet levels (K5), a 512-wide VAE mid block (K6),
    4096 tokens at level 0 (K1). The first call calibrates; one later forward
    launches K1 5, K5 10, K6 2 and K2 0 times, and agrees with the same
    calibration under reference_kernels() to 1e-2 mean |depth|."""
    from genpercept_tpu_torch.models import (
        AutoencoderKL, UNet2DConditionModel, UNetConfig, VAEConfig, init_params_)
    from genpercept_tpu_torch.pipeline import (
        GenPerceptModels, GenPerceptPipeline, PipelineConfig)

    g = torch.Generator().manual_seed(2)
    unet = init_params_(UNet2DConditionModel(UNetConfig(
        block_out_channels=(320, 640, 128, 128), attention_heads=(5, 10, 2, 2),
        cross_attention_dim=48)), g)
    vae = init_params_(AutoencoderKL(VAEConfig(block_out_channels=(32, 32, 64, 512))), g)
    cfg = PipelineConfig(processing_res=512, int8_vae=True, int8_unet=True, int8_unet_ff=True,
                         int8_vae_attn=True)
    pipe = GenPerceptPipeline(GenPerceptModels(unet, vae, text_embed=torch.randn(1, 77, 48,
                                                                               generator=g)),
                              cfg)
    img = (np.random.default_rng(1).uniform(size=(512, 512, 3)) * 255).astype(np.uint8)
    pipe(img)
    assert pipe.int8_mean_dev is not None
    names = ("_flash_bhsd", "_fused_geglu_ff_fwd", "fused_geglu_ff_int8", "_flash_int8_codes")
    mods = (fa, ff, ff, fa)
    before = [getattr(m, n).launches for m, n in zip(mods, names)]
    out = pipe(img).pred_np
    after = [getattr(m, n).launches for m, n in zip(mods, names)]
    assert [b - a for a, b in zip(before, after)] == [5, 0, 10, 2]
    with reference_kernels():
        ref = pipe(img).pred_np
    assert np.isfinite(out).all()
    assert float(np.mean(np.abs(out - ref))) <= 1e-2


def _border(t):
    """The outermost rows and columns of an NCHW tensor, flattened."""
    return torch.cat([t[..., 0, :], t[..., -1, :], t[..., :, 0], t[..., :, -1]], dim=-1)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("n,c,h,w,co,res", [
    (2, 128, 16, 24, 128, False), (1, 128, 20, 40, 256, True),  # ragged tiles
    (1, 256, 72, 96, 128, True), (2, 512, 16, 16, 512, False),
    (2, 128, 96, 96, 128, True),
    (2, 512, 96, 96, 512, True),  # K = 9 * 512 = 4608 terms a sum
])
def test_fused_conv_kernel_matches_plain(gen, n, c, h, w, co, res, dtype, tol):
    x = (torch.randn(n, c, h, w, device="cuda", generator=gen) * 2 + 0.5).to(dtype)
    gs, gb = (torch.randn(c, device="cuda", generator=gen) for _ in range(2))
    cw = (torch.randn(co, c, 3, 3, device="cuda", generator=gen) * (9 * c) ** -0.5).to(dtype)
    cb = torch.randn(co, device="cuda", generator=gen) * 0.1
    r = torch.randn(n, co, h, w, device="cuda", generator=gen).to(dtype) if res else None
    before = fc.fused_gn_silu_conv3x3.launches
    out = fc.fused_gn_silu_conv3x3(x, gs, gb, cw, cb, residual=r)
    with reference_kernels():
        ref = fc.fused_gn_silu_conv3x3(x, gs, gb, cw, cb, residual=r)
    torch.cuda.synchronize()
    assert fc.fused_gn_silu_conv3x3.launches == before + 1
    assert out.dtype == dtype and out.shape == (n, co, h, w)
    scale = ref.float().abs().max().item()
    tol = min(tol, K8_F32_REL if dtype == torch.float32 else K8_BF16_REL)
    d = (out.float() - ref.float()).abs()
    d_border = (_border(out.float()) - _border(ref.float())).abs()
    assert d.max().item() <= tol * scale
    assert d_border.max().item() <= tol * scale
    if dtype == torch.bfloat16:
        assert d.mean().item() <= K8_BF16_MEAN_REL * scale
        assert d_border.mean().item() <= K8_BF16_MEAN_REL * scale


def test_fused_conv_bf16_body_is_wgmma(gen):
    """K8's bf16 body runs its products on wgmma, which the library names."""
    from genpercept_tpu_torch import _build
    body = _build.load().fused_gn_silu_conv3x3_bf16_body().decode()
    assert body.startswith("wgmma"), body


@pytest.mark.parametrize("n,c,h,w,co", [(1, 128, 20, 40, 256), (2, 128, 96, 96, 128),
                                        (2, 512, 96, 96, 512)])
def test_fused_conv_bf16_repeats_bit_for_bit(gen, n, c, h, w, co):
    """No atomics on the output and a fixed order of sums: two calls of K8's
    bf16 body give the same bits (both tiles: 16 x 16 x 128 at Co = 128,
    8 x 16 x 256 else)."""
    x = (torch.randn(n, c, h, w, device="cuda", generator=gen) * 2 + 0.5).to(torch.bfloat16)
    gs, gb = (torch.randn(c, device="cuda", generator=gen) for _ in range(2))
    cw = (torch.randn(co, c, 3, 3, device="cuda", generator=gen) * (9 * c) ** -0.5) \
        .to(torch.bfloat16)
    cb = torch.randn(co, device="cuda", generator=gen) * 0.1
    r = torch.randn(n, co, h, w, device="cuda", generator=gen).to(torch.bfloat16)
    first = fc.fused_gn_silu_conv3x3(x, gs, gb, cw, cb, residual=r)
    second = fc.fused_gn_silu_conv3x3(x, gs, gb, cw, cb, residual=r)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def test_fused_conv_f32_body_is_split_tf32(gen):
    """K8's f32 body runs its products on the tensor cores through split
    TF32 on wgmma, which the library names."""
    from genpercept_tpu_torch import _build
    body = _build.load().fused_gn_silu_conv3x3_f32_body().decode()
    assert body.startswith("split TF32") and "wgmma" in body, body


@pytest.mark.parametrize("n,c,h,w,co", [(1, 128, 20, 40, 256), (2, 512, 96, 96, 512)])
def test_fused_conv_f32_repeats_bit_for_bit(gen, n, c, h, w, co):
    """No atomics on the output and a fixed order of sums: two calls give
    the same bits."""
    x = torch.randn(n, c, h, w, device="cuda", generator=gen) * 2 + 0.5
    gs, gb = (torch.randn(c, device="cuda", generator=gen) for _ in range(2))
    cw = torch.randn(co, c, 3, 3, device="cuda", generator=gen) * (9 * c) ** -0.5
    cb = torch.randn(co, device="cuda", generator=gen) * 0.1
    r = torch.randn(n, co, h, w, device="cuda", generator=gen)
    first = fc.fused_gn_silu_conv3x3(x, gs, gb, cw, cb, residual=r)
    second = fc.fused_gn_silu_conv3x3(x, gs, gb, cw, cb, residual=r)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,c,h,w,co", [
    (2, 128, 24, 16, 128), (1, 320, 24, 40, 320), (1, 256, 20, 24, 128),
    (2, 512, 96, 96, 512),
])
def test_quantized_conv_kernel_matches_plain(gen, n, c, h, w, co, dtype):
    x = torch.randn(n, c, h, w, device="cuda", generator=gen).to(dtype)
    wf = torch.randn(co, c, 3, 3, device="cuda", generator=gen) * 0.05
    b = torch.randn(co, device="cuda", generator=gen) * 0.1
    q = tq.quantize_conv(wf, b, tq.absmax_per_channel(x.movedim(1, -1)), margin=1.0)
    before = qc.quantized_conv3x3.launches
    out = qc.quantized_conv3x3(x, q.w_int8, q.inv_a, q.o_scale, q.bias)
    ref = qc._quantized_conv3x3_ref(x, q.w_int8, q.inv_a, q.o_scale, q.bias)
    torch.cuda.synchronize()
    assert qc.quantized_conv3x3.launches == before + 1
    assert out.dtype == dtype and out.shape == (n, co, h, w)
    assert torch.equal(out, ref)


def test_fused_resnet_block_on_card_matches_cpu(gen):
    """resnet_block(fused=True) at 128 -> 256 (the 1x1 shortcut as the second
    launch's residual): two launches, and the CPU's plain versions' output."""
    from genpercept_tpu_torch.models import layers as TL

    m = TL.init_params_(TL.ResnetBlock(128, 256, None), torch.Generator().manual_seed(3))
    x = torch.randn(2, 128, 32, 24, generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        ref = TL.resnet_block(m, x, None, eps=1e-6, fused=True)
        m.cuda()
        before = fc.fused_gn_silu_conv3x3.launches
        out = TL.resnet_block(m, x.cuda(), None, eps=1e-6, fused=True)
        torch.cuda.synchronize()
    assert fc.fused_gn_silu_conv3x3.launches == before + 2
    assert (out.cpu() - ref).abs().max().item() <= 1e-4 * ref.abs().max().item()


def test_fused_conv_refuses_gradients_on_card(gen):
    x = torch.randn(1, 128, 16, 16, device="cuda", generator=gen, requires_grad=True)
    w = torch.zeros(128, 128, 3, 3, device="cuda")
    one, zero = torch.ones(128, device="cuda"), torch.zeros(128, device="cuda")
    with pytest.raises(RuntimeError, match="inference only"):
        fc.fused_gn_silu_conv3x3(x, one, zero, w, zero)
    with pytest.raises(RuntimeError, match="inference only"):
        qc.quantized_conv3x3(x, w.to(torch.int8), one, one, zero)


@pytest.mark.parametrize("rows", [512, 96, 1000, 8 * 576])  # last: the script's C=1280 shape
@pytest.mark.parametrize("c", [640, 1280])
def test_fused_ff_wide_kernel_matches_plain(gen, c, rows):
    """K2's bf16 body at the UNet's level-1 and level-2 widths."""
    dtype, inner = torch.bfloat16, 4 * c
    x = torch.randn(1, rows, c, device="cuda", generator=gen).to(dtype)
    w1 = ((torch.rand(2 * inner, c, device="cuda", generator=gen) * 2 - 1) / c ** 0.5).to(dtype)
    b1 = torch.randn(2 * inner, device="cuda", generator=gen) * 0.1
    w2 = ((torch.rand(c, inner, device="cuda", generator=gen) * 2 - 1) / inner ** 0.5).to(dtype)
    b2 = torch.randn(c, device="cuda", generator=gen) * 0.1
    before = ff._fused_geglu_ff_fwd.launches
    y = ff.fused_geglu_ff(x, w1, b1, w2, b2)
    ref = ff._fused_geglu_ff_ref(x, w1, b1, w2, b2)
    torch.cuda.synchronize()
    assert ff._fused_geglu_ff_fwd.launches == before + 1
    assert y.dtype == dtype and y.shape == x.shape
    assert (y.float() - ref.float()).abs().max().item() <= 6e-2


def _bf16_qkv(gen, bh, sq, sk, d, scale=1.0):
    q = (torch.randn(bh, sq, d, device="cuda", generator=gen) * scale).to(torch.bfloat16)
    k, v = (torch.randn(bh, sk, d, device="cuda", generator=gen).to(torch.bfloat16)
            for _ in range(2))
    return q, k, v


@pytest.mark.parametrize("bh,sq,sk,d", [(2, 1000, 700, 64), (10, 2304, 2304, 64),
                                        (2, 300, 500, 512), (1, 2304, 2304, 512)])
def test_flash_tiled_kernels_match_plain(gen, bh, sq, sk, d):
    """S1 at every tile of its head dim (K1's function, fold = d <= 128) and
    S3 at every d=512 tile with either fold, against K1's plain version."""
    q, k, v = _bf16_qkv(gen, bh, sq, sk, d)
    ref = fa._flash_bhsd_ref(q, k, v, d ** -0.5)[0].float()
    runs = [(fa.flash_with_blocks, t, ()) for t in (fa.D64_TILES if d == 64 else fa.D512_TILES)]
    if d == 512:
        runs += [(fa.flash_d512_blocks, t, (fold,)) for t in fa.D512_TILES
                 for fold in (True, False)]
    for fn, (bq, bk), extra in runs:
        before = fn.launches
        out = fn(q, k, v, d ** -0.5, bq, bk, *extra)
        torch.cuda.synchronize()
        assert fn.launches == before + 1
        assert out.dtype == torch.bfloat16 and out.shape == q.shape
        err = (out.float() - ref).abs().max().item()
        assert err <= 2e-2 * ref.abs().max().item(), (fn.__name__, bq, bk, extra, err)


@pytest.mark.parametrize("bh,sq,sk", [(2, 1000, 700), (10, 2304, 2304)])
def test_flash_bf16_softmax_kernel_matches_plain(gen, bh, sq, sk):
    """S2 at every tile against its plain version over key blocks of the
    tile's keys: max abs error 2^-7 and mean 1e-4 of max|plain| (the module
    docstring)."""
    q, k, v = _bf16_qkv(gen, bh, sq, sk, 64)
    for bq, bk in fa.D64_TILES:
        ref = fa._flash_bf16_softmax_ref(q, k, v, 0.125, bk).float()
        before = fa.flash_bf16_softmax.launches
        out = fa.flash_bf16_softmax(q, k, v, 0.125, bq, bk)
        torch.cuda.synchronize()
        assert fa.flash_bf16_softmax.launches == before + 1
        assert out.dtype == torch.bfloat16 and out.shape == q.shape
        diff, top = (out.float() - ref).abs(), ref.abs().max().item()
        assert diff.max().item() <= 2.0 ** -7 * top, (bq, bk, diff.max().item())
        assert diff.mean().item() <= 1e-4 * top, (bq, bk, diff.mean().item())


@pytest.mark.parametrize("qscale", [1.0, 32.0])  # 32: logits past the clamp of 110
def test_flash_nomax_kernel_matches_plain(gen, qscale):
    q, k, v = _bf16_qkv(gen, 2, 1000, 700, 64, qscale)
    ref = fa._flash_nomax_ref(q, k, v, 0.125).float()
    if qscale > 1:
        assert (torch.matmul(q.float(), k.float().transpose(1, 2)) * 0.125
                * 1.4426950408889634 > 110).any()
    for bq, bk in fa.D64_TILES:
        before = fa.flash_nomax.launches
        out = fa.flash_nomax(q, k, v, 0.125, bq, bk)
        torch.cuda.synchronize()
        assert fa.flash_nomax.launches == before + 1
        err = (out.float() - ref).abs().max().item()
        assert torch.isfinite(out).all() and err <= 2e-2 * ref.abs().max().item(), (bq, bk, err)


def test_profiling_kernels_refuse_what_they_do_not_take(gen):
    """f32 inputs (the bodies are bf16 only), tiles outside the sets, head
    dims without a body, and K6 past its head dims or its logits buffer."""
    x32 = torch.zeros(1, 128, 64, device="cuda")
    xb = x32.to(torch.bfloat16)
    for fn in (fa.flash_with_blocks, fa.flash_bf16_softmax, fa.flash_nomax):
        with pytest.raises(ValueError):
            fn(x32, x32, x32, 0.125, 64, 64)
        with pytest.raises(ValueError):
            fn(xb, xb, xb, 0.125, 32, 64)
    y = torch.zeros(1, 128, 512, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        fa.flash_d512_blocks(y, y, y, 0.05, 64, 64, True)
    with pytest.raises(ValueError):
        fa.flash_d512_blocks(xb, xb, xb, 0.125, 16, 32, True)
    with pytest.raises(ValueError):
        fa.flash_bf16_softmax(y, y, y, 0.05, 64, 64)
    ops = fa.int8_operands(*(torch.zeros(1, 4608, 64, device="cuda") for _ in range(3)))
    with pytest.raises(ValueError):
        fa._flash_int8_codes(*ops, 0.125, 4608, torch.float32)
    ops = fa.int8_operands(*(torch.zeros(1, 256, 128, device="cuda") for _ in range(3)))
    with pytest.raises(ValueError):
        fa._flash_int8_codes(*ops, 0.125, 256, torch.float32)
