"""The port's multi-resolution noise held to the JAX package's.

JAX's ``multi_res_noise_like`` draws with ``jax.random``; the test replays its
key sequence (the same ``split`` / ``fold_in`` calls in the same order) to
get the same gaussians and the ratio's index, hands them to the port's
``multi_res_noise_core`` (NCHW), and compares with JAX's output: f32 to
1e-5 max abs; bf16 within BF16_ULPS bf16 ulps of max(|x|, 1), the noise's
scale: XLA's CPU backend computes a bf16 chain of adds and products in f32
inside a fusion and rounds where the fusion ends, where the port rounds
after each op, so single elements differ by a few ulps (reading 3). The
port's own draw is checked for unit variance and for its pyramid.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from genpercept_tpu.train import noise as JN
from genpercept_tpu_torch.train import noise as TN

SHAPE = (2, 12, 20, 4)  # (B, h, w, C): a latent of 96x160 pixels
DTYPES = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}
BF16_ULPS = 4


def replay(key, shape, strategy, dtype):
    """JAX's draws in multi_res_noise_like's order: (noise, index, levels),
    numpy in NCHW."""
    b, h, w, c = shape
    key, k0 = jax.random.split(key)
    noise = jax.random.normal(k0, shape, dtype)
    idx, levels = None, []
    if strategy in ("original", "random_step"):
        idx = int(jax.random.randint(jax.random.fold_in(key, 17), (), 0, JN._N_RATIO_BINS))
        pkey = jax.random.fold_in(key, 18)
        for ch, cw in TN.pyramid_sizes(h, w, strategy, idx):
            pkey, ki = jax.random.split(pkey)
            levels.append(jax.random.normal(ki, (b, ch, cw, c), dtype))
    else:
        for ch, cw in TN.pyramid_sizes(h, w, strategy):
            key, ki = jax.random.split(key)
            levels.append(jax.random.normal(ki, (b, ch, cw, c), dtype))

    def nchw(x):
        return np.asarray(x, np.float32).transpose(0, 3, 1, 2)

    return nchw(noise), idx, [nchw(g) for g in levels]


def to_t(x, dtype):
    return torch.from_numpy(np.ascontiguousarray(x)).to(dtype)


def test_ratios_and_sizes_match_jax():
    assert TN.N_RATIO_BINS == JN._N_RATIO_BINS
    assert TN.RATIOS == tuple(2.0 + 2.0 * (j + 0.5) / JN._N_RATIO_BINS
                              for j in range(JN._N_RATIO_BINS))
    assert TN.pyramid_sizes(60, 80, "power_of_two") == [
        (60, 80), (30, 40), (15, 20), (7, 10), (3, 5), (1, 2)]
    assert TN.pyramid_sizes(12, 20, "every_layer") == [(6, 10), (3, 5), (1, 2)]
    assert TN.pyramid_sizes(60, 80, "original", 0)[:2] == [(60, 80), (28, 37)]
    with pytest.raises(ValueError):
        TN.pyramid_sizes(8, 8, "nearest")


@pytest.mark.parametrize("dtype", list(DTYPES), ids=["f32", "bf16"])
@pytest.mark.parametrize("annealed", [False, True])
@pytest.mark.parametrize("strategy", TN.STRATEGIES)
def test_core_matches_jax_on_replayed_draws(strategy, annealed, dtype):
    key = jax.random.key(7)
    if annealed:  # per-sample strength, as the step's t / 1000 annealing
        j_strength = 0.9 * jnp.asarray([0.25, 0.9], jnp.float32).reshape(-1, 1, 1, 1)
        t_strength = torch.tensor([0.25, 0.9]).reshape(-1, 1, 1, 1) * 0.9
    else:
        j_strength = t_strength = 0.9
    ref = JN.multi_res_noise_like(key, SHAPE, j_strength, strategy, dtype)
    noise, idx, levels = replay(key, SHAPE, strategy, dtype)
    td = DTYPES[dtype]
    if idx is not None:
        assert len(levels) == len(TN.pyramid_sizes(SHAPE[1], SHAPE[2], strategy, idx))
    out = TN.multi_res_noise_core(to_t(noise, td), [to_t(g, td) for g in levels],
                                  t_strength, strategy)
    # bf16 with a per-sample strength promotes to f32 in both
    assert str(out.dtype).split(".")[-1] == jnp.dtype(ref.dtype).name
    got = out.float().permute(0, 2, 3, 1).numpy()
    want = np.asarray(ref, np.float32)
    if dtype == jnp.bfloat16:
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1.0))) - 7)
        err = np.abs(got - want) / ulp
        assert err.max() <= BF16_ULPS, float(err.max())
    else:
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("src", [(12, 20), (1, 5), (5, 1), (3, 2), (1, 1)])
def test_bilinear_upsample_equals_jax_resize(src):
    """F.interpolate (half-pixel, no antialias) and the port's upsampling
    equal jax.image.resize's "linear" at every pyramid size, including from
    1 x n: 1e-6 max abs in f32; in bf16 the port's within one bf16 ulp of
    max(|x|, 1) (the gaussians' scale; a weight rounds to bf16 in both)."""
    x = np.random.default_rng(3).normal(size=(2, 4) + src).astype(np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(x.transpose(0, 2, 3, 1)), (2, 12, 20, 4),
                                      "linear"))
    tx = torch.from_numpy(x)
    for got in (TN.upsample_bilinear(tx, (12, 20)),
                F.interpolate(tx, size=(12, 20), mode="bilinear", align_corners=False,
                              antialias=False)):
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), ref, atol=1e-6, rtol=0)
    bf = jax.image.resize(jnp.asarray(x.transpose(0, 2, 3, 1), jnp.bfloat16), (2, 12, 20, 4),
                          "linear")
    got = TN.upsample_bilinear(tx.to(torch.bfloat16), (12, 20)).float().permute(0, 2, 3, 1)
    want = np.asarray(bf, np.float32)
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1.0))) - 7)
    assert np.all(np.abs(got.numpy() - want) <= ulp)


@pytest.mark.parametrize("strategy", TN.STRATEGIES)
def test_port_draw_is_unit_variance_and_seeded(strategy):
    g = torch.Generator().manual_seed(0)
    a = TN.multi_res_noise_like(g, (2, 4, 60, 80), 0.9, strategy)
    assert a.shape == (2, 4, 60, 80) and a.dtype == torch.float32
    assert abs(float(a.std(correction=0)) - 1.0) < 1e-5
    assert abs(float(a.mean())) < 0.5
    b = TN.multi_res_noise_like(torch.Generator().manual_seed(0), (2, 4, 60, 80), 0.9, strategy)
    assert torch.equal(a, b)
    bf = TN.multi_res_noise_like(torch.Generator().manual_seed(0), (2, 4, 60, 80), 0.9,
                                 strategy, torch.bfloat16)
    assert bf.dtype == torch.bfloat16


def test_unknown_strategy_raises_in_both():
    with pytest.raises(ValueError):
        JN.multi_res_noise_like(jax.random.key(0), SHAPE, 0.9, "nearest")
    with pytest.raises(ValueError):
        TN.multi_res_noise_like(torch.Generator(), (2, 4, 12, 20), 0.9, "nearest")
