"""The port's metric3d losses (VNL, HDNL, HDSNL) held to the JAX package's.

Each JAX loss draws with ``jax.random``; the test replays its key sequence
(the same ``split`` calls and samplers in the same order) and hands those
draws to the port's core. Loss and gradient with respect to the prediction
agree to 1e-5 relative in f32 (sums and sorts in another order). The port's
own draws are checked for their ranges, and the training step for routing
the three losses with a batch's intrinsics.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genpercept_tpu.train import metric3d_losses as J3
from genpercept_tpu_torch.train import metric3d_losses as T3

B, H, W = 2, 24, 32
RTOL = 1e-5


def inputs(seed=0, empty_second=False):
    """Depth-like pred/target in [1, 3], a mask with an invalid block, and
    a Hypersim-like K scaled to the raster."""
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    base = 1.5 + 0.03 * yy + 0.02 * xx
    target = (base + 0.2 * rng.normal(size=(B, H, W))).astype(np.float32)
    pred = (base + 0.3 * rng.normal(size=(B, H, W))).astype(np.float32)
    mask = np.ones((B, H, W), bool)
    mask[:, :6, :8] = False
    mask &= rng.uniform(size=(B, H, W)) > 0.1
    if empty_second:
        mask[1] = False
    k = np.array([[886.81 * W / 1024, 0, 512.0 * W / 1024],
                  [0, 886.81 * H / 768, 384.0 * H / 768], [0, 0, 1]], np.float32)
    return pred, target, mask, np.stack([k, k])


def jax_value_grad(fn, pred, *args):
    val, grad = jax.value_and_grad(lambda p: fn(p, *args))(jnp.asarray(pred))
    return float(val), np.asarray(grad)


def port_value_grad(core, pred, *args):
    p = torch.from_numpy(pred).requires_grad_()
    val = core(p, *args)
    (grad,) = torch.autograd.grad(val, p)
    return float(val), grad.numpy()


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def check(jv, jg, tv, tg):
    np.testing.assert_allclose(tv, jv, rtol=RTOL, atol=1e-7)
    np.testing.assert_allclose(tg, jg, rtol=RTOL, atol=RTOL * float(np.abs(jg).max()))


@pytest.mark.parametrize("n_valid", [5, 0, 1, 6])
def test_masked_lower_median(n_valid):
    x = np.random.default_rng(1).normal(size=(3, 11)).astype(np.float32)
    mask = np.zeros((3, 11), bool)
    mask[:, :n_valid] = True
    mask[1, 7] = n_valid > 0
    want = np.asarray(J3._masked_lower_median(jnp.asarray(x), jnp.asarray(mask)))
    np.testing.assert_array_equal(T3.masked_lower_median(t(x), t(mask)).numpy(), want)


@pytest.mark.parametrize("mad_masked_gt", [True, False])
def test_ssi_mae_sum(mad_masked_gt):
    pred, target, mask, _ = inputs(2)
    want = float(J3._ssi_mae_sum(*map(jnp.asarray, (pred, target, mask)), mad_masked_gt))
    got = float(T3.ssi_mae_sum(t(pred), t(target), t(mask), mad_masked_gt).sum())
    np.testing.assert_allclose(got, want, rtol=RTOL)


def hdsnl_windows(key, h, w, n):
    """_rect_masks' draws: (crop h, crop w, y0, x0)."""
    k1, k2, k3, k4 = jax.random.split(key, 4)
    lo_h, lo_w = int(0.125 * h), int(0.125 * w)
    ch = jax.random.randint(k1, (n,), lo_h, max(int(0.5 * h), lo_h + 1))
    cw = jax.random.randint(k2, (n,), lo_w, max(int(0.5 * w), lo_w + 1))
    y0 = jax.random.randint(k3, (n,), 0, max(h - lo_h, 1))
    x0 = jax.random.randint(k4, (n,), 0, max(w - lo_w, 1))
    return tuple(torch.from_numpy(np.asarray(v).astype(np.int64)) for v in (ch, cw, y0, x0))


def test_rect_masks_match_jax():
    key = jax.random.key(3)
    want = np.asarray(J3._rect_masks(key, H, W, 32))
    got = T3.rect_masks(hdsnl_windows(key, H, W, 32), H, W).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("empty", [False, True])
def test_hdsnl_core_matches_jax(empty):
    pred, target, mask, _ = inputs(3, empty)
    key = jax.random.key(4)
    jv, jg = jax_value_grad(lambda p: J3.hdsnl_random_loss(p, jnp.asarray(target),
                                                           jnp.asarray(mask), key), pred)
    tv, tg = port_value_grad(T3.hdsnl_core, pred, t(target), t(mask),
                             hdsnl_windows(key, H, W, 32))
    check(jv, jg, tv, tg)


def hdnl_uniforms(key, b, n):
    u1, u2 = [], []
    for key_i in jax.random.split(key, b):
        k1, k2 = jax.random.split(key_i)
        u1.append(np.asarray(jax.random.uniform(k1, (n,))))
        u2.append(np.asarray(jax.random.uniform(k2, (n,), minval=0.0, maxval=1.0)))
    return t(np.stack(u1)), t(np.stack(u2))


@pytest.mark.parametrize("empty", [False, True])
def test_hdnl_core_matches_jax(empty):
    pred, target, mask, _ = inputs(5, empty)
    key = jax.random.key(6)
    jv, jg = jax_value_grad(lambda p: J3.hdnl_random_loss(p, jnp.asarray(target),
                                                          jnp.asarray(mask), key), pred)
    tv, tg = port_value_grad(T3.hdnl_core, pred, t(target), t(mask), hdnl_uniforms(key, B, 32))
    check(jv, jg, tv, tg)


def vnl_indices(key, mask, ratio=0.15):
    b, h, w = mask.shape
    n = max(int(h * w * ratio), 1)
    out = []
    for key_i, m in zip(jax.random.split(key, b), mask):
        logits = jnp.where(jnp.asarray(m).reshape(-1), 0.0, -1e30)
        ks = jax.random.split(key_i, 3)
        out.append(np.stack([np.asarray(jax.random.categorical(k, logits, shape=(n,)))
                             for k in ks], axis=1))
    return t(np.stack(out).astype(np.int64))


@pytest.mark.parametrize("select", [True, False])
@pytest.mark.parametrize("zero_pred", [False, True])
def test_vnl_core_matches_jax(select, zero_pred):
    pred, target, mask, k = inputs(7)
    if zero_pred:  # a zero predicted depth becomes 1e-4 in both
        pred[0, 10:14, 10:20] = 0.0
    key = jax.random.key(8)
    jv, jg = jax_value_grad(lambda p: J3.vnl_loss(p, jnp.asarray(target), jnp.asarray(mask),
                                                  jnp.asarray(k), key, select=select), pred)
    tv, tg = port_value_grad(lambda p, *a: T3.vnl_core(p, *a, select=select), pred, t(target),
                             t(mask), t(k), vnl_indices(key, mask))
    check(jv, jg, tv, tg)


def test_port_draws_ranges_and_seeding():
    _, _, mask, _ = inputs(9)
    g = torch.Generator().manual_seed(0)
    ch, cw, y0, x0 = T3.hdsnl_draw(g, H, W, 500)
    assert int(ch.min()) >= 3 and int(ch.max()) < 12 and int(cw.min()) >= 4 and int(cw.max()) < 16
    assert int(y0.max()) < H - 3 and int(x0.max()) < W - 4
    u1, u2 = T3.hdnl_draw(g, B, 32)
    assert u1.shape == (B, 32) and 0 <= float(u1.min()) and float(u2.max()) < 1
    idx = T3.vnl_draw(torch.Generator().manual_seed(1), t(mask))
    assert idx.shape == (B, int(0.15 * H * W), 3)
    flat = t(mask).reshape(B, -1)
    assert bool(torch.gather(flat, 1, idx.reshape(B, -1)).all())  # valid pixels only
    again = T3.vnl_draw(torch.Generator().manual_seed(1), t(mask))
    assert torch.equal(idx, again)
    for loss in (T3.vnl_loss(t(inputs(9)[0]), t(inputs(9)[1]), t(mask), t(inputs(9)[3]), g),
                 T3.hdnl_random_loss(t(inputs(9)[0]), t(inputs(9)[1]), t(mask), g),
                 T3.hdsnl_random_loss(t(inputs(9)[0]), t(inputs(9)[1]), t(mask), g)):
        assert torch.isfinite(loss) and float(loss) > 0
