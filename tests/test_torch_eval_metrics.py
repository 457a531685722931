"""The port's eval metrics and alignment held to the JAX package's.

Depth maps, predictions and masks come from numpy seeds; the same arrays
go through ``genpercept_tpu.eval`` (jax.numpy on the CPU) and
``genpercept_tpu_torch.eval`` (torch on the CPU). Tolerances are stated
beside each test.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genpercept_tpu.eval import alignment as ja
from genpercept_tpu.eval import metrics as jm
from genpercept_tpu_torch.eval import alignment as ta
from genpercept_tpu_torch.eval import metrics as tm

MASKS = ("all_valid", "block", "mostly_invalid")


def depth_batch(seed, mask_kind, b=3, hw=(24, 32)):
    """Metric depth in [0.5, 10] and a prediction near it, as eval sees them
    after the clips (both > 0); the mask all valid, with an invalid block,
    or ~98% invalid (a few valid pixels per image)."""
    rng = np.random.default_rng(seed)
    gt = rng.uniform(0.5, 10.0, (b,) + hw).astype(np.float32)
    pred = (gt * rng.uniform(0.7, 1.4, gt.shape)).astype(np.float32)
    mask = np.ones(gt.shape, bool)
    if mask_kind == "block":
        mask[:, 4:12, 6:20] = False
    elif mask_kind == "mostly_invalid":
        mask = rng.uniform(size=gt.shape) < 0.02
        mask[:, 0, 0] = True
    return pred, gt, mask


@pytest.mark.parametrize("mask_kind", MASKS)
@pytest.mark.parametrize("name", sorted(tm.METRIC_FUNCS))
def test_metric_matches_jax(name, mask_kind):
    """Each metric, masked and (on the all-valid batch) unmasked: 1e-6
    relative (f32 sums in another order)."""
    pred, gt, mask = depth_batch(1, mask_kind)
    for m in ((mask, None) if mask_kind == "all_valid" else (mask,)):
        ref = float(jm.METRIC_FUNCS[name](jnp.asarray(pred), jnp.asarray(gt),
                                          None if m is None else jnp.asarray(m)))
        got = tm.METRIC_FUNCS[name](torch.from_numpy(pred), torch.from_numpy(gt),
                                    None if m is None else torch.from_numpy(m))
        assert got.dtype == torch.float32 and got.ndim == 0
        np.testing.assert_allclose(float(got), ref, rtol=1e-6, atol=0, err_msg=name)


def test_compute_metrics_adds_the_batch_axis():
    """A 2-D input gains the batch axis; every name; 1e-6 relative."""
    pred, gt, mask = depth_batch(2, "block", b=1)
    ref = jm.compute_metrics(jnp.asarray(pred[0]), jnp.asarray(gt[0]), jnp.asarray(mask[0]))
    got = tm.compute_metrics(*(torch.from_numpy(a[0]) for a in (pred, gt, mask)))
    assert list(got) == list(ref) == list(tm.METRIC_FUNCS)
    for k in ref:
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=1e-6, err_msg=k)
    names = ["delta1_acc", "log10"]
    assert list(tm.compute_metrics(*(torch.from_numpy(a) for a in (pred, gt, mask)),
                                   names=names)) == names


def test_log10_is_a_global_masked_mean():
    """log10 averages over every valid pixel of the batch, the others per
    image first: with 1 and 9 valid pixels the two differ."""
    pred, gt, _ = depth_batch(3, "all_valid", b=2)
    mask = np.zeros(gt.shape, bool)
    mask[0, 0, :1] = True
    mask[1, 0, :9] = True
    t = [torch.from_numpy(a) for a in (pred, gt, mask)]
    d = np.abs(np.log10(pred.astype(np.float64)) - np.log10(gt.astype(np.float64)))
    np.testing.assert_allclose(float(tm.log10(*t)), d[mask].mean(), rtol=1e-6)
    per_image = np.mean([d[i][mask[i]].mean() for i in range(2)])
    assert abs(d[mask].mean() - per_image) > 1e-3


def test_silog_clamps_cancellation_at_zero():
    """A constant log ratio d has Var[d] = 0, and f32 cancellation puts
    mean(first - second) on either side of 0: where it falls below 0 the
    clamp returns exactly 0. Both packages read within 0.2 of 0 everywhere:
    100 sqrt(n eps d^2), the bound of a running f32 sum of n = 100 terms,
    is 0.17 at d = 0.69, the largest here."""
    mask = torch.ones(1, 10, 10, dtype=torch.bool)
    gt = torch.full((1, 10, 10), 2.0)
    hits = 0
    for k in range(1, 100):
        pred = gt * (1.0 + 0.01 * k)
        d = torch.log(pred) - torch.log(gt)
        raw = (d**2).sum() / 100 - d.sum() ** 2 / 100**2
        got = float(tm.silog_rmse(pred, gt, mask))
        ref = float(jm.silog_rmse(jnp.asarray(pred.numpy()), jnp.asarray(gt.numpy()),
                                  jnp.asarray(mask.numpy())))
        assert 0.0 <= got < 0.2 and 0.0 <= ref < 0.2
        if raw < 0:
            hits += 1
            assert got == 0.0
    assert hits > 0


def test_silog_counts_past_int32_squares():
    """90000 valid pixels: n^2 overflows an int32 (JAX's silog_rmse squares
    its int32 count there and reads garbage, so the comparison with JAX is
    held below 46340 pixels); the port's int64 count gives float64's value
    to 1e-4 (its f32 cancellation)."""
    rng = np.random.default_rng(8)
    gt = rng.uniform(0.5, 10.0, (1, 300, 300)).astype(np.float32)
    pred = (gt * rng.uniform(0.5, 2.0, gt.shape)).astype(np.float32)
    d = np.log(pred.astype(np.float64)) - np.log(gt.astype(np.float64))
    want = np.sqrt(np.mean(d**2) - np.mean(d) ** 2) * 100
    mask = torch.ones(gt.shape, dtype=torch.bool)
    got = float(tm.silog_rmse(torch.from_numpy(pred), torch.from_numpy(gt), mask))
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_metric_tracker_weights_by_count():
    tracker = tm.MetricTracker("a")
    tracker.update("a", 1.0, n=3)
    tracker.update("a", 5.0)
    tracker.update("b", 2.0, n=2)
    assert tracker.result() == {"a": 2.0, "b": 2.0}
    jt = jm.MetricTracker("a")
    for args in (("a", 1.0, 3), ("a", 5.0, 1), ("b", 2.0, 2)):
        jt.update(*args)
    assert jt.result() == tracker.result()
    tracker.reset()
    assert tracker.result() == {"a": 0.0, "b": 0.0}


@pytest.mark.parametrize("max_resolution", [None, 20, 200])
@pytest.mark.parametrize("mask_kind", MASKS)
def test_align_numpy_matches_jax(mask_kind, max_resolution):
    """The numpy lstsq copy, with and without the W-only nearest downsample
    (20 < 32 columns shrinks W; 200 does nothing): equal."""
    pred, gt, mask = depth_batch(5, mask_kind, b=1)
    for dtype in (np.float32, np.float64):
        args = (gt[0].astype(dtype), pred[0].astype(dtype), mask[0])
        ours = ta.align_depth_least_square(*args, max_resolution=max_resolution)
        ref = ja.align_depth_least_square(*args, max_resolution=max_resolution)
        np.testing.assert_array_equal(ours[0], ref[0])
        assert ours[1:] == ref[1:]


def test_nearest_downsample_shrinks_only_w():
    x = np.arange(6 * 10, dtype=np.float32).reshape(6, 10)
    out = ta._nearest_downsample_np(x, 0.5)
    assert out.shape == (6, 5)
    np.testing.assert_array_equal(out, ja._nearest_downsample_np(x, 0.5))
    np.testing.assert_array_equal(out, x[:, ::2])


@pytest.mark.parametrize("mask_kind", MASKS)
def test_align_torch_closed_form_matches_jax(mask_kind):
    """The batched closed form against align_depth_least_square_jax, the
    f32 normal equations over 768 pixels: s and t to 5e-5 relative (JAX's
    own t reads up to 3.3e-5 from a float64 solve of the same equations,
    the port's 5.7e-6) and to 1e-5 of the float64 solve; aligned to 1e-5 of
    max|aligned|; a batch member with one valid pixel (det 0) divides by 1
    in both (its f32 det is rounding, under 1e-12)."""
    pred, gt, mask = depth_batch(6, mask_kind)
    mask[-1] = False
    mask[-1, 3, 3] = True
    ref = ja.align_depth_least_square_jax(jnp.asarray(gt), jnp.asarray(pred), jnp.asarray(mask))
    got = ta.align_depth_least_square_torch(*(torch.from_numpy(a) for a in (gt, pred, mask)))
    f64 = ta.align_depth_least_square_torch(
        *(torch.from_numpy(a.astype(np.float64)) for a in (gt, pred)), torch.from_numpy(mask))
    top = float(np.abs(np.asarray(ref[0])).max())
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), rtol=0, atol=1e-5 * top)
    for r, g, x in zip(ref[1:], got[1:], f64[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=5e-5)
        np.testing.assert_allclose(g.numpy()[:-1], x.numpy()[:-1], rtol=1e-5)
    # the singular member: both divide by 1, f32 cancellation left in s and t
    assert abs(float(got[1][-1])) < 1e-4 and abs(float(ref[1][-1])) < 1e-4
    # the closed form solves what lstsq solves (float64 both)
    _, s, t = ta.align_depth_least_square(gt[0].astype(np.float64),
                                          pred[0].astype(np.float64), mask[0])
    np.testing.assert_allclose([f64[1][0].item(), f64[2][0].item()], [s, t], rtol=1e-9)


def test_depth2disparity_with_zeros():
    """Zeros (and negatives) map to 0 with their mask False, numpy and torch;
    the rest to 1/x; equal to JAX's."""
    d = np.array([[0.0, 2.0, -1.0], [4.0, 0.5, 0.0]], np.float32)
    want = np.array([[0.0, 0.5, 0.0], [0.25, 2.0, 0.0]], np.float32)
    for x in (d, torch.from_numpy(d)):
        disp, mask = ta.depth2disparity(x, return_mask=True)
        np.testing.assert_array_equal(np.asarray(disp), want)
        np.testing.assert_array_equal(np.asarray(mask), d > 0)
        np.testing.assert_array_equal(np.asarray(ta.disparity2depth(disp)),
                                      np.where(want > 0, 1 / np.where(want > 0, want, 1), 0))
    assert isinstance(ta.depth2disparity(torch.from_numpy(d)), torch.Tensor)
    np.testing.assert_array_equal(ta.depth2disparity(d), np.asarray(ja.depth2disparity(d)))
    np.testing.assert_array_equal(ta.depth2disparity(d),
                                  np.asarray(ja.depth2disparity(jnp.asarray(d))))
