"""The port's test-time ensembling held to the JAX package's.

``ensemble_predictions`` gets the same members in both packages (numpy
seeds; members that differ by a scale, a shift and noise, as an ensemble's
do), at E = 3 and at E = 4, where the median is the midpoint of the two
middle members, for both reductions and with each invariance flag off,
uncertainty included. Bar: 1e-5 abs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genpercept_tpu.pipeline.ensemble import ensemble_predictions as j_ensemble
from genpercept_tpu_torch.pipeline.ensemble import _median, ensemble_predictions

TOL = 1e-5


def members(e: int, seed: int, hw=(24, 20)) -> np.ndarray:
    rng = np.random.default_rng(seed)
    base = rng.uniform(size=hw)
    scale = rng.uniform(0.5, 2.0, size=(e, 1, 1))
    shift = rng.uniform(-0.3, 0.3, size=(e, 1, 1))
    return (scale * base + shift + 0.05 * rng.normal(size=(e,) + hw)).astype(np.float32)


@pytest.mark.parametrize("flags", [dict(), dict(scale_invariant=False),
                                   dict(shift_invariant=False),
                                   dict(scale_invariant=False, shift_invariant=False)])
@pytest.mark.parametrize("reduction", ["median", "mean"])
@pytest.mark.parametrize("e", [3, 4])
def test_ensemble_matches_jax(e, reduction, flags):
    preds = members(e, seed=10 * e + len(flags))
    merged, unc = ensemble_predictions(torch.from_numpy(preds), reduction=reduction,
                                       return_uncertainty=True, **flags)
    j_merged, j_unc = j_ensemble(jnp.asarray(preds), reduction=reduction,
                                 return_uncertainty=True, **flags)
    assert merged.dtype == unc.dtype == torch.float32
    assert merged.shape == unc.shape == preds.shape[1:]
    np.testing.assert_allclose(merged.numpy(), np.asarray(j_merged), rtol=0, atol=TOL)
    np.testing.assert_allclose(unc.numpy(), np.asarray(j_unc), rtol=0, atol=TOL)
    assert float(merged.min()) == 0.0 and abs(float(merged.max()) - 1.0) <= 1e-6


@pytest.mark.parametrize("iters", [0, 1, 5])
def test_ensemble_iters_and_merged_only(iters):
    preds = members(3, seed=7)
    ours = ensemble_predictions(torch.from_numpy(preds), iters=iters)
    ref = j_ensemble(jnp.asarray(preds), iters=iters)
    assert isinstance(ours, torch.Tensor)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0, atol=TOL)


def test_ensemble_bf16_members_run_in_f32():
    preds = torch.from_numpy(members(3, seed=8)).to(torch.bfloat16)
    merged = ensemble_predictions(preds)
    ref = j_ensemble(jnp.asarray(preds.float().numpy()))
    assert merged.dtype == torch.float32
    np.testing.assert_allclose(merged.numpy(), np.asarray(ref), rtol=0, atol=TOL)


@pytest.mark.parametrize("e", [1, 2, 3, 4, 5])
def test_median_is_numpys(e):
    """The midpoint of the two middle members at even E; torch.median
    would return the lower one."""
    x = np.random.default_rng(e).normal(size=(e, 5, 6)).astype(np.float32)
    np.testing.assert_array_equal(_median(torch.from_numpy(x)).numpy(),
                                  np.median(x, axis=0).astype(np.float32))
    if e % 2 == 0:
        assert not torch.equal(_median(torch.from_numpy(x)),
                               torch.from_numpy(x).median(dim=0).values)
