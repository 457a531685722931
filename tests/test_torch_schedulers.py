"""The port's reverse-diffusion steps held to the JAX package's.

``pred_original_sample``, ``ddim_step`` (eta = 0, and eta > 0 with noise)
and ``ddpm_step`` get the same numpy inputs in both packages, for the three
prediction types with and without ``clip_sample``, on the SD2.1 betas and
GenPercept's beta == 1 schedule. The bar is the JAX scheduler tests' own
(tests/test_schedulers.py): 1e-6 abs. The port computes in f32 whatever the
input dtype, as JAX promotes a bf16 sample times its f32 tables.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genpercept_tpu.diffusion import GENPERCEPT_SCHEDULER as J_GENPERCEPT
from genpercept_tpu.diffusion import SchedulerConfig as JConfig
from genpercept_tpu.diffusion import ddim_step as j_ddim
from genpercept_tpu.diffusion import ddpm_step as j_ddpm
from genpercept_tpu.diffusion import make_scheduler as j_make
from genpercept_tpu.diffusion.schedulers import pred_original_sample as j_pred_x0
from genpercept_tpu_torch.diffusion import (
    GENPERCEPT_SCHEDULER,
    SchedulerConfig,
    ddim_step,
    ddpm_step,
    make_scheduler,
    pred_original_sample,
)

TOL = 1e-6
PREDICTION_TYPES = ["epsilon", "sample", "v_prediction"]
STEPS = 10
# the 10-step leading spacing's first, middle and last steps, per image
T = np.array([901, 1])


def configs(prediction_type: str, clip: bool):
    kw = dict(prediction_type=prediction_type, clip_sample=clip, clip_sample_range=1.5)
    return SchedulerConfig(**kw), JConfig(**kw)


def inputs(seed: int, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(2, 4, 8, 8)).astype(dtype) for _ in range(3)]


def t_pair(t):
    return torch.from_numpy(np.asarray(t, np.int64)), jnp.asarray(t, jnp.int32)


def close(ours: torch.Tensor, ref) -> None:
    assert ours.dtype == torch.float32
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref, np.float32), rtol=0, atol=TOL)


@pytest.mark.parametrize("clip", [False, True])
@pytest.mark.parametrize("prediction_type", PREDICTION_TYPES)
def test_pred_original_sample_matches_jax(prediction_type, clip):
    cfg, jcfg = configs(prediction_type, clip)
    out, x, _ = inputs(0)
    tt, jt = t_pair(np.array([501, 101]))
    ours = pred_original_sample(cfg, make_scheduler(cfg), torch.from_numpy(out),
                                torch.from_numpy(x), tt)
    ref = j_pred_x0(jcfg, j_make(jcfg), jnp.asarray(out), jnp.asarray(x), jt)
    for a, b in zip(ours, ref):
        close(a, b)


@pytest.mark.parametrize("eta", [0.0, 0.5])
@pytest.mark.parametrize("prediction_type", PREDICTION_TYPES)
def test_ddim_step_matches_jax(prediction_type, eta):
    cfg, jcfg = configs(prediction_type, prediction_type == "sample")
    out, x, noise = inputs(1)
    for t in ([901, 801], [101, 1]):
        tt, jt = t_pair(np.array(t))
        ours = ddim_step(cfg, make_scheduler(cfg), torch.from_numpy(out), tt,
                         torch.from_numpy(x), STEPS, eta=eta, noise=torch.from_numpy(noise))
        ref = j_ddim(jcfg, j_make(jcfg), jnp.asarray(out), jt, jnp.asarray(x), STEPS,
                     eta=eta, noise=jnp.asarray(noise))
        for a, b in zip(ours, ref):
            close(a, b)


@pytest.mark.parametrize("t", [901, 1])
def test_ddim_step_scalar_t_equals_batched(t):
    """t as a scalar and t broadcast to (B,) give the same result."""
    cfg = SchedulerConfig()
    state = make_scheduler(cfg)
    out, x, _ = (torch.from_numpy(a) for a in inputs(2))
    scalar = ddim_step(cfg, state, out, torch.tensor(t), x, STEPS)
    batched = ddim_step(cfg, state, out, torch.full((2,), t), x, STEPS)
    for a, b in zip(scalar, batched):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_ddim_step_eta_needs_noise():
    cfg = SchedulerConfig()
    out, x, _ = (torch.from_numpy(a) for a in inputs(3))
    with pytest.raises(ValueError, match="noise"):
        ddim_step(cfg, make_scheduler(cfg), out, torch.tensor([901, 1]), x, STEPS, eta=0.5)


def test_ddim_step_bf16_computes_in_f32():
    """A bf16 model output and sample: the update runs in f32 as in JAX."""
    cfg, jcfg = SchedulerConfig(), JConfig()
    out, x, _ = inputs(4)
    to_bf16 = [torch.from_numpy(a).to(torch.bfloat16) for a in (out, x)]
    tt, jt = t_pair(T)
    ours = ddim_step(cfg, make_scheduler(cfg), *to_bf16[:1], tt, to_bf16[1], STEPS)
    ref = j_ddim(jcfg, j_make(jcfg), jnp.asarray(out, jnp.bfloat16), jt,
                 jnp.asarray(x, jnp.bfloat16), STEPS)
    for a, b in zip(ours, ref):
        assert b.dtype == jnp.float32
        close(a, b)


def test_ddim_step_genpercept_beta1():
    """beta == 1: pred_x0 is -model_output (the one-step arch's algebra)."""
    cfg, jcfg = GENPERCEPT_SCHEDULER, J_GENPERCEPT
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    out, x, _ = inputs(5)
    tt, jt = t_pair(T)
    ours = ddim_step(cfg, make_scheduler(cfg), torch.from_numpy(out), tt,
                     torch.from_numpy(x), 1)
    ref = j_ddim(jcfg, j_make(jcfg), jnp.asarray(out), jt, jnp.asarray(x), 1)
    for a, b in zip(ours, ref):
        close(a, b)
    close(ours[1], -out)


@pytest.mark.parametrize("prediction_type", PREDICTION_TYPES)
def test_ddpm_step_matches_jax(prediction_type):
    """Includes t = 0, where the step adds no noise."""
    cfg, jcfg = configs(prediction_type, False)
    out, x, noise = inputs(6)
    for t in ([999, 0], [500, 1]):
        tt, jt = t_pair(np.array(t))
        ours = ddpm_step(cfg, make_scheduler(cfg), torch.from_numpy(out), tt,
                         torch.from_numpy(x), torch.from_numpy(noise))
        ref = j_ddpm(jcfg, j_make(jcfg), jnp.asarray(out), jt, jnp.asarray(x),
                     jnp.asarray(noise))
        for a, b in zip(ours, ref):
            close(a, b)
