"""The port's CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA GPU with nvcc (a CUDA kernel has no CPU mode)
and skip elsewhere. They import no JAX, so on a machine without it run them
without the repository's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: f32 1e-4 absolute (kernel and plain version differ in
summation order only); bf16 2e-2 (flash attention: p is rounded to bf16
against the running max in the kernel, the global max in the plain
version) and 6e-2 (feed-forward, as the JAX package's bf16 test).
"""

import numpy as np
import pytest
import torch

from genpercept_tpu_torch.ops import flash_attention as fa
from genpercept_tpu_torch.ops import fused_ff as ff
from genpercept_tpu_torch.ops import reference_kernels

pytestmark = pytest.mark.cuda


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
    assert (out.float() - ref.float()).abs().max().item() <= tol
    assert (lse - ref_lse).abs().max().item() <= tol


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 6e-2)])
@pytest.mark.parametrize("rows", [512, 96, 1000])
def test_fused_ff_kernel_matches_plain(gen, rows, dtype, tol):
    c, inner = 320, 1280
    x = torch.randn(1, rows, c, device="cuda", generator=gen).to(dtype)
    w1 = ((torch.rand(2 * inner, c, device="cuda", generator=gen) * 2 - 1) / c ** 0.5).to(dtype)
    b1 = torch.randn(2 * inner, device="cuda", generator=gen) * 0.1
    w2 = ((torch.rand(c, inner, device="cuda", generator=gen) * 2 - 1) / inner ** 0.5).to(dtype)
    y = ff.fused_geglu_ff(x, w1, b1, w2, None)
    ref = ff._fused_geglu_ff_ref(x, w1, b1, w2, None)
    torch.cuda.synchronize()
    assert (y.float() - ref.float()).abs().max().item() <= tol


def test_kernels_refuse_what_they_do_not_take(gen):
    x = torch.zeros(1, 64, 64, device="cuda", dtype=torch.float16)
    with pytest.raises(ValueError):
        fa._flash_bhsd(x, x, x, 0.125)
    for d in (96, 128, 256):  # no kernel body outside SD2.1's head dims
        y = torch.zeros(1, 64, d, device="cuda")
        with pytest.raises(ValueError):
            fa._flash_bhsd(y, y, y, 0.1)
    z = torch.zeros(1, 512, 640, device="cuda")
    with pytest.raises(ValueError):
        ff.fused_geglu_ff(z, torch.zeros(5120, 640, device="cuda"), None,
                          torch.zeros(640, 2560, device="cuda"), None)


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
