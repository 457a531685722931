"""genpercept_tpu_torch — the PyTorch and CUDA port of genpercept_tpu.

One-step GenPercept depth inference on an NVIDIA Hopper GPU: the SD2.1 VAE,
UNet and CLIP text encoder as ``nn.Module``s whose state-dict keys are the
diffusers names, plain PyTorch for convolutions, norms and projections, and
hand-written CUDA kernels (``csrc/``) where the JAX package has Pallas ones:
flash attention and the fused GEGLU feed-forward. The kernels are compiled
with nvcc at first CUDA use (``_build.py``); on the CPU every kernel wrapper
runs its plain PyTorch version.
"""

__version__ = "0.1.0"
