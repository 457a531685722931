from genpercept_tpu_torch.ops._dispatch import reference_kernels
from genpercept_tpu_torch.ops.norms import group_norm, layer_norm
from genpercept_tpu_torch.ops.attention import dot_product_attention
from genpercept_tpu_torch.ops.embeddings import timestep_embedding
from genpercept_tpu_torch.ops.conv import conv2d, conv1x1, nearest_up2_conv3x3
from genpercept_tpu_torch.ops.resize import resize, max_res_shape
from genpercept_tpu_torch.ops.colorize import colorize_depth

__all__ = [
    "reference_kernels",
    "group_norm",
    "layer_norm",
    "dot_product_attention",
    "timestep_embedding",
    "conv2d",
    "conv1x1",
    "nearest_up2_conv3x3",
    "resize",
    "max_res_shape",
    "colorize_depth",
]
