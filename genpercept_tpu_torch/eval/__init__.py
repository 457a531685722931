from genpercept_tpu_torch.eval.metrics import METRIC_FUNCS, MetricTracker, compute_metrics
from genpercept_tpu_torch.eval.alignment import (
    align_depth_least_square,
    depth2disparity,
    disparity2depth,
)

__all__ = [
    "METRIC_FUNCS",
    "MetricTracker",
    "compute_metrics",
    "align_depth_least_square",
    "depth2disparity",
    "disparity2depth",
]
