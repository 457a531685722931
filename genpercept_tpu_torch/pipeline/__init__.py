from genpercept_tpu_torch.pipeline.tasks import TASKS, TaskSpec
from genpercept_tpu_torch.pipeline.pipeline import (
    GenPerceptModels,
    GenPerceptOutput,
    GenPerceptPipeline,
    PipelineConfig,
    build_single_infer,
)

__all__ = [
    "TASKS",
    "TaskSpec",
    "GenPerceptModels",
    "GenPerceptOutput",
    "GenPerceptPipeline",
    "PipelineConfig",
    "build_single_infer",
]
