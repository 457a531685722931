"""Trainer registry (counterpart of ``genpercept_tpu/train/registry.py``)."""

from genpercept_tpu_torch.train.trainer import Trainer

trainer_cls_name_dict = {
    "GenPerceptTrainer": Trainer,  # the reference's name
    "Trainer": Trainer,
}


def get_trainer_cls(trainer_name: str):
    return trainer_cls_name_dict[trainer_name]
