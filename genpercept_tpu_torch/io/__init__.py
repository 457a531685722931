from genpercept_tpu_torch.io.checkpoints import load_train_checkpoint, save_train_checkpoint
from genpercept_tpu_torch.io.weights import state_dict_from_jax

__all__ = ["load_train_checkpoint", "save_train_checkpoint", "state_dict_from_jax"]
