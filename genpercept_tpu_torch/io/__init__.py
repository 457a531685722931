from genpercept_tpu_torch.io.weights import state_dict_from_jax

__all__ = ["state_dict_from_jax"]
