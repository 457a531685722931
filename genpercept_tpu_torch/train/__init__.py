from genpercept_tpu_torch.train.train_step import (
    OptaxAdam,
    TrainConfig,
    build_loss_fn,
    build_train_step,
    downscale_valid_mask,
    init_train_state,
    make_optimizer,
    replace_unet_conv_in,
    split_trainable,
)

__all__ = ["OptaxAdam", "TrainConfig", "build_loss_fn", "build_train_step",
           "downscale_valid_mask", "init_train_state", "make_optimizer", "replace_unet_conv_in",
           "split_trainable"]
