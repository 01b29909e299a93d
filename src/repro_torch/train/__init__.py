from repro_torch.train.optim import OptimConfig, apply_updates, init_state, lr_at
from repro_torch.train.step import init_opt_state, make_train_step

__all__ = ["OptimConfig", "init_state", "apply_updates", "lr_at",
           "make_train_step", "init_opt_state"]
