from occdepth_tpu_torch.training.trainer import Trainer, exp_name

__all__ = ["Trainer", "exp_name"]
