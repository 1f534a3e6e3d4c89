from occdepth_tpu_torch.losses.crp import relation_loss
from occdepth_tpu_torch.losses.depth import depth_cls_loss
from occdepth_tpu_torch.losses.fp_device import frustum_proportion_loss_device
from occdepth_tpu_torch.losses.metrics import SSCMetrics, confusion_update
from occdepth_tpu_torch.losses.ssc import ce_ssc_loss, geo_scal_loss, sem_scal_loss

__all__ = [
    "ce_ssc_loss",
    "sem_scal_loss",
    "geo_scal_loss",
    "frustum_proportion_loss_device",
    "relation_loss",
    "depth_cls_loss",
    "SSCMetrics",
    "confusion_update",
]
