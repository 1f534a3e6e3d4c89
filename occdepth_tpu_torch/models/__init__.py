"""Model modules of the port (NCHW / NCDHW)."""
from occdepth_tpu_torch.models.occdepth import OccDepthModel

__all__ = ["OccDepthModel"]
