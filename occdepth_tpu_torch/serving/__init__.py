from occdepth_tpu_torch.serving.pipeline import ServingPipeline

__all__ = ["ServingPipeline"]
