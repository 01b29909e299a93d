from repro_torch.distributed.pipeline import (bubble_fraction, pipeline_apply,
                                              stage_params_sharding)

__all__ = ["bubble_fraction", "pipeline_apply", "stage_params_sharding"]
