from repro_torch.ft.watchdog import StepWatchdog, StragglerStats
from repro_torch.ft.elastic import ElasticRunner, QueueDepthAutoscaler, RunState

__all__ = ["StepWatchdog", "StragglerStats", "ElasticRunner",
           "QueueDepthAutoscaler", "RunState"]
