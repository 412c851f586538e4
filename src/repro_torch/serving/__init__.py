from repro_torch.configs.base import CacheConfig
from repro_torch.serving.engine import Engine, EngineConfig, EngineStats
from repro_torch.serving.faults import FaultInjector, FaultPlan
from repro_torch.serving.frontend import (AsyncEngine, PipelineStallError,
                                          TokenStream, WorkerKilled)
from repro_torch.serving.request import FinishReason, Request, RequestState
from repro_torch.serving.sampler import SamplingParams

__all__ = ["AsyncEngine", "CacheConfig", "Engine", "EngineConfig",
           "EngineStats", "FaultInjector", "FaultPlan", "FinishReason",
           "PipelineStallError", "Request", "RequestState", "SamplingParams",
           "TokenStream", "WorkerKilled"]
