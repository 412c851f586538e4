from repro_torch.configs.base import CacheConfig
from repro_torch.serving.engine import Engine, EngineConfig, EngineStats
from repro_torch.serving.request import FinishReason, Request, RequestState
from repro_torch.serving.sampler import SamplingParams

__all__ = ["CacheConfig", "Engine", "EngineConfig", "EngineStats",
           "FinishReason", "Request", "RequestState", "SamplingParams"]
