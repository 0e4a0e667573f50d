"""Continuous-batching engine over the elastic paged pool."""

from .engine import EngineConfig, LLMEngine, Request, RequestOutput, SamplingParams

__all__ = ["EngineConfig", "LLMEngine", "Request", "RequestOutput", "SamplingParams"]
