"""Serving of the port: the batched LM engine."""

from repro_torch.serving.engine import GenerationResult, ServeEngine

__all__ = ["GenerationResult", "ServeEngine"]
