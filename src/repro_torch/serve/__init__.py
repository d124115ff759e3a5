"""Serving side of the port: the batched decode engine."""

from repro_torch.serve.engine import Request, ServeEngine

__all__ = ["Request", "ServeEngine"]
