"""Serving on one device: continuous-batching LM decode and multi-tenant
graph queries."""
from repro_torch.serve.engine import Request, ServeConfig, ServingEngine
from repro_torch.serve.graph_engine import (
    KINDS,
    AdmissionError,
    GraphQuery,
    GraphServeConfig,
    GraphServingEngine,
    QueueFullError,
)

__all__ = ["AdmissionError", "GraphQuery", "GraphServeConfig",
           "GraphServingEngine", "KINDS", "QueueFullError", "Request",
           "ServeConfig", "ServingEngine"]
