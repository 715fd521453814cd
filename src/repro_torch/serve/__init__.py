"""Multi-tenant graph query serving (single device)."""
from repro_torch.serve.graph_engine import (
    KINDS,
    AdmissionError,
    GraphQuery,
    GraphServeConfig,
    GraphServingEngine,
    QueueFullError,
)

__all__ = ["AdmissionError", "GraphQuery", "GraphServeConfig",
           "GraphServingEngine", "KINDS", "QueueFullError"]
