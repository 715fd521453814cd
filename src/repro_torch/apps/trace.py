"""Irregular-access trace capture for the GPU cost model.

Counterpart of ``repro.apps.trace``.  ``TraceRecorder`` is the
instrumentation hook of the frontier runtime:
``core.pipeline.FrontierPipeline.run_instrumented`` feeds it one ``access``
event per iteration (the post-reorder index stream and its active mask,
atomic or load per the app) and ``processed`` counts the IRU-served
elements.  The host apps (``bfs``/``sssp``/``pagerank``) feed the same
interface from their numpy loops, so cost-model replays (the figure drivers
of ``repro_torch.figures``) are comparable across all realizations.

Events are stored as numpy triples ``(indices, active_or_None, atomic)``;
torch tensors (the pipeline's, on any device) are copied to the host.  A
caller that wants to reduce a large trace on the card instead passes its
own object with the same two methods.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@dataclasses.dataclass
class TraceRecorder:
    events: list = dataclasses.field(default_factory=list)
    iru_elements: int = 0

    def access(self, indices, active=None, atomic: bool = False) -> None:
        idx = _host(indices)
        act = None if active is None else np.asarray(_host(active), bool)
        self.events.append((idx, act, atomic))

    def processed(self, n: int) -> None:
        self.iru_elements += int(n)
