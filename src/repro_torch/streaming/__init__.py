"""Streaming graph updates + incremental recomputation.

``StreamingSession`` serves queries over a graph that mutates in place via
:class:`~repro_torch.graph.storage.GraphDelta`; monotone programs
(BFS/SSSP/CC) repair cached results incrementally on the host instead of
recomputing from scratch, and every other query is a full run on the
device through the refreshed graph bindings.
"""
from ..graph.storage import GraphDelta, GraphUpdateError
from .incremental import repair_result
from .session import StreamingSession

__all__ = [
    "GraphDelta",
    "GraphUpdateError",
    "StreamingSession",
    "repair_result",
]
