from .storage import (  # noqa: F401
    GraphData, GraphDelta, GraphUpdateError, PartitionedEdges, graph_from_arrays,
)
from . import generators, datasets  # noqa: F401
