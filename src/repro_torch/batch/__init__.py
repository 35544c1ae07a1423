"""Batched multi-query execution: one launch set answering K queries.

Layers:

* :class:`BatchEngine`: batched state (``[K, n]`` properties on the
  device, ``[K]`` host scalars), masked host interpretation, and each
  kernel launched once for all K lanes through the engine's
  ``batched_runner`` hook;
* :mod:`repro_torch.batch.msbfs`: the bit-packed multi-source BFS path,
  chosen from the MIR, one ``edge_stream`` launch (bitwise-OR reduce) a
  level;
* :class:`DynamicBatcher`: collects a live query stream into batches.

The user-facing surface is :meth:`repro_torch.core.program.Program.bind_batch`
returning a :class:`repro_torch.core.session.BatchSession`, plus the
rerouting inside ``Session.run_many`` and ``SessionPool.run_batch``.
"""
from .dynamic import BatchServeStats, DynamicBatcher
from .engine import BatchEngine, BatchError
from .msbfs import MSBFSPlan, match_msbfs

__all__ = [
    "BatchEngine",
    "BatchError",
    "BatchServeStats",
    "DynamicBatcher",
    "MSBFSPlan",
    "match_msbfs",
]
