"""Host-side incremental repair for monotone graph programs.

After an additions-only :class:`~repro_torch.graph.storage.GraphDelta`, a cached
result of a *monotone* program (every per-edge write is a ``min=``/``max=``
reduction — BFS, SSSP, connected components) is still a valid over-estimate:
new edges can only *improve* (decrease, for min-space) the fixpoint, never
worsen it. Repair therefore seeds a decrease-only relaxation wave from the
delta's endpoints and runs it to convergence on the host — touching only the
affected region — instead of re-running the accelerator from scratch.

The repaired result is **bit-identical** to a from-scratch run on the updated
graph, including auxiliary properties and host scalars:

- distance templates keep their neighbor-minimum ``tuple`` property exact via
  a final maintenance pass over the out-edges of every changed/new source;
- mirror properties (``new_level``, ``comp_next``) equal the primary at any
  fixpoint, so they are copied from the repaired primary;
- convergence flags/counters are zero at any fixpoint and are taken from the
  cached result unchanged; a BFS-style round scalar is recomputed as
  ``max(finite level) + 1``.

Everything here is plain NumPy over the graph's CSR/CSC views in the
*original* vertex id space (cached results are always translated back to
original ids, and the streaming session's graph is never hub-relabeled), so
repair needs no device work and no re-lowering at all.

Arrays not touched by the repair are shared with the cached result rather
than copied; results are read-only by convention throughout the library.
"""
from __future__ import annotations

import time
from typing import Optional, Tuple

import numpy as np

from ..core.engine import EngineResult, EngineStats
from ..core.mir import IncrementalInfo, IncrementalTemplate
from ..graph.storage import GraphData

__all__ = ["repair_result"]

# Internal +inf for unit-distance repair: far above any int32 level but with
# headroom so INF + 1 never wraps int64.
_INF = np.int64(1) << 60


def _expand(
    frontier: np.ndarray,
    indptr: np.ndarray,
    indices: np.ndarray,
    perm: Optional[np.ndarray],
) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
    """Gather the adjacency of ``frontier``: (targets, sources, edge_ids).

    ``sources`` repeats each frontier vertex once per incident slot, so
    ``targets[i]`` is reached from ``sources[i]`` via original edge
    ``perm[slot_i]`` (None when the caller does not need edge ids).
    """
    frontier = frontier.astype(np.int64)
    counts = (indptr[frontier + 1] - indptr[frontier]).astype(np.int64)
    total = int(counts.sum())
    if total == 0:
        z = np.zeros(0, dtype=np.int64)
        return z, z, (z if perm is not None else None)
    starts = indptr[frontier].astype(np.int64)
    # slot index within each vertex's run: 0..count-1
    offs = np.arange(total, dtype=np.int64) - np.repeat(
        np.cumsum(counts) - counts, counts
    )
    eidx = np.repeat(starts, counts) + offs
    targets = indices[eidx].astype(np.int64)
    sources = np.repeat(frontier, counts)
    edges = perm[eidx].astype(np.int64) if perm is not None else None
    return targets, sources, edges


def _relax_wave(
    dist: np.ndarray,
    seeds: np.ndarray,
    indptr: np.ndarray,
    indices: np.ndarray,
    perm: Optional[np.ndarray],
    weights: Optional[np.ndarray],
) -> Tuple[np.ndarray, np.ndarray, int]:
    """Decrease-only relaxation from ``seeds`` to fixpoint.

    Returns (final dist, changed-vertex mask, rounds). Every committed write
    is a strict decrease, so the result is the true min-plus fixpoint over
    the current graph — the same fixpoint the accelerator converges to.
    """
    changed = np.zeros(dist.shape[0], dtype=bool)
    frontier = np.asarray(seeds, dtype=np.int64)
    rounds = 0
    while frontier.size:
        rounds += 1
        targets, sources, edges = _expand(frontier, indptr, indices, perm)
        if targets.size == 0:
            break
        step = weights[edges] if weights is not None else 1
        cand = dist[sources] + step
        nd = dist.copy()
        np.minimum.at(nd, targets, cand)
        frontier = np.flatnonzero(nd < dist)
        dist = nd
        changed[frontier] = True
    return dist, changed, rounds


def _repair_distance(
    template: IncrementalTemplate,
    graph: GraphData,
    cached: EngineResult,
    added: np.ndarray,
    *,
    weighted: bool,
) -> Tuple[dict, int, dict]:
    props = dict(cached.properties)
    dist_arr = np.asarray(props[template.dist_prop])
    dtype = dist_arr.dtype
    dist = dist_arr.astype(np.int64)

    if weighted:
        # The unreached sentinel (~2^30) already behaves as +inf under min;
        # replicate device arithmetic verbatim, no remapping needed.
        reach_limit = np.int64(template.unreached)
    else:
        # BFS marks unreached as a *small* sentinel (-1); lift it to +inf so
        # min-space relaxation is uniform.
        reach_limit = _INF
        dist = np.where(dist == np.int64(template.unreached), _INF, dist)

    indptr, indices, perm = graph.csr
    w_int = (
        np.asarray(graph.weights).astype(np.int64)
        if weighted and graph.weights is not None
        else None
    )

    srcs = np.unique(added[:, 0]).astype(np.int64)
    seeds = srcs[dist[srcs] < reach_limit]
    dist, changed, rounds = _relax_wave(
        dist, seeds, indptr, indices, perm if weighted else None, w_int
    )

    # Neighbor-minimum maintenance: every source whose distance changed (and
    # every reached source of a new edge) re-offers dist+step along ALL its
    # out-edges; min against the cached tuple is exactly the from-scratch
    # value (candidates from unchanged, pre-existing sources are already
    # folded into the cached tuple).
    if template.tuple_prop is not None:
        touched = np.unique(np.concatenate([np.flatnonzero(changed), seeds]))
        tup_arr = np.asarray(props[template.tuple_prop])
        tup = tup_arr.astype(np.int64)
        if touched.size:
            targets, sources, edges = _expand(
                touched, indptr, indices, perm if weighted else None
            )
            if targets.size:
                step = w_int[edges] if w_int is not None else 1
                np.minimum.at(tup, targets, dist[sources] + step)
        props[template.tuple_prop] = tup.astype(dtype)

    if not weighted:
        dist = np.where(dist >= _INF, np.int64(template.unreached), dist)
    dist_out = dist.astype(dtype)
    props[template.dist_prop] = dist_out
    for m in template.mirror_props:
        props[m] = dist_out

    env_updates = {}
    if template.round_scalar is not None:
        finite = dist[dist < reach_limit] if weighted else dist[dist >= 0]
        env_updates[template.round_scalar] = (
            int(finite.max()) + 1 if finite.size else 1
        )
    return props, rounds, env_updates


def _repair_label(
    template: IncrementalTemplate,
    graph: GraphData,
    cached: EngineResult,
    added: np.ndarray,
    lane_ids: Optional[np.ndarray] = None,
) -> Tuple[dict, int, dict]:
    props = dict(cached.properties)
    arr = np.asarray(props[template.dist_prop])
    labels = arr.astype(np.int64)
    out_ptr, out_idx, _ = graph.csr
    in_ptr, in_idx, _ = graph.csc

    # Min-label flood, pushed symmetrically (the program's edge kernel
    # relaxes both endpoints): any vertex whose label drops re-enters the
    # frontier and pushes along its out- AND in-edges, so the merged
    # component converges to its global minimum — the from-scratch fixpoint.
    frontier = np.unique(added.reshape(-1)).astype(np.int64)
    rounds = 0
    while frontier.size:
        rounds += 1
        t1, s1, _ = _expand(frontier, out_ptr, out_idx, None)
        t2, s2, _ = _expand(frontier, in_ptr, in_idx, None)
        targets = np.concatenate([t1, t2])
        sources = np.concatenate([s1, s2])
        if targets.size == 0:
            break
        nl = labels.copy()
        np.minimum.at(nl, targets, labels[sources])
        frontier = np.flatnonzero(nl < labels)
        labels = nl

    if lane_ids is not None:
        # The program's labels are its lane ids (``comp[v] = v``). Under the
        # hub relabel those are degree ranks, which the update moved: the
        # flooded labels still name the components, and each component
        # takes the smallest lane id of its members under the new ranking,
        # as a run from scratch labels it.
        lane_ids = np.asarray(lane_ids, dtype=np.int64)
        low = np.full(labels.shape[0], np.iinfo(np.int64).max, dtype=np.int64)
        np.minimum.at(low, labels, lane_ids)
        labels = low[labels]

    out = labels.astype(arr.dtype)
    props[template.dist_prop] = out
    for m in template.mirror_props:
        props[m] = out
    return props, rounds, {}


def repair_result(
    info: IncrementalInfo,
    graph: GraphData,
    cached: EngineResult,
    added: np.ndarray,
    *,
    version: int = 0,
    lane_ids: Optional[np.ndarray] = None,
) -> EngineResult:
    """Repair ``cached`` against additions ``added`` ([K, 2] int array).

    ``graph`` must be the *updated* graph (additions already applied) in the
    original id space. The caller is responsible for checking
    ``info.incremental_ok`` and that every pending delta is additions-only.
    ``lane_ids`` maps each original vertex id to the id the program sees
    (the engine's ``old2new`` after its refresh, None when the engine does
    not relabel); a label template's repair renames each component by it.
    """
    template = info.template
    if template is None:
        raise ValueError("repair_result requires an incremental template")
    added = np.asarray(added, dtype=np.int64).reshape(-1, 2)
    t0 = time.perf_counter()
    if template.kind == "label":
        props, rounds, env_updates = _repair_label(template, graph, cached, added, lane_ids)
    elif template.kind in ("unit_distance", "weighted_distance"):
        props, rounds, env_updates = _repair_distance(
            template, graph, cached, added,
            weighted=template.kind == "weighted_distance",
        )
    else:  # pragma: no cover - analyze_incremental only emits the kinds above
        raise ValueError(f"unknown incremental template kind: {template.kind}")

    # Additions recycle padding slots, so the physical weight array changed
    # in-place; a from-scratch run would surface the new values.
    if "weight" in props and graph.weights is not None:
        props["weight"] = np.asarray(graph.weights).astype(props["weight"].dtype)

    host_env = dict(cached.host_env)
    host_env.update(env_updates)
    elapsed = time.perf_counter() - t0
    stats = EngineStats()
    stats.host_iterations = rounds
    stats.wall_time_s = elapsed
    stats.run_time_s = elapsed  # pure host work: zero compile time by design
    return EngineResult(
        properties=props, host_env=host_env, stats=stats, version=version
    )
