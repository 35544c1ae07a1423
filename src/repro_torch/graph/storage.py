"""Graph storage substrate: COO / CSR, partitioning, hub detection.

This is the memory layout layer of the back-end framework (paper Fig. 4):

* **EdgeList (COO)** feeds edge-centric kernels ("Burst Read" of edges).
* **CSR** feeds vertex-centric kernels (``v.getNeighbors()``).
* **dst-range partitioning** sizes each destination slice to VMEM (the
  paper sizes partitions to URAM, §III-D) with ascending-src order inside
  each partition.
* **hub relabeling** maps the highest-degree vertices to the lowest ids so
  a dense prefix of every property vector acts as the hub cache (paper
  Fig. 7(b)).
* **dst-sorted permutation** drives the conflict-free shuffle reduction
  (paper Fig. 7(c)): with a static graph the shuffle network's routing is
  precomputed as a permutation, and the reduce becomes a sorted segment
  reduction.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from functools import cached_property
from typing import Optional, Tuple

import numpy as np

# int32 indptr covers edge counts below 2^31; the device ABI (and AOT shape
# signatures) standardize every CSR/CSC array on int32, so larger graphs
# must be sharded rather than silently widened to int64
MAX_INT32_EDGES = 2**31


def _indptr_from_degrees(degrees: np.ndarray, n_edges: int) -> np.ndarray:
    """int32 CSR/CSC indptr from a degree vector, with an overflow guard.

    Keeping indptr int32 (like indices/edge_perm) keeps device buffers and
    AOT shape signatures stable; E >= 2^31 cannot be represented and fails
    loudly here instead of wrapping.
    """
    if n_edges >= MAX_INT32_EDGES:
        raise OverflowError(
            f"graph has {n_edges} edges; int32 indptr covers < 2^31 "
            f"({MAX_INT32_EDGES}). Shard the graph (distributed backend) "
            f"instead of widening the device ABI."
        )
    indptr = np.zeros(degrees.shape[0] + 1, dtype=np.int64)
    np.cumsum(degrees, out=indptr[1:])
    return indptr.astype(np.int32)


class GraphUpdateError(RuntimeError):
    """A :class:`GraphDelta` cannot be applied inside the current bucket."""


def _edge_pairs(edges) -> np.ndarray:
    """Coerce an edge collection to an int32 [K, 2] (src, dst) array."""
    if edges is None:
        return np.empty((0, 2), dtype=np.int32)
    arr = np.asarray(edges, dtype=np.int32)
    if arr.size == 0:
        return arr.reshape(0, 2)
    if arr.ndim != 2 or arr.shape[1] != 2:
        raise ValueError(f"edges must be [K, 2] (src, dst) pairs, got shape {arr.shape}")
    return arr


@dataclass(frozen=True)
class GraphDelta:
    """A batch of edge mutations applied atomically by ``apply_updates``.

    ``added_edges`` / ``removed_edges`` are [K, 2] (src, dst) pairs (any
    array-like; coerced to int32). ``added_weights`` optionally carries one
    weight per added edge; weighted graphs default missing weights to 1.
    """

    added_edges: Optional[np.ndarray] = None  # int32 [K, 2]
    removed_edges: Optional[np.ndarray] = None  # int32 [K, 2]
    added_weights: Optional[np.ndarray] = None  # [K] or None

    def __post_init__(self):
        object.__setattr__(self, "added_edges", _edge_pairs(self.added_edges))
        object.__setattr__(self, "removed_edges", _edge_pairs(self.removed_edges))
        if self.added_weights is not None:
            w = np.asarray(self.added_weights)
            if w.shape != (len(self.added_edges),):
                raise ValueError(
                    f"added_weights shape {w.shape} does not match "
                    f"{len(self.added_edges)} added edges"
                )
            object.__setattr__(self, "added_weights", w)

    @property
    def n_added(self) -> int:
        return int(self.added_edges.shape[0])

    @property
    def n_removed(self) -> int:
        return int(self.removed_edges.shape[0])

    @property
    def additions_only(self) -> bool:
        return self.n_removed == 0

    def endpoints(self) -> np.ndarray:
        """Unique vertex ids touched by the delta (incremental seeds)."""
        return np.unique(
            np.concatenate([self.added_edges.ravel(), self.removed_edges.ravel()])
        )


@dataclass
class GraphData:
    """A graph with precomputed access-optimization metadata.

    Graphs are immutable for every static workflow; the streaming path
    (:mod:`repro.streaming`) mutates one **in place** through
    :meth:`apply_updates`, which recycles ``pad_to`` padding slack as an
    edge free-list so the physical shape — and therefore the
    :class:`~repro.core.accelerator.GraphShape` bucket — never changes.

    ``n_vertices`` / ``n_edges`` are the *physical* (possibly padded)
    counts that size device buffers; ``n_vertices_logical`` /
    ``n_edges_logical`` are the real graph's counts. Globally-normalized
    algorithms (``vertices.size()`` — PageRank's 1/|V| teleport mass) read
    the logical counts, so padded and unpadded runs agree.
    """

    n_vertices: int
    src: np.ndarray  # int32 [E]
    dst: np.ndarray  # int32 [E]
    weights: Optional[np.ndarray] = None  # float32/int32 [E] or None
    n_vertices_logical: Optional[int] = None  # real |V| (defaults to physical)
    n_edges_logical: Optional[int] = None  # real |E| (defaults to physical)
    # bumped by every in-place mutation (apply_updates / compact) so callers
    # holding a reference can detect staleness without hashing arrays
    version: int = field(default=0, init=False, repr=False, compare=False)

    def __post_init__(self):
        self.src = np.asarray(self.src, dtype=np.int32)
        self.dst = np.asarray(self.dst, dtype=np.int32)
        if self.weights is not None:
            self.weights = np.asarray(self.weights)
        if self.src.shape != self.dst.shape:
            raise ValueError("src/dst shape mismatch")
        if self.n_vertices_logical is None:
            self.n_vertices_logical = self.n_vertices
        if self.n_edges_logical is None:
            self.n_edges_logical = self.n_edges
        if not 0 <= self.n_vertices_logical <= self.n_vertices:
            raise ValueError(
                f"n_vertices_logical={self.n_vertices_logical} outside "
                f"[0, {self.n_vertices}]"
            )
        if not 0 <= self.n_edges_logical <= self.n_edges:
            raise ValueError(
                f"n_edges_logical={self.n_edges_logical} outside [0, {self.n_edges}]"
            )

    # -- basic properties ---------------------------------------------------
    @property
    def n_edges(self) -> int:
        return int(self.src.shape[0])

    @property
    def weighted(self) -> bool:
        return self.weights is not None

    @cached_property
    def out_degree(self) -> np.ndarray:
        return np.bincount(self.src, minlength=self.n_vertices).astype(np.int32)

    @cached_property
    def in_degree(self) -> np.ndarray:
        return np.bincount(self.dst, minlength=self.n_vertices).astype(np.int32)

    # -- CSR (out-edges) ------------------------------------------------------
    @cached_property
    def csr(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(indptr[V+1], indices[E], edge_perm[E]): out-adjacency, all int32.

        ``edge_perm`` maps CSR slot -> original edge id, so edge weights /
        edge properties can be gathered for neighbor iteration.
        """
        order = np.argsort(self.src, kind="stable").astype(np.int32)
        return (
            _indptr_from_degrees(self.out_degree, self.n_edges),
            self.dst[order],
            order,
        )

    @cached_property
    def csc(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(indptr, indices, edge_perm): in-adjacency (pull), all int32."""
        order = np.argsort(self.dst, kind="stable").astype(np.int32)
        return (
            _indptr_from_degrees(self.in_degree, self.n_edges),
            self.src[order],
            order,
        )

    @cached_property
    def row_ids(self) -> np.ndarray:
        """CSR row id per CSR slot: vertex owning each out-edge."""
        indptr, _, _ = self.csr
        return np.repeat(
            np.arange(self.n_vertices, dtype=np.int32),
            np.diff(indptr).astype(np.int64),
        )

    # -- shuffle metadata (paper Fig. 7(c)) ------------------------------------
    @cached_property
    def dst_sort_perm(self) -> np.ndarray:
        """Permutation sorting edges by destination (stable).

        The static-graph analogue of the on-the-fly shuffle network: the
        routing decision is precomputed once, and the runtime reduce is a
        sorted segment reduction (conflict-free by construction).
        """
        return np.argsort(self.dst, kind="stable").astype(np.int32)

    # -- hub cache metadata (paper Fig. 7(b)) ----------------------------------
    @cached_property
    def degree_rank(self) -> np.ndarray:
        """Vertices ordered by (in+out) degree, descending — hubs first."""
        return np.argsort(-(self.out_degree.astype(np.int64) + self.in_degree)).astype(
            np.int32
        )

    def relabel_by_degree(self) -> Tuple["GraphData", np.ndarray]:
        """Return (relabeled graph, old->new map) with hubs at ids [0, K).

        Property vectors of the relabeled graph keep hub entries in a dense
        prefix, which is the software analogue of pinning hub vertices in
        URAM/VMEM: gathers for high-degree vertices hit one small block.
        """
        old2new = np.empty(self.n_vertices, dtype=np.int32)
        old2new[self.degree_rank] = np.arange(self.n_vertices, dtype=np.int32)
        g = GraphData(
            self.n_vertices,
            old2new[self.src],
            old2new[self.dst],
            None if self.weights is None else self.weights.copy(),
            n_vertices_logical=self.n_vertices_logical,
            n_edges_logical=self.n_edges_logical,
        )
        return g, old2new

    # -- dst-range partitioning (paper §III-D) -------------------------------
    def partition_by_dst(self, n_partitions: int) -> "PartitionedEdges":
        """Split edges into ``n_partitions`` contiguous dst ranges.

        Inside each partition edges are ordered by ascending ``src``
        (paper: "organizes edges (src, dst) into subgraphs with ascending
        src values within each subpartition") so source-property reads
        stream near-sequentially while the destination slice stays resident.
        """
        n_partitions = max(1, min(n_partitions, self.n_vertices))
        bounds = np.linspace(0, self.n_vertices, n_partitions + 1).astype(np.int64)
        part_of_edge = np.searchsorted(bounds[1:], self.dst, side="right")
        order = np.lexsort((self.src, part_of_edge)).astype(np.int32)
        counts = np.bincount(part_of_edge, minlength=n_partitions)
        offsets = np.zeros(n_partitions + 1, dtype=np.int64)
        np.cumsum(counts, out=offsets[1:])
        return PartitionedEdges(
            graph=self,
            n_partitions=n_partitions,
            vertex_bounds=bounds,
            edge_order=order,
            edge_offsets=offsets,
        )

    # -- convenience ----------------------------------------------------------
    def with_unit_weights(self) -> "GraphData":
        if self.weighted:
            return self
        return GraphData(
            self.n_vertices,
            self.src,
            self.dst,
            np.ones(self.n_edges, np.float32),
            n_vertices_logical=self.n_vertices_logical,
            n_edges_logical=self.n_edges_logical,
        )

    def pad_to(self, n_vertices: int, n_edges: int) -> "GraphData":
        """Pad to a shape bucket: isolated vertices + padding self-loops.

        The accelerator artifact path (:meth:`repro.Program.lower`) compiles
        against a :class:`~repro.core.accelerator.GraphShape` bucket; graphs
        below the bucket are padded up so they share one lowering. Padding
        edges are self-loops on the LAST padding vertex, so no real vertex's
        degree or neighborhood changes.

        The padded graph carries the original counts as
        ``n_vertices_logical`` / ``n_edges_logical``, and ``size()`` (host
        and kernel) reads the logical counts — so globally-normalized
        algorithms (PageRank's 1/|V| teleport mass, PPR) agree between
        padded and unpadded runs. Padding self-loops double as the edge
        free-list that :meth:`apply_updates` consumes, which is why a
        padding edge must never touch a real vertex.
        """
        pad_v = n_vertices - self.n_vertices
        pad_e = n_edges - self.n_edges
        if pad_v < 0 or pad_e < 0:
            raise ValueError(
                f"pad_to target (|V|={n_vertices}, |E|={n_edges}) is smaller "
                f"than the graph (|V|={self.n_vertices}, |E|={self.n_edges})"
            )
        if pad_v == 0 and pad_e == 0:
            return self
        if pad_e > 0 and pad_v == 0:
            raise ValueError(
                "padding edges need at least one padding vertex to carry the "
                "self-loops (a self-loop on a real vertex would change its "
                "degree); pad n_vertices by >= 1 too"
            )
        loop = np.full(pad_e, n_vertices - 1, dtype=np.int32)
        src = np.concatenate([self.src, loop])
        dst = np.concatenate([self.dst, loop])
        w = None
        if self.weights is not None:
            w = np.concatenate([
                self.weights,
                np.ones(pad_e, dtype=self.weights.dtype),
            ])
        return GraphData(
            n_vertices,
            src,
            dst,
            w,
            n_vertices_logical=self.n_vertices_logical,
            n_edges_logical=self.n_edges_logical,
        )

    # -- streaming updates (repro.streaming) ----------------------------------
    def _invalidate_caches(self) -> None:
        """Drop every cached derived structure after an in-place mutation."""
        for name in ("out_degree", "in_degree", "csr", "csc", "row_ids",
                     "dst_sort_perm", "degree_rank"):
            self.__dict__.pop(name, None)

    def _free_slot_mask(self) -> np.ndarray:
        """Free edge slots: padding self-loops on non-logical vertices."""
        return (self.src == self.dst) & (self.src >= self.n_vertices_logical)

    def apply_updates(self, delta: GraphDelta, *, compact: bool = False) -> "GraphData":
        """Apply an edge delta IN PLACE, reusing padding slack as slots.

        Removed edges are tombstoned — rewritten into padding self-loops on
        the last (padding) vertex, returning their slot to the free list.
        Added edges consume free slots. The physical (|V|, |E|) — and with
        it the :class:`~repro.core.accelerator.GraphShape` bucket — never
        changes, so an update against a bound
        :class:`~repro.core.accelerator.Accelerator` is a shape-check-only
        rebind: no re-lowering, no recompilation.

        The mutation is all-or-nothing: feasibility (removals present,
        enough free slots, endpoints in the logical range) is checked
        before any array is touched, and a :class:`GraphUpdateError` means
        the graph is unchanged — re-pad into a larger bucket (see
        ``GraphShape.bucket_for``) and retry. Expects the ``pad_to``
        padding layout (call on the original graph, never a relabeled one).
        """
        add, rem = delta.added_edges, delta.removed_edges
        lv, le = self.n_vertices_logical, self.n_edges_logical
        for kind, e in (("added", add), ("removed", rem)):
            if e.size and (int(e.min()) < 0 or int(e.max()) >= lv):
                raise GraphUpdateError(
                    f"{kind} edges reference vertex ids outside the logical "
                    f"range [0, {lv}); growing the vertex set needs a re-pad "
                    f"into a larger bucket"
                )
        free_mask = self._free_slot_mask()
        n_free = int(free_mask.sum())
        if n_free != self.n_edges - le:
            raise GraphUpdateError(
                f"padding-slot invariant violated: expected {self.n_edges - le} "
                f"free self-loop slots, found {n_free} (apply_updates needs "
                f"the pad_to layout of the original, unrelabeled graph)"
            )
        # resolve removals to physical slots BEFORE mutating anything, so a
        # failed lookup or overflow leaves the graph untouched
        tomb = np.empty(0, dtype=np.int64)
        if len(rem):
            keys = self.src.astype(np.int64) * self.n_vertices + self.dst
            keys[free_mask] = -1  # free slots are not removable edges
            order = np.argsort(keys, kind="stable")
            skeys = keys[order]
            rkeys = rem[:, 0].astype(np.int64) * self.n_vertices + rem[:, 1]
            uniq, counts = np.unique(rkeys, return_counts=True)
            picks = []
            for k, c in zip(uniq, counts):
                lo = int(np.searchsorted(skeys, k, "left"))
                hi = int(np.searchsorted(skeys, k, "right"))
                if hi - lo < int(c):
                    u, v = divmod(int(k), self.n_vertices)
                    raise GraphUpdateError(
                        f"cannot remove edge ({u}, {v}): {int(c)} removal(s) "
                        f"requested but only {hi - lo} present"
                    )
                picks.append(order[lo:lo + int(c)])
            tomb = np.concatenate(picks)
            if self.n_vertices == lv:
                raise GraphUpdateError(
                    "removals need at least one padding vertex to carry the "
                    "tombstone self-loops; pad_to a larger bucket first"
                )
        if n_free + len(tomb) < len(add):
            need_e = le - len(rem) + len(add)
            raise GraphUpdateError(
                f"delta needs {len(add)} free edge slots but only "
                f"{n_free + len(tomb)} are available in this bucket; re-pad "
                f"to GraphShape.bucket_for({lv}, {need_e}) and re-bind"
            )
        pad_vertex = self.n_vertices - 1
        if len(tomb):
            self.src[tomb] = pad_vertex
            self.dst[tomb] = pad_vertex
            if self.weights is not None:
                self.weights[tomb] = 1
        if len(add):
            free = np.flatnonzero(self._free_slot_mask())
            slots = free[: len(add)]
            self.src[slots] = add[:, 0]
            self.dst[slots] = add[:, 1]
            if self.weights is not None:
                if delta.added_weights is not None:
                    self.weights[slots] = np.asarray(
                        delta.added_weights, dtype=self.weights.dtype
                    )
                else:
                    self.weights[slots] = 1
        self.n_edges_logical = le - len(rem) + len(add)
        self.version += 1
        self._invalidate_caches()
        if compact:
            self.compact()
        return self

    def compact(self) -> "GraphData":
        """Stable-partition real edges ahead of free slots, in place.

        Semantically a no-op (the edge multiset is unchanged), but after
        many tombstone/append cycles it restores the "real edges first,
        padding last" layout ``pad_to`` produced, keeping processing order
        close to the freshly-padded graph's.
        """
        free_mask = self._free_slot_mask()
        if not free_mask.any():
            return self
        order = np.argsort(free_mask, kind="stable")  # real edges first
        self.src = self.src[order]
        self.dst = self.dst[order]
        if self.weights is not None:
            self.weights = self.weights[order]
        self.version += 1
        self._invalidate_caches()
        return self


@dataclass
class PartitionedEdges:
    """dst-range partitioned edge list (the URAM/VMEM sizing unit)."""

    graph: GraphData
    n_partitions: int
    vertex_bounds: np.ndarray  # [P+1] dst-range boundaries
    edge_order: np.ndarray  # [E] permutation: partitioned order -> edge id
    edge_offsets: np.ndarray  # [P+1] edge range per partition

    def partition_edges(self, p: int) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
        sl = slice(self.edge_offsets[p], self.edge_offsets[p + 1])
        ids = self.edge_order[sl]
        w = None if self.graph.weights is None else self.graph.weights[ids]
        return self.graph.src[ids], self.graph.dst[ids], w

    @property
    def max_partition_vertices(self) -> int:
        return int(np.max(np.diff(self.vertex_bounds)))


def graph_from_arrays(
    n_vertices: int,
    src,
    dst,
    weights=None,
    *,
    n_vertices_logical: Optional[int] = None,
    n_edges_logical: Optional[int] = None,
) -> GraphData:
    """Build a :class:`GraphData` from plain edge arrays.

    Any array-likes with a numpy view work (numpy arrays, lists, CPU
    tensors), so a graph built by another package crosses over as its
    ``(n_vertices, src, dst, weights)`` arrays and both sides run on the
    same edges in the same order. A graph padded with ``pad_to`` crosses
    with its real counts too (``n_vertices_logical``, ``n_edges_logical``;
    ``None`` means the physical count), so programs that normalise by
    ``vertices.size()`` agree on both sides.
    """
    return GraphData(
        int(n_vertices),
        np.array(src, dtype=np.int32),
        np.array(dst, dtype=np.int32),
        None if weights is None else np.array(weights),
        n_vertices_logical=None if n_vertices_logical is None else int(n_vertices_logical),
        n_edges_logical=None if n_edges_logical is None else int(n_edges_logical),
    )
