"""Host driver: executes ``main()`` and launches device kernels.

This is the system-integration layer of the paper (§III-D): the FPGA build
manages accelerators through OpenCL/XRT. Here the host program is
interpreted in Python, device kernels are PyTorch executables on one
device (the hand-written CUDA kernels on a GPU), and host<->device data
movement is tensor transfer. Graph loading / partitioning / property
allocation are implicit interfaces hidden from the algorithm author.

Engine-level optimizations:
* **hub-vertex cache** (target.cache): the graph is degree-relabeled once
  at bind so hub properties occupy a dense prefix; host-side vertex ids
  are translated at the host/device boundary.
* **frontier compaction** (target.compact_frontier): edge kernels guarded
  by a Frontier Check only traverse edges whose source is active, with
  power-of-two padding (the same pads as the reference, so launch counts
  match). The frontier mask is evaluated on the host, which copies one
  property per such launch from the device. Large frontiers fall back to
  the full-edge stream — the direction-switching insight of paper Fig. 2.

An engine launches the kernels of a shape-generic kernel library: the
library of the :class:`~.accelerator.Accelerator` it was bound from
(``library=``), whose warm-key registry it shares, or one of its own.
Under :mod:`repro_torch.telemetry` a run opens the ``run`` span and each
launch a ``launch:<kernel>`` span (host clocks, as the reference's;
nothing synchronizes the device per launch), and the result carries the
run's span summary in ``trace``.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from . import backend, fir, mir, semantic
from .backend import DTYPES, WEIGHT_KEY
from .. import telemetry as tel
from ..graph.storage import GraphData


class EngineError(Exception):
    pass


@dataclass
class EngineStats:
    """Per-run execution counters.

    A stats object describes ONE engine run, which may answer more than one
    query: a batched run (:mod:`repro_torch.batch`) answers K parameter
    bindings with one set of launches and attaches the same stats object to
    all K results with ``batch_size == K``. Launch and edge counters are
    per batch; :attr:`per_query_launches` divides by the batch.
    """

    kernel_launches: Dict[str, int] = field(default_factory=dict)
    compacted_launches: int = 0
    full_launches: int = 0
    # shuffle supersteps of the distributed engine (core/dist_engine.py)
    dist_supersteps: int = 0
    edges_traversed: int = 0
    host_iterations: int = 0
    wall_time_s: float = 0.0
    # cold-vs-warm split of wall_time_s: compile_time_s is the wall time of
    # each executable's first call in this engine (on a GPU this includes
    # building and loading the CUDA kernels); run_time_s is the remainder
    compile_time_s: float = 0.0
    run_time_s: float = 0.0
    # kernel-fusion accounting (the `fuse` MIR pass): how many launches hit
    # a fused kernel, and how many separate launches fusion saved overall
    fused_launches: int = 0
    launches_saved: int = 0
    # host-side frontier masks of compactable edge launches: how many were
    # evaluated and the wall time spent on them, device-to-host copies of
    # the properties they read included
    frontier_masks: int = 0
    frontier_mask_s: float = 0.0
    # how many queries this run answered (1 = a sequential run; K > 1 = one
    # batched run whose launches served K parameter bindings at once)
    batch_size: int = 1

    @property
    def total_launches(self) -> int:
        return sum(self.kernel_launches.values())

    @property
    def per_query_launches(self) -> float:
        """Launches amortized over the queries this run answered."""
        return self.total_launches / max(self.batch_size, 1)


def count_launch(stats: EngineStats, module: mir.Module, name: str) -> None:
    """Record one logical kernel launch (a fused kernel counts once, not
    per stage)."""
    stats.kernel_launches[name] = stats.kernel_launches.get(name, 0) + 1
    parts = module.fusion_groups.get(name)
    if parts:
        stats.fused_launches += 1
        stats.launches_saved += len(parts) - 1


@dataclass
class EngineResult:
    properties: Dict[str, np.ndarray]
    host_env: Dict[str, Any]
    stats: EngineStats
    # graph version the query was answered against (streaming sessions pin
    # every admitted query to one version; 0 = static/unversioned binding)
    version: int = 0
    # per-run telemetry summary: the run's span tree aggregated by name when
    # tracing was on, None otherwise. Batched runs share one summary across
    # the K results, as they share ``stats``.
    trace: Optional[Dict[str, Any]] = None


@dataclass
class BatchedLaunch:
    """One kernel launch over a leading batch (query) axis.

    ``fn(state, scalars) -> updates`` with every state tensor ``[K, n]``
    and every scalar ``[K, 1]``; ``bump_stats`` applies the counter
    increments ONE sequential launch of the kernel records (the batch
    engine counts a batched launch once; ``EngineStats.batch_size`` holds
    the amortization)."""

    fn: Callable[[Dict[str, torch.Tensor], Dict[str, torch.Tensor]], Dict[str, torch.Tensor]]
    bump_stats: Callable[["EngineStats"], None]


def _next_pow2(n: int) -> int:
    return 1 << max(10, (max(1, n) - 1).bit_length())


def race_safe_target(module: mir.Module, target):
    """``(target, forced)``: a program whose static analysis found a true
    scatter race (GT101) is only sequentially correct under the sorted
    shuffle commit, so disabling shuffle on it is an ablation of
    correctness, not of performance: the analysis verdict wins and
    ``shuffle`` is forced on."""
    if not target.shuffle:
        from ..analysis import needs_shuffle

        if needs_shuffle(module):
            import dataclasses

            return dataclasses.replace(target, shuffle=True), True
    return target, False


def _full_edges(graph: GraphData, kern) -> int:
    """Edges one full-stream launch of ``kern`` traverses."""
    if kern.kind is mir.KernelKind.EDGE:
        return graph.n_edges
    if isinstance(kern, mir.PipelineKernel):
        return graph.n_edges * len(kern.edge_stages)
    return 0


class Engine:
    """Executes one compiled Graphitron module against one graph on one
    device (``"cuda"`` or ``"cpu"``); ``library`` is the kernel library of
    the Accelerator it was bound from (the Accelerator checked the graph
    against its bucket), else the engine lowers a library of its own."""

    def __init__(
        self,
        module: mir.Module,
        graph: GraphData,
        target,
        device: str,
        argv: Optional[List[str]] = None,
        *,
        library=None,
    ):
        self.module = module
        self.device = device
        self.target, self.shuffle_forced = race_safe_target(module, target)
        self.argv = argv or []
        self.stats = EngineStats()
        if library is None:
            from .accelerator import GraphShape, KernelLibrary

            library = KernelLibrary(module, self.target, GraphShape.of(graph), device)
        self.library = library
        # first-touch timing keys; an accelerator's engines share its
        # library's registry, so a rebind starts warm where earlier binds were
        self._warm_keys = library.warm_keys

        # the graph as handed in (original vertex ids): refresh_graph
        # re-derives every binding from it after an in-place mutation
        self.source_graph = graph
        # accumulator properties are NOT vertex-indexed (no id translation)
        self.accumulator_props = set()
        for k in module.kernels.values():
            self.accumulator_props |= k.accumulators
        self._bind_graph(graph)

    def _bind_graph(self, graph: GraphData) -> None:
        """Derive every graph-dependent binding from ``graph``: the hub
        relabel, the device bindings, the degree and weight buffers, and
        the caches over them; then reset the state."""
        # a refresh drops the old bindings first (on the card, two sets of
        # them would double the graph's footprint), with the kernels bound
        # to them and the frontier builder's closure over the old CSR
        self.gb: Dict[str, Any] = {}
        self._lowered: Dict[str, backend.LoweredKernel] = {}
        self._initial: Dict[str, torch.Tensor] = {}
        self.state: Dict[str, torch.Tensor] = {}
        self._host_cache: Dict[str, Tuple[torch.Tensor, np.ndarray]] = {}
        for attr in ("_build_batch", "_deg_np"):
            self.__dict__.pop(attr, None)
        # ---- hub cache: degree relabeling (paper Fig. 7(b)) ----
        if self.target.cache:
            self.graph, self.old2new = graph.relabel_by_degree()
            new2old = graph.degree_rank
        else:
            self.graph, self.old2new = graph, None
            new2old = None
        module = self.module
        self.gb = backend._graph_bindings(self.graph, module, self.target,
                                          new2old=new2old, device=self.device)
        # degree and weight buffers are uploaded once per bind; reset()
        # reuses them, since state tensors are never written in place
        for name, direction in module.degree_props.items():
            deg = self.graph.out_degree if direction == "out" else self.graph.in_degree
            self._initial[name] = self._tensor(deg, DTYPES[module.properties[name].scalar])
        if module.graph.weighted:
            if self.graph.weights is None:
                raise EngineError("weighted edgeset but the loaded graph has no weights")
            wdt = DTYPES[module.graph.weight_scalar or "float"]
            self._initial[WEIGHT_KEY] = self._tensor(self.graph.weights, wdt)
        self.reset()

    def refresh_graph(self, graph: Optional[GraphData] = None) -> None:
        """Re-derive every graph-dependent binding after an in-place update.

        The streaming path mutates ``GraphData`` arrays in place
        (:meth:`GraphData.apply_updates`), which invalidates the hub
        relabel, the burst processing order, every CSR/CSC binding and the
        degree and weight buffers this engine uploaded at bind. The graph
        must stay in the library's bucket. The library's kernels are
        shape-generic (they take the bindings as arguments), so nothing is
        lowered again and the warm keys stay: an in-bucket refresh reports
        no compile time, for a plain engine as for an accelerator's.
        """
        graph = graph if graph is not None else self.source_graph
        self.library.shape.check_bucket(graph)
        self.source_graph = graph
        self._bind_graph(graph)

    def _tensor(self, arr: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
        """A copy of ``arr`` on the device, on the CPU too: the buffer must
        not share memory with the graph, which ``apply_updates`` mutates in
        place."""
        return torch.from_numpy(np.ascontiguousarray(arr)).to(
            device=self.device, dtype=dtype, copy=True)

    def reset(self):
        """(Re)initialize device/host state, keeping lowered kernels — the
        repeat-run path for benchmarking and reuse."""
        module, graph = self.module, self.graph
        self.stats = EngineStats()
        self.state = {}
        # ---- memory allocation (implicit interface) ----
        for p in module.properties.values():
            n = graph.n_edges if p.is_edge else graph.n_vertices
            self.state[p.name] = torch.zeros(n, dtype=DTYPES[p.scalar], device=self.device)
        self.state.update(self._initial)
        # ---- host scalar environment ----
        self.host_env = {}
        for s in module.scalars.values():
            self.host_env[s.name] = self._eval_host(s.init) if s.init is not None else 0

    # ------------------------------------------------------------------
    # vertex id translation at the host/device boundary
    # ------------------------------------------------------------------
    def _xlate(self, prop: str, idx: int) -> int:
        info = self.module.properties[prop]
        if (
            self.old2new is not None
            and not info.is_edge
            and prop not in self.accumulator_props
            and prop not in self.module.degree_props
        ):
            return int(self.old2new[idx])
        return int(idx)

    # ------------------------------------------------------------------
    # kernel launching
    # ------------------------------------------------------------------
    def _kernel(self, name: str) -> backend.LoweredKernel:
        if name not in self._lowered:
            if name not in self.module.kernels:
                raise EngineError(f"{name!r} is not a device kernel")
            self._lowered[name] = self.library.kernel_for(name, self.gb)
        return self._lowered[name]

    def _timed_call(self, key, fn, *args, stats: Optional[EngineStats] = None):
        """Call ``fn``; attribute a first-touch (cold) call's wall time to
        ``compile_time_s`` of ``stats`` (this engine's by default). The
        warm-key registry survives reset() and is shared with the batch
        engine that wraps this one (its keys are ``("batched", name, K)``)."""
        if key in self._warm_keys:
            return fn(*args)
        t0 = time.perf_counter()
        try:
            return fn(*args)
        finally:
            if self.device != "cpu":
                torch.cuda.synchronize(self.device)
            (stats or self.stats).compile_time_s += time.perf_counter() - t0
            self._warm_keys.add(key)

    def _kernel_scalars(self, name: str) -> Dict[str, torch.Tensor]:
        k = self.module.kernels[name]
        out = {}
        for s in sorted(k.scalar_reads):
            info = self.module.scalars[s]
            out[s] = backend.const(self.host_env[s], DTYPES[info.scalar], self.device)
        return out

    def launch(self, name: str):
        kern = self.module.kernels.get(name)
        if kern is None:
            raise EngineError(f"{name!r} is not a device kernel")
        self._count_launch(name)
        tr = tel.get()
        if not tr.enabled:  # hot path: one attribute check when untraced
            self._execute_kernel(name, kern)
            return
        direction = getattr(kern, "direction", None)
        with tr.span(
            "launch:" + name, kernel=name, kind=kern.kind.name.lower(),
            direction=direction.name.lower() if direction is not None else None,
        ) as sp:
            self._execute_kernel(name, kern, sp)

    def _count_launch(self, name: str) -> None:
        """One logical launch (a fused kernel counts once, not per stage)."""
        count_launch(self.stats, self.module, name)

    def batched_runner(self, name: str) -> BatchedLaunch:
        """The batch-axis launch of kernel ``name``: its full stream over
        ``[K, n]`` state and ``[K, 1]`` scalars, with per-row results
        bit-identical to K sequential launches (the shared graph bindings
        are walked once for all K rows), and the stats of one full launch.
        Subclasses (:class:`~.dist_engine.DistEngine`) batch their own
        launch strategy behind the same contract."""
        lk = self._kernel(name)
        return BatchedLaunch(fn=lk.run_batched,
                             bump_stats=self._full_stats_bump(self.module.kernels[name]))

    def _full_stats_bump(self, kern) -> Callable[[EngineStats], None]:
        """Stats increment matching one full-stream launch of ``kern``."""
        edges = _full_edges(self.graph, kern)

        def bump(stats: EngineStats) -> None:
            stats.full_launches += 1
            stats.edges_traversed += edges

        return bump

    def _execute_kernel(self, name: str, kern, sp=None):
        """Launch ``kern``; ``sp`` is its launch span when tracing is on."""
        lk = self._kernel(name)
        scalars = self._kernel_scalars(name)
        if (
            self.target.compact_frontier
            and kern.kind is mir.KernelKind.EDGE
            # DENSE = compile-time verdict that the guard is loop-invariant:
            # skip host-side frontier mask evaluation entirely
            and kern.direction is not mir.Direction.DENSE
            and lk.frontier is not None
            and lk.run_subset is not None
            and self._launch_compacted_edge(lk, kern, scalars, sp)
        ):
            return
        self._full_stats_bump(kern)(self.stats)
        if sp is not None:
            sp.set(mode="full", edges=_full_edges(self.graph, kern))
        updates = self._timed_call(("full", name), lk.run_full, self.state, scalars)
        self.state.update(updates)

    # -- frontier compaction (direction optimization, engine-automatic) ----
    def _batch_builder(self):
        """Frontier expansion bound to this graph's arrays."""
        if not hasattr(self, "_build_batch"):
            gb = self.gb
            indptr, _, _ = self.graph.csr
            self._deg_np = np.diff(indptr)
            deg_dev = self._tensor(self._deg_np, torch.int32)
            starts_dev = self._tensor(indptr[:-1], torch.int32)
            generic = backend.make_frontier_builder(
                self.graph.n_vertices, self.graph.n_edges, self.module.graph.weighted,
            )

            def build(mask, weights, pad_v, pad_e, n_active_edges):
                return generic(deg_dev, starts_dev, gb["csr_indices"], gb["csr_eids"],
                               mask, weights, pad_v, pad_e, n_active_edges)

            self._build_batch = build
        return self._build_batch

    def _launch_compacted_edge(self, lk, kern: mir.Kernel, scalars,
                               sp=None) -> bool:
        t0 = time.perf_counter()
        mask = self._vertex_mask_host(kern, lk.frontier.cond)
        self.stats.frontier_masks += 1
        self.stats.frontier_mask_s += time.perf_counter() - t0
        if mask is None:
            return False
        build = self._batch_builder()
        n_active = int(mask.sum())
        n_active_edges = int(self._deg_np[mask].sum())
        # heuristic switch: large frontiers stream the whole edge list
        if n_active_edges > self.graph.n_edges // 4:
            return False
        pad_v = _next_pow2(n_active)
        pad_e = _next_pow2(n_active_edges)
        if pad_e > self.graph.n_edges:
            return False
        if sp is not None:
            sp.set(
                mode="compacted", edges=n_active_edges, frontier_size=n_active,
                frontier_occupancy=round(n_active / max(1, self.graph.n_vertices), 6),
                pad_v=pad_v, pad_e=pad_e,
            )
        weights = self.state.get(WEIGHT_KEY)
        if weights is None:
            weights = torch.zeros(1, dtype=torch.float32, device=self.device)
        batch = self._timed_call(
            ("fbuild", pad_v, pad_e), build,
            torch.from_numpy(mask).to(self.device), weights, pad_v, pad_e, n_active_edges,
        )
        updates = self._timed_call(
            ("subset", kern.name, pad_v, pad_e), lk.run_subset, self.state, scalars, batch,
        )
        self.state.update(updates)
        self.stats.compacted_launches += 1
        self.stats.edges_traversed += n_active_edges
        return True

    def _vertex_mask_host(self, kern: mir.Kernel, cond: fir.Expr) -> Optional[np.ndarray]:
        """Evaluate a frontier condition per vertex on the host (numpy);
        each property it reads is copied from the device once."""

        def ev(e: fir.Expr):
            if isinstance(e, (fir.IntLit, fir.FloatLit, fir.BoolLit)):
                return e.value
            if isinstance(e, fir.Ident):
                if e.name in self.host_env:
                    return self.host_env[e.name]
                raise EngineError(f"frontier cond references {e.name!r}")
            if isinstance(e, fir.Index) and isinstance(e.base, fir.Ident):
                prop = e.base.name
                idx = e.index
                if isinstance(idx, fir.Ident) and idx.name in (
                    kern.src_param,
                    kern.vertex_param,
                ):
                    return self.state[prop].cpu().numpy()
                raise EngineError("frontier cond must index by src/v")
            if isinstance(e, fir.BinOp):
                a, b = ev(e.lhs), ev(e.rhs)
                return {
                    "+": lambda: a + b, "-": lambda: a - b, "*": lambda: a * b,
                    "/": lambda: a / b, "==": lambda: a == b, "!=": lambda: a != b,
                    "<": lambda: a < b, "<=": lambda: a <= b, ">": lambda: a > b,
                    ">=": lambda: a >= b,
                    "&": lambda: np.logical_and(a, b),
                    "|": lambda: np.logical_or(a, b),
                }[e.op]()
            if isinstance(e, fir.UnaryOp):
                v = ev(e.operand)
                return np.logical_not(v) if e.op == "!" else -v
            raise EngineError("unsupported frontier expression")

        try:
            mask = ev(cond)
        except EngineError:
            return None
        mask = np.asarray(mask)
        if mask.ndim != 1:
            return None
        return mask

    # ------------------------------------------------------------------
    # host program interpretation
    # ------------------------------------------------------------------
    def run(self) -> EngineResult:
        t0 = time.perf_counter()
        host = self.module.host
        assert host is not None
        tr = tel.get()
        root_ctx = None
        if tr.enabled:
            with tr.span("run", engine=type(self).__name__, target=self.target.kind,
                         batch_size=1) as sp:
                self._exec_host_block(host.main.body)
                sp.set(launches=self.stats.total_launches,
                       compacted=self.stats.compacted_launches,
                       full=self.stats.full_launches,
                       supersteps=self.stats.dist_supersteps)
            root_ctx = sp.context()
        else:
            self._exec_host_block(host.main.body)
        props = {}
        for p in self.module.properties.values():
            relabeled = (self.old2new is not None and not p.is_edge
                         and p.name not in self.accumulator_props)
            props[p.name] = self._host_copy(
                p.name, (lambda a: a[self.old2new]) if relabeled else None)
        if WEIGHT_KEY in self.state:
            props["weight"] = self._host_copy(WEIGHT_KEY)
        self.stats.wall_time_s = time.perf_counter() - t0
        self.stats.run_time_s = max(0.0, self.stats.wall_time_s - self.stats.compile_time_s)
        result = EngineResult(properties=props, host_env=dict(self.host_env), stats=self.stats)
        if root_ctx is not None:
            result.trace = tr.summarize(root=root_ctx)
        return result

    def _host_copy(self, key: str, finish: Optional[Callable] = None) -> np.ndarray:
        """State entry ``key`` as a numpy array (``finish`` un-relabels it).
        An entry that still holds its bind-time buffer (degrees, weights no
        kernel wrote) is copied off the device once per bind and handed
        out read-only after that, not copied again on every run: the
        weights alone are |E| values."""
        t = self.state[key]
        hit = self._host_cache.get(key)
        if hit is not None and hit[0] is t:
            return hit[1]
        arr = t.cpu().numpy()
        if finish is not None:
            arr = finish(arr)
        if self._initial.get(key) is t:
            arr.flags.writeable = False
            self._host_cache[key] = (t, arr)
        return arr

    def _exec_host_block(self, body: List[fir.Stmt]):
        for st in body:
            self._exec_host_stmt(st)

    def _host_index(self, prop: str, index: fir.Expr) -> Tuple[torch.Tensor, int]:
        return self.state[prop], self._xlate(prop, int(self._eval_host(index)))

    def _exec_host_stmt(self, st: fir.Stmt):
        if isinstance(st, fir.VarDecl):
            self.host_env[st.name] = (
                self._eval_host(st.init) if st.init is not None else 0
            )
            return
        if isinstance(st, fir.Assign):
            tgt = st.target
            val = self._eval_host(st.value)
            if isinstance(tgt, fir.Ident):
                self.host_env[tgt.name] = val
                return
            if isinstance(tgt, fir.Index) and isinstance(tgt.base, fir.Ident):
                prop = tgt.base.name
                if prop not in self.module.properties:
                    raise EngineError(f"host write to unknown property {prop!r}")
                cur, i = self._host_index(prop, tgt.index)
                new = cur.clone()  # state tensors are never written in place
                new[i] = val
                self.state[prop] = new
                return
            raise EngineError("unsupported host assignment")
        if isinstance(st, fir.ReduceAssign):
            # host scalar reduce: level += 1
            tgt = st.target
            if isinstance(tgt, fir.Ident):
                cur = self.host_env[tgt.name]
                val = self._eval_host(st.value)
                self.host_env[tgt.name] = {
                    "+": lambda: cur + val, "-": lambda: cur - val,
                    "*": lambda: cur * val,
                    "min": lambda: min(cur, val), "max": lambda: max(cur, val),
                }[st.op]()
                return
            if isinstance(tgt, fir.Index) and isinstance(tgt.base, fir.Ident):
                if st.op not in ("+", "min", "max", "*"):
                    raise EngineError(f"host reduce {st.op!r}")
                cur, i = self._host_index(tgt.base.name, tgt.index)
                val = torch.tensor(self._eval_host(st.value), dtype=cur.dtype)
                new = cur.clone()
                new[i] = backend.combine(st.op, cur[i], val.to(cur.device))
                self.state[tgt.base.name] = new
                return
            raise EngineError("unsupported host reduce target")
        if isinstance(st, fir.If):
            if self._truthy(self._eval_host(st.cond)):
                self._exec_host_block(st.then_body)
            else:
                self._exec_host_block(st.else_body)
            return
        if isinstance(st, fir.While):
            guard = 0
            while self._truthy(self._eval_host(st.cond)):
                self.stats.host_iterations += 1
                self._exec_host_block(st.body)
                guard += 1
                if guard > 1_000_000:
                    raise EngineError("host while loop exceeded 1e6 iterations")
            return
        if isinstance(st, fir.ExprStmt):
            self._eval_host(st.expr)
            return
        if isinstance(st, fir.For):
            raise EngineError("host for loops are not part of the grammar")
        raise EngineError(f"unsupported host statement {type(st).__name__}")

    @staticmethod
    def _truthy(v) -> bool:
        return bool(v.item() if hasattr(v, "item") else v)

    def _eval_host(self, e: Optional[fir.Expr]):
        if e is None:
            return None
        if isinstance(e, (fir.IntLit, fir.FloatLit, fir.BoolLit, fir.StrLit)):
            return e.value
        if isinstance(e, fir.Ident):
            if e.name in self.host_env:
                return self.host_env[e.name]
            if e.name == "argv":
                return self.argv
            raise EngineError(f"unknown host identifier {e.name!r}")
        if isinstance(e, fir.Index):
            base = e.base
            if isinstance(base, fir.Ident) and base.name in self.module.properties:
                cur, i = self._host_index(base.name, e.index)
                return cur[i].item()
            if isinstance(base, fir.Ident) and base.name == "argv":
                return self.argv[int(self._eval_host(e.index))]
            seq = self._eval_host(base)
            return seq[int(self._eval_host(e.index))]
        if isinstance(e, fir.BinOp):
            a = self._eval_host(e.lhs)
            b = self._eval_host(e.rhs)
            return {
                "+": lambda: a + b, "-": lambda: a - b, "*": lambda: a * b,
                "/": lambda: a / b, "==": lambda: a == b, "!=": lambda: a != b,
                "<": lambda: a < b, "<=": lambda: a <= b, ">": lambda: a > b,
                ">=": lambda: a >= b, "&": lambda: bool(a) and bool(b),
                "|": lambda: bool(a) or bool(b),
            }[e.op]()
        if isinstance(e, fir.UnaryOp):
            v = self._eval_host(e.operand)
            return (not v) if e.op == "!" else -v
        if isinstance(e, fir.Call):
            return self._host_call(e)
        if isinstance(e, fir.MethodCall):
            return self._host_method(e)
        raise EngineError(f"cannot evaluate host expression {type(e).__name__}")

    def _host_call(self, e: fir.Call):
        if e.func == "load":
            return None  # graph loading happened at engine construction
        if e.func == "swap":
            a, b = e.args
            an, bn = a.name, b.name  # type: ignore[attr-defined]
            self.state[an], self.state[bn] = self.state[bn], self.state[an]
            return None
        if e.func == "print":
            print(*[self._eval_host(a) for a in e.args])
            return None
        if e.func in self.module.host.host_funcs:
            self._exec_host_block(self.module.host.host_funcs[e.func].body)
            return None
        if e.func in semantic.DEVICE_BUILTINS:
            args = [self._eval_host(a) for a in e.args]
            fns: Dict[str, Callable] = {
                "exp": math.exp, "log": math.log, "abs": abs, "sqrt": math.sqrt,
                "min": min, "max": max, "floor": math.floor, "pow": pow,
                "to_float": float, "to_int": int,
                "sigmoid": lambda x: 1.0 / (1.0 + math.exp(-x)),
                "leakyrelu": lambda x, a: x if x > 0 else a * x,
            }
            return fns[e.func](*args)
        raise EngineError(f"unknown host function {e.func!r}")

    def _host_method(self, e: fir.MethodCall):
        obj = e.obj
        name = obj.name if isinstance(obj, fir.Ident) else None
        g = self.module.graph
        if e.method == "size":
            # logical counts: padding is invisible to size()-normalized math
            if name == g.edgeset_name:
                return self.graph.n_edges_logical
            return self.graph.n_vertices_logical
        if e.method in ("init", "process"):
            fn = e.args[0]
            if not isinstance(fn, fir.Ident):
                raise EngineError("init/process expects a function name")
            self.launch(fn.name)
            return None
        if e.method == "getVertices":
            return None  # vertexset binding is implicit
        if e.method in ("getOutDegrees", "getInDegrees"):
            return None  # handled at allocation time
        raise EngineError(f"unknown host method {e.method!r}")
