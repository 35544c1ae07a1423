"""BatchEngine: one set of launches answering K parameterized queries.

The port of the reference's ``batch/engine.py``. The sequential
:class:`~repro_torch.core.engine.Engine` interprets the host program per
query and launches each device kernel once per query. On a graph that does
not change, the kernels do not depend on the query; only the *state* they
transform does, so K parameter bindings can ride one launch set:

* every property gains a **leading batch axis** (``[K, n]`` tensors on the
  device), host scalars are ``[K]`` numpy arrays (``[K, 1]`` tensors inside
  a kernel), and each kernel runs through the engine's batch-axis launch
  (:meth:`Engine.batched_runner`): the full stream, the graph's arrays
  shared by all K rows, the hand-written kernels taking the rows on their
  grid;
* the host program runs ONCE with **per-query active masks**: an ``if``
  runs both branches under refined masks, a ``while`` iterates until every
  lane's condition is false, and converged lanes are masked out of every
  state merge (``torch.where``) without stopping the batch;
* BFS-like frontier programs take the **bit-packed multi-source path**
  (:mod:`repro_torch.batch.msbfs`), chosen from the MIR.

Per-lane results are bit-identical to K sequential runs of the port: each
row goes through the operations a sequential launch performs, the kernels
fold each row's bins in the one-row order, masked merges only suppress
writes a sequential run would not have made, and the full-stream launches
agree exactly with the sequential engine's compacted-frontier launches for
every reduction the DSL admits on the frontier path (integer min/max/add).

Rows a kernel or the host can write are materialised (``[K, n]`` buffers
of their own); only the bind-time weights that no kernel writes stay one
row expanded over the batch (row stride 0), which the kernels read once
per launch for every row. No state tensor is written in place.
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..core import fir, mir
from ..core.backend import DTYPES, WEIGHT_KEY, combine
from ..core.engine import Engine, EngineError, EngineResult, EngineStats, count_launch
from .. import telemetry as tel


class BatchError(Exception):
    pass


# host builtins vectorized over [K] lanes (the numpy analogues of the
# scalar `math`-module table in Engine._host_call)
_VEC_FNS = {
    "exp": np.exp,
    "log": np.log,
    "abs": np.abs,
    "sqrt": np.sqrt,
    "min": np.minimum,
    "max": np.maximum,
    "floor": lambda x: np.floor(x).astype(np.int64),
    "pow": np.power,
    "to_float": lambda x: np.asarray(x, np.float64),
    "to_int": lambda x: np.asarray(x, np.int64),
    "sigmoid": lambda x: 1.0 / (1.0 + np.exp(-np.asarray(x, np.float64))),
    "leakyrelu": lambda x, a: np.where(np.asarray(x) > 0, x, a * np.asarray(x)),
}

# host reads of a property come back as Python numbers in a sequential run
# (``.item()``); here as [K] arrays of the same precision
_HOST_NP = {torch.int32: np.int64, torch.float32: np.float64, torch.bool: np.bool_}


def _vec_binop(op: str, a, b):
    if op == "&":
        return np.logical_and(a, b)
    if op == "|":
        return np.logical_or(a, b)
    return {
        "+": lambda: a + b, "-": lambda: a - b, "*": lambda: a * b,
        "/": lambda: a / b, "==": lambda: a == b, "!=": lambda: a != b,
        "<": lambda: a < b, "<=": lambda: a <= b, ">": lambda: a > b,
        ">=": lambda: a >= b,
    }[op]()


def writes_weights(module: mir.Module) -> bool:
    """True when some kernel (or a stage of a fused one) writes the edge
    weights."""
    for k in module.kernels.values():
        stages = k.stages if isinstance(k, mir.PipelineKernel) else [k]
        if any(getattr(st, "writes_weight", False) for st in stages):
            return True
    return False


class BatchEngine:
    """Executes one compiled module over K parameter bindings at once.

    Wraps a sequential :class:`~repro_torch.core.engine.Engine`: the inner
    engine provides the graph, the lowered kernels and the per-launch
    batching hook; this class owns the batched state and the masked host
    interpretation.
    """

    MSBFS_NAME = "__msbfs__"  # kernel_launches key of the bit-packed path

    def __init__(self, engine: Engine, enable_msbfs: bool = True):
        self.engine = engine
        self.module = engine.module
        self.argv = engine.argv
        self.device = engine.device
        self.enable_msbfs = enable_msbfs
        self.stats = EngineStats()
        self.state: Dict[str, torch.Tensor] = {}
        self.host_env: Dict[str, Any] = {}
        self.batch_size = 0
        self._msbfs_plan: Any = False  # False = not yet matched
        self._writes_weights = writes_weights(self.module)
        self.refresh_graph()

    def refresh_graph(self) -> None:
        """Re-point at the inner engine's graph after its
        :meth:`~repro_torch.core.engine.Engine.refresh_graph`: the
        relabeled graph and its id map on the device are all this wrapper
        keeps of the graph across runs (the launches read ``engine.gb``
        each run, and the multi-source BFS plan is derived from the MIR)."""
        eng = self.engine
        self.graph = eng.graph  # already hub-relabeled by the engine
        self._old2new = (None if eng.old2new is None else
                         torch.from_numpy(np.asarray(eng.old2new, np.int64)).to(self.device))

    # ------------------------------------------------------------------
    # entry point
    # ------------------------------------------------------------------
    def run_batch(self, param_sets: Sequence[Dict[str, Any]]) -> List[EngineResult]:
        """Answer every parameter binding; results in input order.

        All sets must share one key set (the batch-eligibility contract,
        checked again here because this is the last line of defense).
        """
        k = len(param_sets)
        if k == 0:
            return []
        keys = set(param_sets[0])
        for p in param_sets[1:]:
            if set(p) != keys:
                raise BatchError(
                    "batched execution needs one shared parameter key set; got "
                    f"{sorted(keys)} vs {sorted(p)}"
                )
        t0 = time.perf_counter()
        self.batch_size = k
        self.stats = EngineStats(batch_size=k)
        self._reset(param_sets)
        tr = tel.get()
        root_ctx = None
        if tr.enabled:
            with tr.span("run", engine=type(self).__name__, batch_size=k) as sp:
                self._run_host(keys, k)
                sp.set(launches=self.stats.total_launches,
                       msbfs=self.MSBFS_NAME in self.stats.kernel_launches)
            root_ctx = sp.context()
        else:
            self._run_host(keys, k)
        results = self._finalize()
        self.stats.wall_time_s = time.perf_counter() - t0
        self.stats.run_time_s = max(0.0, self.stats.wall_time_s - self.stats.compile_time_s)
        if root_ctx is not None:
            trace = tr.summarize(root=root_ctx)
            for r in results:
                r.trace = trace  # shared, like stats
        return results

    def _run_host(self, keys, k: int) -> None:
        plan = self._msbfs()
        if plan is not None and plan.accepts(keys, self.graph.n_vertices):
            from .msbfs import run_msbfs

            run_msbfs(self, plan)
        else:
            host = self.module.host
            assert host is not None
            self._exec_block(host.main.body, np.ones(k, dtype=bool))

    def _msbfs(self):
        if not self.enable_msbfs:
            return None
        if self._msbfs_plan is False:
            from .msbfs import match_msbfs

            self._msbfs_plan = match_msbfs(self.module)
        return self._msbfs_plan

    # ------------------------------------------------------------------
    # batched state
    # ------------------------------------------------------------------
    def _reset(self, param_sets: Sequence[Dict[str, Any]]) -> None:
        k = len(param_sets)
        module, graph, dev = self.module, self.graph, self.device
        self.state = {}
        for p in module.properties.values():
            n = graph.n_edges if p.is_edge else graph.n_vertices
            self.state[p.name] = torch.zeros((k, n), dtype=DTYPES[p.scalar], device=dev)
        # the bind-time buffers (degrees, weights), one row per lane; weights
        # no kernel writes stay one row expanded over the lanes (stride 0)
        for name, buf in self.engine._initial.items():
            rows = buf.expand(k, -1)
            shared = name == WEIGHT_KEY and not self._writes_weights
            self.state[name] = rows if shared else rows.contiguous()
        # scalar initial values: let the inner engine re-derive them (the
        # same host semantics as a sequential run), then broadcast per lane
        self.engine.reset()
        self.host_env = {
            name: np.full(k, v) if isinstance(v, (int, float, bool, np.number)) else v
            for name, v in self.engine.host_env.items()
        }
        if param_sets:
            for name in param_sets[0]:
                self.host_env[name] = np.asarray([ps[name] for ps in param_sets])

    def _mask(self, mask: np.ndarray) -> torch.Tensor:
        """A ``[K]`` lane mask on the device."""
        return torch.from_numpy(np.array(mask, dtype=bool)).to(self.device)

    def _lanes(self, v, dtype: torch.dtype) -> torch.Tensor:
        """A host value per lane as a ``[K]`` tensor on the device."""
        arr = np.broadcast_to(np.asarray(v), (self.batch_size,))
        return torch.from_numpy(np.array(arr)).to(self.device).to(dtype)

    # ------------------------------------------------------------------
    # kernel launching (batched)
    # ------------------------------------------------------------------
    def _launch(self, name: str, mask: np.ndarray) -> None:
        kern = self.module.kernels.get(name)
        if kern is None:
            raise EngineError(f"{name!r} is not a device kernel")
        count_launch(self.stats, self.module, name)
        tr = tel.get()
        if not tr.enabled:
            self._launch_inner(name, kern, mask)
            return
        with tr.span("launch:" + name, kernel=name, mode="batched",
                     batch_size=self.batch_size, active_lanes=int(mask.sum())):
            self._launch_inner(name, kern, mask)

    def _launch_inner(self, name: str, kern, mask: np.ndarray) -> None:
        scalars = {s: self._lanes(self.host_env[s], DTYPES[self.module.scalars[s].scalar])[:, None]
                   for s in sorted(kern.scalar_reads)}
        # every batch size K is its own first touch; the inner engine's
        # warm-key registry keeps the cold/warm split across run modes
        bl = self.engine.batched_runner(name)
        updates = self.engine._timed_call(("batched", name, self.batch_size), bl.fn,
                                          self.state, scalars, stats=self.stats)
        bl.bump_stats(self.stats)  # one batched launch counts once
        self._merge(updates, mask)

    def _merge(self, updates: Dict[str, torch.Tensor], mask: np.ndarray) -> None:
        """Commit per-lane updates: inactive (converged) lanes keep state."""
        if mask.all():
            self.state.update(updates)
            return
        m = self._mask(mask)[:, None]
        for prop, arr in updates.items():
            self.state[prop] = torch.where(m, arr, self.state[prop])

    # ------------------------------------------------------------------
    # vertex id translation (vectorized host/device boundary)
    # ------------------------------------------------------------------
    def _xlate(self, prop: str, idx) -> np.ndarray:
        info = self.module.properties[prop]
        eng = self.engine
        idx = np.broadcast_to(np.asarray(idx, np.int64), (self.batch_size,))
        if (
            eng.old2new is not None
            and not info.is_edge
            and prop not in eng.accumulator_props
            and prop not in self.module.degree_props
        ):
            return np.asarray(eng.old2new)[idx]
        return idx

    def _cells(self, prop: str, idx_expr: fir.Expr, mask: np.ndarray):
        """Row and column tensors of each lane's ``prop[idx]``."""
        cols = self._xlate(prop, self._eval(idx_expr, mask))
        rows = torch.arange(self.batch_size, device=self.device)
        return rows, torch.from_numpy(np.array(cols)).to(self.device)

    # ------------------------------------------------------------------
    # masked host interpretation
    # ------------------------------------------------------------------
    def _truthy(self, v) -> np.ndarray:
        return np.broadcast_to(np.asarray(v) != 0, (self.batch_size,))

    def _exec_block(self, body: List[fir.Stmt], mask: np.ndarray) -> None:
        for st in body:
            self._exec_stmt(st, mask)

    def _exec_stmt(self, st: fir.Stmt, mask: np.ndarray) -> None:
        if isinstance(st, fir.VarDecl):
            val = self._eval(st.init, mask) if st.init is not None else 0
            val = np.broadcast_to(np.asarray(val), (self.batch_size,))
            old = self.host_env.get(st.name)
            # first declaration seeds every lane; re-declarations (loop
            # bodies) only overwrite the active lanes
            self.host_env[st.name] = (
                np.array(val) if old is None else np.where(mask, val, old)
            )
            return
        if isinstance(st, fir.Assign):
            tgt = st.target
            val = self._eval(st.value, mask)
            if isinstance(tgt, fir.Ident):
                old = self.host_env[tgt.name]
                self.host_env[tgt.name] = np.where(mask, val, old)
                return
            if isinstance(tgt, fir.Index) and isinstance(tgt.base, fir.Ident):
                self._write_prop(tgt.base.name, tgt.index, None, val, mask)
                return
            raise EngineError("unsupported host assignment")
        if isinstance(st, fir.ReduceAssign):
            tgt = st.target
            val = self._eval(st.value, mask)
            if isinstance(tgt, fir.Ident):
                cur = self.host_env[tgt.name]
                new = {
                    "+": lambda: cur + val, "-": lambda: cur - val,
                    "*": lambda: cur * val,
                    "min": lambda: np.minimum(cur, val),
                    "max": lambda: np.maximum(cur, val),
                }[st.op]()
                self.host_env[tgt.name] = np.where(mask, new, cur)
                return
            if isinstance(tgt, fir.Index) and isinstance(tgt.base, fir.Ident):
                self._write_prop(tgt.base.name, tgt.index, st.op, val, mask)
                return
            raise EngineError("unsupported host reduce target")
        if isinstance(st, fir.If):
            cond = self._truthy(self._eval(st.cond, mask))
            tmask = np.logical_and(mask, cond)
            if tmask.any():
                self._exec_block(st.then_body, tmask)
            if st.else_body:
                fmask = np.logical_and(mask, np.logical_not(cond))
                if fmask.any():
                    self._exec_block(st.else_body, fmask)
            return
        if isinstance(st, fir.While):
            guard = 0
            m = np.logical_and(mask, self._truthy(self._eval(st.cond, mask)))
            while m.any():
                self.stats.host_iterations += 1
                self._exec_block(st.body, m)
                m = np.logical_and(m, self._truthy(self._eval(st.cond, m)))
                guard += 1
                if guard > 1_000_000:
                    raise EngineError("host while loop exceeded 1e6 iterations")
            return
        if isinstance(st, fir.ExprStmt):
            self._eval(st.expr, mask)
            return
        if isinstance(st, fir.For):
            raise EngineError("host for loops are not part of the grammar")
        raise EngineError(f"unsupported host statement {type(st).__name__}")

    def _write_prop(self, prop: str, idx_expr: fir.Expr, op: Optional[str],
                    val, mask: np.ndarray) -> None:
        if prop not in self.module.properties:
            raise EngineError(f"host write to unknown property {prop!r}")
        if op is not None and op not in ("+", "*", "min", "max"):
            raise EngineError(f"host reduce {op!r}")
        rows, cols = self._cells(prop, idx_expr, mask)
        arr = self.state[prop]
        cur = arr[rows, cols]
        new = self._lanes(val, arr.dtype)
        if op is not None:
            new = combine(op, cur, new)
        new = torch.where(self._mask(mask), new, cur)
        out = arr.clone(memory_format=torch.contiguous_format)  # never written in place
        out[rows, cols] = new
        self.state[prop] = out

    # ------------------------------------------------------------------
    # vectorized host expression evaluation
    # ------------------------------------------------------------------
    def _eval(self, e: Optional[fir.Expr], mask: np.ndarray):
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
                rows, cols = self._cells(base.name, e.index, mask)
                arr = self.state[base.name]
                return arr[rows, cols].cpu().numpy().astype(_HOST_NP[arr.dtype])
            idx = self._eval(e.index, mask)
            if isinstance(idx, np.ndarray):
                uniq = np.unique(idx)
                if uniq.size != 1:
                    raise EngineError("host sequence index must be lane-uniform")
                idx = uniq[0]
            seq = self._eval(base, mask)
            return seq[int(idx)]
        if isinstance(e, fir.BinOp):
            return _vec_binop(e.op, self._eval(e.lhs, mask), self._eval(e.rhs, mask))
        if isinstance(e, fir.UnaryOp):
            v = self._eval(e.operand, mask)
            return np.logical_not(v) if e.op == "!" else -np.asarray(v)
        if isinstance(e, fir.Call):
            return self._host_call(e, mask)
        if isinstance(e, fir.MethodCall):
            return self._host_method(e, mask)
        raise EngineError(f"cannot evaluate host expression {type(e).__name__}")

    def _host_call(self, e: fir.Call, mask: np.ndarray):
        if e.func == "load":
            return None  # graph loading happened at engine construction
        if e.func == "swap":
            a, b = e.args
            an, bn = a.name, b.name  # type: ignore[attr-defined]
            va, vb = self.state[an], self.state[bn]
            if mask.all():
                self.state[an], self.state[bn] = vb, va
            else:  # per-lane swap: converged lanes keep their buffers
                m = self._mask(mask)[:, None]
                self.state[an] = torch.where(m, vb, va)
                self.state[bn] = torch.where(m, va, vb)
            return None
        if e.func == "print":
            print(*[self._eval(a, mask) for a in e.args])
            return None
        host = self.module.host
        if host is not None and e.func in host.host_funcs:
            self._exec_block(host.host_funcs[e.func].body, mask)
            return None
        if e.func in _VEC_FNS:
            args = [self._eval(a, mask) for a in e.args]
            return _VEC_FNS[e.func](*args)
        raise EngineError(f"unknown host function {e.func!r}")

    def _host_method(self, e: fir.MethodCall, mask: np.ndarray):
        obj = e.obj
        name = obj.name if isinstance(obj, fir.Ident) else None
        g = self.module.graph
        if e.method == "size":
            # logical counts, mirroring Engine._host_method: padding is
            # invisible to size()-normalized math
            if name == g.edgeset_name:
                return self.graph.n_edges_logical
            return self.graph.n_vertices_logical
        if e.method in ("init", "process"):
            fn = e.args[0]
            if not isinstance(fn, fir.Ident):
                raise EngineError("init/process expects a function name")
            self._launch(fn.name, mask)
            return None
        if e.method == "getVertices":
            return None
        if e.method in ("getOutDegrees", "getInDegrees"):
            return None
        raise EngineError(f"unknown host method {e.method!r}")

    # ------------------------------------------------------------------
    # result splitting
    # ------------------------------------------------------------------
    def _finalize(self) -> List[EngineResult]:
        """Per-lane results: each property copied to the host once for all
        lanes (un-relabeled on the device first), split by rows."""
        eng = self.engine
        props: Dict[str, np.ndarray] = {}
        for p in self.module.properties.values():
            arr = self.state[p.name]
            if self._old2new is not None and not p.is_edge and p.name not in eng.accumulator_props:
                arr = arr.index_select(1, self._old2new)
            props[p.name] = arr.cpu().numpy()
        shared_weight = None
        w = self.state.get(WEIGHT_KEY)
        if w is not None:
            if not self._writes_weights:
                # the bind-time weights: the inner engine's one read-only
                # host copy (its state holds them since _reset), as a
                # sequential run returns them
                shared_weight = eng._host_copy(WEIGHT_KEY)
            else:
                props["weight"] = w.cpu().numpy()
        results = []
        for k in range(self.batch_size):
            henv: Dict[str, Any] = {}
            for name, v in self.host_env.items():
                if isinstance(v, np.ndarray):
                    x = v[k] if v.ndim else v
                    henv[name] = x.item() if hasattr(x, "item") else x
                else:
                    henv[name] = v
            lane_props = {n: a[k] for n, a in props.items()}
            if shared_weight is not None:
                lane_props["weight"] = shared_weight
            results.append(EngineResult(
                properties=lane_props, host_env=henv,
                stats=self.stats,  # shared: batch_size says how many
            ))
        return results
