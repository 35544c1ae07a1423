"""Back-end: lowers MIR kernels to PyTorch executables (paper §III-B3).

The FPGA back-end emits Xilinx OpenCL modules (Burst Read, Cache,
Edge/Vertex Operation, Shuffle, RAW-resolve, Reduce, Burst Write — Fig. 4).
Here each module becomes a stage over PyTorch tensors on one device:

    Burst Read    -> static processing order: dst-partitioned, ascending-src
                     edge streaming
    Cache         -> hub-vertex relabeling so hot properties live in a dense
                     prefix
    Edge/Vertex Op-> the user function body, evaluated lane-parallel by the
                     expression evaluator below
    Shuffle+Reduce-> precomputed dst-sort permutation + bin offsets, reduced
                     by the hand-written ``shuffle_reduce`` kernel; edge
                     kernels of the form ``[if (G)] P[dst] op= X`` run as
                     one fused ``edge_stream`` kernel (gather, frontier
                     check, apply, shuffle, reduce)
    Burst Write   -> sequential lane-aligned writes (plain tensor ops)

Semantics notes (mirror the paper's pipeline transforms):
* RAW decoupling (Fig. 5->6): within one kernel, property reads observe the
  kernel's *input* state; scattered reduce-writes commit at kernel exit.
* RMW normalization (§III-C2) happens in the middle-end, so every scattered
  write reaching this layer is either a reduction or a declared plain store.

Dtype ABI: properties are int32, float32 or bool tensors; literals are 0-d
tensors of those types on the kernel's device (never float64). Tensors are
never updated in place: every write builds a new tensor, as the reference's
immutable arrays do, so state entries may share storage safely.

Batch axis (the torch analogue of the reference's ``vmap`` over the full
stream, :attr:`LoweredKernel.run_batched`): in a batched launch every state
array is ``[K, n]`` (row ``k`` is query ``k``) and every host scalar a
``[K, 1]`` tensor, while the graph's bindings stay ``[V]``/``[E]`` and
shared, so the graph is walked once per launch for all K rows. Lane values
are then 0-d, ``[n]`` (the same in every row: literals, vertex ids, graph
arrays) or ``[K, n]``; PyTorch's broadcasting combines them, indexing acts
on the last axis (:func:`_index`), vertex ids stay vertex ids, and each
commit gives every update its property's ``[K, n]`` shape.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import fir, mir
from ..graph.storage import GraphData
from ..kernels import edge_stream as es_kernel
from ..kernels import ref
from ..kernels import shuffle_reduce as sr_kernel

DTYPES = {"int": torch.int32, "float": torch.float32, "bool": torch.bool}

WEIGHT_KEY = "__weight__"


def identity_for(op: str, dtype: torch.dtype) -> Any:
    if op == "*":
        return True if dtype == torch.bool else 1
    return ref.identity(op, dtype)


def combine(op: str, a, b):
    if op == "+":
        return a + b
    if op == "-":
        return a - b
    if op == "*":
        return a * b
    if op == "min":
        return torch.minimum(a, b)
    if op == "max":
        return torch.maximum(a, b)
    raise ValueError(f"unknown reduce op {op!r}")


_CONSTS: Dict[Tuple, torch.Tensor] = {}


def const(value, dtype: torch.dtype, device: str) -> torch.Tensor:
    """A 0-d constant on ``device``, cached by its exact value (``repr``
    keeps -0.0 apart from 0.0): constants are never mutated, and a cached
    one costs no host-to-device copy per launch."""
    key = (type(value), repr(value), dtype, device)
    t = _CONSTS.get(key)
    if t is None:
        if len(_CONSTS) >= 4096:
            _CONSTS.clear()
        t = _CONSTS[key] = torch.tensor(value, dtype=dtype, device=device)
    return t


def _index(arr: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``arr[..., idx]``: lane values of ``arr`` (``[n]``, or ``[K, n]`` in a
    batched launch) at an int32 index that is 0-d, ``[m]`` (shared by the
    rows) or ``[K, m]`` (one row a query); a 0-d index of ``[K, n]`` gives
    ``[K, 1]``. A row expanded over the batch (row stride 0) is gathered
    once and the result stays shared."""
    if arr.dim() == 2 and arr.stride(0) == 0:
        arr = arr[0]
    if arr.dim() == 1:
        return torch.index_select(arr, 0, idx) if idx.dim() == 1 else arr[idx]
    if idx.dim() <= 1:
        return torch.index_select(arr, 1, idx.reshape(-1))
    return torch.gather(arr, 1, idx.long())


def _set(arr: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """A copy of ``arr`` with ``arr[..., idx] = vals`` (per row for a ``[K,
    m]`` index; duplicate indices: the device's store order decides, as for
    the reference's ``.at[].set``)."""
    out = arr.clone(memory_format=torch.contiguous_format)
    if idx.dim() <= 1:
        out[..., idx] = vals
    else:
        out.scatter_(1, idx.long(), torch.broadcast_to(vals, idx.shape).to(out.dtype))
    return out


def _plain_scatter(prop_arr, idx, vals, op: str) -> torch.Tensor:
    """Random scatter without the shuffle stage (the baseline path); a
    batched ``[K, n]`` property scatters row ``k`` into ``k * n ..`` of one
    flattened array."""
    if prop_arr.dim() == 2:
        k, n = prop_arr.shape
        flat_idx = ref.row_bins(idx, k, n)
        flat_vals = torch.broadcast_to(vals, (k, idx.shape[-1])).reshape(-1)
        return _plain_scatter(prop_arr.reshape(-1), flat_idx, flat_vals, op).view(k, n)
    if op == "+":
        return prop_arr.clone().index_add_(0, idx, vals)
    reduce = {"*": "prod", "min": "amin", "max": "amax"}[op]
    return prop_arr.clone().scatter_reduce_(0, idx.long(), vals, reduce, include_self=True)


def apply_scatter(
    prop_arr: torch.Tensor,
    idx: torch.Tensor,
    vals: torch.Tensor,
    mask: Optional[torch.Tensor],
    op: Optional[str],
    *,
    sort_perm: Optional[torch.Tensor] = None,
    offsets: Optional[torch.Tensor] = None,
    split: Optional[sr_kernel.BinSplit] = None,
    options,
) -> torch.Tensor:
    """Commit one scattered write group — the Shuffle/RAW/Reduce stage.

    Under ``options.shuffle`` every reduction and every last-write-wins
    store goes through the ``shuffle_reduce`` kernel: along the full
    dst-sorted stream with the bind-time routing ``(sort_perm, offsets)``
    and work list ``split``, otherwise through its sorting wrapper. The
    ``shuffle=False`` baseline and the ``*`` op stay plain PyTorch
    scatters, as they are XLA scatters and not Pallas in the reference.

    In a batched launch (``prop_arr`` ``[K, n]``) the rows' updates go
    through one batched launch over the shared routing; an index that
    differs per row (``[K, m]``) is routed per row
    (:func:`~repro_torch.kernels.shuffle_reduce.shuffle_reduce_batched`).
    """
    n = prop_arr.shape[-1]
    vals = vals.to(prop_arr.dtype)
    sorted_route = sort_perm is not None and offsets is not None

    def reduce(v, red_op):
        if v.dtype == torch.bool:
            # bool +/min/max are or/and/or: reduce 0/1 as int32; every
            # identity (0, INT_MAX for min, INT_MIN for max) maps back by > 0
            return reduce(v.to(torch.int32), red_op) > 0
        if sorted_route:
            v = _index(v, sort_perm)
            if v.dim() == 2:
                return sr_kernel.shuffle_reduce_sorted_batched(v, offsets, n, red_op, split)
            return sr_kernel.shuffle_reduce_sorted(v, offsets, n, red_op, split)
        if v.dim() == 2 or idx.dim() == 2:
            v = torch.broadcast_to(v, idx.shape[:-1] + v.shape[-1:]) if v.dim() == 1 else v
            return sr_kernel.shuffle_reduce_batched(v, idx, n, red_op)
        return sr_kernel.shuffle_reduce(v, idx, n, red_op)

    if op is None:
        if options.shuffle:
            # Deterministic last-write-wins: each slot takes the LAST
            # writing lane in stream order — the answer a sequential
            # interpretation of the kernel gives (the commit path the GT101
            # race analysis forces on).
            n_lanes = idx.shape[-1]
            pos = torch.arange(n_lanes, dtype=torch.int32, device=idx.device)
            if mask is not None:
                pos = torch.where(mask, pos, -1)
            last = reduce(pos, "max")
            written = last >= 0
            chosen = _index(vals, torch.clamp(last, 0, max(n_lanes - 1, 0)))
            return torch.where(written, chosen, prop_arr)
        # plain scatter store: mask by re-storing the original value
        if mask is not None:
            vals = torch.where(mask, vals, _index(prop_arr, idx))
        return _set(prop_arr, idx, vals)
    if op == "-":
        vals, op = -vals, "+"
    ident = identity_for(op, prop_arr.dtype)
    if mask is not None:
        vals = torch.where(mask, vals, torch.full_like(vals, ident))
    if options.shuffle and op != "*":
        return combine(op, prop_arr, reduce(vals, op))
    return _plain_scatter(prop_arr, idx, vals, op)


# ---------------------------------------------------------------------------
# Expression / statement evaluation contexts
# ---------------------------------------------------------------------------


@dataclass
class LaneCtx:
    """One vectorized execution scope (vertex lanes or edge lanes)."""

    n_lanes: int
    bindings: Dict[str, torch.Tensor]  # param/loop-var name -> lane index array
    valid: Optional[torch.Tensor]  # lane validity (padded subsets)
    # expanded-lane support: position into the parent lane array
    parent: Optional["LaneCtx"] = None
    parent_pos: Optional[torch.Tensor] = None
    # CSR/CSC indptr of the expansion (bin offsets of the parent reduce)
    parent_offsets: Optional[torch.Tensor] = None
    env: Dict[str, torch.Tensor] = field(default_factory=dict)


@dataclass
class KernelExec:
    """Mutable state while executing one kernel invocation."""

    module: mir.Module
    kernel: mir.Kernel
    options: Any
    state: Dict[str, torch.Tensor]
    scalars: Dict[str, torch.Tensor]
    graph_bind: Dict[str, Any]  # csr/csc arrays for neighbor loops
    scatter_updates: List[Tuple] = field(default_factory=list)
    seq_writes: Dict[str, torch.Tensor] = field(default_factory=dict)

    @property
    def device(self) -> str:
        return self.graph_bind["device"]

    def lit(self, value, scalar: str) -> torch.Tensor:
        return const(value, DTYPES[scalar], self.device)

    # -- property views -------------------------------------------------
    def prop_current(self, name: str) -> torch.Tensor:
        return self.seq_writes.get(name, self.state[name])

    # -- expression evaluation -------------------------------------------
    def eval(self, e: fir.Expr, lane: LaneCtx):
        m = self.module
        if isinstance(e, fir.IntLit):
            return self.lit(e.value, "int")
        if isinstance(e, fir.FloatLit):
            return self.lit(e.value, "float")
        if isinstance(e, fir.BoolLit):
            return self.lit(e.value, "bool")
        if isinstance(e, fir.Ident):
            name = e.name
            if name in lane.bindings:
                return lane.bindings[name]
            if name in lane.env:
                return lane.env[name]
            if lane.parent is not None:
                # gather vertex-lane values into the expanded lane
                if name in lane.parent.bindings:
                    return _index(lane.parent.bindings[name], lane.parent_pos)
                if name in lane.parent.env:
                    v = lane.parent.env[name]
                    return _index(v, lane.parent_pos) if v.dim() > 0 else v
            if name in self.scalars:
                return self.scalars[name]
            if name in m.properties:
                raise BackendError(
                    f"property {name!r} used without an index in kernel "
                    f"{self.kernel.name!r}"
                )
            raise BackendError(f"unknown identifier {name!r} in kernel {self.kernel.name!r}")
        if isinstance(e, fir.Index):
            if isinstance(e.base, fir.Ident) and e.base.name in m.properties:
                idx = self.eval(e.index, lane)
                return _index(self.prop_current(e.base.name), idx)
            raise BackendError("only property indexing is supported in kernels")
        if isinstance(e, fir.BinOp):
            a = self.eval(e.lhs, lane)
            b = self.eval(e.rhs, lane)
            return _binop(e.op, a, b)
        if isinstance(e, fir.UnaryOp):
            v = self.eval(e.operand, lane)
            return torch.logical_not(v) if e.op == "!" else -v
        if isinstance(e, fir.Call):
            if e.func == "original_id":
                # clamp like the reference's gather: padded lanes stay in range
                idx = self.eval(e.args[0], lane)
                orig = self.graph_bind["orig_id"]
                return _index(orig, torch.clamp(idx, 0, orig.shape[0] - 1))
            args = [self.eval(a, lane) for a in e.args]
            return _builtin(e.func, args)
        if isinstance(e, fir.MethodCall):
            if e.method == "size":
                # logical (unpadded) counts: globally-normalized algorithms
                # (PageRank 1/|V|) agree padded vs unpadded
                name = _obj_name(e.obj)
                lc = self.graph_bind["logical_counts"]
                if name == self.module.graph.edgeset_name:
                    return self.lit(lc[1], "int")
                return self.lit(lc[0], "int")
            raise BackendError(f"method {e.method!r} not allowed inside kernels")
        raise BackendError(f"cannot evaluate {type(e).__name__} in kernel")

    # -- statement execution -----------------------------------------------
    def exec_block(self, stmts: Sequence[fir.Stmt], lane: LaneCtx, mask):
        for st in stmts:
            self.exec_stmt(st, lane, mask)

    def exec_stmt(self, st: fir.Stmt, lane: LaneCtx, mask):
        if isinstance(st, fir.VarDecl):
            if st.init is not None:
                val = self.eval(st.init, lane)
            else:
                val = self.lit(False if st.type.kind == "bool" else 0, st.type.kind)
            if isinstance(st.type, fir.ScalarType):
                val = val.to(DTYPES[st.type.kind])
            lane.env[st.name] = _broadcast(val, lane.n_lanes)
            return
        if isinstance(st, fir.Assign):
            self._write(st.target, None, self.eval(st.value, lane), lane, mask, st.line)
            return
        if isinstance(st, fir.ReduceAssign):
            self._write(st.target, st.op, self.eval(st.value, lane), lane, mask, st.line)
            return
        if isinstance(st, fir.If):
            cond = _broadcast(self.eval(st.cond, lane), lane.n_lanes).to(torch.bool)
            tmask = cond if mask is None else torch.logical_and(mask, cond)
            self.exec_block(st.then_body, lane, tmask)
            if st.else_body:
                ncond = torch.logical_not(cond)
                fmask = ncond if mask is None else torch.logical_and(mask, ncond)
                self.exec_block(st.else_body, lane, fmask)
            return
        if isinstance(st, fir.For):
            self._exec_neighbor_loop(st, lane, mask)
            return
        if isinstance(st, fir.ExprStmt):
            self.eval(st.expr, lane)
            return
        raise BackendError(f"unsupported device statement {type(st).__name__}")

    # -- neighbor loop: vertex lane -> expanded CSR lane ---------------------
    def _exec_neighbor_loop(self, st: fir.For, lane: LaneCtx, mask):
        it = st.iter
        assert isinstance(it, fir.MethodCall)
        direction = "out" if it.method == "getNeighbors" else "in"
        gb = self.graph_bind
        if direction == "out":
            row_pos, ngh, eids = gb["csr_row_pos"], gb["csr_indices"], gb["csr_eids"]
            indptr = gb["csr_indptr"]
        else:
            row_pos, ngh, eids = gb["csc_row_pos"], gb["csc_indices"], gb["csc_eids"]
            indptr = gb["csc_indptr"]
        ex = LaneCtx(
            n_lanes=int(ngh.shape[0]),
            bindings={st.var: ngh, "edge": eids},
            valid=gb.get(f"{direction}_valid"),
            parent=lane,
            parent_pos=row_pos,
            parent_offsets=indptr,
        )
        exp_mask = None
        if mask is not None:
            exp_mask = _index(mask, row_pos)
        if ex.valid is not None:
            exp_mask = ex.valid if exp_mask is None else torch.logical_and(exp_mask, ex.valid)
        # execute body in the expanded lane; local reduce-assigns to parent
        # vars become segment reductions (the unroll+reduce transform)
        self._expanded_parent_reduce(st.body, ex, exp_mask, lane, row_pos)

    def _expanded_parent_reduce(self, body, ex: LaneCtx, exp_mask, lane: LaneCtx, row_pos):
        for st in body:
            if isinstance(st, fir.ReduceAssign) and isinstance(st.target, fir.Ident) \
                    and st.target.name in lane.env:
                vals = _broadcast(self.eval(st.value, ex), ex.n_lanes)
                op = st.op
                if op == "-":
                    vals, op = -vals, "+"
                ident = identity_for(op, vals.dtype)
                if exp_mask is not None:
                    vals = torch.where(exp_mask, vals, torch.full_like(vals, ident))
                old = lane.env[st.target.name]
                if op == "*":
                    red = _plain_scatter(
                        torch.full(vals.shape[:-1] + (lane.n_lanes,), ident, dtype=vals.dtype,
                                   device=vals.device), row_pos, vals, op)
                elif vals.dim() == 2:  # a batched launch: its rows over one indptr
                    red = sr_kernel.shuffle_reduce_sorted_batched(
                        vals, ex.parent_offsets, lane.n_lanes, op)
                else:
                    # row_pos is sorted by construction: the CSR indptr is
                    # the bin offsets of this segment reduce
                    red = sr_kernel.shuffle_reduce_sorted(
                        vals.contiguous(), ex.parent_offsets, lane.n_lanes, op)
                lane.env[st.target.name] = combine(op, old, red.to(old.dtype))
            elif isinstance(st, fir.If):
                cond = _broadcast(self.eval(st.cond, ex), ex.n_lanes).to(torch.bool)
                tmask = cond if exp_mask is None else torch.logical_and(exp_mask, cond)
                self._expanded_parent_reduce(st.then_body, ex, tmask, lane, row_pos)
                if st.else_body:
                    fm = torch.logical_not(cond)
                    fm = fm if exp_mask is None else torch.logical_and(exp_mask, fm)
                    self._expanded_parent_reduce(st.else_body, ex, fm, lane, row_pos)
            else:
                self.exec_stmt(st, ex, exp_mask)

    # -- writes -------------------------------------------------------------
    def _write(self, target: fir.Expr, op: Optional[str], val, lane: LaneCtx, mask, line: int):
        m = self.module
        # local variable
        if isinstance(target, fir.Ident):
            name = target.name
            if name == self.kernel.weight_param:
                # edge-weight write (CGAW-style): lane-aligned store, visible
                # to subsequent reads of the weight param in this kernel
                cur = self.seq_writes.get(WEIGHT_KEY, lane.bindings[name])
                val = _broadcast(val, lane.n_lanes).to(cur.dtype)
                new = val if op is None else combine(op, cur, val)
                wmask = mask
                if lane.valid is not None:
                    wmask = lane.valid if wmask is None else torch.logical_and(wmask, lane.valid)
                if wmask is not None:
                    new = torch.where(wmask, new, cur)
                self.seq_writes[WEIGHT_KEY] = new
                lane.bindings[name] = new
                return
            if name in lane.env:
                old = lane.env[name]
                new = _broadcast(val, lane.n_lanes).to(old.dtype)
                if op is not None:
                    new = combine(op, old, new)
                if mask is not None:
                    new = torch.where(mask, new, old)
                lane.env[name] = new
                return
            if lane.parent is not None and name in lane.parent.env:
                raise BackendError(
                    f"line {line}: plain assignment to outer var {name!r} inside a "
                    "neighbor loop is ambiguous; use a reduction (+=, min=, ...)"
                )
            raise BackendError(f"line {line}: assignment to undeclared variable {name!r}")
        # property write
        assert isinstance(target, fir.Index) and isinstance(target.base, fir.Ident)
        prop = target.base.name
        if prop not in m.properties:
            raise BackendError(f"line {line}: write to unknown property {prop!r}")
        idx_expr = target.index
        # sequential (burst write) path: P[v] at the kernel's own vertex lane
        if (
            self.kernel.kind is mir.KernelKind.VERTEX
            and isinstance(idx_expr, fir.Ident)
            and idx_expr.name == self.kernel.vertex_param
            and lane.parent is None
        ):
            cur = self.prop_current(prop)
            vids = lane.bindings[idx_expr.name]
            val = _broadcast(val, lane.n_lanes).to(cur.dtype)
            if lane.valid is None and lane.n_lanes == cur.shape[-1]:
                old = cur
                new = val if op is None else combine(op, old, val)
                if mask is not None:
                    new = torch.where(mask, new, old)
                self.seq_writes[prop] = new
            else:
                wmask = mask
                if lane.valid is not None:
                    wmask = lane.valid if wmask is None else torch.logical_and(wmask, lane.valid)
                old = _index(cur, vids)
                new = val if op is None else combine(op, old, val)
                if wmask is not None:
                    new = torch.where(wmask, new, old)
                self.seq_writes[prop] = _set(cur, vids, new)
            return
        # scattered / accumulator path
        idx = self.eval(idx_expr, lane)
        # the precomputed shuffle routing is only valid when scattering
        # along the edge kernel's destination lane in full-stream order
        dst_sorted = (
            self.kernel.kind is mir.KernelKind.EDGE
            and isinstance(idx_expr, fir.Ident)
            and idx_expr.name == self.kernel.dst_param
            and lane.parent is None
        )
        self._scatter(prop, op, idx, val, lane, mask, dst_sorted=dst_sorted)

    def _scatter(self, prop: str, op: Optional[str], idx, val, lane: LaneCtx, mask,
                 dst_sorted: bool = False):
        val = _broadcast(val, lane.n_lanes)
        idx = _broadcast(idx, lane.n_lanes)
        wmask = mask
        if lane.valid is not None:
            wmask = lane.valid if wmask is None else torch.logical_and(wmask, lane.valid)
        route = None
        if dst_sorted and self.graph_bind.get("dst_sort_perm") is not None:
            gb = self.graph_bind
            route = (gb["dst_sort_perm"], gb["dst_offsets"], gb["es_split"])
        self.scatter_updates.append((prop, op, idx, val, wmask, route))

    # -- commit ---------------------------------------------------------------
    def commit(self) -> Dict[str, torch.Tensor]:
        out: Dict[str, torch.Tensor] = {}
        out.update(self.seq_writes)
        for prop, op, idx, val, wmask, route in self.scatter_updates:
            cur = out.get(prop, self.state[prop])
            sort_perm, offsets, split = route if route is not None else (None, None, None)
            out[prop] = apply_scatter(
                cur, idx, val, wmask, op, sort_perm=sort_perm, offsets=offsets, split=split,
                options=self.options,
            )
        # materialize broadcast views: kernels and later launches read
        # these as plain contiguous buffers; in a batched launch an update
        # that no row's value changes ([n]) gets its property's rows
        return {k: _rows_like(v, self.state[k]).contiguous() for k, v in out.items()}


class BackendError(Exception):
    pass


def _binop(op: str, a, b):
    if op == "+":
        return a + b
    if op == "-":
        return a - b
    if op == "*":
        return a * b
    if op == "/":
        # '/' is true division, as in numpy and the reference: int32 / int32
        # gives float32; integer contexts use to_int() explicitly
        return torch.true_divide(a, b)
    if op == "==":
        return a == b
    if op == "!=":
        return a != b
    if op == "<":
        return a < b
    if op == "<=":
        return a <= b
    if op == ">":
        return a > b
    if op == ">=":
        return a >= b
    if op == "&":
        return torch.logical_and(a, b)
    if op == "|":
        return torch.logical_or(a, b)
    raise BackendError(f"unknown operator {op!r}")


def _builtin(name: str, args):
    if name == "exp":
        return torch.exp(args[0])
    if name == "log":
        return torch.log(args[0])
    if name == "abs":
        return torch.abs(args[0])
    if name == "sqrt":
        return torch.sqrt(args[0])
    if name == "sigmoid":
        return torch.sigmoid(args[0])
    if name == "leakyrelu":
        return torch.where(args[0] > 0, args[0], args[0] * args[1])
    if name == "min":
        return torch.minimum(*_promote(args[0], args[1]))
    if name == "max":
        return torch.maximum(*_promote(args[0], args[1]))
    if name == "floor":
        return torch.floor(args[0])
    if name == "pow":
        return torch.pow(args[0], args[1])
    if name == "to_float":
        return args[0].to(torch.float32)
    if name == "to_int":
        return args[0].to(torch.int32)  # truncates toward zero
    raise BackendError(f"unknown builtin {name!r}")


def _promote(a: torch.Tensor, b: torch.Tensor):
    dt = torch.result_type(a, b)
    return a.to(dt), b.to(dt)


def _broadcast(v: torch.Tensor, n: int) -> torch.Tensor:
    """A lane value over ``n`` lanes: 0-d -> ``[n]``, a batched scalar
    ``[K, 1]`` -> ``[K, n]`` (views, nothing copied)."""
    if v.dim() == 0:
        return v.expand(n)
    if v.shape[-1] != n:
        return v.expand(*v.shape[:-1], n)
    return v


def _rows_like(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``v`` with the leading (batch) axes of ``like`` that it lacks."""
    if v.dim() < like.dim():
        return v.expand(*like.shape[:like.dim() - v.dim()], *v.shape)
    return v


def _obj_name(e: fir.Expr) -> str:
    if isinstance(e, fir.Ident):
        return e.name
    raise BackendError("expected a plain identifier")


# ---------------------------------------------------------------------------
# The fused edge-stream route
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class EdgeStreamPlan:
    """An edge kernel whose body is ``[if (G)] P[dst] op= X``.

    ``G`` and the vertex-side operand ``E`` of ``X`` read only
    src-indexed properties, host scalars and literals, so both are
    evaluated once over the V vertex lanes and the ``edge_stream`` kernel
    gathers them per edge. ``X`` is ``E`` (apply ``src``), ``E + weight``
    / ``weight + E`` (``add``) or ``E * weight`` (``mul``).
    """

    prop: str
    op: str  # '+' | 'min' | 'max' ('-' arrives as '+' over -E)
    negate: bool
    guard: Optional[fir.Expr]
    operand: fir.Expr
    apply_op: str


def _src_only(e: fir.Expr, module: mir.Module, kernel: mir.Kernel) -> bool:
    """True when ``e`` reads only ``P[src]``, host scalars and literals."""
    if isinstance(e, (fir.IntLit, fir.FloatLit, fir.BoolLit)):
        return True
    if isinstance(e, fir.Ident):
        return e.name in module.scalars
    if isinstance(e, fir.Index):
        return (isinstance(e.base, fir.Ident) and e.base.name in module.properties
                and not module.properties[e.base.name].is_edge
                and isinstance(e.index, fir.Ident) and e.index.name == kernel.src_param)
    if isinstance(e, fir.BinOp):
        return _src_only(e.lhs, module, kernel) and _src_only(e.rhs, module, kernel)
    if isinstance(e, fir.UnaryOp):
        return _src_only(e.operand, module, kernel)
    if isinstance(e, fir.Call):
        return e.func != "original_id" and all(_src_only(a, module, kernel) for a in e.args)
    if isinstance(e, fir.MethodCall):
        return e.method == "size" and not e.args
    return False


def edge_stream_plan(module: mir.Module, kernel: mir.Kernel) -> Optional[EdgeStreamPlan]:
    """Match an edge kernel against the ``edge_stream`` template."""
    if kernel.kind is not mir.KernelKind.EDGE:
        return None
    body = list(kernel.func.body)
    if len(body) != 1:
        return None
    guard = None
    st = body[0]
    if isinstance(st, fir.If):
        if st.else_body or len(st.then_body) != 1:
            return None
        guard, st = st.cond, st.then_body[0]
    if not (isinstance(st, fir.ReduceAssign) and st.op in ("+", "-", "min", "max")):
        return None
    tgt = st.target
    if not (isinstance(tgt, fir.Index) and isinstance(tgt.base, fir.Ident)
            and tgt.base.name in module.properties
            and not module.properties[tgt.base.name].is_edge
            and isinstance(tgt.index, fir.Ident) and tgt.index.name == kernel.dst_param):
        return None
    value, apply_op = st.value, "src"
    w = kernel.weight_param
    if w is not None and isinstance(value, fir.BinOp) and value.op in ("+", "*"):
        lhs_w = isinstance(value.lhs, fir.Ident) and value.lhs.name == w
        rhs_w = isinstance(value.rhs, fir.Ident) and value.rhs.name == w
        if rhs_w != lhs_w and (value.op == "+" or rhs_w):
            apply_op = "add" if value.op == "+" else "mul"
            value = value.lhs if rhs_w else value.rhs
    if st.op == "-" and apply_op != "src":
        return None
    if not _src_only(value, module, kernel):
        return None
    if guard is not None and not _src_only(guard, module, kernel):
        return None
    op = "+" if st.op == "-" else st.op
    return EdgeStreamPlan(tgt.base.name, op, st.op == "-", guard, value, apply_op)


def _exec_edge_stream(module, kernel, plan: EdgeStreamPlan, options, gb, state, scalars):
    """Run an edge kernel's full stream through the fused kernel; returns
    None when the operand dtypes do not line up with the property (the
    generic path then runs it, with the same result)."""
    cur = state[plan.prop]
    n = gb["n_vertices"]
    ex = KernelExec(module, kernel, options, state, scalars, gb)
    lane = LaneCtx(n_lanes=n, bindings={kernel.src_param: gb["vids"]}, valid=None)
    vval = _broadcast(ex.eval(plan.operand, lane), n)
    weights = state.get(WEIGHT_KEY) if plan.apply_op != "src" else None
    if weights is not None and weights.dim() == 2 and weights.stride(0) == 0:
        weights = weights[0]  # a batch's shared weights: one row, read by every row
    if (cur.dtype not in es_kernel.DTYPE_CODES or vval.dtype != cur.dtype
            or (weights is not None and weights.dtype != cur.dtype)):
        return None
    if plan.negate:
        vval = -vval
    if plan.guard is None:
        vact = const(True, torch.bool, gb["device"]).expand(n)
    else:
        vact = _broadcast(ex.eval(plan.guard, lane), n).to(torch.bool)
    args = (gb["es_src"], gb["es_eid"] if weights is not None else None, weights,
            gb["dst_offsets"], plan.apply_op, plan.op, gb["es_split"])
    if max(vval.dim(), vact.dim(), 1 if weights is None else weights.dim()) == 2:
        # a batched launch: one row a query over the shared edges
        reduced = es_kernel.edge_stream_gather_batched(_rows_like(vval, cur),
                                                       vact.contiguous(), *args)
    else:
        reduced = es_kernel.edge_stream_gather(vval.contiguous(), vact.contiguous(), *args)
    return {plan.prop: combine(plan.op, cur, reduced)}


# ---------------------------------------------------------------------------
# Kernel lowering
# ---------------------------------------------------------------------------


@dataclass
class LoweredKernel:
    """A device kernel lowered against a concrete graph + target."""

    name: str
    kind: mir.KernelKind
    run_full: Callable  # (state, scalars) -> prop updates
    run_subset: Optional[Callable] = None  # (state, scalars, batch) -> updates
    frontier: Optional[mir.FrontierInfo] = None

    @property
    def run_batched(self) -> Callable:
        """``(state [K, n], scalars [K, 1]) -> updates [K, n]``: the full
        stream over a batch of K queries (the batch path never compacts, as
        in the reference). The evaluator takes the leading batch axis
        wherever state and scalars carry one, so this is ``run_full``."""
        return self.run_full


def make_frontier_builder(n_vertices: int, n_edges: int, weighted: bool):
    """Device-side frontier expansion.

    Maps an active-vertex mask to padded CSR edge ranges in O(V + pad_e)
    work (never O(E)), padded to ``(pad_v, pad_e)`` lanes like the
    reference's builder. The caller knows the active vertex and edge
    counts on the host, which sizes the ragged expansion exactly.
    """

    def build(deg, starts, csr_indices, csr_eids, mask, weights, pad_v, pad_e,
              n_active_edges):
        dev = mask.device
        act = torch.nonzero(mask).flatten().to(torch.int32)  # O(V)
        act = torch.cat([act, torch.full((pad_v - act.shape[0],), n_vertices,
                                         dtype=torch.int32, device=dev)])
        vok = act < n_vertices
        act_c = torch.clamp(act, max=n_vertices - 1)
        deg_a = torch.where(vok, _index(deg, act_c), 0)
        starts_a = _index(starts, act_c)
        cum = torch.cumsum(deg_a, 0, dtype=torch.int32) - deg_a

        def expand(x):  # ragged CSR-range expansion, O(pad_e)
            r = torch.repeat_interleave(x, deg_a, output_size=n_active_edges)
            fill = r[-1:] if n_active_edges else x[-1:]
            return torch.cat([r, fill.expand(pad_e - n_active_edges)])

        src, offs, base = expand(act_c), expand(cum), expand(starts_a)
        pos = torch.arange(pad_e, dtype=torch.int32, device=dev)
        valid = pos < n_active_edges
        # padded slots are clamped into range, as the reference's gathers are
        slots = torch.clamp(base + (pos - offs), 0, n_edges - 1)
        dst = _index(csr_indices, slots)
        eid = _index(csr_eids, slots)
        if weighted:
            w = _index(weights, eid)
        else:
            w = torch.zeros(pad_e, dtype=torch.float32, device=dev)
        return src, dst, w, eid, valid

    return build


def _graph_bindings(
    g: GraphData,
    module: mir.Module,
    options,
    new2old: Optional[np.ndarray] = None,
    device: str = "cuda",
):
    """Precompute static processing-order arrays (the Burst Read plan) on
    the host and move them to ``device`` once per bind."""
    if options.burst:
        pe = g.partition_by_dst(options.auto_partitions(g.n_vertices))
        order = pe.edge_order
    else:
        order = np.arange(g.n_edges, dtype=np.int32)
    src_o = g.src[order]
    dst_o = g.dst[order]
    dst_sort = np.argsort(dst_o, kind="stable").astype(np.int32)
    dst_sorted = dst_o[dst_sort]

    indptr, csr_idx, csr_eids = g.csr
    in_indptr, csc_idx, csc_eids = g.csc
    row_ids = np.repeat(np.arange(g.n_vertices, dtype=np.int32), np.diff(indptr).astype(np.int64))
    in_row_ids = np.repeat(np.arange(g.n_vertices, dtype=np.int32), np.diff(in_indptr).astype(np.int64))
    dst_offsets = np.searchsorted(
        dst_sorted, np.arange(g.n_vertices + 1, dtype=np.int64)).astype(np.int32)

    def dev(a):  # a copy on the CPU too: the graph's arrays change in place
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(device, copy=True)

    dst_offsets_d = dev(dst_offsets)
    return {
        "device": device,
        "n_vertices": g.n_vertices,
        "n_edges": g.n_edges,
        "order": dev(order),
        "src": dev(src_o),
        "dst": dev(dst_o),
        "dst_sort_perm": dev(dst_sort),
        # the shuffle routing of the full stream: bin offsets of the
        # dst-sorted edges, and the sorted edges' source and edge ids
        # (what the fused edge_stream kernel gathers through)
        "dst_offsets": dst_offsets_d,
        "es_src": dev(src_o[dst_sort]),
        "es_eid": dev(order[dst_sort]),
        # the full stream's work list (edge_stream and the per-bind
        # shuffle_reduce commits): the bins longer than SPLIT_LEN in chunks
        "es_split": sr_kernel.split_bins(dst_offsets_d, g.n_edges),
        "vids": torch.arange(g.n_vertices, dtype=torch.int32, device=device),
        "csr_row_pos": dev(row_ids),
        "csr_indices": dev(csr_idx),
        "csr_eids": dev(csr_eids),
        "csr_indptr": dev(indptr),
        "csc_row_pos": dev(in_row_ids),
        "csc_indices": dev(csc_idx),
        "csc_eids": dev(csc_eids),
        "csc_indptr": dev(in_indptr),
        # lane-id -> original vertex id (identity unless hub-relabeled)
        "orig_id": dev(
            new2old if new2old is not None else np.arange(g.n_vertices, dtype=np.int32)
        ),
        # unpadded counts behind size()
        "logical_counts": (int(g.n_vertices_logical), int(g.n_edges_logical)),
    }


def _exec_kernel_full(
    module: mir.Module,
    kernel: mir.Kernel,
    options,
    gb: Dict[str, Any],
    state: Dict[str, torch.Tensor],
    scalars: Dict[str, torch.Tensor],
    plan: Optional[EdgeStreamPlan] = None,
) -> Dict[str, torch.Tensor]:
    """Execute one full-stream kernel: lanes -> body -> commit. Shared
    between per-kernel launches and fused pipelines (each stage sees the
    previous stage's committed updates)."""
    if plan is not None and options.shuffle:
        out = _exec_edge_stream(module, kernel, plan, options, gb, state, scalars)
        if out is not None:
            return out
    ex = KernelExec(module, kernel, options, state, scalars, gb)
    if kernel.kind is mir.KernelKind.EDGE:
        n = gb["src"].shape[0]
        bindings = {kernel.src_param: gb["src"], kernel.dst_param: gb["dst"],
                    "edge": gb["order"]}
        if kernel.weight_param is not None:
            bindings[kernel.weight_param] = _index(state[WEIGHT_KEY], gb["order"])
        lane = LaneCtx(n_lanes=n, bindings=bindings, valid=None)
        ex.exec_block(kernel.func.body, lane, None)
        out = ex.commit()
        if WEIGHT_KEY in out:
            # processing-order weights -> original edge order
            out[WEIGHT_KEY] = _set(state[WEIGHT_KEY], gb["order"], out[WEIGHT_KEY])
        return out
    n = gb["n_vertices"]
    lane = LaneCtx(n_lanes=n, bindings={kernel.vertex_param: gb["vids"]}, valid=None)
    ex.exec_block(kernel.func.body, lane, None)
    return ex.commit()


# ---------------------------------------------------------------------------
# Shape-generic lowering (the Accelerator artifact's back end) and its
# per-graph adapter
# ---------------------------------------------------------------------------


# graph-binding entries that are device arrays of the bucket's shape: the
# Burst Read plan a bind uploads. All int32. Not listed:
# ``es_split``, the full stream's work list, whose length follows the
# graph's degree distribution rather than the bucket (it stays per bind),
# and the host-side ints (counts, logical counts, device).
GB_ARRAY_KEYS: Tuple[str, ...] = (
    "order", "src", "dst", "dst_sort_perm", "dst_offsets", "es_src", "es_eid", "vids",
    "csr_row_pos", "csr_indices", "csr_eids", "csr_indptr",
    "csc_row_pos", "csc_indices", "csc_eids", "csc_indptr", "orig_id",
)


def gb_array_bytes(n_vertices: int, n_edges: int) -> int:
    """Bytes of a bucket's :data:`GB_ARRAY_KEYS` arrays, ``es_split`` left
    out (the counterpart of the reference's ``gb_array_specs``)."""
    n = 0
    for key in GB_ARRAY_KEYS:
        if key in ("vids", "orig_id"):
            n += n_vertices
        elif key.endswith("indptr") or key == "dst_offsets":
            n += n_vertices + 1
        else:
            n += n_edges
    return 4 * n


@dataclass
class GenericLoweredKernel:
    """A kernel lowered against a (target, shape bucket), graph-independent.

    Unlike :class:`LoweredKernel`, the graph's binding arrays are an
    *argument* (``gb``, one bind's :func:`_graph_bindings`) rather than
    closed over: the software analogue of rebinding a synthesized
    bitstream to a new graph. One object serves every graph of the bucket;
    :meth:`bind` adapts it to one graph's bindings.
    """

    name: str
    kind: mir.KernelKind
    n_vertices: int
    n_edges: int
    run_full: Callable  # (gb, state, scalars) -> prop updates
    run_subset: Optional[Callable] = None  # (gb, state, scalars, batch) -> updates
    frontier: Optional[mir.FrontierInfo] = None

    def bind(self, gb: Dict[str, Any]) -> LoweredKernel:
        """This kernel over one graph's binding arrays."""
        if (gb["n_vertices"], gb["n_edges"]) != (self.n_vertices, self.n_edges):
            raise BackendError(
                f"kernel {self.name!r} was lowered for |V|={self.n_vertices} "
                f"|E|={self.n_edges}, bound to |V|={gb['n_vertices']} |E|={gb['n_edges']}"
            )
        full, subset = self.run_full, self.run_subset
        return LoweredKernel(
            self.name, self.kind,
            run_full=lambda state, scalars: full(gb, state, scalars),
            run_subset=None if subset is None else
            (lambda state, scalars, batch: subset(gb, state, scalars, batch)),
            frontier=self.frontier,
        )


def lower_kernel_generic(
    module: mir.Module,
    kernel,
    n_vertices: int,
    n_edges: int,
    target,
) -> GenericLoweredKernel:
    """Lower one kernel with the graph's bindings as an argument.

    A fused pipeline (paper Fig. 4 single pipeline) keeps launch semantics
    at its stage boundaries: each stage's updates, scattered reduces
    included, are committed into the running state before the next stage
    runs, so results equal launching the stages separately.
    """
    if isinstance(kernel, mir.PipelineKernel):
        stages = [(st, edge_stream_plan(module, st)) for st in kernel.stages]

        def run_full(gb, state, scalars):
            cur = dict(state)
            out: Dict[str, torch.Tensor] = {}
            for stage, plan in stages:
                upd = _exec_kernel_full(module, stage, target, gb, cur, scalars, plan)
                cur.update(upd)
                out.update(upd)
            return out

        return GenericLoweredKernel(kernel.name, mir.KernelKind.PIPELINE, n_vertices,
                                    n_edges, run_full)

    if kernel.kind is mir.KernelKind.EDGE:
        plan = edge_stream_plan(module, kernel)

        def run_full(gb, state, scalars):
            return _exec_kernel_full(module, kernel, target, gb, state, scalars, plan)

        def run_subset(gb, state, scalars, batch):
            src, dst, w, eid, valid = batch
            # subsets are unsorted: no static shuffle routing
            sub_gb = dict(gb, dst_sort_perm=None)
            ex = KernelExec(module, kernel, target, state, scalars, sub_gb)
            bindings = {kernel.src_param: src, kernel.dst_param: dst, "edge": eid}
            if kernel.weight_param is not None:
                bindings[kernel.weight_param] = w
            lane = LaneCtx(n_lanes=src.shape[0], bindings=bindings, valid=valid)
            ex.exec_block(kernel.func.body, lane, None)
            out = ex.commit()
            if WEIGHT_KEY in out:
                prev = state[WEIGHT_KEY]
                vals = torch.where(valid, out[WEIGHT_KEY], _index(prev, eid))
                out[WEIGHT_KEY] = _set(prev, eid, vals)
            return out

        return GenericLoweredKernel(kernel.name, kernel.kind, n_vertices, n_edges, run_full,
                                    run_subset=run_subset, frontier=kernel.frontier)

    # vertex kernel
    def run_full(gb, state, scalars):
        return _exec_kernel_full(module, kernel, target, gb, state, scalars)

    def run_subset(gb, state, scalars, batch):
        vids, valid = batch
        ex = KernelExec(module, kernel, target, state, scalars, gb)
        lane = LaneCtx(n_lanes=vids.shape[0], bindings={kernel.vertex_param: vids}, valid=valid)
        ex.exec_block(kernel.func.body, lane, None)
        return ex.commit()

    return GenericLoweredKernel(
        kernel.name, kernel.kind, n_vertices, n_edges, run_full,
        run_subset=run_subset if not kernel.has_neighbor_loop else None,
        frontier=kernel.frontier,
    )
