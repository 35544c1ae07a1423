"""Multi-device graph processing: the shuffle network generalized across
shard devices (ForeGraph-style multi-accelerator scaling).

The port of the reference's ``core/dist_engine.py``. Vertices are
range-partitioned across D shard devices (``Target.mesh``); each edge lives
on its **source owner**. One edge-centric superstep is:

1. local gather+apply: every source owner computes the update value of each
   of its edges from its slice of the source properties;
2. **shuffle**: each (source owner, destination owner) segment is copied
   onto the destination owner's device (:func:`shuffle`). The segments were
   bucketed by destination owner at partition time, so the routing is
   static, like the reference's ``all_to_all``;
3. local conflict-free reduce: each destination owner reduces what it
   received into its slice of the destinations with the hand-written
   ``shuffle_reduce`` kernel (``csrc/shuffle_reduce.cu``), the batched
   superstep with its ``[K, U]`` row form.

One process drives every shard, as the reference's single controller
drives its mesh: the host program, the replicated state and the serving
surfaces stay in that process, and the shards are devices of it. On a
machine with several GPUs the shuffle's copies are peer copies; where the
shards outnumber the cards they share them, so on one card all D shards
live on ``cuda:0`` and the copies stay on the device. :func:`shuffle` is
the one place a multi-process transport would replace.

The buckets are stored ragged, not as the reference's ``[D, D, Emax]``
padding: one stream per source owner, grouped by destination owner, with
per-pair offsets (``DistGraph.seg``). They hold the same edges per pair in
the same order. The destination ids a destination owner receives are fixed
at partition time, so the stable order that sorts them by destination (its
``shuffle_reduce`` offsets and work list included) is computed once per
partition, not per superstep; only the values and the condition mask change
between supersteps, and nothing is read back to the host in one.

:class:`DistEngine` is the execution backend built on top of it: it
interprets the host program as the local :class:`~.engine.Engine` does,
but launches every edge kernel of the shape ``[if cond] prop[dst] op=
value`` (``op`` one of ``+``, ``min``, ``max``; ``value`` and ``cond``
reading only source properties, weights, host scalars and literals) as a
superstep. Every other kernel runs the local path on the bind's device, so
any program that runs locally runs distributed with equal results.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from . import backend, fir, mir
from .backend import DTYPES
from .engine import BatchedLaunch, Engine
from .. import telemetry as tel
from ..graph.storage import GraphData
from ..kernels import shuffle_reduce as sr_kernel


def _int32(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32))


@dataclass
class DistGraph:
    """Ragged edge buckets of ``n_devices`` shards.

    Source owner ``i`` holds one stream of its edges on ``mesh[i]``, grouped
    by destination owner: pair ``(i, j)`` is positions ``seg[i, j]:seg[i,
    j + 1]`` of ``src_local[i]``, ``dst_local[i]`` and ``weight[i]``, in
    the graph's edge order. Destination owner ``j`` receives the pairs
    ``(0, j), (1, j), ..`` in that order (pair ``(i, j)`` at
    ``recv_seg[j][i]`` of a stream of ``recv_len[j]``), and
    ``recv_perm[j]`` is the stable sort of the received destination ids,
    with its bin ``recv_offsets[j]`` and work list ``recv_split[j]``.
    """

    n_devices: int
    n_vertices_padded: int  # multiple of n_devices
    mesh: List[str]
    axis: str
    seg: np.ndarray  # int64 [D, D + 1]
    src_local: List[torch.Tensor]  # int32 [n_i] on mesh[i]: source id local to owner i
    dst_local: List[torch.Tensor]  # int32 [n_i] on mesh[i]: dest id local to its owner
    weight: List[Optional[torch.Tensor]]  # [n_i] on mesh[i]; None on an unweighted graph
    recv_seg: np.ndarray  # int64 [D, D + 1]: recv_seg[j][i] = start of pair (i, j)
    recv_perm: List[torch.Tensor]  # int32 [recv_len[j]] on mesh[j]
    recv_offsets: List[torch.Tensor]  # int32 [slice_len + 1] on mesh[j]
    recv_split: List[sr_kernel.BinSplit]
    #: the reference's padded bucket length: the largest pair, at least 1
    emax: int
    partition_s: float = 0.0

    @property
    def slice_len(self) -> int:
        return self.n_vertices_padded // self.n_devices

    @property
    def recv_len(self) -> List[int]:
        return [int(r[-1]) for r in self.recv_seg]

    @property
    def shard_edges(self) -> List[int]:
        """Edges each source owner holds."""
        return [int(s[-1]) for s in self.seg]

    @property
    def padded_slots(self) -> int:
        """Slots of the reference's ``[D, D, Emax]`` layout: what one of its
        supersteps gathers and routes."""
        return self.n_devices * self.n_devices * self.emax

    @property
    def stored_bytes(self) -> int:
        """Device bytes of the buckets and the receive-side routing."""
        ts = [*self.src_local, *self.dst_local, *self.recv_perm, *self.recv_offsets]
        ts += [w for w in self.weight if w is not None]
        for s in self.recv_split:
            ts += list(s)
        return sum(t.numel() * t.element_size() for t in ts)

    def pair(self, i: int, j: int) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
        """``(src_local, dst_local, weight)`` of bucket ``(i, j)`` on the host."""
        a, b = int(self.seg[i, j]), int(self.seg[i, j + 1])
        w = self.weight[i]
        return (self.src_local[i][a:b].cpu().numpy(), self.dst_local[i][a:b].cpu().numpy(),
                None if w is None else w[a:b].cpu().numpy())


def partition_graph(g: GraphData, mesh: Sequence[str], axis: str = "data", *,
                    weight_dtype: torch.dtype = torch.float32) -> DistGraph:
    """Range-partition ``g`` over the shard devices ``mesh``.

    One stable sort of the edges on ``src_owner * D + dst_owner`` groups
    them by pair in edge order (the reference selects each pair with a
    ``flatnonzero`` pass of its own), on ``mesh[0]``; then each destination
    owner sorts the ids it will receive. Reads two sizes back to the host
    per owner, once per partition."""
    t0 = time.perf_counter()
    mesh = [str(m) for m in mesh]
    d = len(mesh)
    if d < 1:
        raise ValueError("partition_graph needs at least one shard device")
    vpad = ((g.n_vertices + d - 1) // d) * d
    sl = vpad // d
    work = mesh[0]
    src = _int32(g.src).to(work)
    dst = _int32(g.dst).to(work)
    key = (src // sl) * d + dst // sl
    order = torch.sort(key, stable=True).indices if d > 1 else None
    counts = torch.bincount(key, minlength=d * d).cpu().numpy().astype(np.int64)
    pair_start = np.concatenate([[0], np.cumsum(counts)])
    seg = np.stack([pair_start[i * d:(i + 1) * d + 1] - pair_start[i * d] for i in range(d)])
    if order is not None:
        src, dst = src[order], dst[order]
    src_l, dst_l = src % sl, dst % sl
    w_all = None
    if g.weights is not None:
        w_all = torch.from_numpy(np.ascontiguousarray(g.weights)).to(work, dtype=weight_dtype)
        if order is not None:
            w_all = w_all[order]

    def own(t, i):  # owner i's stream on its device
        a, b = pair_start[i * d], pair_start[(i + 1) * d]
        return t[a:b].to(mesh[i])

    recv_seg = np.zeros((d, d + 1), np.int64)
    recv_perm, recv_offsets, recv_split = [], [], []
    for j in range(d):
        parts = [dst_l[pair_start[i * d + j]:pair_start[i * d + j + 1]] for i in range(d)]
        recv_seg[j, 1:] = np.cumsum([p.shape[0] for p in parts])
        ids = torch.cat(parts).to(mesh[j])
        ids_sorted, perm = torch.sort(ids, stable=True)
        offsets = sr_kernel.bin_offsets(ids_sorted, sl)
        recv_perm.append(perm.to(torch.int32))
        recv_offsets.append(offsets)
        recv_split.append(sr_kernel.split_bins(offsets, ids.shape[0]))
    dg = DistGraph(
        n_devices=d, n_vertices_padded=vpad, mesh=mesh, axis=axis, seg=seg,
        src_local=[own(src_l, i) for i in range(d)],
        dst_local=[own(dst_l, i) for i in range(d)],
        weight=[None if w_all is None else own(w_all, i) for i in range(d)],
        recv_seg=recv_seg, recv_perm=recv_perm, recv_offsets=recv_offsets,
        recv_split=recv_split, emax=max(1, int(counts.max())),
    )
    for dev in set(mesh):
        if torch.device(dev).type == "cuda":
            torch.cuda.synchronize(dev)
    dg.partition_s = time.perf_counter() - t0
    return dg


def shuffle(dg: DistGraph, sent: List[torch.Tensor]) -> List[torch.Tensor]:
    """Route each source owner's update values (``[.., n_i]`` on ``mesh[i]``,
    grouped by destination owner) to the destination owners: owner ``j``
    gets ``[.., recv_len[j]]`` on ``mesh[j]``, pair ``(0, j)`` first.

    Each segment is one ``copy_`` on the destination's device: a peer copy
    between two cards, a device copy where two shards share one. Before a
    copy between two devices the destination's stream waits for the
    source's (``copy_`` itself also orders both streams)."""
    lead = sent[0].shape[:-1]
    out = []
    for j, dev in enumerate(dg.mesh):
        buf = torch.empty(lead + (dg.recv_len[j],), dtype=sent[0].dtype, device=dev)
        for i, vals in enumerate(sent):
            a, b = int(dg.seg[i, j]), int(dg.seg[i, j + 1])
            if a == b:
                continue
            if vals.device != buf.device and buf.device.type == "cuda":
                torch.cuda.current_stream(buf.device).wait_stream(
                    torch.cuda.current_stream(vals.device))
            r = int(dg.recv_seg[j, i])
            on_dst = (torch.cuda.device(buf.device) if buf.device.type == "cuda"
                      else contextlib.nullcontext())
            with on_dst:
                buf[..., r:r + b - a].copy_(vals[..., a:b], non_blocking=True)
        out.append(buf)
    return out


class SuperStep:
    """One distributed superstep of a lowered edge kernel:

        step(props: {name: [.., V]}, scalars: {name: 0-d or [K, 1]}) -> [.., Vpad]

    in three stages, each callable on its own: :meth:`apply` (each source
    owner's update values on its device), :func:`shuffle` and
    :meth:`reduce` (each destination owner's ``shuffle_reduce``).
    ``val_fn``/``cond_fn`` are ``fn(env, w, scalars, device)`` over the
    source-gathered properties ``env``, the bucket weights ``w`` and the
    host scalars, all on one source owner's device. A leading batch axis
    ``K`` on the properties or scalars rides through every stage (one
    shuffle round and one batched reduce per owner for all K rows). The
    result, on ``out_device`` (the first property's device by default), is
    the reduced update per destination: the identity of ``reduce_op``
    where no edge contributed or the condition masked every edge out.
    ``out_dtype=None`` keeps the values' dtype."""

    def __init__(self, dg: DistGraph, src_props: List[str], val_fn: Callable,
                 cond_fn: Optional[Callable], reduce_op: str, out_dtype: Optional[torch.dtype],
                 out_device: Optional[str] = None):
        self.dg = dg
        self.src_props = src_props
        self.val_fn = val_fn
        self.cond_fn = cond_fn
        self.reduce_op = reduce_op
        self.out_dtype = out_dtype
        self.out_device = out_device

    def __call__(self, props: Dict[str, torch.Tensor],
                 scalars: Dict[str, torch.Tensor]) -> torch.Tensor:
        dest = self.out_device
        if dest is None:
            dest = next(iter(props.values())).device if props else self.dg.mesh[0]
        return self.reduce(shuffle(self.dg, self.apply(props, scalars)), dest)

    def apply(self, props: Dict[str, torch.Tensor],
              scalars: Dict[str, torch.Tensor]) -> List[torch.Tensor]:
        """Each source owner's update values ``[.., n_i]`` on ``mesh[i]``:
        the gather of its slice of the source properties, the value, and
        the identity where the condition is false."""
        dg, sl = self.dg, self.dg.slice_len
        lead: Tuple[int, ...] = ()
        for t in (*props.values(), *scalars.values()):
            if t.dim() == 2:
                lead = (t.shape[0],)
                break
        sent: List[torch.Tensor] = []
        for i, dev in enumerate(dg.mesh):
            idx = dg.src_local[i]
            env = {p: backend._index(props[p][..., i * sl:(i + 1) * sl].to(dev), idx)
                   for p in self.src_props}
            sc = {k: v.to(dev) for k, v in scalars.items()}
            w = dg.weight[i]
            vals = self.val_fn(env, w, sc, dev)
            dtype = self.out_dtype or vals.dtype
            shape = lead + (idx.shape[0],)
            vals = torch.broadcast_to(vals.to(dtype), shape)
            if self.cond_fn is not None:
                ok = torch.broadcast_to(self.cond_fn(env, w, sc, dev).to(torch.bool), shape)
                vals = torch.where(ok, vals, backend.const(
                    backend.identity_for(self.reduce_op, dtype), dtype, dev))
            # bool reduces as 0/1 in int32 (every identity maps back by > 0)
            sent.append(vals.to(torch.int32) if dtype == torch.bool else vals)
        return sent

    def reduce(self, recv: List[torch.Tensor], dest) -> torch.Tensor:
        """Each destination owner's received values, sorted by the
        partition's routing and reduced by ``shuffle_reduce`` on its
        device; the owners' slices joined on ``dest``."""
        dg, sl, op = self.dg, self.dg.slice_len, self.reduce_op
        reds = []
        for j in range(dg.n_devices):
            # an owner that receives no edge launches too: its bins, all
            # empty, take the identity
            v = backend._index(recv[j], dg.recv_perm[j])
            fn = (sr_kernel.shuffle_reduce_sorted_batched if v.dim() == 2
                  else sr_kernel.shuffle_reduce_sorted)
            reds.append(fn(v, dg.recv_offsets[j], sl, op, dg.recv_split[j]).to(dest))
        red = torch.cat(reds, dim=-1)
        return red > 0 if self.out_dtype == torch.bool else red


def make_expr_push_step(
    dg: DistGraph,
    src_props: List[str],
    val_fn: Callable,
    cond_fn: Optional[Callable],
    reduce_op: str,
    out_dtype: Optional[torch.dtype],
    out_device: Optional[str] = None,
) -> SuperStep:
    """The :class:`SuperStep` of one lowered edge kernel (the reference's
    jitted ``shard_map`` step)."""
    return SuperStep(dg, src_props, val_fn, cond_fn, reduce_op, out_dtype, out_device)


def make_push_step(dg: DistGraph, value_fn: Callable, reduce_op: str = "+"):
    """The superstep of one property: ``value_fn(src_prop_vals, weights) ->
    update values`` (elementwise). Returns ``fn(prop [V or Vpad]) ->
    reduced updates [Vpad]`` on the property's device (combined with the
    old property by the caller's vertex kernel)."""
    step = make_expr_push_step(dg, ["prop"], lambda env, w, s, dev: value_fn(env["prop"], w),
                               None, reduce_op, None)
    return lambda prop: step({"prop": prop}, {})


# ---------------------------------------------------------------------------
# Generalized distributed edge-kernel superstep
# ---------------------------------------------------------------------------


class _NotDistributable(Exception):
    """Kernel body falls outside the src-gather -> dst-reduce shape."""


def _lower_dist_expr(
    module: mir.Module,
    kern: mir.Kernel,
    e: fir.Expr,
    src_props: Set[str],
    weight_ok: bool,
) -> Callable:
    """Lower a per-edge expression to ``fn(env, w, scalars, device) ->
    tensor``.

    ``env`` maps property name -> values gathered at the edge's source,
    ``w`` is the per-edge weight, ``scalars`` the host scalar environment,
    ``device`` the source owner's. Anything needing dst-side gathers,
    accumulator cells, or id translation raises :class:`_NotDistributable`
    (local fallback)."""
    if isinstance(e, (fir.IntLit, fir.FloatLit, fir.BoolLit)):
        v = e.value
        dt = {fir.IntLit: torch.int32, fir.FloatLit: torch.float32,
              fir.BoolLit: torch.bool}[type(e)]
        return lambda env, w, s, dev: backend.const(v, dt, dev)
    if isinstance(e, fir.Ident):
        name = e.name
        if name == kern.weight_param:
            if not weight_ok:
                raise _NotDistributable("edge weights are mutated elsewhere")
            return lambda env, w, s, dev: w
        if name in module.scalars:
            return lambda env, w, s, dev: s[name]
        raise _NotDistributable(f"identifier {name!r}")
    if isinstance(e, fir.Index):
        base, idx = e.base, e.index
        if (
            isinstance(base, fir.Ident)
            and base.name in module.properties
            and isinstance(idx, fir.Ident)
            and idx.name == kern.src_param
            and not module.properties[base.name].is_edge
        ):
            prop = base.name
            src_props.add(prop)
            return lambda env, w, s, dev: env[prop]
        raise _NotDistributable("non-src-indexed property read")
    if isinstance(e, fir.BinOp):
        fa = _lower_dist_expr(module, kern, e.lhs, src_props, weight_ok)
        fb = _lower_dist_expr(module, kern, e.rhs, src_props, weight_ok)
        op = e.op
        return lambda env, w, s, dev: backend._binop(op, fa(env, w, s, dev), fb(env, w, s, dev))
    if isinstance(e, fir.UnaryOp):
        fv = _lower_dist_expr(module, kern, e.operand, src_props, weight_ok)
        if e.op == "!":
            return lambda env, w, s, dev: torch.logical_not(fv(env, w, s, dev))
        return lambda env, w, s, dev: -fv(env, w, s, dev)
    if isinstance(e, fir.Call):
        if e.func == "original_id":
            raise _NotDistributable("original_id needs the relabel table")
        fargs = [_lower_dist_expr(module, kern, a, src_props, weight_ok) for a in e.args]
        func = e.func
        return lambda env, w, s, dev: backend._builtin(func, [f(env, w, s, dev) for f in fargs])
    raise _NotDistributable(type(e).__name__)


def _match_dist_kernel(kern: mir.Kernel) -> Tuple[Optional[fir.Expr], str, str, fir.Expr]:
    """Match ``[if cond] prop[dst] op= value`` and return its pieces."""
    body = list(kern.func.body)
    cond: Optional[fir.Expr] = None
    if (
        len(body) == 1
        and isinstance(body[0], fir.If)
        and not body[0].else_body
        and len(body[0].then_body) == 1
    ):
        cond = body[0].cond
        st = body[0].then_body[0]
    elif len(body) == 1:
        st = body[0]
    else:
        raise _NotDistributable("multi-statement body")
    if not isinstance(st, fir.ReduceAssign) or st.op not in ("+", "min", "max"):
        raise _NotDistributable("not a +/min/max reduction")
    tgt = st.target
    if not (
        isinstance(tgt, fir.Index)
        and isinstance(tgt.base, fir.Ident)
        and isinstance(tgt.index, fir.Ident)
        and tgt.index.name == kern.dst_param
    ):
        raise _NotDistributable("write is not prop[dst]")
    return cond, tgt.base.name, st.op, st.value


class DistEngine(Engine):
    """Multi-device engine: the shared host interpreter of :class:`Engine`
    plus distributed supersteps for scatter-reduce edge kernels.

    The host state lives on the bind's ``device``; shard ``k``'s slice and
    buckets on ``mesh[k]``, where ``mesh = target.mesh(device)``. The graph is
    partitioned lazily, on the first distributable edge-kernel launch.
    Kernels that read edge weights are only distributed when no kernel in
    the module writes weights (the weight buckets are built once at
    partition time).
    """

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
        super().__init__(module, graph, target, device, argv=argv, library=library)
        shards = dataclasses.replace(self.target, kind="distributed").mesh(device)
        self.mesh = [str(m) for m in shards]
        self.axis = self.target.axis
        self._dist_graph: Optional[DistGraph] = None
        self._dist_lowered: Dict[str, Optional[tuple]] = {}
        self._weights_static = not any(k.writes_weight for k in module.kernels.values())

    def refresh_graph(self, graph: Optional[GraphData] = None) -> None:
        super().refresh_graph(graph)
        # the superstep closures captured the old partition: partition
        # again on the next distributable launch
        self._dist_graph = None
        self._dist_lowered.clear()

    # -- lazy partition -----------------------------------------------------
    def _partitioned(self) -> DistGraph:
        if self._dist_graph is None:
            wdt = DTYPES[self.module.graph.weight_scalar or "float"]
            self._dist_graph = partition_graph(self.graph, self.mesh, self.axis,
                                               weight_dtype=wdt)
        return self._dist_graph

    # -- per-kernel distributed lowering ------------------------------------
    def _dist_kernel(self, name: str) -> Optional[tuple]:
        if name in self._dist_lowered:
            return self._dist_lowered[name]
        kern = self.module.kernels[name]
        entry = None
        try:
            cond, out_prop, op, value = _match_dist_kernel(kern)
            src_props: Set[str] = set()
            val_fn = _lower_dist_expr(self.module, kern, value, src_props, self._weights_static)
            cond_fn = (
                _lower_dist_expr(self.module, kern, cond, src_props, self._weights_static)
                if cond is not None
                else None
            )
            out_dtype = self.state[out_prop].dtype
            step = make_expr_push_step(self._partitioned(), sorted(src_props), val_fn, cond_fn,
                                       op, out_dtype, self.device)
            entry = (step, out_prop, op, sorted(src_props))
        except _NotDistributable:
            entry = None
        self._dist_lowered[name] = entry
        return entry

    # -- superstep execution -------------------------------------------------
    def _dist_exec(self, name: str, entry: tuple) -> None:
        """Run one distributed superstep of an already-lowered edge kernel."""
        step, out_prop, op, src_props = entry
        scalars = self._kernel_scalars(name)
        props = {p: self.state[p] for p in src_props}
        tr = tel.get()
        sp = tel.NULL_SPAN
        if tr.enabled:
            # shuffle volume as the reference counts it: D x D dst-owner
            # buckets of Emax slots each
            dg = self._partitioned()
            sp = tr.span("superstep", kernel=name, devices=dg.n_devices,
                         shuffle_elements=dg.padded_slots, edges=self.graph.n_edges)
        with sp:
            red = self._timed_call(("dist", name), step, props, scalars)[: self.graph.n_vertices]
        cur = self.state[out_prop]
        self.state[out_prop] = backend.combine(op, cur, red.to(cur.dtype))
        self.stats.dist_supersteps += 1
        self.stats.edges_traversed += self.graph.n_edges

    # -- per-launch batching hook (repro_torch.batch) -------------------------
    def batched_runner(self, name: str) -> BatchedLaunch:
        """Batch-axis lowering of the distributed launch strategy.

        Edge kernels that run as supersteps sequentially keep doing so
        batched: one shuffle round and one batched ``shuffle_reduce`` per
        destination owner serve all K rows, each row folded as its one-row
        launch folds it, so results stay bit-identical to sequential
        distributed runs. Fused pipelines are consumed stage-wise exactly
        like the sequential :meth:`launch`; everything else takes the local
        batched launch."""
        kern = self.module.kernels.get(name)
        if isinstance(kern, mir.PipelineKernel):
            entries = {s.name: self._dist_kernel(s.name) for s in kern.edge_stages}
            if any(e is not None for e in entries.values()):
                return self._batched_pipeline(kern, entries)
        elif kern is not None and kern.kind is mir.KernelKind.EDGE:
            entry = self._dist_kernel(name)
            if entry is not None:
                n_edges = self.graph.n_edges

                def bump(stats):
                    stats.dist_supersteps += 1
                    stats.edges_traversed += n_edges

                return BatchedLaunch(fn=self._batched_superstep(entry), bump_stats=bump)
        return super().batched_runner(name)

    def _batched_superstep(self, entry: tuple) -> Callable:
        """fn(state, scalars) -> {out_prop: combined} over a leading K axis."""
        step, out_prop, op, src_props = entry
        n_v = self.graph.n_vertices

        def run(state, scalars):
            red = step({p: state[p] for p in src_props}, scalars)[:, :n_v]
            cur = state[out_prop]
            return {out_prop: backend.combine(op, cur, red.to(cur.dtype))}

        return run

    def _batched_pipeline(self, kern: mir.PipelineKernel,
                          entries: Dict[str, Optional[tuple]]) -> BatchedLaunch:
        """Stage-wise batched pipeline: distributable edge stages run as
        batched supersteps, the rest as local batched launches, with each
        stage's updates committed before the next (the sequential stage-wise
        consumption, so results and superstep accounting line up)."""
        stage_fns = []
        n_dist = 0
        n_local_edges = 0
        for stage in kern.stages:
            entry = entries.get(stage.name)
            if entry is not None:
                stage_fns.append(self._batched_superstep(entry))
                n_dist += 1
            else:
                stage_fns.append(super().batched_runner(stage.name).fn)
                if stage.kind is mir.KernelKind.EDGE:
                    n_local_edges += 1

        def run(state, scalars):
            cur = dict(state)
            out = {}
            for fn in stage_fns:
                upd = fn(cur, scalars)
                cur.update(upd)
                out.update(upd)
            return out

        n_edges = self.graph.n_edges

        def bump(stats):
            stats.dist_supersteps += n_dist
            stats.full_launches += len(stage_fns) - n_dist
            stats.edges_traversed += n_edges * (n_dist + n_local_edges)

        return BatchedLaunch(fn=run, bump_stats=bump)

    # -- launch override -----------------------------------------------------
    def launch(self, name: str):
        kern = self.module.kernels.get(name)
        if isinstance(kern, mir.PipelineKernel):
            # consume a fused pipeline stage by stage whenever an edge stage
            # can run as a superstep (stage kernels keep their own entries
            # in module.kernels, so per-stage lowering caches under the
            # stage names); otherwise the local pipeline launch
            entries = {s.name: self._dist_kernel(s.name) for s in kern.edge_stages}
            if any(e is not None for e in entries.values()):
                self._count_launch(name)
                tr = tel.get()
                sp = tr.span("launch:" + name, kernel=name, kind="pipeline",
                             mode="dist") if tr.enabled else tel.NULL_SPAN
                with sp:
                    for stage in kern.stages:
                        entry = entries.get(stage.name)
                        if entry is not None:
                            self._dist_exec(stage.name, entry)
                        else:
                            self._execute_kernel(stage.name, stage)
                return
        elif kern is not None and kern.kind is mir.KernelKind.EDGE:
            entry = self._dist_kernel(name)
            if entry is not None:
                self._count_launch(name)
                tr = tel.get()
                sp = tr.span("launch:" + name, kernel=name, kind="edge",
                             mode="dist") if tr.enabled else tel.NULL_SPAN
                with sp:
                    self._dist_exec(name, entry)
                return
        super().launch(name)
