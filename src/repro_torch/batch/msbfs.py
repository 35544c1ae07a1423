"""Bit-packed multi-source BFS: the classic MS-BFS layout for batched roots.

The port of the reference's ``batch/msbfs.py``. Level-synchronous BFS
programs dominate multi-query graph serving (every query is "the same
traversal from a different root"), and their per-query state is ONE bit:
"is v in the frontier". Packing 32 queries into each int32 word turns K
frontier expansions into one:

* the frontier and the seen set are ``[W, V]`` int32 words on the device
  (W = ceil(K / 32); bit ``q % 32`` of word ``q // 32`` is query ``q``);
* one traversal step ORs every in-neighbour's frontier word into each
  vertex: ONE launch of the hand-written ``edge_stream`` kernel with the
  words as its rows, apply ``src`` and the bitwise-OR reduce, over the
  bind's dst-sorted edges, offsets and work list (the reference does it
  with an ``associative_scan`` over the CSC stream);
* the newly reached bits record their BFS level (unpacked in PyTorch on
  the device), and the loop runs until every packed query has an empty
  frontier, reading one "any new bit" flag back per level, so the launch
  total does not depend on K.

The reference packs 64 sources a word where JAX has 64-bit integers
enabled; the port always packs 32. Levels are the same either way.

Selection is automatic and conservative: :func:`match_msbfs` (copied from
the reference) re-derives the BFS template from the MIR, and anything that
does not match runs on the generic batched path. The reconstruction is
exact: for a matched program every output property and host scalar equals
what the sequential interpreter computes (levels are unique per vertex;
``tuple[v]`` is the vertex's own level for every reached vertex except the
root, which takes the min over its reached in-neighbours).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core import fir, mir
from ..core.engine import count_launch
from ..kernels import edge_stream as es_kernel

WORD_BITS = 32  # sources packed into one int32 word


@dataclass(frozen=True)
class MSBFSPlan:
    """The pieces of a matched level-synchronous BFS program."""

    level_prop: str  # e.g. old_level: the frontier/level property
    next_prop: str  # e.g. new_level: double-buffered level copy
    tuple_prop: str  # e.g. tuple: the min-reduce scratch
    counter_prop: str  # e.g. activeVertex: frontier-size accumulator
    level_scalar: str  # e.g. level
    root_scalar: str  # e.g. root
    loop_var: str  # e.g. frontier_size (local declared in main)
    inf: int  # the "unreached" fill of tuple_prop
    init_kernel: str
    loop_launches: Tuple[str, ...]  # launch names per host iteration

    def accepts(self, param_keys, n_vertices: int) -> bool:
        """Fast path applies when queries only vary the root and the
        unreached sentinel cannot be confused with a real level."""
        return set(param_keys) <= {self.root_scalar} and self.inf > n_vertices + 1


# ---------------------------------------------------------------------------
# template matching on the MIR
# ---------------------------------------------------------------------------


def _int_value(e: fir.Expr) -> Optional[int]:
    if isinstance(e, fir.IntLit):
        return e.value
    if isinstance(e, fir.UnaryOp) and e.op == "-" and isinstance(e.operand, fir.IntLit):
        return -e.operand.value
    return None


def _is_prop_at(e: fir.Expr, prop: str, var: str) -> bool:
    return (
        isinstance(e, fir.Index)
        and isinstance(e.base, fir.Ident)
        and e.base.name == prop
        and isinstance(e.index, fir.Ident)
        and e.index.name == var
    )


def _match_eq(e: fir.Expr) -> Optional[Tuple[fir.Expr, fir.Expr]]:
    if isinstance(e, fir.BinOp) and e.op == "==":
        return e.lhs, e.rhs
    return None


def _match_prop_eq(e: fir.Expr, var: str):
    """Match ``P[var] == rhs`` (either operand order) -> (prop, rhs)."""
    sides = _match_eq(e)
    if sides is None:
        return None
    for a, b in (sides, sides[::-1]):
        if (
            isinstance(a, fir.Index)
            and isinstance(a.base, fir.Ident)
            and isinstance(a.index, fir.Ident)
            and a.index.name == var
        ):
            return a.base.name, b
    return None

def _is_scalar_plus_one(e: fir.Expr, scalar: str) -> bool:
    if not (isinstance(e, fir.BinOp) and e.op == "+"):
        return False
    for a, b in ((e.lhs, e.rhs), (e.rhs, e.lhs)):
        if isinstance(a, fir.Ident) and a.name == scalar and _int_value(b) == 1:
            return True
    return False


def _launch_name(st: fir.Stmt) -> Optional[str]:
    if (
        isinstance(st, fir.ExprStmt)
        and isinstance(st.expr, fir.MethodCall)
        and st.expr.method in ("init", "process")
        and len(st.expr.args) == 1
        and isinstance(st.expr.args[0], fir.Ident)
    ):
        return st.expr.args[0].name
    return None


def _expand_launch(module: mir.Module, name: str) -> List[str]:
    """Resolve a fused/pipelined launch back to the original kernel names."""
    parts = module.fusion_groups.get(name)
    if parts:
        return list(parts)
    return [name]


def match_msbfs(module: mir.Module) -> Optional[MSBFSPlan]:
    """Re-derive the BFS template from an analyzed module, or None.

    Matches the paper-Fig.-1 edge-centric BFS shape regardless of which
    passes ran: fused vertex kernels and pipelines are expanded back to
    their original stages via ``module.fusion_groups`` before matching.
    """
    if module.host is None or module.graph.weighted:
        return None
    body = module.host.main.body
    if len(body) != 5:
        return None
    st_init, st_l, st_n, st_var, st_loop = body

    # vertices.init(reset)
    init_names = (
        _expand_launch(module, _launch_name(st_init))
        if _launch_name(st_init)
        else []
    )
    if len(init_names) != 1:
        return None
    init_kernel = init_names[0]

    # L[root] = 1; N[root] = 1
    def _root_assign(st: fir.Stmt) -> Optional[Tuple[str, str]]:
        if (
            isinstance(st, fir.Assign)
            and isinstance(st.target, fir.Index)
            and isinstance(st.target.base, fir.Ident)
            and isinstance(st.target.index, fir.Ident)
            and _int_value(st.value) == 1
        ):
            return st.target.base.name, st.target.index.name
        return None

    la, na = _root_assign(st_l), _root_assign(st_n)
    if la is None or na is None or la[1] != na[1]:
        return None
    level_prop, root_scalar = la
    next_prop = na[0]
    if root_scalar not in module.scalars or level_prop == next_prop:
        return None

    # var fs: int = 1
    if not (isinstance(st_var, fir.VarDecl) and _int_value(st_var.init) == 1):
        return None
    loop_var = st_var.name

    # while (fs) { launches...; fs = C[0]; C[0] = 0; lvl += 1; }
    if not (
        isinstance(st_loop, fir.While)
        and isinstance(st_loop.cond, fir.Ident)
        and st_loop.cond.name == loop_var
    ):
        return None
    loop_body = list(st_loop.body)
    launches: List[str] = []
    while loop_body and _launch_name(loop_body[0]) is not None:
        launches.append(_launch_name(loop_body[0]))
        loop_body.pop(0)
    if len(loop_body) != 3 or not launches:
        return None
    st_fs, st_c0, st_lvl = loop_body
    if not (
        isinstance(st_fs, fir.Assign)
        and isinstance(st_fs.target, fir.Ident)
        and st_fs.target.name == loop_var
        and isinstance(st_fs.value, fir.Index)
        and isinstance(st_fs.value.base, fir.Ident)
        and _int_value(st_fs.value.index) == 0
    ):
        return None
    counter_prop = st_fs.value.base.name
    if not (
        isinstance(st_c0, fir.Assign)
        and isinstance(st_c0.target, fir.Index)
        and isinstance(st_c0.target.base, fir.Ident)
        and st_c0.target.base.name == counter_prop
        and _int_value(st_c0.target.index) == 0
        and _int_value(st_c0.value) == 0
    ):
        return None
    if not (
        isinstance(st_lvl, fir.ReduceAssign)
        and st_lvl.op == "+"
        and isinstance(st_lvl.target, fir.Ident)
        and _int_value(st_lvl.value) == 1
    ):
        return None
    level_scalar = st_lvl.target.name
    if level_scalar not in module.scalars:
        return None
    if _int_value(module.scalars[level_scalar].init or fir.IntLit(value=-1)) != 1:
        return None

    # expand fused launches back to [edge, update, apply] originals
    expanded: List[str] = []
    for nm in launches:
        expanded.extend(_expand_launch(module, nm))
    if len(expanded) != 3:
        return None
    e_name, u_name, a_name = expanded
    ek = module.kernels.get(e_name)
    uk = module.kernels.get(u_name)
    ak = module.kernels.get(a_name)
    ik = module.kernels.get(init_kernel)
    if not all(
        k is not None and isinstance(k, mir.Kernel) for k in (ek, uk, ak, ik)
    ):
        return None
    if ek.kind is not mir.KernelKind.EDGE:
        return None
    if uk.kind is not mir.KernelKind.VERTEX or ak.kind is not mir.KernelKind.VERTEX:
        return None
    if ik.kind is not mir.KernelKind.VERTEX:
        return None

    # the PR-2 verdicts must agree this is a dynamic frontier on L:
    # DENSE would mean the guard is loop-invariant — not a real BFS frontier
    if ek.frontier is None or ek.frontier.props != {level_prop}:
        return None
    if ek.direction is mir.Direction.DENSE:
        return None

    # edge kernel: if (L[src] == lvl) T[dst] min= lvl + 1
    eb = ek.func.body
    if not (
        len(eb) == 1
        and isinstance(eb[0], fir.If)
        and not eb[0].else_body
        and len(eb[0].then_body) == 1
    ):
        return None
    g = _match_prop_eq(eb[0].cond, ek.src_param)
    if g is None or g[0] != level_prop:
        return None
    if not (isinstance(g[1], fir.Ident) and g[1].name == level_scalar):
        return None
    red = eb[0].then_body[0]
    if not (
        isinstance(red, fir.ReduceAssign)
        and red.op == "min"
        and isinstance(red.target, fir.Index)
        and isinstance(red.target.base, fir.Ident)
        and _is_prop_at(red.target, red.target.base.name, ek.dst_param)
        and _is_scalar_plus_one(red.value, level_scalar)
    ):
        return None
    tuple_prop = red.target.base.name
    if tuple_prop in (level_prop, next_prop, counter_prop):
        return None

    # update kernel: if ((T[v] == lvl+1) & (L[v] == -1)) { N[v] = T[v]; C[0] += 1 }
    ub = uk.func.body
    if not (
        len(ub) == 1
        and isinstance(ub[0], fir.If)
        and not ub[0].else_body
        and len(ub[0].then_body) == 2
    ):
        return None
    cond = ub[0].cond
    if not (isinstance(cond, fir.BinOp) and cond.op == "&"):
        return None
    matched_t = matched_l = False
    for side in (cond.lhs, cond.rhs):
        m = _match_prop_eq(side, uk.vertex_param)
        if m is None:
            return None
        prop, rhs = m
        if prop == tuple_prop and _is_scalar_plus_one(rhs, level_scalar):
            matched_t = True
        elif prop == level_prop and _int_value(rhs) == -1:
            matched_l = True
    if not (matched_t and matched_l):
        return None
    set_n, bump_c = ub[0].then_body
    if not (
        isinstance(set_n, fir.Assign)
        and _is_prop_at(set_n.target, next_prop, uk.vertex_param)
        and _is_prop_at(set_n.value, tuple_prop, uk.vertex_param)
    ):
        return None
    if not (
        isinstance(bump_c, fir.ReduceAssign)
        and bump_c.op == "+"
        and isinstance(bump_c.target, fir.Index)
        and isinstance(bump_c.target.base, fir.Ident)
        and bump_c.target.base.name == counter_prop
        and _int_value(bump_c.target.index) == 0
        and _int_value(bump_c.value) == 1
    ):
        return None

    # apply kernel: L[v] = N[v]
    ab = ak.func.body
    if not (
        len(ab) == 1
        and isinstance(ab[0], fir.Assign)
        and _is_prop_at(ab[0].target, level_prop, ak.vertex_param)
        and _is_prop_at(ab[0].value, next_prop, ak.vertex_param)
    ):
        return None

    # init kernel: L[v] = -1; N[v] = -1; T[v] = INF (any order)
    inits: Dict[str, int] = {}
    for st in ik.func.body:
        if not (
            isinstance(st, fir.Assign)
            and isinstance(st.target, fir.Index)
            and isinstance(st.target.base, fir.Ident)
            and isinstance(st.target.index, fir.Ident)
            and st.target.index.name == ik.vertex_param
            and _int_value(st.value) is not None
        ):
            return None
        inits[st.target.base.name] = _int_value(st.value)
    if set(inits) != {level_prop, next_prop, tuple_prop}:
        return None
    if inits[level_prop] != -1 or inits[next_prop] != -1:
        return None
    inf = inits[tuple_prop]
    if inf <= 1:
        return None

    # level / tuple / next must be ints for levels to transfer exactly
    for prop in (level_prop, next_prop, tuple_prop, counter_prop):
        if module.properties[prop].scalar != "int":
            return None
    if module.scalars[root_scalar].scalar != "int":
        return None

    return MSBFSPlan(
        level_prop=level_prop,
        next_prop=next_prop,
        tuple_prop=tuple_prop,
        counter_prop=counter_prop,
        level_scalar=level_scalar,
        root_scalar=root_scalar,
        loop_var=loop_var,
        inf=inf,
        init_kernel=init_kernel,
        loop_launches=tuple(launches),
    )


# ---------------------------------------------------------------------------
# packed traversal
# ---------------------------------------------------------------------------


def pack_roots(roots: np.ndarray, n_vertices: int) -> np.ndarray:
    """The level-1 frontier of ``roots`` (one per query, relabeled ids) as
    ``[W, V]`` int32 words: bit ``q % 32`` of word ``q // 32`` at vertex
    ``roots[q]``."""
    k = roots.shape[0]
    lanes = np.arange(k)
    words = np.zeros(((k + WORD_BITS - 1) // WORD_BITS, n_vertices), np.uint32)
    np.bitwise_or.at(words, (lanes // WORD_BITS, roots),
                     np.left_shift(np.uint32(1), (lanes % WORD_BITS).astype(np.uint32)))
    return words.view(np.int32)


def run_msbfs(be, plan: MSBFSPlan) -> None:
    """Execute the packed traversal on a BatchEngine and fill its state.

    Works in the engine's (possibly hub-relabeled) vertex id space; the
    BatchEngine's result splitting translates back.
    """
    eng = be.engine
    g = be.graph
    gb = eng.gb
    dev = be.device
    k = be.batch_size
    n_v, n_e = g.n_vertices, g.n_edges

    roots_orig = np.broadcast_to(np.asarray(be.host_env[plan.root_scalar], np.int64), (k,))
    o2n = eng.old2new
    roots = np.asarray(o2n)[roots_orig] if o2n is not None else roots_orig

    frontier = torch.from_numpy(pack_roots(roots, n_v)).to(dev)  # [W, V]
    seen = frontier
    lanes = torch.arange(k, device=dev)
    word_of, shift = lanes // WORD_BITS, (lanes % WORD_BITS).to(torch.int32)[:, None]
    levels = torch.full((k, n_v), -1, dtype=torch.int32, device=dev)
    roots_t = torch.from_numpy(np.array(roots)).to(dev)
    levels[lanes, roots_t] = 1
    every = torch.ones(n_v, dtype=torch.bool, device=dev)  # no frontier check: | of 0 is 0

    its = 0
    while True:
        its += 1
        be.stats.host_iterations += 1
        count_launch(be.stats, be.module, be.MSBFS_NAME)
        be.stats.full_launches += 1
        be.stats.edges_traversed += n_e
        if n_e == 0:
            break
        # one launch for every query: row w ORs word w of each in-neighbour
        reach = es_kernel.edge_stream_gather_batched(
            frontier, every, gb["es_src"], None, None, gb["dst_offsets"], "src", "|",
            gb["es_split"])
        new = reach & ~seen
        seen = seen | new
        # unpack the newly reached bits into per-query levels
        newly = (torch.bitwise_right_shift(new[word_of], shift) & 1) != 0  # [K, V]
        levels = torch.where(newly & (levels < 0), its + 1, levels)
        frontier = new
        if not bool(new.any()):  # one read-back a level
            break

    # ---- exact reconstruction of the sequential interpreter's state ----
    inf = plan.inf
    tup = torch.where(levels >= 1, levels, inf)
    # tuple[v] = min over reached in-neighbours u of (level[u] + 1): for any
    # reached v != root that is exactly level[v]; the root's level 1 was
    # assigned on the host, never min-reduced, so it takes the min over its
    # own in-neighbours (INF when none is reached)
    indptr, csc_idx, _ = g.csc
    deg = indptr[roots + 1] - indptr[roots]
    nbrs = np.concatenate([csc_idx[indptr[r]:indptr[r + 1]] for r in roots]
                          + [np.zeros(0, np.int64)]).astype(np.int64)
    lane_of = torch.from_numpy(np.repeat(np.arange(k), deg)).to(dev)
    lv = levels[lane_of, torch.from_numpy(nbrs).to(dev)]
    lv = torch.where(lv >= 1, lv + 1, inf)
    root_t = torch.full((k,), inf, dtype=torch.int32, device=dev).scatter_reduce_(
        0, lane_of, lv, "amin")
    tup[lanes, roots_t] = root_t

    be.state[plan.level_prop] = levels
    be.state[plan.next_prop] = levels.clone()
    be.state[plan.tuple_prop] = tup
    # the counter prop stays all-zero (the host clears it after the last
    # iteration), as do any other never-written properties: _reset zeroed them
    depth = levels.amax(dim=1).cpu().numpy().astype(np.int64)  # >= 1 (the root)
    be.host_env[plan.level_scalar] = depth + 1
    be.host_env[plan.loop_var] = np.zeros(k, np.int64)
