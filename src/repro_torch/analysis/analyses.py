"""Dataflow analyses over analyzed MIR modules.

Runs *after* semantic analysis (and, for a compiled ``Program``, after the
optimization pass pipeline — so fusion-merged kernels are analyzed in their
final, concatenated form and cross-kernel conflicts introduced by ``fuse``
surface here). Nothing in this module mutates the module or contributes to
its canonical serialization: like ``passes.analyze_incremental`` (the
precedent this framework promotes), verdicts live entirely outside
``Module.describe()`` / ``fir.dump``, so program fingerprints, cache
identities and saved artifacts are untouched by analysis.

The concrete analyses (diagnostic codes in :mod:`.diagnostics`):

* **Scatter-write race** (GT101/GT102) — the paper's §III memory-conflict
  hazard. A per-edge write (DST/NEIGHBOR/OTHER pattern anywhere, or SRC in
  an edge kernel) that is a plain ``=`` store races unless its value is
  *uniform per target slot* (e.g. ``active[src] = 0``: every edge of one
  src writes the same value). ``min=``/``max=``/``+=``/``-=``/``*=``
  reductions are commutative-associative and conflict-free. Two different
  reduce ops on one property inside one kernel (possible after ``fuse``
  body-merges adjacent vertex kernels) are order-dependent: GT102.
* **Determinism certificate** (GT201) — ``deterministic`` (no scatters, or
  only min/max/integer reductions), ``reduction-deterministic`` (float
  ``+=``/``*=`` scatters: value-correct under any reduction order, but
  bitwise output depends on it; the shuffle path's sorted segment reduce
  pins a canonical order), or ``racy`` (a GT101/GT102 finding exists).
* **Uninitialized-read / dead-write** (GT301/GT302) along host control
  flow in launch order.
* **Non-termination heuristics** (GT401/GT402).
* **Shape-dependent dtype/overflow** (GT501/GT502) given a ``GraphShape``.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Set, Tuple

from ..core import fir, mir
from ..core.passes import (
    _host_blocks,
    _host_written_names,
    _iter_all_stmts,
    _launch_target,
    _visit_expr,
    analyze_incremental,
)
from ..core.semantic import _index_pattern
from .diagnostics import Diagnostic, make

_SCATTERED = (mir.IndexPattern.DST, mir.IndexPattern.NEIGHBOR,
              mir.IndexPattern.OTHER)
_INT32_MAX = 2**31 - 1

# certificate tiers, weakest guarantee last
DETERMINISTIC = "deterministic"
REDUCTION_DETERMINISTIC = "reduction-deterministic"
RACY = "racy"


def _device_kernels(module: mir.Module) -> List[mir.Kernel]:
    """Plain kernels to analyze — includes fusion-merged bodies (they are
    reanalyzed ``Kernel`` entries) and PipelineKernel stages (stages keep
    their own ``module.kernels`` entries, and stage boundaries commit, so
    a pipeline introduces no cross-stage write hazard of its own)."""
    return [k for k in module.kernels.values()
            if isinstance(k, mir.Kernel) and k.kind is not mir.KernelKind.HOST]


def _iter_prop_writes(module: mir.Module, k: mir.Kernel):
    """Yield ``(stmt, prop, pattern, op)`` for every property write in
    ``k``'s body, tracking neighbor-loop variables for NEIGHBOR patterns.
    ``op`` is the reduce op or None for a plain assignment."""
    loop_vars: Set[str] = set()

    def walk(body):
        for st in body:
            if isinstance(st, (fir.Assign, fir.ReduceAssign)):
                tgt = st.target
                if (isinstance(tgt, fir.Index) and isinstance(tgt.base, fir.Ident)
                        and tgt.base.name in module.properties):
                    pat = _index_pattern(tgt.index, k, loop_vars)
                    op = st.op if isinstance(st, fir.ReduceAssign) else None
                    yield st, tgt.base.name, pat, op
            elif isinstance(st, fir.If):
                yield from walk(st.then_body)
                yield from walk(st.else_body)
            elif isinstance(st, fir.For):
                loop_vars.add(st.var)
                yield from walk(st.body)
                loop_vars.discard(st.var)
            elif isinstance(st, fir.While):
                yield from walk(st.body)

    yield from walk(k.func.body)


def _per_edge(k: mir.Kernel, pattern: mir.IndexPattern) -> bool:
    """True when multiple lanes/edges may target the same slot: scattered
    patterns anywhere, SRC writes in edge kernels (one src, many edges),
    and CONST accumulator cells written from edge kernels."""
    if pattern in _SCATTERED:
        return True
    if k.kind is mir.KernelKind.EDGE and pattern in (
            mir.IndexPattern.SRC, mir.IndexPattern.CONST):
        return True
    return False


def _write_anchor(k: mir.Kernel, tgt_index: fir.Expr) -> Optional[str]:
    """The index identifier a write is keyed on, when it is a plain ident."""
    if isinstance(tgt_index, fir.Ident):
        return tgt_index.name
    return None


def _value_uniform(module: mir.Module, k: mir.Kernel, value: fir.Expr,
                   anchor: Optional[str]) -> bool:
    """True when ``value`` is provably the same for every edge/lane writing
    a given target slot — literals, host scalars, and reads keyed on the
    write's own index. Anything else (other kernel params, the edge
    weight, locals, differently-indexed property reads) is conservatively
    per-edge-varying."""
    uniform = True
    params = {p for p in (k.vertex_param, k.src_param, k.dst_param,
                          k.weight_param) if p}

    def visit(e):
        nonlocal uniform
        if not uniform or e is None:
            return
        if isinstance(e, (fir.IntLit, fir.FloatLit, fir.BoolLit, fir.StrLit)):
            return
        if (isinstance(e, fir.Index) and isinstance(e.base, fir.Ident)
                and e.base.name in module.properties):
            idx = e.index
            if not (anchor and isinstance(idx, fir.Ident) and idx.name == anchor):
                uniform = False
            return
        if isinstance(e, fir.Ident):
            if e.name in module.scalars or e.name == anchor:
                return
            if e.name in params:
                uniform = False  # varies per edge relative to the target slot
            else:
                uniform = False  # locals/loop vars: conservatively varying
            return
        if isinstance(e, fir.BinOp):
            visit(e.lhs)
            visit(e.rhs)
        elif isinstance(e, fir.UnaryOp):
            visit(e.operand)
        elif isinstance(e, fir.Index):
            visit(e.base)
            visit(e.index)
        elif isinstance(e, (fir.Call, fir.MethodCall)):
            for a in e.args:
                visit(a)
            if isinstance(e, fir.MethodCall):
                visit(e.obj)

    visit(value)
    return uniform


def race_analysis(module: mir.Module) -> Tuple[List[Diagnostic], Set[str]]:
    """GT101/GT102 plus the float-reduction property set (certificate).

    Returns ``(diagnostics, float_reduce_props)`` where the latter names
    float properties receiving per-edge ``+``/``-``/``*`` reductions —
    value-correct but reassociation-sensitive.
    """
    diags: List[Diagnostic] = []
    float_props: Set[str] = set()
    seen: Set[Tuple[str, str, int, int]] = set()  # dedup fusion body copies

    for k in _device_kernels(module):
        ops_by_prop: Dict[str, Set[str]] = {}
        first_site: Dict[str, Tuple[int, int]] = {}
        for st, prop, pat, op in _iter_prop_writes(module, k):
            if not _per_edge(k, pat):
                continue
            anchor = None
            if pat in (mir.IndexPattern.SRC, mir.IndexPattern.DST,
                       mir.IndexPattern.NEIGHBOR):
                anchor = _write_anchor(k, st.target.index)
            if op is None:
                if _value_uniform(module, k, st.value, anchor):
                    continue  # every conflicting writer stores the same value
                key = ("GT101", prop, st.line, st.col)
                if key not in seen:
                    seen.add(key)
                    diags.append(make(
                        "GT101",
                        f"non-reduction scatter write: {prop}[{pat.value}] = ... "
                        f"is stored per edge with an edge-varying value; "
                        f"concurrent edges targeting one {pat.value} slot race. "
                        f"Use a min=/max=/+= reduction (or make the stored "
                        f"value depend only on the written index).",
                        kernel=k.name, prop=prop, line=st.line, col=st.col,
                    ))
                effective = "="
            else:
                effective = op
                if (op in ("+", "-", "*")
                        and module.properties[prop].scalar == "float"):
                    float_props.add(prop)
            ops_by_prop.setdefault(prop, set()).add(effective)
            first_site.setdefault(prop, (st.line, st.col))

        for prop, ops in sorted(ops_by_prop.items()):
            if len(ops) > 1:
                line, col = first_site[prop]
                key = ("GT102", prop, line, col)
                if key in seen:
                    continue
                seen.add(key)
                diags.append(make(
                    "GT102",
                    f"conflicting reduction operators {sorted(ops)} on "
                    f"scattered property {prop} within kernel {k.name}; "
                    f"the combined result depends on commit order.",
                    kernel=k.name, prop=prop, line=line, col=col,
                ))
    return diags, float_props


def certificate_info(module: mir.Module) -> Tuple[str, str]:
    """(tier, explanation) of the determinism certificate."""
    race_diags, float_props = race_analysis(module)
    if race_diags:
        codes = sorted({d.code for d in race_diags})
        return RACY, (
            f"racy: unresolved scatter-write hazards ({', '.join(codes)}); "
            f"results depend on commit order"
        )
    if float_props:
        return REDUCTION_DETERMINISTIC, (
            f"reduction-deterministic: float reductions into "
            f"{sorted(float_props)} are value-correct under any reduction "
            f"order but bitwise-sensitive to reassociation; the shuffle "
            f"path's sorted segment reduce pins a canonical edge order"
        )
    return DETERMINISTIC, (
        "deterministic: all scattered writes are order-insensitive "
        "reductions (min/max or integer arithmetic)"
    )


def determinism_certificate(module: mir.Module) -> str:
    """The certificate tier alone (what reports and manifests carry)."""
    return certificate_info(module)[0]


def needs_shuffle(module: mir.Module) -> bool:
    """True when the program relies on the shuffle stage for *correctness*,
    not just throughput: it contains a racy plain-``=`` scatter, and only
    the shuffle path's deterministic last-write-wins commit gives it a
    defined result. Engines consult this to force ``shuffle`` on
    (``Target.shuffle=False`` is a throughput ablation, not a license to
    produce undefined results)."""
    diags, _ = race_analysis(module)
    return any(d.code == "GT101" for d in diags)


# ---------------------------------------------------------------------------
# host-control-flow analyses
# ---------------------------------------------------------------------------


def _prop_mentions(module: mir.Module, e: fir.Expr) -> Set[str]:
    """Property names read anywhere inside one expression tree."""
    out: Set[str] = set()

    def note(x):
        if isinstance(x, fir.Index) and isinstance(x.base, fir.Ident) \
                and x.base.name in module.properties:
            out.add(x.base.name)
        if isinstance(x, fir.Ident) and x.name in module.properties:
            out.add(x.name)

    _visit_expr(e, note)
    return out


def _launch_stages(module: mir.Module, st: fir.Stmt) -> List[mir.Kernel]:
    """The plain kernels a host statement launches (pipeline stages in
    commit order), or [] when it is not a launch."""
    tgt = _launch_target(module, st)
    if tgt is None:
        return []
    kern = module.kernels[tgt[0]]
    if isinstance(kern, mir.PipelineKernel):
        return list(kern.stages)
    return [kern]


def uninit_and_dead_analysis(module: mir.Module) -> List[Diagnostic]:
    """GT301 (read-before-init) + GT302 (write-only property).

    Walks the host program in launch order, tracking which properties have
    been written (by host index-stores or by launched kernels — reduce
    writes count: they *define* through accumulation over the zero-filled
    buffer). A kernel/host read of a never-written property relies on the
    backend's implicit zero fill: GT301. Properties written somewhere but
    never read by any kernel or host expression are flagged GT302 (they
    remain observable in results, hence a warning, not an error).
    """
    diags: List[Diagnostic] = []
    props = module.properties
    defined: Set[str] = set(module.degree_props)
    reported: Set[str] = set()

    def read(prop: str, line: int, col: int, where: str):
        if prop in props and prop not in defined and prop not in reported:
            reported.add(prop)
            diags.append(make(
                "GT301",
                f"property {prop} is read ({where}) before any kernel or "
                f"host statement initializes it; the read observes the "
                f"implicit zero-filled buffer.",
                prop=prop, line=line, col=col,
            ))

    def expr_reads(e: Optional[fir.Expr], st: fir.Stmt, where: str):
        if e is None:
            return
        for p in sorted(_prop_mentions(module, e)):
            read(p, st.line, getattr(st, "col", 0), where)

    def scan(body: List[fir.Stmt], depth: int = 0):
        if depth > 8:  # host-func recursion guard
            return
        for st in body:
            stages = _launch_stages(module, st)
            if stages:
                for s in stages:
                    for r in s.reads:
                        read(r.prop, st.line, getattr(st, "col", 0),
                             f"by kernel {s.name}")
                    defined.update(w.prop for w in s.writes)
                continue
            if isinstance(st, fir.Assign):
                if isinstance(st.target, fir.Index):
                    expr_reads(st.target.index, st, "as a host index")
                expr_reads(st.value, st, "by a host statement")
                tgt = st.target
                if (isinstance(tgt, fir.Index) and isinstance(tgt.base, fir.Ident)
                        and tgt.base.name in props):
                    defined.add(tgt.base.name)
            elif isinstance(st, fir.ReduceAssign):
                expr_reads(st.target, st, "by a host reduce")
                expr_reads(st.value, st, "by a host statement")
                tgt = st.target
                if (isinstance(tgt, fir.Index) and isinstance(tgt.base, fir.Ident)
                        and tgt.base.name in props):
                    defined.add(tgt.base.name)
            elif isinstance(st, fir.VarDecl):
                expr_reads(st.init, st, "by a host statement")
            elif isinstance(st, fir.If):
                expr_reads(st.cond, st, "by a host condition")
                scan(st.then_body, depth)
                scan(st.else_body, depth)
            elif isinstance(st, fir.While):
                expr_reads(st.cond, st, "by a host condition")
                scan(st.body, depth)
            elif isinstance(st, fir.For):
                expr_reads(st.iter, st, "by a host statement")
                scan(st.body, depth)
            elif isinstance(st, fir.ExprStmt):
                e = st.expr
                if isinstance(e, fir.Call) and e.func == "swap":
                    for a in e.args:
                        if isinstance(a, fir.Ident) and a.name in props:
                            read(a.name, st.line, getattr(st, "col", 0),
                                 "by swap()")
                            defined.add(a.name)
                    continue
                if (isinstance(e, fir.Call)
                        and e.func in module.host.host_funcs):
                    scan(module.host.host_funcs[e.func].body, depth + 1)
                    continue
                expr_reads(e, st, "by a host statement")

    scan(module.host.main.body)

    # -- dead writes: written somewhere, read nowhere ----------------------
    read_props: Set[str] = set()
    written_props: Dict[str, Tuple[Optional[str], int, int]] = {}
    for k in _device_kernels(module):
        read_props.update(r.prop for r in k.reads)
        for st, prop, _pat, _op in _iter_prop_writes(module, k):
            written_props.setdefault(prop, (k.name, st.line, st.col))
    for block in _host_blocks(module):
        for st in _iter_all_stmts(block):
            for e in _stmt_read_exprs(st):
                read_props |= _prop_mentions(module, e)
            if isinstance(st, (fir.Assign, fir.ReduceAssign)):
                tgt = st.target
                if (isinstance(tgt, fir.Index) and isinstance(tgt.base, fir.Ident)
                        and tgt.base.name in props):
                    written_props.setdefault(
                        tgt.base.name, (None, st.line, getattr(st, "col", 0)))
    for prop in sorted(set(written_props) - read_props):
        kname, line, col = written_props[prop]
        diags.append(make(
            "GT302",
            f"property {prop} is written but never read by any kernel or "
            f"host statement; its writes are observable only as a result "
            f"output.",
            kernel=kname, prop=prop, line=line, col=col,
        ))
    return diags


def _stmt_read_exprs(st: fir.Stmt) -> List[fir.Expr]:
    """The value-side expressions of one host statement (read positions)."""
    if isinstance(st, fir.Assign):
        out = [st.value]
        if isinstance(st.target, fir.Index):
            out.append(st.target.index)
        return out
    if isinstance(st, fir.ReduceAssign):
        return [st.target, st.value]
    if isinstance(st, fir.VarDecl):
        return [st.init] if st.init is not None else []
    if isinstance(st, fir.If):
        return [st.cond]
    if isinstance(st, fir.While):
        return [st.cond]
    if isinstance(st, fir.For):
        return [st.iter]
    if isinstance(st, fir.ExprStmt):
        return [st.expr]
    return []


def _names_read(module: mir.Module, e: fir.Expr) -> Tuple[Set[str], bool]:
    """(scalar/local/property names read in ``e``, analyzable) — not
    analyzable when the condition involves calls whose effects we cannot
    model (e.g. ``argv()``)."""
    names: Set[str] = set()
    analyzable = True

    def note(x):
        nonlocal analyzable
        if isinstance(x, fir.Index) and isinstance(x.base, fir.Ident) \
                and x.base.name in module.properties:
            names.add(x.base.name)
        elif isinstance(x, fir.Ident):
            names.add(x.name)
        elif isinstance(x, (fir.Call, fir.MethodCall)):
            analyzable = False

    _visit_expr(e, note)
    return names, analyzable


def _body_writes(module: mir.Module, body: List[fir.Stmt],
                 depth: int = 0) -> Set[str]:
    """Every name (host var, scalar, property) written inside a loop body,
    including properties written by launched kernels and writes inside
    called host functions."""
    written: Set[str] = set()
    if depth > 8:
        return written
    for st in _iter_all_stmts(body):
        stages = _launch_stages(module, st)
        if stages:
            for s in stages:
                written.update(w.prop for w in s.writes)
            continue
        if isinstance(st, (fir.Assign, fir.ReduceAssign)):
            tgt = st.target
            if isinstance(tgt, fir.Ident):
                written.add(tgt.name)
            elif isinstance(tgt, fir.Index) and isinstance(tgt.base, fir.Ident):
                written.add(tgt.base.name)
        elif isinstance(st, fir.For):
            written.add(st.var)
        elif isinstance(st, fir.ExprStmt):
            e = st.expr
            if isinstance(e, fir.Call) and e.func == "swap":
                written.update(a.name for a in e.args
                               if isinstance(a, fir.Ident))
            elif isinstance(e, fir.Call) and e.func in module.host.host_funcs:
                written |= _body_writes(
                    module, module.host.host_funcs[e.func].body, depth + 1)
    return written


def termination_analysis(module: mir.Module) -> List[Diagnostic]:
    """GT401 (condition never updated) + GT402 (stale frontier loop)."""
    diags: List[Diagnostic] = []
    # globally-mutated names: distinguishes a dynamic frontier from a
    # loop-invariant guard (mirrors the `direction` pass's DENSE verdict)
    mutated: Set[str] = set(_host_written_names(module))
    for k in _device_kernels(module):
        mutated |= {w.prop for w in k.writes}

    for block in _host_blocks(module):
        for st in _iter_all_stmts(block):
            if not isinstance(st, fir.While):
                continue
            cond_names, analyzable = _names_read(module, st.cond)
            writes = _body_writes(module, st.body)
            if analyzable and not (cond_names & writes):
                what = (f"variables {sorted(cond_names)} are"
                        if cond_names else "the condition reads no variable and is")
                diags.append(make(
                    "GT401",
                    f"while condition never updated: {what} never written "
                    f"inside the loop body, so the loop cannot make "
                    f"progress toward termination.",
                    line=st.line, col=getattr(st, "col", 0),
                ))
            # frontier staleness: a dynamically-guarded edge kernel is
            # launched here, but nothing in this loop updates its frontier
            for lst in _iter_all_stmts(st.body):
                for s in _launch_stages(module, lst):
                    fr = s.frontier
                    if fr is None or s.kind is not mir.KernelKind.EDGE:
                        continue
                    if not (fr.props & mutated):
                        continue  # loop-invariant guard (direction: DENSE)
                    if not (fr.props & writes):
                        diags.append(make(
                            "GT402",
                            f"frontier loop never updates the frontier: "
                            f"kernel {s.name} is guarded on "
                            f"{sorted(fr.props)} but no statement in this "
                            f"loop writes those properties — the frontier "
                            f"can never drain.",
                            kernel=s.name, line=st.line,
                            col=getattr(st, "col", 0),
                        ))
    return diags


# ---------------------------------------------------------------------------
# shape-dependent dtype / overflow analysis
# ---------------------------------------------------------------------------


def shape_analysis(module: mir.Module, shape) -> List[Diagnostic]:
    """GT501/GT502 given a GraphShape-like object with ``n_edges``.

    Edge indices and CSR offsets are int32 in every backend buffer layout:
    |E| past 2**31-1 is unrepresentable (GT502). Int properties receiving
    per-edge ``+`` reductions accumulate up to |E| contributions per sweep;
    with host loops repeating sweeps, int32 wraps once |E| nears the int32
    range — flagged with a 2x safety margin (GT501).
    """
    diags: List[Diagnostic] = []
    n_edges = int(getattr(shape, "n_edges", 0) or 0)
    if n_edges > _INT32_MAX:
        diags.append(make(
            "GT502",
            f"graph shape declares n_edges={n_edges}, which exceeds the "
            f"int32 edge-index space ({_INT32_MAX}) of the CSR "
            f"indptr/indices layout.",
        ))
    if n_edges > _INT32_MAX // 2:
        for k in _device_kernels(module):
            for st, prop, pat, op in _iter_prop_writes(module, k):
                if op not in ("+", "-"):
                    continue
                if not _per_edge(k, pat):
                    continue
                if module.properties[prop].scalar != "int":
                    continue
                diags.append(make(
                    "GT501",
                    f"int32 accumulator {prop} receives a per-edge "
                    f"'{op}=' reduction; at n_edges={n_edges} a single "
                    f"sweep can contribute up to |E| increments and "
                    f"overflow int32. Use a float property or reduce "
                    f"the shape bucket.",
                    kernel=k.name, prop=prop, line=st.line, col=st.col,
                ))
    # dedup repeated sites per (kernel, prop)
    seen: Set[Tuple[str, Optional[str], Optional[str]]] = set()
    out: List[Diagnostic] = []
    for d in diags:
        key = (d.code, d.kernel, d.prop)
        if key not in seen:
            seen.add(key)
            out.append(d)
    return out


# ---------------------------------------------------------------------------
# framework entry
# ---------------------------------------------------------------------------


def incremental_diagnostic(module: mir.Module) -> Diagnostic:
    """``passes.analyze_incremental`` promoted into the framework: the
    streaming-eligibility boolean with its explanation attached."""
    info = analyze_incremental(module)
    if info.incremental_ok:
        msg = (f"streaming-incremental eligible: monotone "
               f"{'/'.join(info.reduce_ops)} reductions match the "
               f"{info.template.kind!r} repair template on property "
               f"{info.template.dist_prop!r}.")
    elif info.monotone:
        msg = ("monotone but no recognized repair template; streaming "
               "updates fall back to full recompute.")
    else:
        msg = ("not streaming-incremental: "
               + "; ".join(info.reasons)
               + ". Streaming updates fall back to full recompute.")
    return make("GT202", msg)


def analyze_module(module: mir.Module, shape=None) -> List[Diagnostic]:
    """Run every analysis over one analyzed (and possibly optimized) MIR
    module; returns diagnostics sorted most-severe-first."""
    diags: List[Diagnostic] = []
    race_diags, _ = race_analysis(module)
    diags += race_diags
    tier, explanation = certificate_info(module)
    diags.append(make("GT201", f"determinism certificate: {explanation}"))
    diags.append(incremental_diagnostic(module))
    diags += uninit_and_dead_analysis(module)
    diags += termination_analysis(module)
    if shape is not None:
        diags += shape_analysis(module, shape)
    return sorted(diags, key=lambda d: d.sort_key)
