"""MIR optimization pass pipeline (between semantic analysis and lowering).

The FPGA frameworks Graphitron is measured against (HitGraph, ThunderGP,
GraVF-M) bake one fixed hardware pipeline that every algorithm must fit.
Graphitron's claim is the inverse: algorithm-independent optimizations are
*derived per program* by the compiler. This module is that derivation
step — an ordered, introspectable pass manager running over the analyzed
:class:`~repro.core.mir.Module` before any kernel is lowered:

``fold``
    Host constant folding. Scalars bound at compile time via
    ``CompileOptions.scalar_bindings`` are substituted as literals into
    every kernel and host expression, then literal subexpressions are
    simplified (``(1.0 - 0.85)`` -> ``0.15``; ``if (false) ...`` bodies
    drop out entirely). Bound scalars stop being run-time parameters.

``dce``
    Dead property / scalar elimination driven by the
    :class:`~repro.core.mir.MemoryPlan`: properties never accessed by any
    kernel or host statement lose their device buffer (channels are
    renumbered densely), scalars that nothing reads or writes disappear
    (write-only scalars stay — like write-only property buffers they are
    observable results, via ``EngineResult.host_env``), and kernels whose
    bodies folded away to nothing are deleted together with their launch
    statements.

``direction``
    Compile-time push/pull direction selection per edge kernel
    (:class:`~repro.core.mir.Direction`). Frontier guards over props that
    no kernel or host statement ever mutates are loop-invariant — the
    kernel is marked ``DENSE`` and the engine skips host-side frontier
    mask evaluation entirely (PageRank's ``deg[src] > 0``). Real dynamic
    frontiers are marked ``SPARSE`` and always attempt compaction. This
    replaces the engine's runtime-only fallback heuristic with a
    compile-time verdict.

``fuse``
    Kernel fusion. Maximal runs of launch statements with no intervening
    host dependency are grouped: adjacent vertex kernels with the same
    index pattern merge into one body (one lane sweep), and an edge kernel
    followed by the vertex apply over its scatter target becomes a
    :class:`~repro.core.mir.PipelineKernel` — the paper's Fig. 4 single
    pipeline, lowered as ONE jitted launch with stage-boundary commits.
    Edge kernels assigned ``SPARSE`` direction are never fused (fusing
    would forfeit frontier compaction), and a fusion group never extends
    from a vertex kernel into a following edge kernel.

Every transformation appends a line to ``Module.pass_report``; the report
is embedded in ``Module.describe()`` so golden tests pin exactly what the
pipeline did. ``CompileOptions.passes`` selects the pipeline ("default",
"none", or a comma list) and participates in the Program content-hash
cache key, so pass ablations never alias cached artifacts.
"""
from __future__ import annotations

import copy
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Set, Tuple

from . import fir, mir, semantic


class PassError(Exception):
    """Raised for invalid pass lists or unusable compile-time bindings."""


DEFAULT_PASSES: Tuple[str, ...] = ("fold", "dce", "direction", "fuse")


def parse_pass_list(spec: str) -> Tuple[str, ...]:
    """Parse ``CompileOptions.passes`` into an ordered pass-name tuple."""
    spec = (spec or "").strip()
    if spec in ("none", ""):
        return ()
    if spec in ("default", "all"):
        return DEFAULT_PASSES
    names = tuple(s.strip() for s in spec.split(",") if s.strip())
    unknown = [n for n in names if n not in PASSES]
    if unknown:
        raise PassError(
            f"unknown pass(es) {unknown}; available: {sorted(PASSES)} "
            f"(or 'default' / 'none')"
        )
    return names


@dataclass
class PassContext:
    module: mir.Module
    options: "object"  # CompileOptions (kept untyped: no import cycle)
    changed_kernels: Set[str] = field(default_factory=set)

    def report(self, line: str) -> None:
        self.module.pass_report.append(line)


def run_pipeline(module: mir.Module, options) -> mir.Module:
    """Run the selected passes over a COPY of ``module`` (the analyzed
    base module is cached per-source across all option sets and must stay
    pristine). Returns the input unchanged when no pass is selected."""
    names = parse_pass_list(getattr(options, "passes", "none"))
    if tuple(getattr(options, "scalar_bindings", ()) or ()) and "fold" not in names:
        # silently ignoring a requested specialization would run the program
        # with the scalar's declared default — wrong results, no warning
        raise PassError(
            "CompileOptions.scalar_bindings requires the 'fold' pass, but "
            f"passes={getattr(options, 'passes', None)!r} does not select it"
        )
    if not names:
        return module
    module = copy.deepcopy(module)
    ctx = PassContext(module=module, options=options)
    for name in names:
        PASSES[name](ctx)
        # body-mutating passes invalidate the Property Detector results
        for kname in sorted(ctx.changed_kernels):
            kern = module.kernels.get(kname)
            if kern is not None and isinstance(kern, mir.Kernel):
                semantic.reanalyze_kernel(kern, module)
        ctx.changed_kernels.clear()
    return module


# ---------------------------------------------------------------------------
# FIR walking / rewriting utilities
# ---------------------------------------------------------------------------


def _map_expr(e: Optional[fir.Expr], fn: Callable) -> Optional[fir.Expr]:
    """Bottom-up expression rewrite: children first, then ``fn`` on the node."""
    if e is None:
        return None
    if isinstance(e, fir.BinOp):
        e.lhs = _map_expr(e.lhs, fn)
        e.rhs = _map_expr(e.rhs, fn)
    elif isinstance(e, fir.UnaryOp):
        e.operand = _map_expr(e.operand, fn)
    elif isinstance(e, fir.Index):
        e.base = _map_expr(e.base, fn)
        e.index = _map_expr(e.index, fn)
    elif isinstance(e, fir.Call):
        e.args = [_map_expr(a, fn) for a in e.args]
    elif isinstance(e, fir.MethodCall):
        e.obj = _map_expr(e.obj, fn)
        e.args = [_map_expr(a, fn) for a in e.args]
    return fn(e)


def _map_stmts(stmts: List[fir.Stmt], fn: Callable) -> None:
    """Apply ``fn`` (via :func:`_map_expr`) to every expression position."""
    for st in stmts:
        if isinstance(st, fir.VarDecl):
            st.init = _map_expr(st.init, fn)
        elif isinstance(st, fir.Assign):
            st.target = _map_expr(st.target, fn)
            st.value = _map_expr(st.value, fn)
        elif isinstance(st, fir.ReduceAssign):
            st.target = _map_expr(st.target, fn)
            st.value = _map_expr(st.value, fn)
        elif isinstance(st, fir.If):
            st.cond = _map_expr(st.cond, fn)
            _map_stmts(st.then_body, fn)
            _map_stmts(st.else_body, fn)
        elif isinstance(st, fir.While):
            st.cond = _map_expr(st.cond, fn)
            _map_stmts(st.body, fn)
        elif isinstance(st, fir.For):
            st.iter = _map_expr(st.iter, fn)
            _map_stmts(st.body, fn)
        elif isinstance(st, fir.ExprStmt):
            st.expr = _map_expr(st.expr, fn)


def _walk_exprs(stmts: List[fir.Stmt], fn: Callable) -> None:
    """Read-only visit of every expression (fn receives each node once)."""

    def visit(e):
        fn(e)
        return e

    _map_stmts(stmts, visit)


def _visit_expr(e: Optional[fir.Expr], fn: Callable) -> None:
    """Read-only visit of one expression tree."""

    def visit(x):
        fn(x)
        return x

    _map_expr(e, visit)


def _host_scalar_reads(module: mir.Module) -> Set[str]:
    """Host scalars whose VALUE is observed somewhere in host code.

    A plain-assignment target (``wonly = 5``) is a write, not a read —
    only the value side counts. A reduce-assignment target (``level += 1``)
    reads its current value, and an indexed target (``P[root] = 1``)
    reads whatever its index expression references.
    """
    reads: Set[str] = set()

    def note(e):
        if isinstance(e, fir.Ident) and e.name in module.scalars:
            reads.add(e.name)

    def scan(body: List[fir.Stmt]):
        for st in body:
            if isinstance(st, fir.Assign):
                if isinstance(st.target, fir.Index):
                    _visit_expr(st.target.index, note)
                _visit_expr(st.value, note)
            elif isinstance(st, fir.ReduceAssign):
                _visit_expr(st.target, note)
                _visit_expr(st.value, note)
            elif isinstance(st, fir.VarDecl):
                _visit_expr(st.init, note)
            elif isinstance(st, fir.If):
                _visit_expr(st.cond, note)
                scan(st.then_body)
                scan(st.else_body)
            elif isinstance(st, (fir.While, fir.For)):
                if isinstance(st, fir.While):
                    _visit_expr(st.cond, note)
                else:
                    _visit_expr(st.iter, note)
                scan(st.body)
            elif isinstance(st, fir.ExprStmt):
                _visit_expr(st.expr, note)

    for block in _host_blocks(module):
        scan(block)
    return reads


def _host_blocks(module: mir.Module) -> List[List[fir.Stmt]]:
    blocks = [module.host.main.body]
    blocks += [f.body for f in module.host.host_funcs.values()]
    return blocks


_LIT = (fir.IntLit, fir.FloatLit, fir.BoolLit)


def _lit_value(e: fir.Expr):
    return e.value


def _make_lit(value, line: int) -> fir.Expr:
    if isinstance(value, bool):
        return fir.BoolLit(line=line, value=value)
    if isinstance(value, int):
        return fir.IntLit(line=line, value=value)
    if isinstance(value, float):
        return fir.FloatLit(line=line, value=value)
    raise PassError(f"cannot fold value of type {type(value).__name__}")


_INT32_MIN, _INT32_MAX = -(2**31), 2**31 - 1


def _fold_arith(a, b, op: str):
    """Fold one arithmetic op with DEVICE semantics, or return None.

    Device kernels evaluate int literals as int32 and float literals as
    float32, so folds involving a float are computed in numpy float32 —
    the folded literal is bit-identical to what the lowered kernel would
    compute from its literal operands. Integer folds that leave the int32
    range are refused (the device would wrap; the host would not).
    """
    import numpy as np

    if isinstance(a, float) or isinstance(b, float):
        f32 = {"+": np.add, "-": np.subtract, "*": np.multiply,
               "/": np.divide}[op]
        with np.errstate(all="ignore"):
            return float(f32(np.float32(a), np.float32(b)))
    if op == "/":
        return None  # int/int true division: leave to the device
    res = {"+": a + b, "-": a - b, "*": a * b}[op]
    if not (_INT32_MIN <= res <= _INT32_MAX):
        return None
    return res


def _fold_node(e: fir.Expr) -> fir.Expr:
    """Fold one expression node whose children are already folded."""
    if isinstance(e, fir.UnaryOp) and isinstance(e.operand, _LIT):
        v = _lit_value(e.operand)
        return _make_lit((not v) if e.op == "!" else -v, e.line)
    if isinstance(e, fir.BinOp) and isinstance(e.lhs, _LIT) and isinstance(e.rhs, _LIT):
        a, b = _lit_value(e.lhs), _lit_value(e.rhs)
        try:
            if e.op in ("+", "-", "*", "/"):
                res = _fold_arith(a, b, e.op)
                return e if res is None else _make_lit(res, e.line)
            if e.op in ("==", "!=", "<", "<=", ">", ">="):
                if isinstance(a, float) or isinstance(b, float):
                    # compare with DEVICE semantics (float32 promotion),
                    # exactly like _fold_arith: a float64 comparison could
                    # disagree with the lowered kernel and delete a branch
                    # the device would take
                    import numpy as np

                    a, b = np.float32(a), np.float32(b)
                res = {
                    "==": a == b, "!=": a != b, "<": a < b,
                    "<=": a <= b, ">": a > b, ">=": a >= b,
                }[e.op]
                return _make_lit(bool(res), e.line)
            if e.op == "&":
                return _make_lit(bool(a) and bool(b), e.line)
            if e.op == "|":
                return _make_lit(bool(a) or bool(b), e.line)
        except (ZeroDivisionError, OverflowError):
            return e
    return e


def _simplify_static_ifs(stmts: List[fir.Stmt]) -> Tuple[List[fir.Stmt], int]:
    """Replace ``if (true/false)`` with the taken branch, recursively."""
    out: List[fir.Stmt] = []
    n = 0
    for st in stmts:
        if isinstance(st, fir.If):
            st.then_body, a = _simplify_static_ifs(st.then_body)
            st.else_body, b = _simplify_static_ifs(st.else_body)
            n += a + b
            if isinstance(st.cond, fir.BoolLit):
                out.extend(st.then_body if st.cond.value else st.else_body)
                n += 1
                continue
        elif isinstance(st, (fir.While, fir.For)):
            st.body, a = _simplify_static_ifs(st.body)
            n += a
        out.append(st)
    return out, n


def _collect_local_names(stmts: List[fir.Stmt]) -> Set[str]:
    names: Set[str] = set()
    for st in stmts:
        if isinstance(st, fir.VarDecl):
            names.add(st.name)
        elif isinstance(st, fir.If):
            names |= _collect_local_names(st.then_body)
            names |= _collect_local_names(st.else_body)
        elif isinstance(st, (fir.While, fir.For)):
            if isinstance(st, fir.For):
                names.add(st.var)
            names |= _collect_local_names(st.body)
    return names


def _rename_idents(stmts: List[fir.Stmt], mapping: Dict[str, str]) -> None:
    """Alpha-rename identifiers (params / locals / loop vars) in-place."""

    def sub(e):
        if isinstance(e, fir.Ident) and e.name in mapping:
            e.name = mapping[e.name]
        return e

    def walk(body: List[fir.Stmt]):
        for st in body:
            if isinstance(st, fir.VarDecl) and st.name in mapping:
                st.name = mapping[st.name]
            elif isinstance(st, fir.For) and st.var in mapping:
                st.var = mapping[st.var]
            if isinstance(st, fir.If):
                walk(st.then_body)
                walk(st.else_body)
            elif isinstance(st, (fir.While, fir.For)):
                walk(st.body)

    walk(stmts)
    _map_stmts(stmts, sub)


# ---------------------------------------------------------------------------
# pass: fold — compile-time scalar binding + literal simplification
# ---------------------------------------------------------------------------


def _host_written_names(module: mir.Module) -> Set[str]:
    """Identifiers and property names written by host statements."""
    written: Set[str] = set()

    def scan(body: List[fir.Stmt]):
        for st in body:
            if isinstance(st, (fir.Assign, fir.ReduceAssign)):
                tgt = st.target
                if isinstance(tgt, fir.Ident):
                    written.add(tgt.name)
                elif isinstance(tgt, fir.Index) and isinstance(tgt.base, fir.Ident):
                    written.add(tgt.base.name)
            elif isinstance(st, fir.If):
                scan(st.then_body)
                scan(st.else_body)
            elif isinstance(st, (fir.While, fir.For)):
                scan(st.body)
            elif isinstance(st, fir.ExprStmt):
                e = st.expr
                if isinstance(e, fir.Call) and e.func == "swap":
                    for a in e.args:
                        if isinstance(a, fir.Ident):
                            written.add(a.name)

    for block in _host_blocks(module):
        scan(block)
    return written


_COERCE = {"int": int, "float": float, "bool": bool}


def pass_fold(ctx: PassContext) -> None:
    module = ctx.module
    bindings = tuple(getattr(ctx.options, "scalar_bindings", ()) or ())
    host_written = _host_written_names(module)

    subs: Dict[str, fir.Expr] = {}
    for name, value in bindings:
        info = module.scalars.get(name)
        if info is None:
            raise PassError(
                f"scalar_bindings names {name!r}, which is not a declared "
                f"host scalar (have: {sorted(module.scalars)})"
            )
        if name in host_written:
            raise PassError(
                f"cannot bind scalar {name!r} at compile time: the host "
                f"program assigns it"
            )
        subs[name] = _make_lit(_COERCE[info.scalar](value), 0)

    def substitute(e):
        if isinstance(e, fir.Ident) and e.name in subs:
            return copy.deepcopy(subs[e.name])
        return e

    folds = 0

    def fold(e):
        nonlocal folds
        new = _fold_node(e)
        if new is not e:
            folds += 1
        return new

    for name, kern in list(module.kernels.items()):
        if not isinstance(kern, mir.Kernel):
            continue
        before = folds
        if subs:
            _map_stmts(kern.func.body, substitute)
        _map_stmts(kern.func.body, fold)
        kern.func.body, n_ifs = _simplify_static_ifs(kern.func.body)
        if subs or folds > before or n_ifs:
            ctx.changed_kernels.add(name)
    # Host code gets SUBSTITUTION only, never arithmetic folding: the host
    # interpreter evaluates in Python float64, so folding with the device's
    # float32 semantics could change host control flow. Substituting a
    # bound scalar's (exact) value is semantics-preserving; folding is not.
    if subs:
        for block in _host_blocks(module):
            _map_stmts(block, substitute)
        # surviving scalars may reference a bound scalar in their
        # initializer (evaluated by the engine at construction time)
        for info in module.scalars.values():
            if info.name not in subs:
                info.init = _map_expr(info.init, substitute)

    for name in subs:
        del module.scalars[name]
        ctx.report(f"fold: bound scalar {name} = {_lit_value(subs[name])} "
                   f"(removed from run-time parameters)")
    if folds:
        ctx.report(f"fold: simplified {folds} constant expression(s)")


# ---------------------------------------------------------------------------
# pass: dce — dead property / scalar / kernel elimination
# ---------------------------------------------------------------------------


def _kernel_body_is_empty(kern: mir.Kernel) -> bool:
    def empty(stmts: List[fir.Stmt]) -> bool:
        for st in stmts:
            if isinstance(st, fir.If):
                if not (empty(st.then_body) and empty(st.else_body)):
                    return False
            else:
                return False
        return True

    return empty(kern.func.body)


def _strip_launches(module: mir.Module, names: Set[str]) -> int:
    """Remove host launch statements of the given kernels."""
    removed = 0

    def scan(body: List[fir.Stmt]) -> List[fir.Stmt]:
        nonlocal removed
        out = []
        for st in body:
            k = _launch_target(module, st)
            if k is not None and k[0] in names:
                removed += 1
                continue
            if isinstance(st, fir.If):
                st.then_body = scan(st.then_body)
                st.else_body = scan(st.else_body)
            elif isinstance(st, (fir.While, fir.For)):
                st.body = scan(st.body)
            out.append(st)
        return out

    module.host.main.body = scan(module.host.main.body)
    for f in module.host.host_funcs.values():
        f.body = scan(f.body)
    return removed


def pass_dce(ctx: PassContext) -> None:
    module = ctx.module

    for _round in range(8):
        changed = False

        # -- dead kernels: bodies that folded away to nothing --------------
        dead_kernels = {
            n for n, k in module.kernels.items()
            if isinstance(k, mir.Kernel) and _kernel_body_is_empty(k)
        }
        if dead_kernels:
            _strip_launches(module, dead_kernels)
            for n in sorted(dead_kernels):
                del module.kernels[n]
                ctx.report(f"dce: removed kernel {n} (body folded to nothing)")
            changed = True

        # -- property / scalar use census ----------------------------------
        used_props: Set[str] = set()
        read_scalars: Set[str] = set()
        for kern in module.kernels.values():
            if not isinstance(kern, mir.Kernel):
                continue
            used_props |= {r.prop for r in kern.reads}
            used_props |= {w.prop for w in kern.writes}
            read_scalars |= kern.scalar_reads

        # property uses: ANY host mention keeps a buffer alive — including
        # write targets (write-only properties are observable results) and
        # bare idents (`swap(a, b)`)
        def host_prop_visit(e):
            if (isinstance(e, fir.Index) and isinstance(e.base, fir.Ident)
                    and e.base.name in module.properties):
                used_props.add(e.base.name)
            if isinstance(e, fir.Ident) and e.name in module.properties:
                used_props.add(e.name)

        for block in _host_blocks(module):
            _walk_exprs(block, host_prop_visit)
        # scalar uses: genuine reads in host code, reads from other
        # scalars' initializer expressions (evaluated by the engine at
        # construction), and host writes — a write-only scalar is still an
        # observable result via EngineResult.host_env, exactly like a
        # write-only property buffer
        read_scalars |= _host_scalar_reads(module)
        for info in module.scalars.values():
            _visit_expr(
                info.init,
                lambda e: read_scalars.add(e.name)
                if isinstance(e, fir.Ident) and e.name in module.scalars
                else None,
            )
        read_scalars |= {
            n for n in _host_written_names(module) if n in module.scalars
        }

        # -- never-accessed properties lose their device buffer ------------
        for name in sorted(set(module.properties) - used_props):
            del module.properties[name]
            module.degree_props.pop(name, None)
            ctx.report(f"dce: removed property {name} (never accessed; "
                       f"buffer freed)")
            changed = True

        # -- scalars never accessed at all disappear -----------------------
        dead_scalars = set(module.scalars) - read_scalars
        if dead_scalars:
            for name in sorted(dead_scalars):
                del module.scalars[name]
                ctx.report(f"dce: removed scalar {name} (never accessed)")
            changed = True

        if not changed:
            break

    # -- rebuild the memory plan with dense channel numbering --------------
    old_n = len(module.memory.buffers)
    module.memory = mir.MemoryPlan()
    for p in module.properties.values():
        module.memory.add(p)
    if len(module.memory.buffers) != old_n:
        ctx.report(
            f"dce: memory plan now {len(module.memory.buffers)} buffer(s) "
            f"(was {old_n}); channels renumbered"
        )


# ---------------------------------------------------------------------------
# pass: direction — compile-time push/pull selection per edge kernel
# ---------------------------------------------------------------------------


def pass_direction(ctx: PassContext) -> None:
    module = ctx.module
    mutated: Set[str] = set(_host_written_names(module))
    for kern in module.kernels.values():
        if isinstance(kern, mir.Kernel):
            mutated |= {w.prop for w in kern.writes}
            if kern.writes_weight:
                mutated.add("__weight__")

    compact = getattr(ctx.options, "compact_frontier", True)
    for name, kern in module.kernels.items():
        if not isinstance(kern, mir.Kernel) or kern.kind is not mir.KernelKind.EDGE:
            continue
        if not compact:
            kern.direction = mir.Direction.DENSE
            ctx.report(f"direction: {name} -> dense (frontier compaction disabled)")
        elif kern.frontier is None:
            kern.direction = mir.Direction.DENSE
            ctx.report(f"direction: {name} -> dense (no frontier guard)")
        elif not (kern.frontier.props & mutated):
            kern.direction = mir.Direction.DENSE
            ctx.report(
                f"direction: {name} -> dense (loop-invariant guard on "
                f"{sorted(kern.frontier.props)})"
            )
        else:
            kern.direction = mir.Direction.SPARSE
            ctx.report(
                f"direction: {name} -> sparse (dynamic frontier on "
                f"{sorted(kern.frontier.props)})"
            )


# ---------------------------------------------------------------------------
# pass: fuse — kernel fusion over adjacent launches
# ---------------------------------------------------------------------------


def _launch_target(module: mir.Module, st: fir.Stmt) -> Optional[Tuple[str, str]]:
    """Return (kernel name, launch object name) if ``st`` is a device
    kernel launch (``obj.init(f)`` / ``obj.process(f)``), else None."""
    if not isinstance(st, fir.ExprStmt):
        return None
    e = st.expr
    if not (isinstance(e, fir.MethodCall) and e.method in ("init", "process")):
        return None
    if len(e.args) != 1 or not isinstance(e.args[0], fir.Ident):
        return None
    kname = e.args[0].name
    if kname not in module.kernels:
        return None
    obj = e.obj.name if isinstance(e.obj, fir.Ident) else ""
    return kname, obj


def _fusion_eligible(kern) -> bool:
    if isinstance(kern, mir.PipelineKernel):
        return False
    if kern.kind is mir.KernelKind.VERTEX:
        return True
    if kern.kind is mir.KernelKind.EDGE:
        # SPARSE/AUTO edge kernels keep their standalone launch so the
        # engine can frontier-compact them (fusing forfeits compaction)
        return kern.direction is mir.Direction.DENSE
    return False


def _can_extend_group(group: List[mir.Kernel], nxt: mir.Kernel) -> bool:
    if not _fusion_eligible(nxt):
        return False
    if nxt.kind is mir.KernelKind.EDGE and not any(
        k.kind is mir.KernelKind.EDGE for k in group
    ):
        # a group may only contain an edge kernel if it STARTS with one:
        # the Fig. 4 pipeline shape is edge traversal -> vertex apply,
        # never vertex init -> edge traversal
        return False
    return True


def _touched_props(kern: mir.Kernel) -> Set[str]:
    return {r.prop for r in kern.reads} | {w.prop for w in kern.writes}


def _merge_safe(stages: List[mir.Kernel]) -> bool:
    """True when concatenating the bodies into ONE lane sweep is
    observationally identical to launching the stages in sequence: no
    earlier stage's scattered/accumulator write may be observed (read OR
    overwritten) by a later stage, because scattered writes commit at
    kernel exit while sequential (burst) writes chain lane-locally."""
    if any(k.kind is not mir.KernelKind.VERTEX for k in stages):
        return False
    if any(k.has_neighbor_loop for k in stages):
        return False
    for i, a in enumerate(stages):
        deferred = a.scatter_props | a.accumulators
        for b in stages[i + 1:]:
            if deferred & _touched_props(b):
                return False
    return True


def _build_merged_kernel(
    module: mir.Module, name: str, stages: List[mir.Kernel]
) -> mir.Kernel:
    canon = stages[0].vertex_param
    taken = set(module.properties) | set(module.scalars) | {canon}
    body: List[fir.Stmt] = []
    for i, st_kern in enumerate(stages):
        stage_body = copy.deepcopy(st_kern.func.body)
        mapping: Dict[str, str] = {}
        if st_kern.vertex_param != canon:
            mapping[st_kern.vertex_param] = canon
        for local in sorted(_collect_local_names(stage_body)):
            fresh = f"{local}__s{i}"
            while fresh in taken:
                fresh += "_"
            mapping[local] = fresh
            taken.add(fresh)
        if mapping:
            _rename_idents(stage_body, mapping)
        body.extend(stage_body)
    func = fir.FuncDecl(
        name=name,
        params=[copy.deepcopy(stages[0].func.params[0])],
        body=body,
    )
    kern = mir.Kernel(name, mir.KernelKind.VERTEX, func, vertex_param=canon)
    semantic.reanalyze_kernel(kern, module)
    return kern


def pass_fuse(ctx: PassContext) -> None:
    module = ctx.module
    by_stages: Dict[Tuple[str, ...], str] = {}

    def fused_name(names: Tuple[str, ...]) -> str:
        base = "__".join(names)
        while base in module.kernels:
            base += "_"
        return base

    def materialize(names: Tuple[str, ...]) -> str:
        if names in by_stages:
            return by_stages[names]
        stages = [module.kernels[n] for n in names]
        name = fused_name(names)
        if _merge_safe(stages):
            module.kernels[name] = _build_merged_kernel(module, name, stages)
            how = "merged vertex kernel"
        else:
            module.kernels[name] = mir.PipelineKernel(name=name, stages=stages)
            kinds = [s.kind.value for s in stages]
            how = f"pipeline [{' -> '.join(kinds)}]"
        module.fusion_groups[name] = names
        by_stages[names] = name
        ctx.report(f"fuse: {' + '.join(names)} -> {name} ({how})")
        return name

    def rewrite(body: List[fir.Stmt]) -> List[fir.Stmt]:
        out: List[fir.Stmt] = []
        i = 0
        while i < len(body):
            st = body[i]
            tgt = _launch_target(module, st)
            if tgt is None:
                if isinstance(st, fir.If):
                    st.then_body = rewrite(st.then_body)
                    st.else_body = rewrite(st.else_body)
                elif isinstance(st, (fir.While, fir.For)):
                    st.body = rewrite(st.body)
                out.append(st)
                i += 1
                continue
            # collect the maximal fusable group starting here
            kname, obj = tgt
            group = [module.kernels[kname]]
            names = [kname]
            j = i + 1
            if _fusion_eligible(group[0]):
                while j < len(body):
                    nxt = _launch_target(module, body[j])
                    if nxt is None:
                        break
                    nk = module.kernels[nxt[0]]
                    if not _can_extend_group(group, nk):
                        break
                    group.append(nk)
                    names.append(nxt[0])
                    j += 1
            if len(group) >= 2:
                new = materialize(tuple(names))
                out.append(
                    fir.ExprStmt(
                        line=st.line,
                        expr=fir.MethodCall(
                            line=st.line,
                            obj=fir.Ident(line=st.line, name=obj),
                            method="process",
                            args=[fir.Ident(line=st.line, name=new)],
                        ),
                    )
                )
                i = j
            else:
                out.append(st)
                i += 1
        return out

    module.host.main.body = rewrite(module.host.main.body)
    for f in module.host.host_funcs.values():
        f.body = rewrite(f.body)


PASSES: Dict[str, Callable[[PassContext], None]] = {
    "fold": pass_fold,
    "dce": pass_dce,
    "direction": pass_direction,
    "fuse": pass_fuse,
}


# ---------------------------------------------------------------------------
# incremental-recomputation analysis (streaming path; not in PASSES)
# ---------------------------------------------------------------------------
# Unlike the rewriting passes above, this analysis never mutates the module
# and never contributes to its canonical serialization — program
# fingerprints, cache identities and saved artifacts are untouched. It is
# computed lazily by repro.streaming when the first delta arrives.


def _iter_all_stmts(stmts: List[fir.Stmt]):
    """Yield every statement, descending into nested bodies."""
    for st in stmts:
        yield st
        if isinstance(st, fir.If):
            yield from _iter_all_stmts(st.then_body)
            yield from _iter_all_stmts(st.else_body)
        elif isinstance(st, (fir.While, fir.For)):
            yield from _iter_all_stmts(st.body)


def _prop_index(module: mir.Module, e) -> Optional[Tuple[str, fir.Expr]]:
    """(property name, index expr) when ``e`` is ``P[i]`` for a property."""
    if (isinstance(e, fir.Index) and isinstance(e.base, fir.Ident)
            and e.base.name in module.properties):
        return e.base.name, e.index
    return None


def _ident_name(e) -> Optional[str]:
    return e.name if isinstance(e, fir.Ident) else None


def _const_int(module: mir.Module, e) -> Optional[int]:
    """Fold an expression to a compile-time int (literals, const scalars)."""
    if isinstance(e, fir.IntLit):
        return int(e.value)
    if isinstance(e, fir.UnaryOp) and e.op == "-":
        v = _const_int(module, e.operand)
        return None if v is None else -v
    if isinstance(e, fir.Ident) and e.name in module.scalars:
        init = module.scalars[e.name].init
        return None if init is None else _const_int(module, init)
    return None


def _vertex_init_literal(module: mir.Module,
                         vertex_kernels: List[mir.Kernel],
                         prop: str) -> Optional[int]:
    """The constant a vertex kernel initializes ``prop[v]`` to, if any."""
    for k in vertex_kernels:
        for st in _iter_all_stmts(k.func.body):
            if not isinstance(st, fir.Assign):
                continue
            tgt = _prop_index(module, st.target)
            if tgt and tgt[0] == prop and _ident_name(tgt[1]) == k.vertex_param:
                v = _const_int(module, st.value)
                if v is not None:
                    return v
    return None


def _copy_source(module: mir.Module, vertex_kernels: List[mir.Kernel],
                 dst_prop: str) -> Optional[str]:
    """Find M such that some vertex kernel runs ``dst_prop[v] = M[v]``."""
    for k in vertex_kernels:
        for st in _iter_all_stmts(k.func.body):
            if not isinstance(st, fir.Assign):
                continue
            tgt = _prop_index(module, st.target)
            if not (tgt and tgt[0] == dst_prop
                    and _ident_name(tgt[1]) == k.vertex_param):
                continue
            val = _prop_index(module, st.value)
            if val and _ident_name(val[1]) == k.vertex_param:
                return val[0]
    return None


def _has_vertex_copy(module: mir.Module, vertex_kernels: List[mir.Kernel],
                     dst_prop: str, src_prop: str) -> bool:
    return _copy_source(module, vertex_kernels, dst_prop) == src_prop or any(
        _copy_source(module, [k], dst_prop) == src_prop for k in vertex_kernels
    )


def _match_label(module: mir.Module, edge_kernels: List[mir.Kernel],
                 vertex_kernels: List[mir.Kernel]) -> Optional[mir.IncrementalTemplate]:
    """Connected-components shape: symmetric unguarded min-label exchange."""
    for k in edge_kernels:
        reduces = [s for s in _iter_all_stmts(k.func.body)
                   if isinstance(s, fir.ReduceAssign) and s.op == "min"]
        if len(reduces) != 2:
            continue
        pairs = []
        for s in reduces:
            tgt = _prop_index(module, s.target)
            val = _prop_index(module, s.value)
            if tgt is None or val is None:
                break
            pairs.append((tgt[0], _ident_name(tgt[1]), val[0], _ident_name(val[1])))
        if len(pairs) != 2:
            continue
        (p1, t1, q1, v1), (p2, t2, q2, v2) = pairs
        symmetric = (
            p1 == p2 and q1 == q2
            and {(t1, v1), (t2, v2)}
            == {(k.dst_param, k.src_param), (k.src_param, k.dst_param)}
        )
        if not symmetric:
            continue
        nxt, label = p1, q1  # next[dst] min= label[src] (and mirrored)
        # the apply step must fold improvements back (label := next) and the
        # labels must start as vertex ids — both are what make min-flood
        # repair converge to the same fixpoint as a from-scratch run
        if not _has_vertex_copy(module, vertex_kernels, label, nxt):
            continue
        ids_init = any(
            isinstance(st, fir.Assign)
            and (tgt := _prop_index(module, st.target)) is not None
            and tgt[0] == label and _ident_name(tgt[1]) == k2.vertex_param
            and _ident_name(st.value) == k2.vertex_param
            for k2 in vertex_kernels
            for st in _iter_all_stmts(k2.func.body)
        )
        if not ids_init:
            continue
        return mir.IncrementalTemplate(
            kind="label", dist_prop=label, mirror_props=(nxt,)
        )
    return None


def _match_distance(module: mir.Module, edge_kernels: List[mir.Kernel],
                    vertex_kernels: List[mir.Kernel]) -> Optional[mir.IncrementalTemplate]:
    """BFS / SSSP shapes: guarded ``T[dst] min= dist-ish + step`` relaxation."""
    for k in edge_kernels:
        for st in _iter_all_stmts(k.func.body):
            if not isinstance(st, fir.If):
                continue
            reduces = [s for s in st.then_body
                       if isinstance(s, fir.ReduceAssign) and s.op == "min"]
            if len(reduces) != 1:
                continue
            r = reduces[0]
            tgt = _prop_index(module, r.target)
            if not (tgt and _ident_name(tgt[1]) == k.dst_param):
                continue
            tuple_prop = tgt[0]
            val, cond = r.value, st.cond
            if not (isinstance(val, fir.BinOp) and val.op == "+"):
                continue
            if not (isinstance(cond, fir.BinOp) and cond.op == "=="):
                continue
            guard = _prop_index(module, cond.lhs)
            if not (guard and _ident_name(guard[1]) == k.src_param):
                continue
            # BFS family: `if dist[src] == level: T[dst] min= level + 1`
            rs = _ident_name(cond.rhs)
            if (rs is not None and rs in module.scalars
                    and _ident_name(val.lhs) == rs
                    and isinstance(val.rhs, fir.IntLit) and val.rhs.value == 1):
                dist = guard[0]
                sentinel = _vertex_init_literal(module, vertex_kernels, dist)
                mirror = _copy_source(module, vertex_kernels, dist)
                if sentinel is not None:
                    return mir.IncrementalTemplate(
                        kind="unit_distance", dist_prop=dist,
                        tuple_prop=tuple_prop,
                        mirror_props=(mirror,) if mirror else (),
                        unreached=sentinel, round_scalar=rs,
                    )
            # SSSP family: `if active[src] == 1: T[dst] min= D[src] + w`
            if (isinstance(cond.rhs, fir.IntLit) and cond.rhs.value == 1
                    and k.weight_param is not None
                    and _ident_name(val.rhs) == k.weight_param):
                dsrc = _prop_index(module, val.lhs)
                if not (dsrc and _ident_name(dsrc[1]) == k.src_param):
                    continue
                dist = dsrc[0]
                sentinel = _vertex_init_literal(module, vertex_kernels, dist)
                if sentinel is not None and _has_vertex_copy(
                        module, vertex_kernels, dist, tuple_prop):
                    return mir.IncrementalTemplate(
                        kind="weighted_distance", dist_prop=dist,
                        tuple_prop=tuple_prop, unreached=sentinel,
                    )
    return None


def analyze_incremental(module: mir.Module) -> mir.IncrementalInfo:
    """Monotonicity verdict + repair template for streaming re-convergence.

    A module is *monotone* when every per-edge write to a vertex property
    (SRC/DST/NEIGHBOR/OTHER patterns in edge kernels, scattered patterns in
    vertex kernels) is a ``min=``/``max=`` reduction — const-index
    accumulator cells (host control counters) and sequential vertex-apply
    writes are exempt. For such programs, adding edges can only tighten
    the fixpoint, so re-convergence may be seeded from the delta endpoints
    alone. Non-monotone programs (PageRank's ``+=`` mass flow, weight
    mutation, plain-assign scatters) get ``monotone=False`` and the
    streaming layer transparently falls back to full recompute.
    """
    scattered = (mir.IndexPattern.DST, mir.IndexPattern.NEIGHBOR,
                 mir.IndexPattern.OTHER)
    ops: Set[str] = set()
    reasons: List[str] = []
    monotone = True
    base = [k for k in module.kernels.values()
            if isinstance(k, mir.Kernel) and k.kind is not mir.KernelKind.HOST]
    for k in base:
        if k.writes_weight:
            monotone = False
            reasons.append(f"{k.name}: mutates edge weights")
        for w in k.writes:
            if w.pattern is mir.IndexPattern.CONST:
                continue  # accumulator cell: host control flow, not state
            per_edge = (w.pattern in scattered
                        or (k.kind is mir.KernelKind.EDGE
                            and w.pattern is mir.IndexPattern.SRC))
            if not per_edge:
                continue  # sequential vertex-apply write
            if w.reduce_op in ("min", "max"):
                ops.add(w.reduce_op)
            else:
                monotone = False
                reasons.append(
                    f"{k.name}: per-edge '{w.reduce_op or '='}' write to {w.prop}"
                )
    if not ops:
        monotone = False
        reasons.append("no min=/max= reduction to re-converge through")
    template = None
    if monotone:
        edge_kernels = [k for k in base if k.kind is mir.KernelKind.EDGE]
        vertex_kernels = [k for k in base if k.kind is mir.KernelKind.VERTEX]
        template = (_match_label(module, edge_kernels, vertex_kernels)
                    or _match_distance(module, edge_kernels, vertex_kernels))
    return mir.IncrementalInfo(
        monotone=monotone, reduce_ops=tuple(sorted(ops)),
        reasons=tuple(reasons), template=template,
    )
