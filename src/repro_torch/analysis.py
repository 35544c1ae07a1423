"""Scatter-write race analysis over analyzed MIR modules.

A trimmed copy of the reference package's ``analysis/analyses.py`` (the
race analysis, ``needs_shuffle`` and the determinism certificate) with
the two pieces of ``analysis/diagnostics.py`` it needs. The engine
consults :func:`needs_shuffle` to force the shuffle commit on for
programs whose plain ``=`` scatter writes race (GT101): only the shuffle
path's deterministic last-write-wins commit gives them a defined result.
Accelerator reports and artifact manifests carry
:func:`determinism_certificate`.

Nothing here mutates the module or its canonical serialization.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Set, Tuple

from .core import fir, mir
from .core.semantic import _index_pattern

_SCATTERED = (mir.IndexPattern.DST, mir.IndexPattern.NEIGHBOR,
              mir.IndexPattern.OTHER)

# determinism certificate tiers (the reference's strings)
DETERMINISTIC = "deterministic"
REDUCTION_DETERMINISTIC = "reduction-deterministic"
RACY = "racy"

#: code -> severity of the two race diagnostics this module emits
CODES: Dict[str, str] = {"GT101": "error", "GT102": "error"}


@dataclass(frozen=True)
class Diagnostic:
    """One race finding (same fields as the reference's Diagnostic)."""

    code: str
    severity: str
    message: str
    kernel: Optional[str] = None
    prop: Optional[str] = None
    line: int = 0
    col: int = 0


def make(code: str, message: str, *, kernel: Optional[str] = None,
         prop: Optional[str] = None, line: int = 0, col: int = 0) -> Diagnostic:
    """Build a Diagnostic with the severity registered for its code."""
    if code not in CODES:
        raise ValueError(f"unknown diagnostic code {code!r}")
    return Diagnostic(code=code, severity=CODES[code], message=message,
                      kernel=kernel, prop=prop, line=line, col=col)


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
    return k.kind is mir.KernelKind.EDGE and pattern in (
        mir.IndexPattern.SRC, mir.IndexPattern.CONST)


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
            # kernel params vary per edge relative to the target slot;
            # locals and loop vars are conservatively varying too
            uniform = False
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
    """GT101/GT102 plus the float-reduction property set.

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
