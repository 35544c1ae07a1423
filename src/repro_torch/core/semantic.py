"""Middle-end semantic analysis: FIR -> MIR.

Performs (paper §III-B2):
* symbol-table construction and kernel classification,
* type/arity checking of known operators and builtins,
* the *Property Detector* (reads/writes, index patterns, reduce ops),
* memory planning (buffer per property, host/device placement),
* MIR transforms:
    - read-modify-write normalization (``P[0] = P[0] + x`` -> ``P[0] += x``),
      the unroll-with-reduce transform of §III-C2;
    - RAW decoupling detection (paper Fig. 5 -> Fig. 6): a property read on
      the gather side and reduce-written on the scatter side of one kernel
      is snapshot-decoupled;
    - frontier detection (the *Frontier Check* module of Fig. 4).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Set

from . import fir, mir

DEVICE_BUILTINS = {
    "exp": 1, "log": 1, "abs": 1, "sqrt": 1, "sigmoid": 1,
    "leakyrelu": 2, "min": 2, "max": 2, "floor": 1, "pow": 2,
    "to_float": 1, "to_int": 1, "original_id": 1,
}
HOST_BUILTINS = {"load": None, "swap": 2, "print": None, "argv": None}


class SemanticError(Exception):
    """Semantic error carrying the 1-based source ``line``/``col`` of the
    offending FIR node (the parser threads both through every node it
    builds). For programs built by the embedded front-end the line is the
    Python line number of the offending decorated-function statement and
    ``col`` is 0 (Python ASTs are lowered per-statement, not per-token)."""

    def __init__(self, msg: str, line: int = 0, col: int = 0):
        super().__init__(msg)
        self.line = line
        self.col = col


def _serr(msg: str, node) -> SemanticError:
    line = getattr(node, "line", 0) or 0
    col = getattr(node, "col", 0) or 0
    prefix = f"line {line}: " if line else ""
    return SemanticError(prefix + msg, line, col)


def _index_pattern(idx: fir.Expr, k: mir.Kernel, loop_vars: Set[str]) -> mir.IndexPattern:
    if isinstance(idx, fir.IntLit):
        return mir.IndexPattern.CONST
    if isinstance(idx, fir.Ident):
        if idx.name == k.vertex_param:
            return mir.IndexPattern.SELF
        if idx.name == k.src_param:
            return mir.IndexPattern.SRC
        if idx.name == k.dst_param:
            return mir.IndexPattern.DST
        if idx.name in loop_vars:
            return mir.IndexPattern.NEIGHBOR
    return mir.IndexPattern.OTHER


class Analyzer:
    def __init__(self, program: fir.Program):
        self.program = program
        self.module: Optional[mir.Module] = None

    # ------------------------------------------------------------------
    def analyze(self) -> mir.Module:
        prog = self.program
        elements = {e.name for e in prog.elements}
        graph: Optional[mir.GraphInfo] = None
        properties: Dict[str, mir.PropertyInfo] = {}
        scalars: Dict[str, mir.ScalarInfo] = {}
        degree_props: Dict[str, str] = {}
        vertexset_name: Optional[str] = None

        for c in prog.consts:
            t = c.type
            if isinstance(t, fir.EdgesetType):
                if t.element not in elements:
                    raise _serr(f"unknown element {t.element!r}", c)
                load_args: List[fir.Expr] = []
                if isinstance(c.init, fir.Call) and c.init.func == "load":
                    load_args = c.init.args
                graph = mir.GraphInfo(
                    edgeset_name=c.name,
                    vertexset_name=None,
                    weighted=t.weighted,
                    weight_scalar=t.weight,
                    load_args=load_args,
                )
            elif isinstance(t, fir.VertexsetType):
                vertexset_name = c.name
            elif isinstance(t, fir.VectorType):
                if t.element not in elements:
                    raise _serr(f"unknown element {t.element!r}", c)
                is_edge = t.element.lower().startswith("edge")
                properties[c.name] = mir.PropertyInfo(c.name, t.element, t.scalar, is_edge)
                if isinstance(c.init, fir.MethodCall) and c.init.method in (
                    "getOutDegrees",
                    "getInDegrees",
                ):
                    degree_props[c.name] = "out" if c.init.method == "getOutDegrees" else "in"
            elif isinstance(t, fir.ScalarType):
                scalars[c.name] = mir.ScalarInfo(c.name, t.kind, c.init)
            else:
                raise _serr(f"unsupported const type {t}", c)

        if graph is None:
            raise SemanticError("program declares no edgeset")
        graph.vertexset_name = vertexset_name

        module = mir.Module(
            program=prog,
            graph=graph,
            properties=properties,
            scalars=scalars,
            degree_props=degree_props,
        )
        for p in properties.values():
            module.memory.add(p)

        host_funcs: Dict[str, fir.FuncDecl] = {}
        main_func: Optional[fir.FuncDecl] = None
        for f in prog.funcs:
            kind, kernel = self._classify(f, elements, module)
            if kind is mir.KernelKind.HOST:
                if f.name == "main":
                    main_func = f
                else:
                    host_funcs[f.name] = f
            else:
                module.kernels[f.name] = kernel

        if main_func is None:
            raise SemanticError("program has no main()")
        module.host = mir.HostProgram(main=main_func, host_funcs=host_funcs)

        for k in module.kernels.values():
            self._normalize_rmw(k.func.body, module)
            self._detect_properties(k, module)
            self._detect_frontier(k, module)
            self._decouple_raw(k)
        return module

    # ------------------------------------------------------------------
    def _classify(self, f: fir.FuncDecl, elements: Set[str], module: mir.Module):
        ptypes = [p.type for p in f.params]

        def is_vertex(t) -> bool:
            return isinstance(t, fir.ElementType) and t.name in elements and \
                t.name.lower().startswith("vertex")

        if len(f.params) == 0:
            return mir.KernelKind.HOST, None
        if len(f.params) == 1 and is_vertex(ptypes[0]):
            k = mir.Kernel(f.name, mir.KernelKind.VERTEX, f, vertex_param=f.params[0].name)
            return mir.KernelKind.VERTEX, k
        if len(f.params) in (2, 3) and is_vertex(ptypes[0]) and is_vertex(ptypes[1]):
            wp = None
            if len(f.params) == 3:
                t2 = ptypes[2]
                if not (isinstance(t2, fir.ScalarType) and t2.kind in ("int", "float")):
                    raise _serr("edge weight param must be int/float", f)
                if not module.graph.weighted:
                    raise _serr(
                        f"weighted edge function {f.name!r} on an "
                        "unweighted edgeset", f
                    )
                wp = f.params[2].name
            k = mir.Kernel(
                f.name,
                mir.KernelKind.EDGE,
                f,
                src_param=f.params[0].name,
                dst_param=f.params[1].name,
                weight_param=wp,
            )
            return mir.KernelKind.EDGE, k
        raise _serr(
            f"cannot classify function {f.name!r} "
            f"(params must be (Vertex), (Vertex, Vertex[, int|float]), or ())", f
        )

    # ------------------------------------------------------------------
    def _normalize_rmw(self, body: List[fir.Stmt], module: mir.Module):
        """Rewrite ``P[i] = P[i] op x`` into ``P[i] op= x`` (§III-C2).

        This exposes the reduction so the back-end can lower it as a
        conflict-free parallel reduce instead of a serialized RMW.
        """

        def same_index(a: fir.Expr, b: fir.Expr) -> bool:
            if isinstance(a, fir.IntLit) and isinstance(b, fir.IntLit):
                return a.value == b.value
            if isinstance(a, fir.Ident) and isinstance(b, fir.Ident):
                return a.name == b.name
            return False

        for i, st in enumerate(body):
            if isinstance(st, fir.If):
                self._normalize_rmw(st.then_body, module)
                self._normalize_rmw(st.else_body, module)
            elif isinstance(st, (fir.While, fir.For)):
                self._normalize_rmw(st.body, module)
            elif isinstance(st, fir.Assign) and isinstance(st.target, fir.Index):
                tgt = st.target
                if not (isinstance(tgt.base, fir.Ident) and tgt.base.name in module.properties):
                    continue
                v = st.value
                if isinstance(v, fir.BinOp) and v.op in ("+", "*"):
                    for lhs, rhs in ((v.lhs, v.rhs), (v.rhs, v.lhs)):
                        if (
                            isinstance(lhs, fir.Index)
                            and isinstance(lhs.base, fir.Ident)
                            and lhs.base.name == tgt.base.name
                            and same_index(lhs.index, tgt.index)
                        ):
                            body[i] = fir.ReduceAssign(
                                line=st.line, col=st.col, target=tgt,
                                op=v.op, value=rhs,
                            )
                            break

    # ------------------------------------------------------------------
    def _detect_properties(self, k: mir.Kernel, module: mir.Module):
        """The Property Detector: collect every property access."""
        props = module.properties
        loop_vars: Set[str] = set()

        def walk_expr(e: fir.Expr):
            if e is None:
                return
            if isinstance(e, fir.Index) and isinstance(e.base, fir.Ident) and e.base.name in props:
                k.reads.append(
                    mir.PropAccess(e.base.name, _index_pattern(e.index, k, loop_vars))
                )
                walk_expr(e.index)
                return
            if isinstance(e, fir.Ident):
                if e.name in module.scalars:
                    k.scalar_reads.add(e.name)
                return
            if isinstance(e, fir.BinOp):
                walk_expr(e.lhs)
                walk_expr(e.rhs)
            elif isinstance(e, fir.UnaryOp):
                walk_expr(e.operand)
            elif isinstance(e, fir.Index):
                walk_expr(e.base)
                walk_expr(e.index)
            elif isinstance(e, fir.Call):
                if e.func in DEVICE_BUILTINS and DEVICE_BUILTINS[e.func] != len(e.args):
                    raise _serr(
                        f"builtin {e.func}() takes "
                        f"{DEVICE_BUILTINS[e.func]} args, got {len(e.args)}", e
                    )
                for a in e.args:
                    walk_expr(a)
            elif isinstance(e, fir.MethodCall):
                walk_expr(e.obj)
                for a in e.args:
                    walk_expr(a)

        def record_write(target: fir.Expr, op: Optional[str], st: fir.Stmt):
            if isinstance(target, fir.Index) and isinstance(target.base, fir.Ident):
                name = target.base.name
                if name in props:
                    pat = _index_pattern(target.index, k, loop_vars)
                    k.writes.append(mir.PropAccess(name, pat, op))
                    if pat is mir.IndexPattern.CONST:
                        k.accumulators.add(name)
                    walk_expr(target.index)
                    return
            if isinstance(target, fir.Ident):
                if target.name == k.weight_param:
                    k.writes_weight = True
                    return
                return  # local variable
            raise _serr("unsupported write target", st)

        def walk_stmts(body: List[fir.Stmt]):
            for st in body:
                if isinstance(st, fir.Assign):
                    record_write(st.target, None, st)
                    walk_expr(st.value)
                elif isinstance(st, fir.ReduceAssign):
                    record_write(st.target, st.op, st)
                    walk_expr(st.value)
                elif isinstance(st, fir.VarDecl):
                    walk_expr(st.init)
                elif isinstance(st, fir.If):
                    walk_expr(st.cond)
                    walk_stmts(st.then_body)
                    walk_stmts(st.else_body)
                elif isinstance(st, fir.For):
                    if (
                        isinstance(st.iter, fir.MethodCall)
                        and st.iter.method in ("getNeighbors", "getInNeighbors")
                    ):
                        k.has_neighbor_loop = True
                        loop_vars.add(st.var)
                        walk_stmts(st.body)
                        loop_vars.discard(st.var)
                    else:
                        raise _serr(
                            "device for-loops must iterate "
                            "v.getNeighbors()/v.getInNeighbors()", st
                        )
                elif isinstance(st, fir.While):
                    raise _serr("while loops are host-only constructs", st)
                elif isinstance(st, fir.ExprStmt):
                    walk_expr(st.expr)

        walk_stmts(k.func.body)

    # ------------------------------------------------------------------
    def _detect_frontier(self, k: mir.Kernel, module: mir.Module):
        """Frontier Check: single top-level guard reading gather-side props."""
        body = [s for s in k.func.body]
        if len(body) != 1 or not isinstance(body[0], fir.If) or body[0].else_body:
            return
        cond = body[0].cond
        props: Set[str] = set()
        ok = True

        def scan(e: fir.Expr):
            nonlocal ok
            if e is None or not ok:
                return
            if isinstance(e, fir.Index) and isinstance(e.base, fir.Ident) and \
                    e.base.name in module.properties:
                pat = _index_pattern(e.index, k, set())
                if pat in (mir.IndexPattern.SELF, mir.IndexPattern.SRC):
                    props.add(e.base.name)
                else:
                    ok = False
                return
            if isinstance(e, fir.BinOp):
                scan(e.lhs)
                scan(e.rhs)
            elif isinstance(e, fir.UnaryOp):
                scan(e.operand)
            elif isinstance(e, (fir.IntLit, fir.FloatLit, fir.BoolLit, fir.Ident)):
                return
            else:
                ok = False

        scan(cond)
        if ok and props:
            k.frontier = mir.FrontierInfo(cond=cond, props=props)

    # ------------------------------------------------------------------
    def _decouple_raw(self, k: mir.Kernel):
        """RAW decoupling (Fig. 5 -> Fig. 6): snapshot gather-side reads of
        properties that are also scatter-written in the same kernel."""
        gather_reads = {
            r.prop
            for r in k.reads
            if r.pattern in (mir.IndexPattern.SRC, mir.IndexPattern.SELF,
                             mir.IndexPattern.NEIGHBOR)
        }
        scatter_writes = {
            w.prop
            for w in k.writes
            if w.pattern in (mir.IndexPattern.DST, mir.IndexPattern.NEIGHBOR,
                             mir.IndexPattern.OTHER)
        }
        k.snapshot_props = gather_reads & scatter_writes


def analyze(program: fir.Program) -> mir.Module:
    return Analyzer(program).analyze()


def reanalyze_kernel(k: mir.Kernel, module: mir.Module) -> mir.Kernel:
    """Re-run the per-kernel detectors after a pass mutated the body.

    Optimization passes (``repro.core.passes``) rewrite kernel bodies —
    constant folding substitutes literals, dead-property elimination strips
    writes, fusion concatenates bodies. Afterwards the Property Detector
    results, frontier annotation, and RAW decoupling must be recomputed so
    the back-end lowers the *transformed* body, not stale metadata.
    """
    k.reads = []
    k.writes = []
    k.scalar_reads = set()
    k.accumulators = set()
    k.snapshot_props = set()
    k.frontier = None
    k.has_neighbor_loop = False
    k.writes_weight = False
    a = Analyzer(module.program)
    a._normalize_rmw(k.func.body, module)
    a._detect_properties(k, module)
    a._detect_frontier(k, module)
    a._decouple_raw(k)
    return k
