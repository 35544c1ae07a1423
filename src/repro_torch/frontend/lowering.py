"""Python-AST -> FIR lowering for the embedded front-end.

Decorated kernel/host functions are **never executed**: their source is
re-read (``inspect.getsourcelines``), parsed with :mod:`ast`, and each
statement is lowered into the same FIR dataclasses the ``.gt`` text
parser produces (:mod:`repro_torch.core.fir`). The supported surface is exactly
the text grammar's expression/statement set:

=====================================  =====================================
Python                                 Graphitron
=====================================  =====================================
``P[v] = e``                           ``P[v] = e;``
``P[dst] += e`` / ``-=`` / ``*=``      ``P[dst] += e;`` ...
``P[dst] = min(P[dst], e)``            ``P[dst] min= e;`` (same for max)
``if c: ... elif/else: ...``           ``if (c) ... else ... end``
``x: int = e``                         ``var x: int = e;``
``while c: ...`` (main only)           ``while (c) ... end``
``for n in v.getNeighbors(): ...``     ``for n in v.getNeighbors() ... end``
``a and b`` / ``a or b`` / ``not a``   ``a & b`` / ``a | b`` / ``!a``
``edges.process(k)`` etc.              ``edges.process(k);``
``to_float(x)``, ``exp(x)``, ...       the device builtins, verbatim
=====================================  =====================================

Anything outside that surface raises :class:`FrontendError` carrying the
**Python file and line number** of the offending construct — the embedded
analogue of the text parser's line/column diagnostics.

Name resolution: a ``Name`` is looked up as (1) a function parameter, (2)
a previously declared kernel-local / loop variable, (3) a handle or plain
``int``/``float``/``bool`` constant captured from the function's
globals/closure, (4) a declared symbol of the owning
:class:`~repro_torch.frontend.builder.GraphProgram` with the same name.
Handles lower to the *declared* DSL name (so ``tuple_`` in Python can
back a property named ``tuple``); captured Python number constants are
inlined as literals — host-language parameterization for free.
"""
from __future__ import annotations

import ast
import contextlib
import inspect
import textwrap
from typing import List, Optional, Sequence, Tuple

from ..core import fir
from ..core.semantic import DEVICE_BUILTINS, HOST_BUILTINS


class FrontendError(Exception):
    """Embedded front-end error, located at a Python ``filename:lineno``."""

    def __init__(self, msg: str, filename: Optional[str] = None,
                 lineno: Optional[int] = None):
        loc = ""
        if filename:
            loc = f"{filename}:{lineno}: " if lineno else f"{filename}: "
        super().__init__(loc + msg)
        self.filename = filename
        self.lineno = lineno


# pythonic aliases for the DSL's camelCase set/element methods
_METHOD_ALIASES = {
    "neighbors": "getNeighbors",
    "in_neighbors": "getInNeighbors",
    "out_degrees": "getOutDegrees",
    "in_degrees": "getInDegrees",
    "vertices": "getVertices",
}

_BIN_OPS = {
    ast.Add: "+", ast.Sub: "-", ast.Mult: "*", ast.Div: "/",
}
_CMP_OPS = {
    ast.Eq: "==", ast.NotEq: "!=", ast.Lt: "<", ast.LtE: "<=",
    ast.Gt: ">", ast.GtE: ">=",
}
_REDUCE_OPS = {ast.Add: "+", ast.Sub: "-", ast.Mult: "*"}

# names callable inside kernels/main even when not importable stubs
_CALLABLE_NAMES = set(DEVICE_BUILTINS) | set(HOST_BUILTINS) - {"argv"}


def function_ast(fn) -> Tuple[ast.FunctionDef, str]:
    """The FunctionDef node of ``fn`` with absolute (file) line numbers."""
    filename = fn.__code__.co_filename
    try:
        src_lines, start = inspect.getsourcelines(fn)
    except (OSError, TypeError) as e:
        raise FrontendError(
            "cannot read the source of the decorated function (source "
            "unavailable — e.g. defined in a REPL); embedded kernels must "
            "live in a real file",
            filename=filename,
        ) from e
    tree = ast.parse(textwrap.dedent("".join(src_lines)))
    ast.increment_lineno(tree, start - 1)
    fdef = tree.body[0]
    if not isinstance(fdef, ast.FunctionDef):
        raise FrontendError(
            "decorator target must be a plain `def` function",
            filename=filename, lineno=getattr(fdef, "lineno", None),
        )
    return fdef, filename


def capture_env(fn) -> dict:
    """The function's globals merged with its closure cells.

    This is the environment handle names resolve in. Python does *not*
    create closure cells for names the function only assigns (``level +=
    1`` makes ``level`` a local), so assigned-but-undeclared names fall
    back to the owning program's declared-symbol table by DSL name.
    """
    env = dict(fn.__globals__)
    if fn.__closure__:
        for name, cell in zip(fn.__code__.co_freevars, fn.__closure__):
            with contextlib.suppress(ValueError):  # still-empty cell
                env[name] = cell.cell_contents
    return env


class Lowerer:
    """Lower one decorated function body into a list of FIR statements."""

    def __init__(self, program, fn, fdef: ast.FunctionDef, filename: str,
                 params: Sequence[str]):
        self.program = program  # GraphProgram (late import avoids a cycle)
        self.fn = fn
        self.fdef = fdef
        self.filename = filename
        self.params = list(params)
        self.locals: set = set()
        self.env = capture_env(fn)

    # -- diagnostics --------------------------------------------------------
    def err(self, msg: str, node) -> FrontendError:
        return FrontendError(
            msg, filename=self.filename, lineno=getattr(node, "lineno", None)
        )

    # -- name resolution ----------------------------------------------------
    def _lookup(self, name: str):
        """A handle/constant for ``name``, or None for params/locals/misses."""
        if name in self.env:
            return self.env[name]
        sym = self.program.symbol(name)
        return sym

    def _check_owned(self, val, name: str, node):
        """Reject handles captured from a *different* GraphProgram: they
        would silently lower by DSL name into this program's namespace."""
        owner = getattr(val, "_program", None)
        if owner is not None and owner is not self.program:
            raise self.err(
                f"handle {name!r} belongs to GraphProgram {owner.name!r}, "
                f"not {self.program.name!r}: kernels can only reference "
                "handles declared on their own program", node,
            )

    def _name_to_ident(self, node: ast.Name) -> fir.Expr:
        from .builder import Handle  # deferred: builder imports this module

        name = node.id
        ln = node.lineno
        if name in self.params or name in self.locals:
            return fir.Ident(line=ln, name=name)
        val = self._lookup(name)
        if isinstance(val, Handle):
            self._check_owned(val, name, node)
            return fir.Ident(line=ln, name=val.name)
        if isinstance(val, bool):
            return fir.BoolLit(line=ln, value=val)
        if isinstance(val, int):
            return fir.IntLit(line=ln, value=val)
        if isinstance(val, float):
            return fir.FloatLit(line=ln, value=val)
        raise self.err(
            f"unknown name {name!r}: not a kernel parameter, a declared "
            f"local (`{name}: int = ...`), a program handle, or a captured "
            f"int/float/bool constant", node,
        )

    # -- expressions --------------------------------------------------------
    def lower_expr(self, e: ast.expr) -> fir.Expr:
        ln = getattr(e, "lineno", 0)
        if isinstance(e, ast.Constant):
            v = e.value
            if isinstance(v, bool):
                return fir.BoolLit(line=ln, value=v)
            if isinstance(v, int):
                return fir.IntLit(line=ln, value=v)
            if isinstance(v, float):
                return fir.FloatLit(line=ln, value=v)
            if isinstance(v, str):
                return fir.StrLit(line=ln, value=v)
            raise self.err(f"unsupported literal {v!r}", e)
        if isinstance(e, ast.Name):
            return self._name_to_ident(e)
        if isinstance(e, ast.BinOp):
            op = _BIN_OPS.get(type(e.op))
            if op is None:
                raise self.err(
                    f"unsupported operator {type(e.op).__name__}: the DSL "
                    "has + - * / only", e,
                )
            return fir.BinOp(line=ln, op=op,
                             lhs=self.lower_expr(e.left),
                             rhs=self.lower_expr(e.right))
        if isinstance(e, ast.Compare):
            if len(e.ops) != 1:
                raise self.err(
                    "chained comparisons are not supported; split with `and`", e
                )
            op = _CMP_OPS.get(type(e.ops[0]))
            if op is None:
                raise self.err(
                    f"unsupported comparison {type(e.ops[0]).__name__}", e
                )
            return fir.BinOp(line=ln, op=op,
                             lhs=self.lower_expr(e.left),
                             rhs=self.lower_expr(e.comparators[0]))
        if isinstance(e, ast.BoolOp):
            op = "&" if isinstance(e.op, ast.And) else "|"
            out = self.lower_expr(e.values[0])
            for v in e.values[1:]:
                out = fir.BinOp(line=ln, op=op, lhs=out, rhs=self.lower_expr(v))
            return out
        if isinstance(e, ast.UnaryOp):
            if isinstance(e.op, ast.USub):
                return fir.UnaryOp(line=ln, op="-",
                                   operand=self.lower_expr(e.operand))
            if isinstance(e.op, ast.Not):
                return fir.UnaryOp(line=ln, op="!",
                                   operand=self.lower_expr(e.operand))
            if isinstance(e.op, ast.UAdd):
                return self.lower_expr(e.operand)
            raise self.err(f"unsupported unary {type(e.op).__name__}", e)
        if isinstance(e, ast.Subscript):
            return fir.Index(line=ln,
                             base=self.lower_expr(e.value),
                             index=self.lower_expr(e.slice))
        if isinstance(e, ast.Call):
            return self._lower_call(e)
        raise self.err(
            f"unsupported Python expression {type(e).__name__} in an "
            "embedded kernel", e,
        )

    def _builtin_name(self, e: ast.Call) -> Optional[str]:
        """DSL builtin name for a plain-name call, or None."""
        from .builder import KernelHandle

        if not isinstance(e.func, ast.Name):
            return None
        fname = e.func.id
        val = self._lookup(fname)
        if val is not None:
            dsl = getattr(val, "_dsl_builtin", None)
            if dsl is not None:
                return dsl
            if isinstance(val, KernelHandle):
                if not val.decl.params:  # zero-arg host helper: `helper();`
                    self._check_owned(val, fname, e)
                    return val.name
                raise self.err(
                    f"kernel {val.name!r} cannot be called directly; launch "
                    "it with vertices.init(k) / edges.process(k)", e,
                )
            if val in (min, max, abs, pow, print):
                return val.__name__
            raise self.err(
                f"{fname!r} is not a DSL builtin; kernels can only call "
                f"the builtins {', '.join(sorted(_CALLABLE_NAMES))} and "
                "zero-arg host helpers", e,
            )
        if fname in _CALLABLE_NAMES:
            return fname
        raise self.err(
            f"unknown function {fname!r}; kernels can only call the DSL "
            f"builtins ({', '.join(sorted(_CALLABLE_NAMES))}) and zero-arg "
            "host helpers", e,
        )

    def _lower_call(self, e: ast.Call) -> fir.Expr:
        ln = e.lineno
        if e.keywords:
            raise self.err("keyword arguments are not supported in the DSL", e)
        args = [self.lower_expr(a) for a in e.args]
        if isinstance(e.func, ast.Attribute):
            method = _METHOD_ALIASES.get(e.func.attr, e.func.attr)
            return fir.MethodCall(line=ln, obj=self.lower_expr(e.func.value),
                                  method=method, args=args)
        return fir.Call(line=ln, func=self._builtin_name(e), args=args)

    # -- statements ---------------------------------------------------------
    def lower_body(self) -> List[fir.Stmt]:
        body = self.fdef.body
        # skip a leading docstring
        if body and isinstance(body[0], ast.Expr) and \
                isinstance(body[0].value, ast.Constant) and \
                isinstance(body[0].value.value, str):
            body = body[1:]
        return self._lower_stmts(body)

    def _lower_stmts(self, stmts: Sequence[ast.stmt]) -> List[fir.Stmt]:
        out: List[fir.Stmt] = []
        for s in stmts:
            out.extend(self.lower_stmt(s))
        return out

    def _assign_target(self, t: ast.expr) -> fir.Expr:
        """Lower an assignment target (Name or Subscript) to an lvalue."""
        from .builder import (
            Handle, PropertyHandle, ScalarHandle,
        )

        if isinstance(t, ast.Subscript):
            return self.lower_expr(t)
        if isinstance(t, ast.Name):
            name = t.id
            if name in self.params or name in self.locals:
                return fir.Ident(line=t.lineno, name=name)
            val = self._lookup(name)
            if isinstance(val, Handle):
                self._check_owned(val, name, t)
            if isinstance(val, ScalarHandle):
                return fir.Ident(line=t.lineno, name=val.name)
            if isinstance(val, PropertyHandle):
                raise self.err(
                    f"property {val.name!r} needs an index to be written: "
                    f"`{name}[v] = ...`", t,
                )
            if isinstance(val, Handle):
                raise self.err(f"cannot assign to {type(val).__name__} "
                               f"{val.name!r}", t)
            raise self.err(
                f"assignment to undeclared name {name!r}; declare a "
                f"kernel-local with an annotation: `{name}: int = ...`", t,
            )
        raise self.err("unsupported assignment target", t)

    def _min_max_reduce(self, target: fir.Expr,
                        value: ast.expr) -> Optional[fir.ReduceAssign]:
        """``P[i] = min(P[i], e)`` / ``max`` -> ``P[i] min= e`` (the
        Pythonic spelling of the DSL's min=/max= reduction)."""
        if not (isinstance(value, ast.Call) and isinstance(value.func, ast.Name)
                and len(value.args) == 2 and not value.keywords):
            return None
        fname = value.func.id
        val = self._lookup(fname)
        dsl = getattr(val, "_dsl_builtin", None) if val is not None else None
        if val is not None and dsl is None and val in (min, max):
            dsl = val.__name__
        if val is None and fname in ("min", "max"):
            dsl = fname
        if dsl not in ("min", "max"):
            return None
        tgt_dump = fir.dump(target)
        lowered = [self.lower_expr(a) for a in value.args]
        for i in (0, 1):
            if fir.dump(lowered[i]) == tgt_dump:
                return fir.ReduceAssign(line=value.lineno, target=target,
                                        op=dsl, value=lowered[1 - i])
        return None

    def lower_stmt(self, s: ast.stmt) -> List[fir.Stmt]:
        ln = getattr(s, "lineno", 0)
        if isinstance(s, ast.Pass):
            return []
        if isinstance(s, ast.Expr):
            if isinstance(s.value, ast.Constant):
                return []  # stray docstring/ellipsis
            if not isinstance(s.value, ast.Call):
                raise self.err(
                    "expression statements must be calls "
                    "(e.g. edges.process(kernel))", s,
                )
            return [fir.ExprStmt(line=ln, expr=self.lower_expr(s.value))]
        if isinstance(s, ast.Assign):
            if len(s.targets) != 1:
                raise self.err("multiple assignment targets are not "
                               "supported", s)
            target = self._assign_target(s.targets[0])
            reduce = self._min_max_reduce(target, s.value)
            if reduce is not None:
                return [reduce]
            return [fir.Assign(line=ln, target=target,
                               value=self.lower_expr(s.value))]
        if isinstance(s, ast.AnnAssign):
            if not isinstance(s.target, ast.Name):
                raise self.err("annotated declarations must target a plain "
                               "name", s)
            ann = s.annotation
            ann_name = ann.id if isinstance(ann, ast.Name) else None
            if ann_name not in ("int", "float", "bool"):
                raise self.err(
                    "local declarations must be annotated int/float/bool "
                    f"(got {ast.dump(ann) if ann_name is None else ann_name})",
                    s,
                )
            if s.value is None:
                raise self.err(
                    f"local declaration {s.target.id!r} needs an "
                    f"initializer: `{s.target.id}: {ann_name} = ...`", s,
                )
            init = self.lower_expr(s.value)
            self.locals.add(s.target.id)
            return [fir.VarDecl(line=ln, name=s.target.id,
                                type=fir.ScalarType(ann_name), init=init)]
        if isinstance(s, ast.AugAssign):
            op = _REDUCE_OPS.get(type(s.op))
            if op is None:
                raise self.err(
                    f"unsupported in-place operator {type(s.op).__name__}: "
                    "the DSL has += -= *= (and min=/max= via "
                    "`P[i] = min(P[i], e)`)", s,
                )
            return [fir.ReduceAssign(line=ln,
                                     target=self._assign_target(s.target),
                                     op=op, value=self.lower_expr(s.value))]
        if isinstance(s, ast.If):
            return [fir.If(line=ln, cond=self.lower_expr(s.test),
                           then_body=self._lower_stmts(s.body),
                           else_body=self._lower_stmts(s.orelse))]
        if isinstance(s, ast.While):
            if s.orelse:
                raise self.err("while/else is not supported", s)
            return [fir.While(line=ln, cond=self.lower_expr(s.test),
                              body=self._lower_stmts(s.body))]
        if isinstance(s, ast.For):
            if s.orelse:
                raise self.err("for/else is not supported", s)
            if not isinstance(s.target, ast.Name):
                raise self.err("loop target must be a plain name", s)
            it = s.iter
            if not (isinstance(it, ast.Call) and
                    isinstance(it.func, ast.Attribute)):
                raise self.err(
                    "for-loops must iterate a neighbor method: "
                    "`for n in v.getNeighbors():`", s,
                )
            iter_expr = self.lower_expr(it)
            var = s.target.id
            fresh = var not in self.locals
            self.locals.add(var)
            try:
                body = self._lower_stmts(s.body)
            finally:
                if fresh:
                    self.locals.discard(var)
            return [fir.For(line=ln, var=var, iter=iter_expr, body=body)]
        if isinstance(s, ast.Return):
            raise self.err(
                "kernels and main() cannot return values; results live in "
                "properties and host scalars", s,
            )
        raise self.err(
            f"unsupported Python statement {type(s).__name__} in an "
            "embedded kernel", s,
        )
