"""The embedded authoring surface: :class:`GraphProgram` and its handles.

A :class:`GraphProgram` is built in ordinary Python and compiles through
the exact pipeline the ``.gt`` text parser feeds — it constructs FIR
directly, so ``repro_torch.compile(program)`` and ``repro_torch.compile(text_twin)``
produce MIR-hash-identical modules and share one cache entry::

    from repro_torch.frontend import GraphProgram, to_float

    p = GraphProgram("pagerank")
    edges    = p.edgeset("edges")
    vertices = p.vertexset("vertices")
    rank     = p.vertex_prop("rank", float)
    deg      = p.vertex_prop("deg", int, init=edges.out_degrees())
    iters    = p.scalar("iters", int, init=20)

    @p.vertex_kernel
    def initRank(v):
        rank[v] = 1.0 / to_float(vertices.size())

    @p.edge_kernel
    def push(src, dst):
        if deg[src] > 0:
            rank[dst] += rank[src] / to_float(deg[src])

    @p.main
    def main():
        vertices.init(initRank)
        i: int = 0
        while i < iters:
            edges.process(push)
            i = i + 1

    session = repro_torch.compile(p).bind(graph)

Handles are *typed names*: inside decorated functions they are never
executed — the body is lowered from the Python AST
(:mod:`repro_torch.frontend.lowering`) — so indexing/calling a handle at
module scope raises a :class:`FrontendError` pointing that out.
:meth:`GraphProgram.to_source` emits the equivalent ``.gt`` text
(``parse(p.to_source())`` round-trips to the same MIR hash).
"""
from __future__ import annotations

import copy
import keyword
from typing import Dict, List, Optional, Union

from ..core import fir
from ..core.lexer import KEYWORDS as _DSL_KEYWORDS
from .lowering import FrontendError, Lowerer, function_ast

_SCALAR_NAMES = {
    int: "int", float: "float", bool: "bool",
    "int": "int", "float": "float", "bool": "bool",
}

ScalarLike = Union[type, str]


def _scalar_name(dtype: ScalarLike, *, what: str, allow=("int", "float", "bool")):
    name = _SCALAR_NAMES.get(dtype)
    if name is None or name not in allow:
        raise FrontendError(
            f"{what} must be one of {'/'.join(allow)} (python types int/"
            f"float/bool or their names), got {dtype!r}"
        )
    return name


class InitExpr:
    """A declaration-time initializer expression (e.g. ``edges.out_degrees()``)."""

    def __init__(self, expr: fir.Expr):
        self.expr = expr


class Handle:
    """Base of all typed handles: a declared DSL name inside one program."""

    def __init__(self, program: "GraphProgram", name: str):
        self._program = program
        self.name = name

    def _only_in_kernels(self, action: str):
        raise FrontendError(
            f"{action} {type(self).__name__} {self.name!r} outside a "
            "decorated kernel: handles are lowered from the AST of "
            "@vertex_kernel/@edge_kernel/@main functions and are not "
            "executable Python values"
        )

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self.name!r})"


class PropertyHandle(Handle):
    """A ``vector{Element}(scalar)`` property; index it inside kernels."""

    def __init__(self, program, name, element, scalar):
        super().__init__(program, name)
        self.element = element
        self.scalar = scalar

    def __getitem__(self, idx):
        self._only_in_kernels("reading")

    def __setitem__(self, idx, value):
        self._only_in_kernels("writing")


class ScalarHandle(Handle):
    """A host scalar — a declared run-time parameter of the Program."""

    def __init__(self, program, name, scalar, required):
        super().__init__(program, name)
        self.scalar = scalar
        self.required = required

    def __bool__(self):
        self._only_in_kernels("testing")

    def __add__(self, other):
        self._only_in_kernels("using")

    __radd__ = __sub__ = __rsub__ = __mul__ = __rmul__ = __add__


class VertexsetHandle(Handle):
    """The program's vertexset; ``init``/``process``/``size`` in kernels."""

    def init(self, kernel):
        self._only_in_kernels("calling init() on")

    def process(self, kernel):
        self._only_in_kernels("calling process() on")

    def size(self):
        self._only_in_kernels("calling size() on")


class EdgesetHandle(Handle):
    """The program's edgeset. ``out_degrees()``/``in_degrees()`` are
    declaration-time initializers; ``process()`` is kernel-only."""

    def __init__(self, program, name, weighted, weight_scalar):
        super().__init__(program, name)
        self.weighted = weighted
        self.weight_scalar = weight_scalar

    def process(self, kernel):
        self._only_in_kernels("calling process() on")

    # -- declaration-time initializer expressions --------------------------
    def _method_init(self, method: str) -> InitExpr:
        return InitExpr(fir.MethodCall(obj=fir.Ident(name=self.name),
                                       method=method, args=[]))

    def get_vertices(self) -> InitExpr:
        return self._method_init("getVertices")

    def out_degrees(self) -> InitExpr:
        return self._method_init("getOutDegrees")

    def in_degrees(self) -> InitExpr:
        return self._method_init("getInDegrees")

    # camelCase twins of the .gt spellings
    getVertices = get_vertices
    getOutDegrees = out_degrees
    getInDegrees = in_degrees


class KernelHandle(Handle):
    """A lowered device/host function; reference it in main()'s
    ``set.init(k)`` / ``set.process(k)`` calls."""

    def __init__(self, program, name, decl: fir.FuncDecl, fn):
        super().__init__(program, name)
        self.decl = decl
        self.fn = fn  # the original Python function (for introspection)

    def __call__(self, *args, **kwargs):
        raise FrontendError(
            f"kernel {self.name!r} is not directly callable: launch it from "
            "main() with vertices.init(k) / edges.process(k), or run the "
            "compiled program via repro_torch.compile(program).bind(graph).run()"
        )


class GraphProgram:
    """Declarative builder for one Graphitron program.

    Declaration order is preserved into the FIR (and thus into
    :meth:`to_source` and the canonical MIR hash), exactly like the order
    of ``const``/``func`` declarations in a ``.gt`` file.
    """

    def __init__(self, name: str = "program", *, vertex_element: str = "Vertex",
                 edge_element: str = "Edge"):
        self.name = name
        self.vertex_element = vertex_element
        self.edge_element = edge_element
        self._consts: List[fir.ConstDecl] = []
        self._funcs: List[fir.FuncDecl] = []
        self._symbols: Dict[str, Handle] = {}
        self._edgeset: Optional[EdgesetHandle] = None
        self._vertexset: Optional[VertexsetHandle] = None
        self._has_main = False
        # compile memo set by repro_torch.core.program: (MIR fingerprint, .gt
        # source); any further declaration invalidates it
        self._identity = None

    # -- symbol bookkeeping -------------------------------------------------
    def symbol(self, name: str) -> Optional[Handle]:
        """The declared handle named ``name`` (DSL name), or None."""
        return self._symbols.get(name)

    def _check_name(self, name: str):
        if not isinstance(name, str) or not name.isidentifier():
            raise FrontendError(
                f"invalid DSL identifier {name!r} in program {self.name!r}"
            )
        if name in _DSL_KEYWORDS or keyword.iskeyword(name):
            raise FrontendError(
                f"{name!r} is a keyword and cannot name a declaration "
                f"(program {self.name!r})"
            )
        if name in self._symbols:
            raise FrontendError(
                f"duplicate declaration {name!r} in program {self.name!r}"
            )

    def _declare(self, handle: Handle, decl: fir.ConstDecl) -> Handle:
        self._check_name(handle.name)
        self._symbols[handle.name] = handle
        self._consts.append(decl)
        self._identity = None
        return handle

    # -- graph declarations -------------------------------------------------
    def edgeset(self, name: str = "edges", *, weight: Optional[ScalarLike] = None,
                path: Optional[str] = None) -> EdgesetHandle:
        """Declare the program's edgeset (``const name: edgeset{Edge}(...)``).

        ``weight=int``/``float`` declares weighted edges. The default
        initializer is ``load(argv[1])`` (the graph comes from the bound
        session); ``path`` switches to ``load("path")``.
        """
        if self._edgeset is not None:
            raise FrontendError(
                f"program {self.name!r} already declares edgeset "
                f"{self._edgeset.name!r} (one edgeset per program)"
            )
        if path is not None and ('"' in path or "\n" in path):
            raise FrontendError(
                f"edgeset path {path!r} cannot contain '\"' or newlines "
                "(the DSL string syntax has no escapes)"
            )
        wt = None if weight is None else _scalar_name(
            weight, what="edge weight", allow=("int", "float"))
        ty = fir.EdgesetType(self.edge_element, self.vertex_element,
                             self.vertex_element, wt)
        arg = fir.StrLit(value=path) if path is not None else \
            fir.Index(base=fir.Ident(name="argv"), index=fir.IntLit(value=1))
        init = fir.Call(func="load", args=[arg])
        handle = EdgesetHandle(self, name, weighted=wt is not None,
                               weight_scalar=wt)
        self._declare(handle, fir.ConstDecl(name=name, type=ty, init=init))
        self._edgeset = handle
        return handle

    def vertexset(self, name: str = "vertices",
                  of: Optional[EdgesetHandle] = None) -> VertexsetHandle:
        """Declare the vertexset (``const name: vertexset{Vertex} =
        edges.getVertices();``). ``of`` defaults to the declared edgeset."""
        of = of if of is not None else self._edgeset
        if of is None:
            raise FrontendError(
                f"program {self.name!r}: declare the edgeset before the "
                "vertexset (it is derived via getVertices())"
            )
        init = fir.MethodCall(obj=fir.Ident(name=of.name),
                              method="getVertices", args=[])
        handle = VertexsetHandle(self, name)
        self._declare(handle, fir.ConstDecl(
            name=name, type=fir.VertexsetType(self.vertex_element), init=init))
        self._vertexset = handle
        return handle

    # -- data declarations --------------------------------------------------
    def _prop(self, name: str, element: str, dtype: ScalarLike,
              init) -> PropertyHandle:
        scalar = _scalar_name(dtype, what=f"property {name!r} type")
        init_expr = None
        if isinstance(init, InitExpr):
            init_expr = init.expr
        elif init is not None:
            raise FrontendError(
                f"property {name!r}: init must be a declaration-time "
                "expression like edges.out_degrees() (properties are "
                "zero-initialized; set values in an init kernel)"
            )
        handle = PropertyHandle(self, name, element, scalar)
        self._declare(handle, fir.ConstDecl(
            name=name, type=fir.VectorType(element, scalar), init=init_expr))
        return handle

    def vertex_prop(self, name: str, dtype: ScalarLike,
                    init=None) -> PropertyHandle:
        """Declare ``const name: vector{Vertex}(dtype);`` — a |V|-length
        device buffer. ``init=edges.out_degrees()`` maps the degree vector."""
        return self._prop(name, self.vertex_element, dtype, init)

    def edge_prop(self, name: str, dtype: ScalarLike,
                  init=None) -> PropertyHandle:
        """Declare ``const name: vector{Edge}(dtype);`` — an |E|-length
        device buffer."""
        return self._prop(name, self.edge_element, dtype, init)

    def scalar(self, name: str, dtype: ScalarLike, init=None) -> ScalarHandle:
        """Declare a host scalar — a run-time parameter of the compiled
        Program. ``init=None`` makes it required at ``session.run()``."""
        scalar = _scalar_name(dtype, what=f"scalar {name!r} type")
        init_expr = None
        if init is not None:
            if isinstance(init, bool) and scalar == "bool":
                init_expr = fir.BoolLit(value=init)
            elif scalar == "int" and isinstance(init, int) and \
                    not isinstance(init, bool):
                init_expr = fir.IntLit(value=init)
            elif scalar == "float" and isinstance(init, (int, float)) and \
                    not isinstance(init, bool):
                init_expr = fir.FloatLit(value=float(init))
            else:
                raise FrontendError(
                    f"scalar {name!r}: initializer {init!r} does not match "
                    f"declared type {scalar}"
                )
        handle = ScalarHandle(self, name, scalar, required=init is None)
        self._declare(handle, fir.ConstDecl(
            name=name, type=fir.ScalarType(scalar), init=init_expr))
        return handle

    # -- function decorators ------------------------------------------------
    def _register_func(self, handle: KernelHandle) -> KernelHandle:
        self._check_name(handle.name)
        self._symbols[handle.name] = handle
        self._funcs.append(handle.decl)
        self._identity = None
        return handle

    def _lower(self, fn, fdef, filename, param_names) -> List[fir.Stmt]:
        return Lowerer(self, fn, fdef, filename, param_names).lower_body()

    @staticmethod
    def _param_names(fdef, filename) -> List[str]:
        a = fdef.args
        if a.vararg or a.kwarg or a.kwonlyargs or a.posonlyargs or \
                a.defaults or a.kw_defaults:
            raise FrontendError(
                "kernel parameters must be plain positional names "
                "(no defaults, *args, **kwargs, or keyword-only)",
                filename=filename, lineno=fdef.lineno,
            )
        return [arg.arg for arg in a.args]

    def vertex_kernel(self, fn) -> KernelHandle:
        """Lower ``def k(v)`` into a vertex kernel (``func k(v: Vertex)``)."""
        fdef, filename = function_ast(fn)
        names = self._param_names(fdef, filename)
        if len(names) != 1:
            raise FrontendError(
                f"@vertex_kernel {fn.__name__!r} must take exactly one "
                f"vertex parameter, got {len(names)}",
                filename=filename, lineno=fdef.lineno,
            )
        params = [fir.Param(name=names[0],
                            type=fir.ElementType(self.vertex_element))]
        body = self._lower(fn, fdef, filename, names)
        decl = fir.FuncDecl(line=fdef.lineno, name=fn.__name__,
                            params=params, body=body)
        return self._register_func(KernelHandle(self, fn.__name__, decl, fn))

    def edge_kernel(self, fn) -> KernelHandle:
        """Lower ``def k(src, dst[, weight])`` into an edge kernel."""
        fdef, filename = function_ast(fn)
        names = self._param_names(fdef, filename)
        if len(names) not in (2, 3):
            raise FrontendError(
                f"@edge_kernel {fn.__name__!r} must take (src, dst) or "
                f"(src, dst, weight), got {len(names)} parameter(s)",
                filename=filename, lineno=fdef.lineno,
            )
        params = [
            fir.Param(name=names[0], type=fir.ElementType(self.vertex_element)),
            fir.Param(name=names[1], type=fir.ElementType(self.vertex_element)),
        ]
        if len(names) == 3:
            if self._edgeset is None or not self._edgeset.weighted:
                raise FrontendError(
                    f"@edge_kernel {fn.__name__!r} takes a weight parameter "
                    "but the program's edgeset is unweighted (declare it "
                    "with edgeset(weight=int) first)",
                    filename=filename, lineno=fdef.lineno,
                )
            params.append(fir.Param(
                name=names[2],
                type=fir.ScalarType(self._edgeset.weight_scalar)))
        body = self._lower(fn, fdef, filename, names)
        decl = fir.FuncDecl(line=fdef.lineno, name=fn.__name__,
                            params=params, body=body)
        return self._register_func(KernelHandle(self, fn.__name__, decl, fn))

    def _host_func(self, fn, name: str) -> KernelHandle:
        fdef, filename = function_ast(fn)
        names = self._param_names(fdef, filename)
        if names:
            raise FrontendError(
                f"host function {name!r} must take no parameters "
                "(host scalars are read by name)",
                filename=filename, lineno=fdef.lineno,
            )
        body = self._lower(fn, fdef, filename, names)
        decl = fir.FuncDecl(line=fdef.lineno, name=name, params=[], body=body)
        return self._register_func(KernelHandle(self, name, decl, fn))

    def main(self, fn) -> KernelHandle:
        """Lower the decorated zero-arg function into the program's
        ``main()`` host control flow (while / process / init / scalar
        updates), whatever the Python function is called."""
        if self._has_main:
            raise FrontendError(
                f"program {self.name!r} already has a @main function"
            )
        handle = self._host_func(fn, "main")
        self._has_main = True
        return handle

    def host(self, fn) -> KernelHandle:
        """Lower a zero-arg host helper function (callable from main)."""
        return self._host_func(fn, fn.__name__)

    # -- exports ------------------------------------------------------------
    def to_fir(self) -> fir.Program:
        """A fresh FIR Program (deep-copied: semantic analysis normalizes
        kernel bodies in place, and the builder's masters stay pristine)."""
        if not self._has_main:
            raise FrontendError(
                f"program {self.name!r} has no @main function; decorate the "
                "host control flow with @program.main"
            )
        if self._edgeset is None:
            raise FrontendError(
                f"program {self.name!r} declares no edgeset"
            )
        return fir.Program(
            elements=[fir.ElementDecl(name=self.vertex_element),
                      fir.ElementDecl(name=self.edge_element)],
            consts=copy.deepcopy(self._consts),
            funcs=copy.deepcopy(self._funcs),
        )

    def to_source(self) -> str:
        """Equivalent ``.gt`` text: ``parse(p.to_source())`` analyzes to a
        MIR-hash-identical module (the round-trip tests pin this)."""
        return fir.dump(self.to_fir()) + "\n"

    def fingerprint(self) -> str:
        """Canonical MIR content hash (the front-end-independent cache
        identity; equals the text twin's hash)."""
        from ..core import mir, semantic

        return mir.fingerprint(semantic.analyze(self.to_fir()))

    def __repr__(self) -> str:
        kernels = [f.name for f in self._funcs]
        return (f"GraphProgram({self.name!r}, consts={len(self._consts)}, "
                f"funcs={kernels})")
