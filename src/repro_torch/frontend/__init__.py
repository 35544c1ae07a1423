"""Embedded Python front-end for the Graphitron DSL.

The second of the compiler's two front-ends (the first is the ``.gt``
text parser): author graph algorithms as decorated Python functions over
typed handles, get the **identical MIR** — and therefore the identical
passes/lowering/backends — as the textual program. ``repro_torch.compile``
accepts either form; see :mod:`repro_torch.frontend.builder` for the authoring
surface and :mod:`repro_torch.frontend.lowering` for the supported grammar.

The names below (``to_float``, ``exp``, ...) are *import-for-IDE* stubs
of the DSL device builtins: importing them gives linters and completion
something real to resolve, but kernel bodies are lowered from the AST,
so the stubs are never executed (calling one at module scope raises).
Python's own ``min``/``max``/``abs``/``pow`` are recognized directly.
"""
from .builder import (
    EdgesetHandle,
    GraphProgram,
    Handle,
    InitExpr,
    KernelHandle,
    PropertyHandle,
    ScalarHandle,
    VertexsetHandle,
)
from .lowering import FrontendError


def _builtin_stub(name: str, arity: int, doc: str):
    def stub(*args):
        raise FrontendError(
            f"{name}() is a Graphitron device builtin: it can only appear "
            "inside @vertex_kernel/@edge_kernel/@main decorated bodies "
            "(which are lowered from the AST, never executed)"
        )

    stub.__name__ = name
    stub.__qualname__ = name
    stub.__doc__ = f"{doc} (DSL builtin, {arity} arg{'s' if arity != 1 else ''})."
    stub._dsl_builtin = name
    return stub


exp = _builtin_stub("exp", 1, "e**x")
log = _builtin_stub("log", 1, "natural logarithm")
sqrt = _builtin_stub("sqrt", 1, "square root")
sigmoid = _builtin_stub("sigmoid", 1, "logistic sigmoid")
leakyrelu = _builtin_stub("leakyrelu", 2, "leaky ReLU with negative slope")
floor = _builtin_stub("floor", 1, "round toward -inf")
to_float = _builtin_stub("to_float", 1, "int -> float cast")
to_int = _builtin_stub("to_int", 1, "float -> int cast")
original_id = _builtin_stub("original_id", 1, "pre-relabeling vertex id")
swap = _builtin_stub("swap", 2, "host-side O(1) buffer swap")

__all__ = [
    "GraphProgram",
    "FrontendError",
    "Handle",
    "PropertyHandle",
    "ScalarHandle",
    "VertexsetHandle",
    "EdgesetHandle",
    "KernelHandle",
    "InitExpr",
    # DSL builtin stubs
    "exp", "log", "sqrt", "sigmoid", "leakyrelu", "floor",
    "to_float", "to_int", "original_id", "swap",
]
