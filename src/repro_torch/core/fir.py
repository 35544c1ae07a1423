"""Front-end IR (FIR) for the Graphitron DSL.

This module is the *rigorous grammar definition* the paper calls for: every
construct the language accepts is one of the dataclasses below, and the
parser can produce nothing else.

Grammar (EBNF)
--------------

    program      ::= decl*
    decl         ::= element_decl | const_decl | func_decl
    element_decl ::= 'element' IDENT 'end'
    const_decl   ::= 'const' IDENT ':' type ('=' expr)? ';'
    type         ::= 'int' | 'float' | 'bool'
                   | 'vertexset' '{' IDENT '}'
                   | 'edgeset' '{' IDENT '}' '(' IDENT ',' IDENT (',' ('int'|'float'))? ')'
                   | 'vector' '{' IDENT '}' '(' ('int'|'float'|'bool') ')'
    func_decl    ::= 'func' IDENT '(' params? ')' stmt* 'end'
    params       ::= param (',' param)*
    param        ::= IDENT ':' (IDENT | 'int' | 'float' | 'bool')
    stmt         ::= var_decl | assign | reduce_assign | if_stmt | while_stmt
                   | for_stmt | expr_stmt
    var_decl     ::= 'var' IDENT ':' type '=' expr ';'
    assign       ::= lvalue '=' expr ';'
    reduce_assign::= lvalue ('min='|'max='|'+='|'-='|'*=') expr ';'
    lvalue       ::= IDENT ('[' expr ']')?
    if_stmt      ::= 'if' '(' expr ')' stmt* ('else' stmt*)? 'end'
    while_stmt   ::= 'while' '(' expr ')' stmt* 'end'
    for_stmt     ::= 'for' IDENT 'in' expr stmt* 'end'
    expr_stmt    ::= expr ';'
    expr         ::= or_e ;  or_e ::= and_e ('|' and_e)* ; and_e ::= cmp_e ('&' cmp_e)*
    cmp_e        ::= add_e (('=='|'!='|'<'|'<='|'>'|'>=') add_e)?
    add_e        ::= mul_e (('+'|'-') mul_e)* ; mul_e ::= unary_e (('*'|'/') unary_e)*
    unary_e      ::= ('-'|'!') unary_e | postfix_e
    postfix_e    ::= primary ( '.' IDENT '(' args? ')' | '[' expr ']' )*
    primary      ::= INT | FLOAT | 'true' | 'false' | STRING | IDENT
                   | IDENT '(' args? ')' | '(' expr ')'

Comments start with '%' and run to end of line (paper Fig. 1 line 29).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import List, Optional, Union

# --------------------------------------------------------------------------
# Types
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class ScalarType:
    kind: str  # 'int' | 'float' | 'bool'

    def __str__(self) -> str:
        return self.kind


@dataclass(frozen=True)
class VertexsetType:
    element: str  # element name, e.g. 'Vertex'

    def __str__(self) -> str:
        return f"vertexset{{{self.element}}}"


@dataclass(frozen=True)
class EdgesetType:
    element: str
    src_element: str
    dst_element: str
    weight: Optional[str] = None  # 'int' | 'float' | None

    @property
    def weighted(self) -> bool:
        return self.weight is not None

    def __str__(self) -> str:
        w = f", {self.weight}" if self.weight else ""
        return f"edgeset{{{self.element}}}({self.src_element}, {self.dst_element}{w})"


@dataclass(frozen=True)
class VectorType:
    element: str  # 'Vertex' or 'Edge' (an element name)
    scalar: str  # 'int' | 'float' | 'bool'

    def __str__(self) -> str:
        return f"vector{{{self.element}}}({self.scalar})"


@dataclass(frozen=True)
class ElementType:
    """A bare element used as a parameter type, e.g. ``v: Vertex``."""

    name: str

    def __str__(self) -> str:
        return self.name


Type = Union[ScalarType, VertexsetType, EdgesetType, VectorType, ElementType]

INT = ScalarType("int")
FLOAT = ScalarType("float")
BOOL = ScalarType("bool")

# --------------------------------------------------------------------------
# Expressions
# --------------------------------------------------------------------------


@dataclass
class Node:
    """Base FIR node: every node carries its source line/column for
    diagnostics. Both fields are ``compare=False`` and ignored by
    :func:`dump`, so provenance never perturbs MIR fingerprints."""

    line: int = field(default=0, compare=False)
    col: int = field(default=0, compare=False)


@dataclass
class Expr(Node):
    pass


@dataclass
class IntLit(Expr):
    value: int = 0


@dataclass
class FloatLit(Expr):
    value: float = 0.0


@dataclass
class BoolLit(Expr):
    value: bool = False


@dataclass
class StrLit(Expr):
    value: str = ""


@dataclass
class Ident(Expr):
    name: str = ""


@dataclass
class BinOp(Expr):
    op: str = ""  # + - * / == != < <= > >= & |
    lhs: Expr = None
    rhs: Expr = None


@dataclass
class UnaryOp(Expr):
    op: str = ""  # - !
    operand: Expr = None


@dataclass
class Index(Expr):
    base: Expr = None
    index: Expr = None


@dataclass
class Call(Expr):
    func: str = ""
    args: List[Expr] = field(default_factory=list)


@dataclass
class MethodCall(Expr):
    obj: Expr = None
    method: str = ""
    args: List[Expr] = field(default_factory=list)


# --------------------------------------------------------------------------
# Statements
# --------------------------------------------------------------------------


@dataclass
class Stmt(Node):
    pass


@dataclass
class VarDecl(Stmt):
    name: str = ""
    type: Type = None
    init: Optional[Expr] = None


@dataclass
class Assign(Stmt):
    target: Expr = None  # Ident or Index
    value: Expr = None


@dataclass
class ReduceAssign(Stmt):
    target: Expr = None
    op: str = ""  # 'min' | 'max' | '+' | '-' | '*'
    value: Expr = None


@dataclass
class If(Stmt):
    cond: Expr = None
    then_body: List[Stmt] = field(default_factory=list)
    else_body: List[Stmt] = field(default_factory=list)


@dataclass
class While(Stmt):
    cond: Expr = None
    body: List[Stmt] = field(default_factory=list)


@dataclass
class For(Stmt):
    var: str = ""
    iter: Expr = None
    body: List[Stmt] = field(default_factory=list)


@dataclass
class ExprStmt(Stmt):
    expr: Expr = None


# --------------------------------------------------------------------------
# Declarations
# --------------------------------------------------------------------------


@dataclass
class ElementDecl(Node):
    name: str = ""


@dataclass
class ConstDecl(Node):
    name: str = ""
    type: Type = None
    init: Optional[Expr] = None


@dataclass
class Param(Node):
    name: str = ""
    type: Type = None


@dataclass
class FuncDecl(Node):
    name: str = ""
    params: List[Param] = field(default_factory=list)
    body: List[Stmt] = field(default_factory=list)


@dataclass
class Program(Node):
    """FIR root node; the front-end exposes this to later phases."""

    elements: List[ElementDecl] = field(default_factory=list)
    consts: List[ConstDecl] = field(default_factory=list)
    funcs: List[FuncDecl] = field(default_factory=list)

    def func(self, name: str) -> FuncDecl:
        for f in self.funcs:
            if f.name == name:
                return f
        raise KeyError(f"no function named {name!r}")


def dump(node, indent: int = 0) -> str:
    """Human-readable FIR dump (used by tests and ``--emit=fir``)."""
    pad = "  " * indent
    if isinstance(node, Program):
        parts = [dump(e, indent) for e in node.elements]
        parts += [dump(c, indent) for c in node.consts]
        parts += [dump(f, indent) for f in node.funcs]
        return "\n".join(parts)
    if isinstance(node, ElementDecl):
        return f"{pad}element {node.name} end"
    if isinstance(node, ConstDecl):
        init = f" = {dump(node.init)}" if node.init is not None else ""
        return f"{pad}const {node.name}: {node.type}{init};"
    if isinstance(node, FuncDecl):
        ps = ", ".join(f"{p.name}: {p.type}" for p in node.params)
        body = "\n".join(dump(s, indent + 1) for s in node.body)
        return f"{pad}func {node.name}({ps})\n{body}\n{pad}end"
    if isinstance(node, VarDecl):
        return f"{pad}var {node.name}: {node.type} = {dump(node.init)};"
    if isinstance(node, Assign):
        return f"{pad}{dump(node.target)} = {dump(node.value)};"
    if isinstance(node, ReduceAssign):
        return f"{pad}{dump(node.target)} {node.op}= {dump(node.value)};"
    if isinstance(node, If):
        s = f"{pad}if ({dump(node.cond)})\n"
        s += "\n".join(dump(x, indent + 1) for x in node.then_body)
        if node.else_body:
            s += f"\n{pad}else\n" + "\n".join(dump(x, indent + 1) for x in node.else_body)
        return s + f"\n{pad}end"
    if isinstance(node, While):
        body = "\n".join(dump(x, indent + 1) for x in node.body)
        return f"{pad}while ({dump(node.cond)})\n{body}\n{pad}end"
    if isinstance(node, For):
        body = "\n".join(dump(x, indent + 1) for x in node.body)
        return f"{pad}for {node.var} in {dump(node.iter)}\n{body}\n{pad}end"
    if isinstance(node, ExprStmt):
        return f"{pad}{dump(node.expr)};"
    if isinstance(node, BinOp):
        return f"({dump(node.lhs)} {node.op} {dump(node.rhs)})"
    if isinstance(node, UnaryOp):
        return f"({node.op}{dump(node.operand)})"
    if isinstance(node, Index):
        return f"{dump(node.base)}[{dump(node.index)}]"
    if isinstance(node, Call):
        return f"{node.func}({', '.join(dump(a) for a in node.args)})"
    if isinstance(node, MethodCall):
        return f"{dump(node.obj)}.{node.method}({', '.join(dump(a) for a in node.args)})"
    if isinstance(node, Ident):
        return node.name
    if isinstance(node, (IntLit, FloatLit, BoolLit)):
        return str(node.value).lower() if isinstance(node, BoolLit) else str(node.value)
    if isinstance(node, StrLit):
        # double-quoted: the lexer only accepts " strings, so dump() output
        # stays valid Graphitron (round-trip parse(dump(p)) requires it);
        # the lexer has no escape syntax, so quotes/newlines cannot be
        # represented — reject them rather than emit unlexable text
        if '"' in node.value or "\n" in node.value:
            raise ValueError(
                f"string constant {node.value!r} cannot be dumped: the DSL "
                "has no escape syntax for '\"' or newlines"
            )
        return '"' + node.value + '"'
    raise TypeError(f"cannot dump {type(node)}")
