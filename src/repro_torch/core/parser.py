"""Recursive-descent parser for the Graphitron DSL: token stream -> FIR.

The grammar is documented in :mod:`repro.core.fir`. The parser assembles
FIRNodes of varying granularity and returns the root :class:`fir.Program`,
exactly the front-end role described in paper §III-B1.
"""
from __future__ import annotations

from typing import List, Optional

from . import fir
from .lexer import Token, tokenize


class ParseError(SyntaxError):
    """Parse error with a 1-based ``line``/``col`` source location."""

    def __init__(self, msg: str, line: int = 0, col: int = 0):
        super().__init__(msg)
        self.line = line
        self.col = col


def _err(msg: str, tok: Token) -> ParseError:
    return ParseError(f"line {tok.line}, col {tok.col}: {msg}", tok.line, tok.col)


class Parser:
    def __init__(self, toks: List[Token]):
        self.toks = toks
        self.pos = 0

    # -- token helpers -----------------------------------------------------
    def peek(self, ahead: int = 0) -> Token:
        return self.toks[min(self.pos + ahead, len(self.toks) - 1)]

    def next(self) -> Token:
        t = self.toks[self.pos]
        self.pos += 1
        return t

    def at(self, kind: str, text: Optional[str] = None, ahead: int = 0) -> bool:
        t = self.peek(ahead)
        return t.kind == kind and (text is None or t.text == text)

    def expect(self, kind: str, text: Optional[str] = None) -> Token:
        t = self.peek()
        if not self.at(kind, text):
            want = text or kind
            raise _err(f"expected {want!r}, found {t!r}", t)
        return self.next()

    def accept(self, kind: str, text: Optional[str] = None) -> Optional[Token]:
        if self.at(kind, text):
            return self.next()
        return None

    # -- program -----------------------------------------------------------
    def parse_program(self) -> fir.Program:
        prog = fir.Program()
        while not self.at("eof"):
            if self.at("kw", "element"):
                prog.elements.append(self.parse_element())
            elif self.at("kw", "const"):
                prog.consts.append(self.parse_const())
            elif self.at("kw", "func"):
                prog.funcs.append(self.parse_func())
            else:
                t = self.peek()
                raise _err(f"expected declaration, found {t!r}", t)
        return prog

    def parse_element(self) -> fir.ElementDecl:
        t = self.expect("kw", "element")
        name = self.expect("ident").text
        self.expect("kw", "end")
        return fir.ElementDecl(line=t.line, col=t.col, name=name)

    def parse_const(self) -> fir.ConstDecl:
        t = self.expect("kw", "const")
        name = self.expect("ident").text
        self.expect("op", ":")
        ty = self.parse_type()
        init = None
        if self.accept("op", "="):
            init = self.parse_expr()
        self.expect("op", ";")
        return fir.ConstDecl(line=t.line, col=t.col, name=name, type=ty, init=init)

    # -- types ---------------------------------------------------------------
    def parse_type(self) -> fir.Type:
        t = self.peek()
        if t.kind == "kw" and t.text in ("int", "float", "bool"):
            self.next()
            return fir.ScalarType(t.text)
        if self.accept("kw", "vertexset"):
            self.expect("op", "{")
            elem = self.expect("ident").text
            self.expect("op", "}")
            return fir.VertexsetType(elem)
        if self.accept("kw", "edgeset"):
            self.expect("op", "{")
            elem = self.expect("ident").text
            self.expect("op", "}")
            self.expect("op", "(")
            src = self.expect("ident").text
            self.expect("op", ",")
            dst = self.expect("ident").text
            weight = None
            if self.accept("op", ","):
                wt = self.next()
                if wt.text not in ("int", "float"):
                    raise _err("edge weight must be int or float", wt)
                weight = wt.text
            self.expect("op", ")")
            return fir.EdgesetType(elem, src, dst, weight)
        if self.accept("kw", "vector"):
            self.expect("op", "{")
            elem = self.expect("ident").text
            self.expect("op", "}")
            self.expect("op", "(")
            st = self.next()
            if st.text not in ("int", "float", "bool"):
                raise _err("vector scalar must be int/float/bool", st)
            self.expect("op", ")")
            return fir.VectorType(elem, st.text)
        if t.kind == "ident":
            self.next()
            return fir.ElementType(t.text)
        raise _err(f"expected type, found {t!r}", t)

    # -- functions -----------------------------------------------------------
    def parse_func(self) -> fir.FuncDecl:
        t = self.expect("kw", "func")
        name = self.expect("ident").text
        self.expect("op", "(")
        params: List[fir.Param] = []
        if not self.at("op", ")"):
            while True:
                pn = self.expect("ident").text
                self.expect("op", ":")
                pt = self.parse_type()
                params.append(fir.Param(name=pn, type=pt))
                if not self.accept("op", ","):
                    break
        self.expect("op", ")")
        body = self.parse_block()
        self.expect("kw", "end")
        return fir.FuncDecl(line=t.line, col=t.col, name=name, params=params, body=body)

    def parse_block(self, until=("end", "else")) -> List[fir.Stmt]:
        stmts: List[fir.Stmt] = []
        while not (self.peek().kind == "kw" and self.peek().text in until) and not self.at("eof"):
            stmts.append(self.parse_stmt())
        return stmts

    # -- statements ------------------------------------------------------------
    def parse_stmt(self) -> fir.Stmt:
        t = self.peek()
        if self.at("kw", "var"):
            self.next()
            name = self.expect("ident").text
            self.expect("op", ":")
            ty = self.parse_type()
            init = None
            if self.accept("op", "="):
                init = self.parse_expr()
            self.expect("op", ";")
            return fir.VarDecl(line=t.line, col=t.col, name=name, type=ty, init=init)
        if self.at("kw", "if"):
            self.next()
            self.expect("op", "(")
            cond = self.parse_expr()
            self.expect("op", ")")
            then_body = self.parse_block()
            else_body: List[fir.Stmt] = []
            if self.accept("kw", "else"):
                else_body = self.parse_block(until=("end",))
            self.expect("kw", "end")
            return fir.If(line=t.line, col=t.col, cond=cond, then_body=then_body, else_body=else_body)
        if self.at("kw", "while"):
            self.next()
            self.expect("op", "(")
            cond = self.parse_expr()
            self.expect("op", ")")
            body = self.parse_block(until=("end",))
            self.expect("kw", "end")
            return fir.While(line=t.line, col=t.col, cond=cond, body=body)
        if self.at("kw", "for"):
            self.next()
            var = self.expect("ident").text
            self.expect("kw", "in")
            it = self.parse_expr()
            body = self.parse_block(until=("end",))
            self.expect("kw", "end")
            return fir.For(line=t.line, col=t.col, var=var, iter=it, body=body)
        # expression-leading statements: assign / reduce-assign / call
        expr = self.parse_expr()
        if self.at("op", "="):
            self.next()
            value = self.parse_expr()
            self.expect("op", ";")
            if not isinstance(expr, (fir.Ident, fir.Index)):
                raise _err("invalid assignment target", t)
            return fir.Assign(line=t.line, col=t.col, target=expr, value=value)
        for op_tok, op in (("min=", "min"), ("max=", "max"), ("+=", "+"), ("-=", "-"), ("*=", "*")):
            if self.at("op", op_tok):
                self.next()
                value = self.parse_expr()
                self.expect("op", ";")
                if not isinstance(expr, (fir.Ident, fir.Index)):
                    raise _err("invalid reduce target", t)
                return fir.ReduceAssign(line=t.line, col=t.col, target=expr, op=op, value=value)
        self.expect("op", ";")
        return fir.ExprStmt(line=t.line, col=t.col, expr=expr)

    # -- expressions ------------------------------------------------------------
    def parse_expr(self) -> fir.Expr:
        return self.parse_or()

    def parse_or(self) -> fir.Expr:
        e = self.parse_and()
        while self.at("op", "|"):
            t = self.next()
            e = fir.BinOp(line=t.line, col=t.col, op="|", lhs=e, rhs=self.parse_and())
        return e

    def parse_and(self) -> fir.Expr:
        e = self.parse_cmp()
        while self.at("op", "&"):
            t = self.next()
            e = fir.BinOp(line=t.line, col=t.col, op="&", lhs=e, rhs=self.parse_cmp())
        return e

    def parse_cmp(self) -> fir.Expr:
        e = self.parse_add()
        for op in ("==", "!=", "<=", ">=", "<", ">"):
            if self.at("op", op):
                t = self.next()
                return fir.BinOp(line=t.line, col=t.col, op=op, lhs=e, rhs=self.parse_add())
        return e

    def parse_add(self) -> fir.Expr:
        e = self.parse_mul()
        while self.at("op", "+") or self.at("op", "-"):
            t = self.next()
            e = fir.BinOp(line=t.line, col=t.col, op=t.text, lhs=e, rhs=self.parse_mul())
        return e

    def parse_mul(self) -> fir.Expr:
        e = self.parse_unary()
        while self.at("op", "*") or self.at("op", "/"):
            t = self.next()
            e = fir.BinOp(line=t.line, col=t.col, op=t.text, lhs=e, rhs=self.parse_unary())
        return e

    def parse_unary(self) -> fir.Expr:
        if self.at("op", "-") or self.at("op", "!"):
            t = self.next()
            return fir.UnaryOp(line=t.line, col=t.col, op=t.text, operand=self.parse_unary())
        return self.parse_postfix()

    def parse_postfix(self) -> fir.Expr:
        e = self.parse_primary()
        while True:
            if self.at("op", "."):
                t = self.next()
                method = self.expect("ident").text
                self.expect("op", "(")
                args = self.parse_args()
                self.expect("op", ")")
                e = fir.MethodCall(line=t.line, col=t.col, obj=e, method=method, args=args)
            elif self.at("op", "["):
                t = self.next()
                idx = self.parse_expr()
                self.expect("op", "]")
                e = fir.Index(line=t.line, col=t.col, base=e, index=idx)
            else:
                return e

    def parse_args(self) -> List[fir.Expr]:
        args: List[fir.Expr] = []
        if not self.at("op", ")"):
            while True:
                args.append(self.parse_expr())
                if not self.accept("op", ","):
                    break
        return args

    def parse_primary(self) -> fir.Expr:
        t = self.peek()
        if t.kind == "int":
            self.next()
            return fir.IntLit(line=t.line, col=t.col, value=int(t.text))
        if t.kind == "float":
            self.next()
            return fir.FloatLit(line=t.line, col=t.col, value=float(t.text))
        if t.kind == "string":
            self.next()
            return fir.StrLit(line=t.line, col=t.col, value=t.text)
        if self.at("kw", "true") or self.at("kw", "false"):
            self.next()
            return fir.BoolLit(line=t.line, col=t.col, value=t.text == "true")
        if t.kind == "ident":
            self.next()
            if self.at("op", "("):
                self.next()
                args = self.parse_args()
                self.expect("op", ")")
                return fir.Call(line=t.line, col=t.col, func=t.text, args=args)
            return fir.Ident(line=t.line, col=t.col, name=t.text)
        if self.accept("op", "("):
            e = self.parse_expr()
            self.expect("op", ")")
            return e
        raise _err(f"expected expression, found {t!r}", t)


def parse(src: str) -> fir.Program:
    """Front-end entry point: source text -> FIR Program (the AST root)."""
    return Parser(tokenize(src)).parse_program()
