"""Lexer for the Graphitron DSL.

Produces a token stream from source text. Illegal expressions (unclosed
string constants, stray characters) raise :class:`LexError`, mirroring the
front-end behaviour described in paper §III-B1. Every token carries its
line *and* column so parse/semantic diagnostics can point at the exact
offending character (surfaced with a source excerpt by
:class:`repro.core.program.ProgramError`).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

KEYWORDS = {
    "element", "end", "const", "func", "var", "if", "else", "while", "for",
    "in", "int", "float", "bool", "vertexset", "edgeset", "vector", "true",
    "false",
}

# Longest-match-first multi-character operators.
MULTI_OPS = [
    "min=", "max=", "+=", "-=", "*=", "==", "!=", "<=", ">=",
]
SINGLE_OPS = "=+-*/<>!&|;:,.()[]{}"


class LexError(SyntaxError):
    """Lexical error with a 1-based ``line``/``col`` source location."""

    def __init__(self, msg: str, line: int = 0, col: int = 0):
        super().__init__(msg)
        self.line = line
        self.col = col


@dataclass(frozen=True)
class Token:
    kind: str  # 'ident' | 'int' | 'float' | 'string' | 'kw' | 'op' | 'eof'
    text: str
    line: int
    col: int = 0  # 1-based column of the token's first character

    def __repr__(self) -> str:  # compact for error messages
        return f"{self.kind}:{self.text!r}@{self.line}:{self.col}"


def tokenize(src: str) -> List[Token]:
    toks: List[Token] = []
    i, n, line = 0, len(src), 1
    line_start = 0  # offset of the first character of the current line

    def col(at: int) -> int:
        return at - line_start + 1

    while i < n:
        c = src[i]
        if c == "\n":
            line += 1
            i += 1
            line_start = i
            continue
        if c in " \t\r":
            i += 1
            continue
        if c == "%":  # comment to end of line (paper Fig. 1, line 29)
            while i < n and src[i] != "\n":
                i += 1
            continue
        if c == '"':
            j = i + 1
            while j < n and src[j] != '"':
                if src[j] == "\n":
                    raise LexError(
                        f"line {line}, col {col(i)}: unclosed string constant",
                        line, col(i),
                    )
                j += 1
            if j >= n:
                raise LexError(
                    f"line {line}, col {col(i)}: unclosed string constant",
                    line, col(i),
                )
            toks.append(Token("string", src[i + 1 : j], line, col(i)))
            i = j + 1
            continue
        if c.isdigit() or (c == "." and i + 1 < n and src[i + 1].isdigit()):
            j = i
            seen_dot = False
            while j < n and (src[j].isdigit() or (src[j] == "." and not seen_dot)):
                if src[j] == ".":
                    # '1.foo' is Index-like; only consume dot if digit follows
                    if j + 1 >= n or not src[j + 1].isdigit():
                        break
                    seen_dot = True
                j += 1
            text = src[i:j]
            toks.append(Token("float" if "." in text else "int", text, line, col(i)))
            i = j
            continue
        if c.isalpha() or c == "_":
            j = i
            while j < n and (src[j].isalnum() or src[j] == "_"):
                j += 1
            text = src[i:j]
            # 'min=' / 'max=' reduce operators: ident immediately followed by '='
            if text in ("min", "max"):
                k = j
                while k < n and src[k] in " \t":
                    k += 1
                if k < n and src[k] == "=" and (k + 1 >= n or src[k + 1] != "="):
                    toks.append(Token("op", text + "=", line, col(i)))
                    i = k + 1
                    continue
            kind = "kw" if text in KEYWORDS else "ident"
            toks.append(Token(kind, text, line, col(i)))
            i = j
            continue
        matched = False
        for op in MULTI_OPS:
            if src.startswith(op, i):
                # careful: '==' must not be split; '+=' etc. are fine
                toks.append(Token("op", op, line, col(i)))
                i += len(op)
                matched = True
                break
        if matched:
            continue
        if c in SINGLE_OPS:
            toks.append(Token("op", c, line, col(i)))
            i += 1
            continue
        raise LexError(
            f"line {line}, col {col(i)}: illegal character {c!r}", line, col(i)
        )
    toks.append(Token("eof", "", line, col(i)))
    return toks
