"""Read integer constants of the port's CUDA sources from their own text.

The CPU tests hold a kernel's tiles, stages and shared memory to what its
source computes, without a compiler: ``c_eval`` evaluates one of the
source's integer constant expressions, ``defined`` the expression of a
``name = ...;`` definition and ``returned`` a one-line function's return
expression.
"""
import re


def c_eval(expr: str, env: dict) -> int:
    """An integer constant expression of the source (``+ - * /``,
    comparisons, ``&&``, ``||``, ``?:``, ``A::b`` names read as ``A_b``)
    evaluated over ``env``, whatever its layout."""
    e = " ".join(expr.replace("::", "_").split())
    depth = 0
    for i, ch in enumerate(e):
        depth += (ch == "(") - (ch == ")")
        if ch == "?" and depth == 0:
            rest, d, nest = e[i + 1:], 0, 0
            for j, c in enumerate(rest):
                d += (c == "(") - (c == ")")
                if d == 0 and c == "?":
                    nest += 1
                elif d == 0 and c == ":":
                    if nest == 0:
                        return c_eval(rest[:j] if c_eval(e[:i], env) else rest[j + 1:], env)
                    nest -= 1
    py = e.replace("&&", " and ").replace("||", " or ").replace("/", "//")
    return int(eval(py, {"__builtins__": {}}, dict(env)))


def defined(text: str, name: str, **env) -> int:
    """The value of ``name = <expr>;`` in ``text`` (its first definition)."""
    return c_eval(re.search(rf"\b{name}\s*=\s*([^;]+);", text).group(1), env)


def returned(text: str, fn: str, **env) -> int:
    """The value of the one-line function ``fn``'s return expression."""
    body = re.search(rf"\b{fn}\s*\([^)]*\)\s*\{{\s*return\s+([^;]+);", text)
    return c_eval(body.group(1), env)
