"""Compilation options: front-end / middle-end concerns only.

``passes`` selects the MIR optimization pass pipeline that runs between
semantic analysis and lowering (see :mod:`.passes`): ``"default"`` runs
all of them, ``"none"`` disables the pipeline, and a comma list
(``"fold,fuse"``) runs a subset. ``scalar_bindings`` binds host scalars to
values at compile time: the ``fold`` pass substitutes them as literals and
the scalar disappears from the program's run-time parameters.

Where the program runs is a :class:`~.target.Target`, given at bind time.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class CompileOptions:
    # MIR optimization pass pipeline: "default" | "none" | "fuse,dce,..."
    passes: str = "default"
    # compile-time scalar bindings consumed by the `fold` pass
    scalar_bindings: Tuple[Tuple[str, object], ...] = ()
