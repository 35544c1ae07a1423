"""Graph generators: RMAT (Kronecker), uniform, and small fixtures.

No network access is available, so the Table II datasets are synthesized to
the published (|V|, |E|, avg-degree, skew) statistics (see datasets.py).
RMAT follows Leskovec et al. (Kronecker graphs), the same generator behind
rmat-19-32 in the paper.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from .storage import GraphData


def rmat(
    scale: int,
    edge_factor: int,
    a: float = 0.57,
    b: float = 0.19,
    c: float = 0.19,
    seed: int = 0,
    weighted: bool = False,
    max_weight: int = 64,
) -> GraphData:
    """RMAT generator (Graph500 parameters by default)."""
    n = 1 << scale
    m = n * edge_factor
    rng = np.random.default_rng(seed)
    d = 1.0 - a - b - c
    src = np.zeros(m, dtype=np.int64)
    dst = np.zeros(m, dtype=np.int64)
    # vectorized bit-by-bit Kronecker recursion
    for bit in range(scale):
        r = rng.random(m)
        # quadrant probabilities, with noise to avoid exact self-similarity
        go_right = (r >= a + b) & (r < a + b + c) | (r >= a + b + c)
        go_down = (r >= a) & (r < a + b) | (r >= a + b + c)
        src |= go_down.astype(np.int64) << bit
        dst |= go_right.astype(np.int64) << bit
    w = rng.integers(1, max_weight, m).astype(np.float32) if weighted else None
    return GraphData(n, src.astype(np.int32), dst.astype(np.int32), w)


def uniform_random(
    n_vertices: int,
    n_edges: int,
    seed: int = 0,
    weighted: bool = False,
    max_weight: int = 64,
) -> GraphData:
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n_vertices, n_edges).astype(np.int32)
    dst = rng.integers(0, n_vertices, n_edges).astype(np.int32)
    w = rng.integers(1, max_weight, n_edges).astype(np.float32) if weighted else None
    return GraphData(n_vertices, src, dst, w)


def power_law(
    n_vertices: int,
    n_edges: int,
    exponent: float = 2.1,
    seed: int = 0,
    weighted: bool = False,
    max_weight: int = 64,
) -> GraphData:
    """Power-law (social-network-like) graph via weighted vertex sampling."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, n_vertices + 1, dtype=np.float64)
    p = ranks ** (-1.0 / (exponent - 1.0))
    p /= p.sum()
    src = rng.choice(n_vertices, n_edges, p=p).astype(np.int32)
    dst = rng.choice(n_vertices, n_edges, p=p).astype(np.int32)
    perm = rng.permutation(n_vertices).astype(np.int32)  # de-correlate id/degree
    w = rng.integers(1, max_weight, n_edges).astype(np.float32) if weighted else None
    return GraphData(n_vertices, perm[src], perm[dst], w)


def chain(n: int, weighted: bool = False) -> GraphData:
    src = np.arange(n - 1, dtype=np.int32)
    dst = src + 1
    w = np.ones(n - 1, np.float32) if weighted else None
    return GraphData(n, src, dst, w)


def deep_chain(n: int, multiplicity: int = 1000,
               weighted: bool = False) -> GraphData:
    """A diameter-``n`` chain with ``multiplicity`` parallel edges per hop
    (both directions).

    The frontier-compaction stress fixture: BFS walks ``n`` levels whose
    frontiers are single vertices, while full-edge streaming pays the
    whole ``2*(n-1)*multiplicity`` edge list at every level — the regime
    where the direction optimization structurally pays (paper Fig. 2),
    and the autotuner's gated workload.
    """
    f = np.arange(n - 1, dtype=np.int32)
    src = np.concatenate([np.repeat(f, multiplicity),
                          np.repeat(f + 1, multiplicity)])
    dst = np.concatenate([np.repeat(f + 1, multiplicity),
                          np.repeat(f, multiplicity)])
    w = np.ones(src.shape[0], np.float32) if weighted else None
    return GraphData(n, src, dst, w)


def star(n: int, weighted: bool = False) -> GraphData:
    """Hub 0 points at everyone — the hub-cache stress fixture."""
    src = np.zeros(n - 1, dtype=np.int32)
    dst = np.arange(1, n, dtype=np.int32)
    w = np.ones(n - 1, np.float32) if weighted else None
    return GraphData(n, src, dst, w)


def grid2d(side: int, weighted: bool = False) -> GraphData:
    idx = np.arange(side * side).reshape(side, side)
    right = np.stack([idx[:, :-1].ravel(), idx[:, 1:].ravel()])
    down = np.stack([idx[:-1, :].ravel(), idx[1:, :].ravel()])
    e = np.concatenate([right, down], axis=1)
    w = np.ones(e.shape[1], np.float32) if weighted else None
    return GraphData(side * side, e[0].astype(np.int32), e[1].astype(np.int32), w)


def load_edge_list(path: str, weighted: Optional[bool] = None) -> GraphData:
    """SNAP-style whitespace edge list loader: ``src dst [weight]`` lines."""
    rows = []
    with open(path) as f:
        for ln in f:
            ln = ln.strip()
            if not ln or ln.startswith(("#", "%")):
                continue
            parts = ln.split()
            rows.append([float(x) for x in parts[:3]])
    arr = np.asarray(rows)
    src = arr[:, 0].astype(np.int32)
    dst = arr[:, 1].astype(np.int32)
    has_w = arr.shape[1] >= 3 if weighted is None else weighted
    w = arr[:, 2].astype(np.float32) if (has_w and arr.shape[1] >= 3) else None
    n = int(max(src.max(), dst.max())) + 1 if len(src) else 0
    return GraphData(n, src, dst, w)
