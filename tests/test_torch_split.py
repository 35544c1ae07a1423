"""edge_stream's work list: long bins cut into chunks of at most SPLIT_LEN.

``split_bins`` is a plain torch function, so it runs here. These tests
check that the runs the kernel walks (its chunks, then the bins that are
not split, in quads of four) cover every edge of every bin exactly once,
in order, with no run longer than ``SPLIT_LEN``; and that the schedule the
CUDA kernel runs (per run a strided sum over a group of 32 lanes, or of 8
lanes in a quad of short bins, and a shuffle tree; the chunks' partials
folded in chunk order) gives what the plain version gives:
exactly for int32, ``min`` and ``max``, and for float32 ``+`` within the
bound of two summation orders, ``2 * (n_b + 5) * 2^-24 * sum|v|`` per bin
(the bound chip_smoke.py's ``f32_sum_tolerance`` holds the kernel to).
The kernel itself runs only on the card (``tests/test_torch_gpu.py``).
"""
import re

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.algorithms import sources
from repro_torch.graph import generators
from repro_torch.kernels import _build, ref
from repro_torch.kernels import edge_stream as es
from repro_torch.kernels import shuffle_reduce as sr

L = sr.SPLIT_LEN


def _offsets(counts, start: int = 0) -> torch.Tensor:
    return torch.tensor(np.concatenate([[start], start + np.cumsum(counts)]), dtype=torch.int32)


GROUP, QUAD, SHORT = 8, 4, 32  # csrc/edge_stream.cu: kGroup, kQuad, kShort


def work_items(split: sr.BinSplit, offsets: torch.Tensor, n_stream: int) -> list:
    """The bins' and chunks' runs as the kernel walks them, in order, as
    ``(slot, bin, lo, hi, lanes)``: slot ``("partial", k)`` for chunk k,
    ``("out", b)`` for a whole bin; ``lanes`` is the width of the lane
    group that walks the run (the whole warp, or 8 lanes when all bins of
    the bin's quad hold at most SHORT edges)."""
    off = offsets.clamp(0, n_stream).tolist()
    n_out = len(off) - 1
    items = []
    for k, (b, c) in enumerate(split.chunks.tolist()):
        lo, hi = off[b] + c * L, off[b + 1]
        items.append((("partial", k), b, min(lo, hi), min(lo + L, hi), 32))
    for b0 in range(0, n_out, QUAD):
        quad = range(b0, min(b0 + QUAD, n_out))
        short = all(off[b + 1] - off[b] <= SHORT for b in quad)
        for b in quad:
            if off[b + 1] - off[b] <= L:
                items.append((("out", b), b, off[b], max(off[b], off[b + 1]),
                              GROUP if short else 32))
    return items


BOUNDARY = [0, L - 1, L, L + 1, 0, 2 * L, 2 * L + 1, 0, 3 * L + 5, 1, 0]
CASES = {
    "boundaries": (_offsets(BOUNDARY), sum(BOUNDARY)),
    # the last bins run past the stream and clamp; a negative first offset clamps to 0
    "past_the_stream": (torch.cat([torch.tensor([-7], dtype=torch.int32), _offsets(BOUNDARY)[1:]]),
                        sum(BOUNDARY[:6]) + 40),
    "hub_among_short_bins": (_offsets([5, 0, 9, 10 * L + 3] + [3, 0, 31, 32, 33] * 20), None),
    "no_bin_split": (_offsets([0, 7, L, 1, L]), None),
    "no_bins": (torch.zeros(1, dtype=torch.int32), 0),
}


@pytest.mark.parametrize("case", list(CASES))
def test_work_items_cover_every_edge_once_in_order(case):
    offsets, n_stream = CASES[case]
    n_stream = int(offsets[-1]) if n_stream is None else n_stream
    split = sr.split_bins(offsets, n_stream)
    off = offsets.clamp(0, n_stream).tolist()
    n = [max(0, off[b + 1] - off[b]) for b in range(len(off) - 1)]
    # the split bins are exactly the bins longer than L, each cut into ceil(n / L)
    assert split.bins.tolist() == [b for b, nb in enumerate(n) if nb > L]
    assert split.first.tolist() == [0, *np.cumsum([-(-n[b] // L) for b in split.bins.tolist()])]
    assert split.chunks.dtype == split.bins.dtype == split.first.dtype == torch.int32
    items = work_items(split, offsets, n_stream)
    assert all(hi - lo <= L for _, _, lo, hi, _ in items)
    assert [slot for slot, *_ in items[:split.chunks.shape[0]]] == [
        ("partial", k) for k in range(split.chunks.shape[0])]
    covered = {}
    for _, b, lo, hi, _ in items:
        covered.setdefault(b, []).extend(range(lo, hi))
    for b in range(len(n)):
        assert covered[b] == list(range(off[b], off[b] + n[b])), b
    # a split bin's chunks are its slots first[j]:first[j+1], in chunk order
    for j, b in enumerate(split.bins.tolist()):
        lo, hi = split.first[j].item(), split.first[j + 1].item()
        assert split.chunks[lo:hi].tolist() == [[b, c] for c in range(hi - lo)]


def _warp(vals: torch.Tensor, op: str, ident, lanes: int) -> torch.Tensor:
    """One lane group over a run: lane l folds elements l, l + lanes, ...
    in order, then the __shfl_down_sync tree (offsets lanes/2 .. 1) leaves
    the group's first lane with the result."""
    pad = (-vals.shape[0]) % lanes
    rows = torch.cat([vals, torch.full((pad,), ident, dtype=vals.dtype)]).reshape(-1, lanes)
    acc = torch.full((lanes,), ident, dtype=vals.dtype)
    for row in rows:
        acc = _apply(op, acc, row)
    o = lanes // 2
    while o:
        acc = _apply(op, acc, torch.cat([acc[o:], acc[lanes - o:]]))
        o //= 2
    return acc[0]


def _apply(op, a, b):
    return {"+": torch.add, "min": torch.minimum, "max": torch.maximum}[op](a, b)


def emulate_split(vval, vact, src_s, eid_s, w, offsets, apply_op, op, split):
    """The split schedule in plain torch: every item's warp, chunk partials
    into a scratch buffer, then each split bin's partials folded in chunk
    order from the identity."""
    ident = ref.identity(op, vval.dtype)
    upd = ref._apply(apply_op, vval[src_s], None if w is None else w[eid_s])
    upd = torch.where(vact[src_s], upd, torch.full_like(upd, ident))
    out = torch.empty(offsets.shape[0] - 1, dtype=vval.dtype)
    partial = torch.empty(split.chunks.shape[0], dtype=vval.dtype)
    for (where, idx), _, lo, hi, lanes in work_items(split, offsets, src_s.shape[0]):
        (partial if where == "partial" else out)[idx] = _warp(upd[lo:hi], op, ident, lanes)
    for j, b in enumerate(split.bins.tolist()):
        acc = torch.tensor(ident, dtype=vval.dtype)
        for k in range(split.first[j], split.first[j + 1]):
            acc = _apply(op, acc, partial[k])
        out[b] = acc
    return out, upd


@pytest.mark.parametrize("dtype", [torch.int32, torch.float32])
@pytest.mark.parametrize("apply_op", ["add", "mul", "src"])
@pytest.mark.parametrize("op", ["+", "min", "max"])
def test_split_schedule_matches_the_plain_version(dtype, apply_op, op):
    rng = np.random.default_rng(7)
    counts = np.concatenate([[0, 5 * L + 17, L - 1, L, L + 1, 0, 2 * L, 2 * L + 1],
                             rng.integers(0, 40, 300)])
    offsets = _offsets(counts)
    n_v, n_e = 500, int(counts.sum())
    src_s = torch.from_numpy(rng.integers(0, n_v, n_e).astype(np.int32))
    eid_s = torch.from_numpy(rng.permutation(n_e).astype(np.int32))
    vact = torch.from_numpy(rng.random(n_v) < 0.6)
    if dtype == torch.int32:
        vval, w = (torch.from_numpy(rng.integers(-30, 30, n).astype(np.int32)) for n in (n_v, n_e))
    else:
        vval, w = (torch.from_numpy(rng.normal(size=n).astype(np.float32)) for n in (n_v, n_e))
    eid, ww = (None, None) if apply_op == "src" else (eid_s, w)
    split = sr.split_bins(offsets, n_e)
    assert split.bins.shape[0] == 4 and split.chunks.shape[0] == 6 + 2 + 2 + 3
    assert {lanes for *_, lanes in work_items(split, offsets, n_e)} == {GROUP, 32}
    got, upd = emulate_split(vval, vact, src_s, eid, ww, offsets, apply_op, op, split)
    want = ref.edge_stream_gather_ref(vval, vact, src_s, eid, ww, offsets, apply_op, op)
    # on the CPU the wrapper takes the plain version and ignores the work list
    assert torch.equal(es.edge_stream_gather(vval, vact, src_s, eid, ww, offsets, apply_op, op,
                                             split), want)
    if dtype == torch.float32 and op == "+":
        ids = ref.bin_ids(offsets).long()
        n_b = torch.bincount(ids, minlength=len(counts)).double()
        abs_sum = torch.zeros(len(counts), dtype=torch.float64).index_add_(
            0, ids, torch.where(vact[src_s], upd, 0.0).abs().double())
        tol = 2.0 * (n_b + 5.0) * 2.0**-24 * abs_sum
        assert bool(((got.double() - want.double()).abs() <= tol).all())
    else:
        assert torch.equal(got, want)


def test_bind_builds_the_work_list_and_the_engine_passes_it(monkeypatch):
    """The bind stores split_bins of its dst offsets beside them, and every
    fused edge launch hands that list to the kernel's wrapper."""
    g = generators.power_law(300, 5000, seed=3)
    sess = repro_torch.compile(sources.PAGERANK).bind(g, device="cpu")
    gb = sess.engine.gb
    want = sr.split_bins(gb["dst_offsets"], gb["n_edges"])
    assert all(torch.equal(a, b) for a, b in zip(gb["es_split"], want))
    seen = []
    inner = es.edge_stream_gather

    def recording(*args):
        seen.append(args[8])
        return inner(*args)

    monkeypatch.setattr(es, "edge_stream_gather", recording)
    sess.run(iters=2)
    assert seen and all(s is gb["es_split"] for s in seen)


def test_edge_stream_source_has_no_atomics():
    """No atomics on results and no atomic ticket: each bin's (or chunk's)
    sum is taken by one warp in a fixed order and the chunks are folded in
    chunk order, so a float + gives the same bits on every run."""
    text = (_build.CSRC / "edge_stream.cu").read_text()
    assert not re.search(r"atomic[A-Z]|\batom\.|\bred\.", text)
