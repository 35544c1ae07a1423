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


# --------------------------------------------------------------------------
# the batched walk: groups of R rows, R / C lanes loading an edge's R values
# --------------------------------------------------------------------------


def test_row_group_is_the_least_width_that_holds_the_rows():
    """``row_group(k)``: the least of GROUP_ROWS at or above k (K = 2 one
    group of 2), else the largest, the last group then partial."""
    assert es.GROUP_ROWS == tuple(sorted(es.GROUP_ROWS)) and es.GROUP_ROWS[0] == 2
    for k in range(1, 80):
        fits = [r for r in es.GROUP_ROWS if r >= k]
        assert es.row_group(k) == (min(fits) if fits else max(es.GROUP_ROWS)), k
    assert es.row_group(2) == 2 and -(-64 // es.row_group(64)) == 4


def pack_group(vval, vact, group: int, g: int, apply_op: str, op: str):
    """The pack kernel's output for rows g * group .. of ``[K, V]`` values
    and ``[K, V]`` flags: the ``[V, group]`` tile (apply src: the identity
    where a row's flag is off; rows past the last: the identity) and, for
    weighted applies, each vertex's flag word (bit r: row r)."""
    k, n_v = vval.shape
    ident = ref.identity(op, vval.dtype)
    rows = range(g * group, min(k, (g + 1) * group))
    tile = torch.full((n_v, group), ident, dtype=vval.dtype)
    word = torch.zeros(n_v, dtype=torch.int64)
    for r, row in enumerate(rows):
        tile[:, r] = vval[row]
        if apply_op == "src":
            tile[:, r] = torch.where(vact[row], vval[row], torch.full_like(vval[row], ident))
        word |= vact[row].to(torch.int64) << r
    return tile, (None if apply_op == "src" else word)


def test_pack_twin_holds_each_rows_values_and_flags():
    rng = np.random.default_rng(4)
    vval = torch.from_numpy(rng.normal(size=(11, 50)).astype(np.float32))
    vact = torch.from_numpy(rng.random((11, 50)) < 0.5)
    for apply_op in ("src", "add"):
        tile, word = pack_group(vval, vact, 8, 1, apply_op, "+")
        for r in range(8):
            row = 8 + r
            if row >= 11:
                assert torch.equal(tile[:, r], torch.zeros(50))
                assert word is None or not (word >> r & 1).any()
            elif apply_op == "src":
                assert torch.equal(tile[:, r], torch.where(vact[row], vval[row], 0.0))
            else:
                assert torch.equal(tile[:, r], vval[row])
                assert torch.equal((word >> r & 1).bool(), vact[row])


def _fold(op, acc, val, on):
    return torch.where(on, _apply(op, acc, val), acc)


def one_row_run(upd, on, op, ident, lo, hi, lanes, order=None):
    """The one-row walk of a run: lane v walks edges lo + v, lo + v +
    lanes, ... in order, folding the active ones (an inactive edge
    skipped), then the shuffle tree; returns lane 0's result (and records
    the edges each lane walks)."""
    acc = torch.full((lanes,), ident, dtype=upd.dtype)
    for t in range(lo, hi, lanes):
        e = torch.arange(t, t + lanes)
        ok = e < hi
        e = e.clamp(max=max(hi - 1, 0))
        acc = _fold(op, acc, upd[e], ok & on[e])
        if order is not None:
            for v in range(lanes):
                if ok[v]:
                    order.setdefault(v, []).append(int(e[v]))
    o = lanes // 2
    while o:
        acc = _apply(op, acc, torch.cat([acc[o:], acc[lanes - o:]]))
        o //= 2
    return acc[0]


def group_run(tile, word, src_s, eid_s, w, apply_op, op, lo, hi, lanes, order=None):
    """csrc/edge_stream.cu's walk_rows and reduce_rows for one group over one
    run, lane by lane: lane P * a + q (P = R / C lanes an edge, C = min(R, 4))
    holds virtual lanes A * j + a (A = lanes / P) for rows q * C + c; each
    folds its edges from the packed tile (row r's flag bit, or the identity
    the pack put there) with the shared weights ``w``; the tree pairs
    registers at offsets of at least A and lanes P * o apart below it.
    Returns the group's R results (and records the edges each (row,
    virtual lane) walks)."""
    n_v, group = tile.shape
    c_n = min(group, 4)
    p_n = group // c_n
    a_n = lanes // p_n
    ident = ref.identity(op, tile.dtype)
    acc = torch.full((lanes, p_n, c_n), ident, dtype=tile.dtype)
    for lane in range(lanes):
        a, q = divmod(lane, p_n)
        for j in range(p_n):
            v = a_n * j + a
            for e in range(lo + v, hi, lanes):
                s = int(src_s[e])
                for c in range(c_n):
                    row = q * c_n + c
                    if order is not None:
                        order.setdefault((row, v), []).append(e)
                    val = tile[s, row]
                    if apply_op != "src":
                        if not (int(word[s]) >> row) & 1:
                            continue
                        val = ref._apply(apply_op, val, w[eid_s[e]])
                    acc[lane, j, c] = _apply(op, acc[lane, j, c], val)
    o = lanes // 2
    while o:
        if o >= a_n:
            for j in range(p_n - o // a_n):
                acc[:, j] = _apply(op, acc[:, j], acc[:, j + o // a_n])
        else:
            src = torch.arange(lanes) + p_n * o
            src = torch.where(src < lanes, src, torch.arange(lanes))
            acc[:, 0] = _apply(op, acc[:, 0], acc[src, 0])
        o //= 2
    return acc[:p_n, 0].reshape(-1)


def _fold_chunks(out, partial, split):
    for j, b in enumerate(split.bins.tolist()):
        acc = torch.tensor(0.0)
        for c in range(split.first[j], split.first[j + 1]):
            acc = acc + partial[c]
        out[b] = acc
    return out


@pytest.mark.parametrize("k", [1, 2, 3, 7, 8, 9, 16, 33])
@pytest.mark.parametrize("apply_op", ["src", "add"])
def test_row_groups_fold_each_row_in_its_one_row_order(k, apply_op):
    """Every row of a K-row launch, walked by its group (K = 1: the one-row
    walk): the same edges in the same order for each (row, lane) as the
    one-row walk, and the same float + bits, item by item and after the
    chunks' fold; the one-row walk (inactive edges skipped) has the bits of
    emulate_split (their identity folded). Inputs: normal values with some
    -0.0, per-row flags, shared weights."""
    rng = np.random.default_rng(100 + k)
    counts = np.concatenate([[0, 2 * L + 17, L, 0, 0, 0], rng.integers(0, 40, 24),
                             rng.integers(0, 9, 16)])
    offsets = _offsets(counts)
    n_out = len(counts)
    n_v, n_e = 60, int(counts.sum())
    src_s = torch.from_numpy(rng.integers(0, n_v, n_e).astype(np.int32))
    eid_s = torch.from_numpy(rng.permutation(n_e).astype(np.int32))
    vval = torch.from_numpy(rng.normal(size=(k, n_v)).astype(np.float32))
    vval[torch.from_numpy(rng.random((k, n_v)) < 0.05)] = -0.0
    vact = torch.from_numpy(rng.random((k, n_v)) < 0.6)
    w = torch.from_numpy(rng.normal(size=n_e).astype(np.float32))
    eid, ww = (None, None) if apply_op == "src" else (eid_s, w)
    split = sr.split_bins(offsets, n_e)
    items = work_items(split, offsets, n_e)
    n_chunks = split.chunks.shape[0]
    one = {"out": torch.empty(k, n_out), "partial": torch.empty(k, n_chunks)}
    orders = {}
    for row in range(k):
        upd = ref._apply(apply_op, vval[row][src_s], None if ww is None else ww[eid])
        for (where, idx), _, lo, hi, lanes in items:
            order = orders.setdefault((row, where, idx), {})
            one[where][row, idx] = one_row_run(upd, vact[row][src_s], "+", 0.0, lo, hi, lanes,
                                               order)
        _fold_chunks(one["out"][row], one["partial"][row], split)
        sched, _ = emulate_split(vval[row], vact[row], src_s, eid, ww, offsets, apply_op, "+",
                                 split)
        assert torch.equal(one["out"][row].view(torch.int32), sched.view(torch.int32)), row
    if k == 1:
        return  # a one-row launch
    group = es.row_group(k)
    grouped = {"out": torch.empty(k, n_out), "partial": torch.empty(k, n_chunks)}
    for g in range(-(-k // group)):
        tile, word = pack_group(vval, vact, group, g, apply_op, "+")
        rows = range(g * group, min(k, (g + 1) * group))
        for (where, idx), _, lo, hi, lanes in items:
            order = {}
            got = group_run(tile, word, src_s, eid_s, w, apply_op, "+", lo, hi, lanes, order)
            for r, row in enumerate(rows):
                grouped[where][row, idx] = got[r]
                assert {v: order.get((r, v), []) for v in range(lanes)} == {
                    v: orders[row, where, idx].get(v, []) for v in range(lanes)}, (row, idx)
    for row in range(k):
        _fold_chunks(grouped["out"][row], grouped["partial"][row], split)
    for where in ("partial", "out"):
        assert torch.equal(grouped[where].view(torch.int32), one[where].view(torch.int32)), where
