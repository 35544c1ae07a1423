"""shuffle_reduce's schedule: work lists on every route, bins by length.

The CUDA kernel (``csrc/shuffle_reduce.cu``) walks a work list's chunks
(bins longer than ``SPLIT_LEN`` cut from their own start), then the bins in
groups of 32: a bin of at most ``LANE_LEN`` updates is one lane's alone,
in stream order; middle bins of at most ``QUAD_LEN`` take 8 lanes each,
four at a time, and longer ones the whole warp, one after another (lanes
side by side, then a shuffle tree); the long bins are left to their
chunks, whose partials a second pass folds in chunk order. Every route
hands it a list without reading anything back to the host: the bind's
``split_bins`` for the full stream, ``one_bin_split`` for a broadcast
(stride-0) index, and the fixed-shape ``launch_split`` for any other
stream. These tests emulate that schedule in plain torch and check that
it covers every update of every bin once, in order, in runs of at most
``SPLIT_LEN``; that it depends on a bin's length alone, not on where the
bin sits; and that it gives what the plain version gives: exactly for
int32, ``min`` and ``max``, and for float32 ``+`` within the bound of two
summation orders, ``2 * (n_b + 5) * 2^-24 * sum|v|`` per bin. The kernel
itself runs only on the card (``tests/test_torch_gpu.py``).
"""
import math
import re

import numpy as np
import pytest
import torch

import repro
import repro_torch
from repro.algorithms import sources as ref_sources
from repro.graph import generators as ref_generators
from repro_torch.algorithms import sources
from repro_torch.kernels import _build, ref
from repro_torch.kernels import shuffle_reduce as sr

from _hypothesis_compat import given, settings, strategies as st

L = sr.SPLIT_LEN
LANE_LEN, QUAD_LEN = 64, 256  # csrc/shuffle_reduce.cu: kLaneLen, kQuadLen
LANES = {"lane": 1, "quad": 8, "warp": 32}  # lanes that walk a run, by mode


def _offsets(counts, start: int = 0) -> torch.Tensor:
    return torch.tensor(np.concatenate([[start], start + np.cumsum(counts, dtype=np.int64)]),
                        dtype=torch.int32)


def schedule(offsets: torch.Tensor, n_stream: int, split):
    """The kernel's runs, in the order it takes them, as ``(slot, bin, lo,
    hi, mode)``: slot ``("partial", k)`` for chunk slot k, ``("out", b)``
    for a whole bin; mode ``"lane"`` (one lane, in stream order), ``"quad"``
    (8 lanes) or ``"warp"`` (32 lanes), lanes side by side and a shuffle
    tree. Then the folds:
    ``(bin, [chunk slots in chunk order])`` per split bin."""
    off = offsets.clamp(0, n_stream).tolist()
    n_out = len(off) - 1
    runs = []
    chunks = [] if split is None else split.chunks.tolist()
    for k, (b, c) in enumerate(chunks):
        if b < 0 or b >= n_out or c < 0:
            continue  # an unused slot
        lo, hi = off[b], off[b + 1]
        runs.append((("partial", k), b, min(lo + c * L, hi), min(lo + (c + 1) * L, hi), "warp"))
    for b0 in range(0, n_out, 32):
        group = range(b0, min(b0 + 32, n_out))
        n = {b: max(0, off[b + 1] - off[b]) for b in group}
        runs += [(("out", b), b, off[b], off[b] + n[b], "lane") for b in group if n[b] <= LANE_LEN]
        runs += [(("out", b), b, off[b], off[b] + n[b], "quad") for b in group
                 if LANE_LEN < n[b] <= QUAD_LEN]
        runs += [(("out", b), b, off[b], off[b] + n[b], "warp") for b in group
                 if QUAD_LEN < n[b] <= L]
    folds = []
    if split is not None:
        for b, f in zip(split.bins.tolist(), split.first.tolist()):
            if 0 <= b < n_out and off[b + 1] - off[b] > L:
                folds.append((b, list(range(f, f + -(-(off[b + 1] - off[b]) // L)))))
    return runs, folds


def _apply(op, a, b):
    return {"+": torch.add, "min": torch.minimum, "max": torch.maximum}[op](a, b)


def _run(vals: torch.Tensor, op: str, ident, mode: str) -> torch.Tensor:
    """One run: a lane folding it in order, or a group of 8 or 32 lanes
    (lane l folds elements l, l + lanes, ... in order) and the
    __shfl_down_sync tree, which leaves the group's first lane with the
    result."""
    acc = torch.tensor(ident, dtype=vals.dtype)
    if mode == "lane":
        for x in vals:
            acc = _apply(op, acc, x)
        return acc
    lanes = LANES[mode]
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


def emulate(vals: torch.Tensor, offsets: torch.Tensor, op: str, split) -> torch.Tensor:
    """The kernel's schedule in plain torch: every run, chunk partials into
    a scratch buffer, then each split bin's partials folded in chunk order
    from the identity."""
    ident = ref.identity(op, vals.dtype)
    runs, folds = schedule(offsets, vals.shape[0], split)
    out = torch.full((offsets.shape[0] - 1,), 7, dtype=vals.dtype)  # every bin is written
    written = set()
    partial = {}
    for (where, k), b, lo, hi, mode in runs:
        r = _run(vals[lo:hi], op, ident, mode)
        if where == "partial":
            partial[k] = r
        else:
            out[b] = r
            written.add(b)
    for b, slots in folds:
        acc = torch.tensor(ident, dtype=vals.dtype)
        for k in slots:
            acc = _apply(op, acc, partial[k])
        out[b] = acc
        written.add(b)
    assert written == set(range(out.shape[0]))
    return out


BOUNDARY = [0, L - 1, L, L + 1, 0, 2 * L, 2 * L + 1, 0, 3 * L + 5, 1, 0, LANE_LEN,
            LANE_LEN + 1, QUAD_LEN, QUAD_LEN + 1]
CASES = {
    "boundaries": (_offsets(BOUNDARY), None),
    # the last bins run past the stream and clamp; a negative first offset clamps to 0
    "past_the_stream": (torch.cat([torch.tensor([-7], dtype=torch.int32),
                                   _offsets(BOUNDARY)[1:]]), sum(BOUNDARY[:6]) + 40),
    "hub_among_short_bins": (_offsets([5, 0, 9, 10 * L + 3] + [3, 0, 31, 65, 200] * 20), None),
    "one_bin_holds_the_stream": (_offsets([0, 0, 7 * L + 3, 0]), None),
    "no_bin_split": (_offsets([0, 7, L, 1, L]), None),
    "many_empty_bins": (_offsets([0] * 300 + [3 * L] + [0] * 200), None),
    "no_bins": (torch.zeros(1, dtype=torch.int32), 0),
}


def _case(case):
    offsets, n_stream = CASES[case]
    return offsets, int(offsets[-1]) if n_stream is None else n_stream


def _lists(offsets, n_stream):
    """The lists the routes hand the kernel for this stream: the bind's and
    the per-launch one (a stride-0 stream is a case of its own)."""
    return {"per_bind": sr.split_bins(offsets, n_stream),
            "per_launch": sr.launch_split(offsets, n_stream)}


@pytest.mark.parametrize("route", ["per_bind", "per_launch"])
@pytest.mark.parametrize("case", list(CASES))
def test_schedule_covers_every_update_once_in_order(case, route):
    offsets, n_stream = _case(case)
    split = _lists(offsets, n_stream)[route]
    off = offsets.clamp(0, n_stream).tolist()
    n = [max(0, off[b + 1] - off[b]) for b in range(len(off) - 1)]
    runs, folds = schedule(offsets, n_stream, split)
    assert all(hi - lo <= L for _, _, lo, hi, _ in runs)
    # the chunk slots come first, so the heaviest items start first
    kinds = [where for (where, _), *_ in runs]
    assert kinds == sorted(kinds, key=lambda w: w != "partial")
    assert [b for b, _ in folds] == [b for b in range(len(n)) if n[b] > L]
    covered = {b: [] for b in range(len(n))}
    by_slot = {k: (lo, hi) for (where, k), _, lo, hi, _ in runs if where == "partial"}
    for (where, _), b, lo, hi, _ in runs:
        if where == "out":
            covered[b].extend(range(lo, hi))
    for b, slots in folds:
        for k in slots:
            covered[b].extend(range(*by_slot[k]))
    for b in range(len(n)):
        assert covered[b] == list(range(off[b], off[b] + n[b])), b


@pytest.mark.parametrize("case", list(CASES))
def test_launch_list_has_fixed_shapes_and_holds_the_bind_list(case):
    offsets, n_stream = _case(case)
    _check_launch_list(offsets, n_stream)


def _check_launch_list(offsets, n_stream):
    got = sr.launch_split(offsets, n_stream)
    want = sr.split_bins(offsets, n_stream)
    w = sr.split_windows(n_stream)
    assert w == (-(-n_stream // L) if n_stream > L else 0)
    assert got.chunks.shape == (2 * w, 2) and got.bins.shape == (w,)
    assert got.first.shape == (w + 1,)
    assert got.chunks.dtype == got.bins.dtype == got.first.dtype == torch.int32
    # its used slots, in slot order, are split_bins' list
    used = got.chunks[:, 0] >= 0
    assert torch.equal(got.chunks[used], want.chunks)
    assert torch.equal(got.bins[got.bins >= 0], want.bins)
    assert bool((got.chunks[~used] == -1).all())
    off = offsets.clamp(0, n_stream)
    for j, b in enumerate(got.bins.tolist()):
        if b >= 0:
            k = -(-int(off[b + 1] - off[b]) // L)
            f = int(got.first[j])
            assert got.chunks[f:f + k].tolist() == [[b, c] for c in range(k)]
    # what the CUDA kernel does, thread by thread, gives the same list
    assert emulate_list_kernel(offsets, n_stream) == (got.chunks.tolist(), got.bins.tolist(),
                                                      got.first.tolist())


def emulate_list_kernel(offsets: torch.Tensor, n_stream: int):
    """``shuffle_reduce_list_kernel`` thread by thread, on lists filled with
    -1: each long bin writes split slot ``w`` (its start's window) and chunk
    slots ``2w + c``. Asserts that no slot is written twice and that every
    slot lies inside the fixed shapes (the layout's two claims)."""
    key = offsets.clamp(0, n_stream).tolist()
    w = sr.split_windows(n_stream)
    chunks, bins = [[-1, -1] for _ in range(2 * w)], [-1] * w
    for b in range(len(key) - 1):
        n = key[b + 1] - key[b]
        if n <= L:
            continue
        win, k = key[b] // L, -(-n // L)
        assert 2 * win + k <= 2 * w and bins[win] == -1
        bins[win] = b
        for c in range(k):
            assert chunks[2 * win + c] == [-1, -1]
            chunks[2 * win + c] = [b, c]
    return chunks, bins, [2 * v for v in range(w + 1)]


@settings(max_examples=200, deadline=None)
@given(counts=st.lists(st.one_of(st.integers(0, 40), st.integers(L - 2, 3 * L + 3),
                                 st.integers(0, 9 * L)), max_size=30),
       start=st.integers(-3 * L, 0), cut=st.integers(0, 4 * L))
def test_launch_list_matches_split_bins_on_drawn_offsets(counts, start, cut):
    """Offsets drawn with long bins among short ones, a negative start and
    a stream that ends before the last offsets (they clamp)."""
    offsets = _offsets(counts, start)
    _check_launch_list(offsets, max(0, int(offsets[-1]) - cut))


@pytest.mark.parametrize("n", [1, L - 1, L, L + 1, 3 * L, 524_288])
def test_stride0_list_is_sized_on_the_host(n):
    one = torch.tensor(5, dtype=torch.int32).expand(n)
    split = sr.one_bin_split(one, n)
    if n <= L:
        assert split is None  # one bin of at most L updates is not split
        return
    k = -(-n // L)
    assert split.chunks.tolist() == [[5, c] for c in range(k)]
    assert split.bins.tolist() == [5] and split.first.tolist() == [0, k]
    _, offsets = sr.route(one, 9)
    runs, folds = schedule(offsets, n, split)
    assert folds == [(5, list(range(k)))]
    assert sum(hi - lo for _, b, lo, hi, _ in runs if b == 5) == n


def _stream(rng, dtype, counts, n_out=None):
    offsets = _offsets(counts)
    n = int(offsets[-1])
    if dtype == torch.int32:
        vals = torch.from_numpy(rng.integers(-2**20, 2**20, n).astype(np.int32))
    else:
        vals = torch.from_numpy(rng.normal(size=n).astype(np.float32))
    return vals, offsets


def _check_against_plain(got, vals, offsets, op):
    want = ref.segment_reduce_ref(vals, offsets, op)
    if vals.dtype == torch.float32 and op == "+":
        ids = ref.bin_ids(offsets).long()
        n_b = torch.bincount(ids, minlength=got.shape[0]).double()
        abs_sum = torch.zeros(got.shape[0], dtype=torch.float64).index_add_(
            0, ids, vals.abs().double())
        tol = 2.0 * (n_b + 5.0) * 2.0**-24 * abs_sum
        assert bool(((got.double() - want.double()).abs() <= tol).all())
    else:
        assert torch.equal(got, want)


SKEW = [0, 6 * L + 17, L - 1, L, L + 1, 0, 2 * L, 2 * L + 1, LANE_LEN, LANE_LEN + 1, QUAD_LEN,
        QUAD_LEN + 1, 0]


@pytest.mark.parametrize("route", ["per_bind", "per_launch"])
@pytest.mark.parametrize("dtype", [torch.int32, torch.float32])
@pytest.mark.parametrize("op", ["+", "min", "max"])
def test_schedule_matches_the_plain_version(route, dtype, op):
    rng = np.random.default_rng(11)
    counts = np.concatenate([SKEW, rng.integers(0, 90, 200)])
    vals, offsets = _stream(rng, dtype, counts)
    split = _lists(offsets, vals.shape[0])[route]
    modes = {mode for *_, mode in schedule(offsets, vals.shape[0], split)[0]}
    assert modes == {"lane", "quad", "warp"}
    _check_against_plain(emulate(vals, offsets, op, split), vals, offsets, op)


@pytest.mark.parametrize("dtype", [torch.int32, torch.float32])
@pytest.mark.parametrize("op", ["+", "min", "max"])
def test_stride0_schedule_matches_the_plain_version(dtype, op):
    """The one-bin counter: every update into one bin, with its host-sized list."""
    rng = np.random.default_rng(12)
    n = 9 * L + 31
    one = torch.tensor(2, dtype=torch.int32).expand(n)
    vals = _stream(rng, dtype, [n])[0]
    _, offsets = sr.route(one, 6)
    _check_against_plain(emulate(vals, offsets, op, sr.one_bin_split(one, n)), vals, offsets, op)


@pytest.mark.parametrize("length", [0, 1, LANE_LEN, LANE_LEN + 1, QUAD_LEN + 1, L, L + 1,
                                    4 * L + 9])
@pytest.mark.parametrize("route", ["per_bind", "per_launch"])
def test_a_bin_sums_the_same_wherever_it_sits(length, route):
    """Which lanes sum a bin, and in what order, follows from its length:
    the same float values give the same bits after any other bins."""
    rng = np.random.default_rng(length)
    bin_vals = torch.from_numpy(rng.normal(size=length).astype(np.float32))
    got = set()
    for before in ([], [3], [L + 7, 0, 40], [5 * L + 1, 100, 2], list(rng.integers(0, 70, 50))):
        counts = list(before) + [length] + [9, 2 * L]
        vals = torch.from_numpy(rng.normal(size=sum(counts)).astype(np.float32))
        pos = int(sum(before))
        vals[pos:pos + length] = bin_vals
        offsets = _offsets(counts)
        split = _lists(offsets, vals.shape[0])[route]
        mode = {m for _, b, *_, m in schedule(offsets, vals.shape[0], split)[0]
                if b == len(before)}
        got.add((emulate(vals, offsets, "+", split)[len(before)].view(torch.int32).item(),
                 tuple(mode)))
    assert len(got) == 1


GRAPH_ALGORITHMS = {
    "BFS_ECP": {"root": 3}, "BFS_HYBRID": {"root": 3}, "PAGERANK": {"iters": 5},
    "SSSP": {"root": 3}, "PPR": {"source": 3, "max_iters": 8}, "CGAW": {}, "WCC": {},
    "KCORE": {"k": 3},
}


@pytest.mark.parametrize("name", list(GRAPH_ALGORITHMS))
def test_engine_hands_the_bind_list_and_keeps_the_launch_counts(name, monkeypatch):
    """Every commit along the bind's full stream hands shuffle_reduce the
    bind's own work list, and the launch counters equal the reference's."""
    g = ref_generators.power_law(200, 1400, seed=5, weighted=True)
    tg = repro_torch.graph_from_arrays(g.n_vertices, g.src, g.dst, g.weights,
                                       n_vertices_logical=g.n_vertices_logical,
                                       n_edges_logical=g.n_edges_logical)
    want = repro.compile(getattr(ref_sources, name)).bind(g).run(**GRAPH_ALGORITHMS[name])
    sess = repro_torch.compile(getattr(sources, name)).bind(tg, device="cpu")
    gb = sess.engine.gb
    seen = []
    inner = sr.shuffle_reduce_sorted

    def recording(vals, offsets, n_out, op, split=None):
        if offsets is gb["dst_offsets"]:
            seen.append(split)
        return inner(vals, offsets, n_out, op, split)

    monkeypatch.setattr(sr, "shuffle_reduce_sorted", recording)
    got = sess.run(**GRAPH_ALGORITHMS[name])
    assert all(s is gb["es_split"] for s in seen)
    if name in ("CGAW", "WCC", "KCORE"):  # the programs that commit along the full stream
        assert seen
    for key in ("kernel_launches", "compacted_launches", "full_launches", "fused_launches"):
        assert getattr(got.stats, key) == getattr(want.stats, key), key


def test_shuffle_reduce_source_has_no_atomics():
    """No atomics on results and no atomic ticket: each bin's (or chunk's)
    result comes from one lane or one warp in a fixed order and the chunks
    are folded in chunk order, so a float + gives the same bits on every
    run."""
    text = (_build.CSRC / "shuffle_reduce.cu").read_text()
    assert not re.search(r"atomic[A-Z]|\batom\.|\bred\.", text)
    assert f"kLaneLen = {LANE_LEN};" in text and f"kQuadLen = {QUAD_LEN};" in text


def test_windows_depend_on_the_stream_length_alone():
    for n in (0, 1, L, L + 1, 2 * L, 4_194_304):
        assert sr.split_windows(n) == (math.ceil(n / L) if n > L else 0)
