"""The hand-written CUDA kernels and the port's main path on the card.

Every test here is marked ``gpu`` and skips without a CUDA device: a CUDA
kernel has no CPU mode. The file imports only ``torch``, numpy and the
port, so it runs on a machine without JAX:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Each kernel is held to its plain PyTorch version on the same inputs
(integer-valued, so every summation order is exact), and each program to
the same program on the CPU.
"""
import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.algorithms import sources
from repro_torch.graph import generators
from repro_torch.kernels import edge_stream as es
from repro_torch.kernels import ref
from repro_torch.kernels import shuffle_reduce as sr

SR_SHAPES = [(64, 16), (1000, 300), (4096, 512), (513, 1024), (7, 5)]
ES_SHAPES = [(128, 32), (3000, 400), (5000, 123)]
ALGORITHMS = {
    "bfs": ("BFS_ECP", {"root": 3}),
    "bfs_hybrid": ("BFS_HYBRID", {"root": 3}),
    "pagerank": ("PAGERANK", {"iters": 5}),
    "sssp": ("SSSP", {"root": 3}),
    "ppr": ("PPR", {"source": 3, "max_iters": 8}),
    "cgaw": ("CGAW", {}),
    "wcc": ("WCC", {}),
    "kcore": ("KCORE", {"k": 3}),
}
FLOAT_SUMS = {"pagerank", "ppr", "cgaw"}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return "cuda"


@pytest.mark.gpu
@pytest.mark.parametrize("op", ["+", "min", "max"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.int32])
def test_cuda_shuffle_reduce_matches_plain(cuda, op, dtype):
    gen = torch.Generator(device=cuda).manual_seed(0)
    for n, v in SR_SHAPES:
        idx = torch.randint(0, v + 10, (n,), generator=gen, device=cuda, dtype=torch.int32)
        vals = torch.randint(-50, 50, (n,), generator=gen, device=cuda).to(dtype)
        before = sr.LAUNCHES
        got = sr.shuffle_reduce(vals, idx, v, op)
        assert sr.LAUNCHES == before + 1
        assert torch.equal(got, ref.shuffle_reduce_ref(vals, idx, v, op))


@pytest.mark.gpu
@pytest.mark.parametrize("op", ["+", "min", "max"])
def test_cuda_offsets_past_the_stream_are_clamped(cuda, op):
    vals = torch.arange(40, dtype=torch.int32, device=cuda) - 7
    bad = torch.tensor([-5, 3, 10, 10, 38, 55, 90], dtype=torch.int32, device=cuda)
    good = bad.clamp(0, 40)
    got = sr.shuffle_reduce_sorted(vals, bad, 6, op)
    assert torch.equal(got, ref.segment_reduce_ref(vals, good, op))
    src_s = torch.arange(40, dtype=torch.int32, device=cuda) % 9
    vact = torch.arange(9, device=cuda) % 2 == 0
    vval = torch.arange(9, dtype=torch.int32, device=cuda) * 3
    got = es.edge_stream_gather(vval, vact, src_s, None, None, bad, "src", op)
    assert torch.equal(got, ref.edge_stream_gather_ref(vval, vact, src_s, None, None, good,
                                                       "src", op))


@pytest.mark.gpu
@pytest.mark.parametrize("apply_op", ["add", "mul", "src"])
@pytest.mark.parametrize("reduce_op", ["+", "min", "max"])
def test_cuda_edge_stream_matches_plain(cuda, apply_op, reduce_op):
    gen = torch.Generator(device=cuda).manual_seed(1)
    for e, v in ES_SHAPES:
        sv = torch.randint(-20, 20, (e,), generator=gen, device=cuda).float()
        w = torch.randint(-20, 20, (e,), generator=gen, device=cuda).float()
        dst = torch.randint(0, v, (e,), generator=gen, device=cuda, dtype=torch.int32)
        act = torch.rand(e, generator=gen, device=cuda) < 0.4
        before = es.LAUNCHES
        got = es.edge_stream(sv, w, dst, act, v, apply_op, reduce_op)
        assert es.LAUNCHES == before + 1
        assert torch.equal(got, ref.edge_stream_ref(sv, w, dst, act, v, apply_op, reduce_op))


@pytest.mark.gpu
@pytest.mark.parametrize("algo", list(ALGORITHMS))
def test_cuda_port_matches_cpu_port(cuda, algo):
    """The same program on the card (hand-written kernels) and on the CPU
    (plain versions) agree, and the kernels were launched (PAGERANK
    commits through ``edge_stream`` alone)."""
    g = generators.power_law(200, 1400, seed=5, weighted=True)
    name, params = ALGORITHMS[algo]
    prog = repro_torch.compile(getattr(sources, name))
    want = prog.bind(g, device="cpu").run(**params)
    before = sr.LAUNCHES + es.LAUNCHES
    got = prog.bind(g).run(**params)
    assert sr.LAUNCHES + es.LAUNCHES > before
    for prop, a in want.properties.items():
        if algo in FLOAT_SUMS and a.dtype == np.float32:
            np.testing.assert_allclose(got.properties[prop], a, rtol=1e-5, atol=1e-6)
        else:
            np.testing.assert_array_equal(got.properties[prop], a)
    assert got.host_env == want.host_env
    assert got.stats.kernel_launches == want.stats.kernel_launches
