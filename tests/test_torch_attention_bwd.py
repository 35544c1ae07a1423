"""The gradients of the port's two kernels held to the reference on the CPU.

On the CPU :class:`FlashAttentionFn` and :class:`MoeGatherFn` run their
plain twins, ``ref.flash_attention_bwd_ref`` (an explicit formula, no
autograd) and ``ref.moe_gather_bwd_ref``. The attention twin is held to
``jax.vjp`` of the reference's ``kernels/ref.py::flash_attention_ref``
(scale ``1/sqrt(Dqk)``) within ``1e-5`` of the gradient's scale; the
gather's transpose to the reference's ``moe_scatter_ref`` (``rows=None``)
and to torch autograd of the port's ``moe_gather_ref`` (with rows); both
Functions pass ``torch.autograd.gradcheck`` in float64. The tensor-core
backward's numerics (P from the forward's log-sum-exp, P and dS rounded
to bf16 before their products) are modelled by
``ref.flash_attention_bwd_sm90_ref``, held to ``jax.vjp`` on bf16-valued
inputs; the log-sum-exp the plain forward gives, to
``jax.nn.logsumexp``. The CUDA kernels are held to these twins on the
card by ``tests/test_torch_gpu.py``, which imports no JAX.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import moe_dispatch as md
from repro_torch.kernels import ref
from repro_torch.models import moe as moe_mod

RTOL = 1e-5
# (b, h, hkv, lq, lk, dqk, dv, causal, window): causal, windowed,
# bidirectional, GQA, Dv < Dqk (MLA), Lq < Lk (a query block at the end)
CASES = [(2, 4, 4, 32, 32, 16, 16, True, 0), (1, 4, 1, 40, 40, 32, 32, True, 8),
         (2, 2, 2, 24, 24, 16, 16, False, 0), (1, 6, 2, 33, 33, 24, 16, True, 0),
         (1, 4, 2, 12, 50, 32, 32, True, 0), (1, 4, 4, 20, 20, 48, 32, True, 5)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Smoke-size tensors gain nothing from intra-op threads; one thread
    keeps this file from oversubscribing the cores that the suite's
    parallel workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ids(c):
    return "x".join(map(str, c[:7])) + ("-causal" if c[7] else "-bidir") + (
        f"-w{c[8]}" if c[8] else "")


def _inputs(case, seed=0, dtype=np.float32):
    b, h, hkv, lq, lk, dqk, dv, _, _ = case
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(dtype) for s in
            [(b, h, lq, dqk), (b, hkv, lk, dqk), (b, hkv, lk, dv), (b, h, lq, dv)]]


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_attention_bwd_twin_matches_jax_vjp(case):
    causal, window = case[7], case[8]
    q, k, v, dout = _inputs(case)
    out_j, vjp = jax.vjp(lambda a, b, c: jref.flash_attention_ref(a, b, c, causal, window),
                         jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(dout))
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, dout))
    out = ref.flash_attention_ref(tq, tk, tv, causal, window)
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j), rtol=RTOL, atol=RTOL)
    got = ref.flash_attention_bwd_ref(tq, tk, tv, out, tdo, causal, window)
    for name, a, w in zip("qkv", got, want):
        w = np.asarray(w)
        assert a.shape == w.shape, name
        np.testing.assert_allclose(a.numpy(), w, rtol=RTOL, atol=RTOL * np.abs(w).max(),
                                   err_msg=name)


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_flash_attention_fn_autograd_equals_twin(case):
    """``flash_attention`` on tensors that require a gradient goes through
    FlashAttentionFn; ``backward`` gives the twin's gradients, and without
    a gradient nothing records a graph."""
    causal, window = case[7], case[8]
    q, k, v, dout = (torch.from_numpy(a) for a in _inputs(case, seed=1))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = fa.flash_attention(*leaves, causal=causal, window=window)
    assert out.grad_fn is not None and "FlashAttentionFn" in type(out.grad_fn).__name__
    out.backward(dout)
    want = ref.flash_attention_bwd_ref(q, k, v, out.detach(), dout, causal, window)
    for leaf, w in zip(leaves, want):
        assert torch.equal(leaf.grad, w)
    with torch.no_grad():
        assert fa.flash_attention(*leaves, causal=causal, window=window).grad_fn is None


@pytest.mark.parametrize("causal,window,hkv,dv,lq", [(True, 0, 2, 6, 5), (True, 3, 1, 6, 7),
                                                     (False, 0, 4, 4, 5), (True, 0, 2, 6, 9)])
def test_flash_attention_fn_gradcheck(causal, window, hkv, dv, lq):
    """Numerical gradients in float64 at tiny shapes (GQA, a window, Dv <
    Dqk, bidirectional, rows with no key when Lq > Lk)."""
    gen = torch.Generator().manual_seed(0)
    q = torch.randn(1, 4, lq, 6, generator=gen, dtype=torch.float64, requires_grad=True)
    k = torch.randn(1, hkv, 7, 6, generator=gen, dtype=torch.float64, requires_grad=True)
    v = torch.randn(1, hkv, 7, dv, generator=gen, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda a, b, c: fa.FlashAttentionFn.apply(a, b, c, causal, window, 0.5), (q, k, v))


def _binned(rng, e, c, d, aligned: bool = True):
    """The reference tests' dispatch layout: sizes per expert, offsets at
    multiples of 8 slots (or packed), a sorted-token table [T, D]."""
    sizes = np.minimum(rng.multinomial(e * c // 2, np.ones(e) / e), c).astype(np.int32)
    span = ((sizes + 7) // 8) * 8 if aligned else sizes
    offs = np.zeros(e, np.int32)
    offs[1:] = np.cumsum(span)[:-1]
    n_tok = int(offs[-1] + span[-1])
    return offs, sizes, n_tok


@pytest.mark.parametrize("e,c,d,aligned", [(8, 16, 8, True), (4, 32, 16, False),
                                           (16, 8, 4, True)])
def test_moe_gather_bwd_twin_matches_moe_scatter_ref(e, c, d, aligned):
    rng = np.random.default_rng(e + c)
    offs, sizes, n_tok = _binned(rng, e, c, d, aligned)
    dout = rng.standard_normal((e, c, d)).astype(np.float32)
    want = np.asarray(jref.moe_scatter_ref(jnp.asarray(dout), jnp.asarray(offs),
                                           jnp.asarray(sizes), n_tok))
    got = ref.moe_gather_bwd_ref(torch.from_numpy(dout)[None], None,
                                 torch.from_numpy(offs)[None], torch.from_numpy(sizes)[None],
                                 c, n_tok)[0]
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("g,t,e,k,cap", [(2, 24, 4, 2, 6), (4, 16, 8, 3, 8), (1, 40, 6, 2, 20)])
def test_moe_gather_bwd_twin_matches_autograd_of_gather_ref(g, t, e, k, cap):
    """With the MoE layer's rows (each token's k assignments, sorted by
    expert, some dropped at capacity): the twin equals autograd of the
    plain gather, and MoeGatherFn's backward equals the twin bit for bit."""
    gen = torch.Generator().manual_seed(g * t)
    top_e = torch.rand(g, t, e, generator=gen).topk(k, dim=-1).indices
    _, order, offsets, sizes = moe_mod.route(top_e, e, cap)
    offsets, sizes = offsets.to(torch.int32), sizes.to(torch.int32)
    rows = (order // k).to(torch.int32)
    x = torch.randn(g, t, 5, generator=gen, requires_grad=True)
    dout = torch.randn(g, e, cap, 5, generator=gen)
    (want,) = torch.autograd.grad(ref.moe_gather_ref(x, rows, offsets, sizes, cap), x, dout)
    twin = ref.moe_gather_bwd_ref(dout, rows, offsets, sizes, cap, t)
    torch.testing.assert_close(twin, want, rtol=1e-6, atol=1e-6)
    out = md.moe_gather(x, offsets, sizes, cap, rows)
    assert "MoeGatherFn" in type(out.grad_fn).__name__
    out.backward(dout)
    assert torch.equal(x.grad, twin)


def test_moe_gather_fn_gradcheck():
    gen = torch.Generator().manual_seed(5)
    top_e = torch.rand(2, 6, 3, generator=gen).topk(2, dim=-1).indices
    _, order, offsets, sizes = moe_mod.route(top_e, 3, 3)
    rows = (order // 2).to(torch.int32)
    x = torch.randn(2, 6, 4, generator=gen, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda a: md.moe_gather(a, offsets.to(torch.int32), sizes.to(torch.int32), 3, rows), (x,))


# ---------------------------------------------------------------------------
# The tensor-core backward's numerics (csrc/flash_attention_bwd_sm90.cu),
# modelled by ref.flash_attention_bwd_sm90_ref with the forward's lse
# (ref.attention_lse_ref), on bf16-valued inputs
# ---------------------------------------------------------------------------

# CASES, and a GQA group of 8 and Lq > Lk under a causal mask (the first
# eight rows see no key)
SM90_CASES = CASES + [(1, 8, 1, 24, 24, 32, 32, True, 0), (1, 4, 2, 20, 12, 32, 16, True, 0)]
#: the model against jax.vjp, both on the same bf16-valued inputs: max over
#: rows of max |err| / max(rms(row), 1e-2 rms(tensor)) (the card's rule).
#: What differs is the model's two bf16 roundings (P before dV, dS before
#: dK and dQ; 2^-9 relative each) summed over a row's keys: the worst row
#: reads ~1.2e-2 at these sizes, a dropped key tile 0.7-3.9
SM90_MODEL_TOL = 2e-2
GRAD_ROW_FLOOR = 1e-2


def _row_rel(got, want) -> float:
    g, w = np.asarray(got, np.float64), np.asarray(want, np.float64)
    rms = np.sqrt((w ** 2).mean(axis=-1))
    floor = GRAD_ROW_FLOOR * np.sqrt((w ** 2).mean())
    return float((np.abs(g - w).max(axis=-1) / np.maximum(np.maximum(rms, floor), 1e-30)).max())


def _bf16_inputs(case, seed=0):
    """q, k, v, dout of ``case`` rounded to bf16 values (float32 arrays)."""
    return [torch.from_numpy(a).bfloat16().float().numpy() for a in _inputs(case, seed)]


def _empty_rows(case) -> int:
    """Leading query rows that see no key: under a causal mask, the rows at
    negative positions when Lq > Lk."""
    lq, lk, causal = case[3], case[4], case[7]
    return max(0, lq - lk) if causal else 0


@pytest.mark.parametrize("case", SM90_CASES, ids=_ids)
def test_attention_lse_matches_jax_logsumexp(case):
    """The plain forward's log-sum-exp (log2 domain, as the kernel writes
    it) times ln(2) is jax.nn.logsumexp of the masked scaled scores within
    float32 rounding; a row that sees no key has +inf (its P is 0)."""
    b, h, hkv, lq, lk, dqk, _, causal, window = case
    q, k, _, _ = _bf16_inputs(case)
    logits = jnp.einsum("bhqd,bhkd->bhqk", q, jnp.repeat(k, h // hkv, axis=1)) / np.sqrt(dqk)
    qpos = jnp.arange(lq)[:, None] + lk - lq
    kpos = jnp.arange(lk)[None, :]
    mask = jnp.ones((lq, lk), bool)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    want = np.asarray(jax.nn.logsumexp(jnp.where(mask, logits, -jnp.inf), axis=-1))
    got = ref.attention_lse_ref(torch.from_numpy(q), torch.from_numpy(k), causal, window).numpy()
    assert got.shape == (b, h, lq) and got.dtype == np.float32
    n0 = _empty_rows(case)
    assert np.all(got[:, :, :n0] == np.inf) and np.isfinite(got[:, :, n0:]).all()
    np.testing.assert_allclose(got[:, :, n0:] * np.log(2), want[:, :, n0:], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("case", SM90_CASES, ids=_ids)
def test_attention_bwd_sm90_model_matches_jax_vjp(case):
    """The model of the tensor-core backward against jax.vjp of the
    reference's attention on bf16-valued inputs, within SM90_MODEL_TOL by
    the row-relative rule; dq of a row that sees no key is 0. The model
    takes the reference's own float32 output, so delta is that of the
    function jax differentiates (on the card the kernels and the plain twin
    share the kernel's bf16 output)."""
    causal, window = case[7], case[8]
    q, k, v, dout = _bf16_inputs(case)
    n0 = _empty_rows(case)
    out_j, vjp = jax.vjp(lambda a, b, c: jref.flash_attention_ref(a, b, c, causal, window),
                         jnp.asarray(q[:, :, n0:]), jnp.asarray(k), jnp.asarray(v))
    want = [np.asarray(w) for w in vjp(jnp.asarray(dout[:, :, n0:]))]
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, dout))
    out = ref.flash_attention_ref(tq, tk, tv, causal, window)
    np.testing.assert_allclose(out[:, :, n0:].numpy(), np.asarray(out_j), rtol=RTOL, atol=RTOL)
    lse = ref.attention_lse_ref(tq, tk, causal, window)
    dq, dk, dv = ref.flash_attention_bwd_sm90_ref(tq, tk, tv, out, tdo, lse, causal, window)
    assert dq.shape == tq.shape and dk.shape == tk.shape and dv.shape == tv.shape
    assert torch.all(dq[:, :, :n0] == 0)
    errs = {"dq": _row_rel(dq[:, :, n0:], want[0]), "dk": _row_rel(dk, want[1]),
            "dv": _row_rel(dv, want[2])}
    assert all(e <= SM90_MODEL_TOL for e in errs.values()), errs


@pytest.mark.parametrize("case", SM90_CASES, ids=_ids)
def test_attention_bwd_sm90_model_control_fails(case):
    """The control: the model with a tile of 16 keys dropped from P (at
    these sizes a key tile) fails the rule the sound model passes, in every
    one of dq, dk and dv."""
    causal, window, lk = case[7], case[8], case[4]
    q, k, v, dout = _bf16_inputs(case)
    n0 = _empty_rows(case)
    _, vjp = jax.vjp(lambda a, b, c: jref.flash_attention_ref(a, b, c, causal, window),
                     jnp.asarray(q[:, :, n0:]), jnp.asarray(k), jnp.asarray(v))
    want = [np.asarray(w) for w in vjp(jnp.asarray(dout[:, :, n0:]))]
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, dout))
    out = ref.flash_attention_ref(tq, tk, tv, causal, window)
    lse = ref.attention_lse_ref(tq, tk, causal, window)
    keys = (max(0, lk // 2 - 8), lk // 2 + 8)
    dq, dk, dv = ref.flash_attention_bwd_sm90_ref(tq, tk, tv, out, tdo, lse, causal, window,
                                                  drop_keys=keys)
    errs = {"dq": _row_rel(dq[:, :, n0:], want[0]), "dk": _row_rel(dk, want[1]),
            "dv": _row_rel(dv, want[2])}
    assert all(e > SM90_MODEL_TOL for e in errs.values()), errs
