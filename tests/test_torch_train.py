"""The port's training substrate held to the reference on the CPU, case for
case with the reference's ``tests/test_train.py``: optimizers, schedules,
microbatching, quantization, the straggler monitor, data determinism; and
one train step from the reference's carried weights and optimizer state.

The 8-bit moments are blocked per leaf, and the reference's leaves are
stacked across layers while the port's are per layer, so the quantized
state is compared on the same flat leaves (``_quant``/``_dequant`` bit for
bit, three ``apply_updates`` steps), and the quantized train step by its
own rule: the loss falls by more than 0.2 in 30 steps.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, strategies as st

from repro.configs import smoke_config as ref_smoke_config
from repro.data import SyntheticLM as RefSyntheticLM
from repro.distributed.compression import StragglerMonitor as RefStragglerMonitor
from repro.models import Model as RefModel
from repro.train import OptConfig as RefOptConfig
from repro.train import init_state as ref_init_state
from repro.train import make_train_step as ref_make_train_step
from repro.train import optimizer as ref_opt
from repro_torch.configs import smoke_config
from repro_torch.data import SyntheticLM
from repro_torch.distributed.compression import StragglerMonitor
from repro_torch.models import params_from_numpy
from repro_torch.models.convert import _flatten, opt_state_from_numpy
from repro_torch.train import OptConfig, init_state, make_train_step
from repro_torch.train import optimizer as opt_mod


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Smoke-size tensors gain nothing from intra-op threads; one thread
    keeps this file from oversubscribing the cores that the suite's
    parallel workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    cfg = smoke_config("qwen3-0.6b")
    ref_cfg = ref_smoke_config("qwen3-0.6b")
    params = jax.tree.map(np.asarray, RefModel(ref_cfg, dtype=jnp.float32)
                          .init(jax.random.PRNGKey(0)))
    data = SyntheticLM(cfg, seq_len=64, global_batch=8, seed=0)
    return cfg, params, data


def _model(cfg, params):
    return params_from_numpy(cfg, params, device="cpu", dtype=torch.float32)


def _batch(data, step):
    return {k: torch.from_numpy(v) for k, v in data.batch(step).items()}


@pytest.mark.parametrize("quantized", [False, True])
def test_training_reduces_loss(setup, quantized):
    cfg, params, data = setup
    model = _model(cfg, params)
    ocfg = OptConfig(lr=3e-3, warmup_steps=5, total_steps=60, quantized=quantized)
    state = init_state(dict(model.named_parameters()), ocfg)
    ts = make_train_step(model, ocfg, n_microbatches=2)
    l0 = lN = None
    for i in range(30):
        state, metrics = ts(state, _batch(data, i))
        if i == 0:
            l0 = float(metrics["loss"])
        lN = float(metrics["loss"])
    assert lN < l0 - 0.2, f"no learning: {l0} -> {lN}"


def test_microbatch_equivalence(setup):
    """Accumulated microbatch gradients == single-shot gradients on the
    same global batch."""
    cfg, params, data = setup
    model = _model(cfg, params)
    model.requires_grad_(True)
    b = _batch(data, 0)

    def grads(batch):
        model.zero_grad(set_to_none=True)
        model.loss(batch)[0].backward()
        return {n: p.grad.clone() for n, p in model.named_parameters()}

    g1 = grads(b)
    nm = 4
    acc = {n: torch.zeros_like(g) for n, g in g1.items()}
    for i in range(nm):
        gi = grads({k: v[i * 2:(i + 1) * 2] for k, v in b.items()})
        for n in acc:
            acc[n] += gi[n]
    for n, g in g1.items():
        np.testing.assert_allclose(g.numpy(), (acc[n] / nm).numpy(), rtol=1e-3, atol=1e-6,
                                   err_msg=n)


def test_lr_schedule_shape_and_reference():
    ocfg = OptConfig(lr=1e-3, warmup_steps=10, total_steps=100, min_lr_ratio=0.1)
    lrs = [float(opt_mod.lr_schedule(ocfg, s)) for s in [0, 5, 10, 50, 100]]
    assert lrs[0] == 0.0
    assert lrs[1] == pytest.approx(5e-4)
    assert lrs[2] == pytest.approx(1e-3, rel=0.2)
    assert lrs[3] < lrs[2]
    assert lrs[4] == pytest.approx(1e-4, rel=0.05)
    ref_cfg = RefOptConfig(lr=1e-3, warmup_steps=10, total_steps=100, min_lr_ratio=0.1)
    for s in range(0, 120, 3):
        want = float(ref_opt.lr_schedule(ref_cfg, jnp.int32(s)))
        assert float(opt_mod.lr_schedule(ocfg, s)) == pytest.approx(want, rel=1e-6, abs=1e-12)


def test_grad_clipping():
    ocfg = OptConfig(lr=1.0, grad_clip=1.0, warmup_steps=0, total_steps=1, weight_decay=0.0)
    params = {"w": torch.zeros(4)}
    grads = {"w": torch.full((4,), 100.0)}
    state = init_state(params, ocfg)
    opt_mod.apply_updates(params, grads, state, ocfg)
    # clipped global norm = 1 -> per-element grad 0.5 -> adam update ~ lr
    assert torch.isfinite(params["w"]).all()
    assert params["w"].abs().max() < 2.0
    ref_cfg = RefOptConfig(lr=1.0, grad_clip=1.0, warmup_steps=0, total_steps=1,
                           weight_decay=0.0)
    rp = {"w": jnp.zeros((4,), jnp.float32)}
    want, _ = ref_opt.apply_updates(rp, {"w": jnp.full((4,), 100.0)},
                                    ref_init_state(rp, ref_cfg), ref_cfg)
    np.testing.assert_array_equal(params["w"].numpy(), np.asarray(want["w"]))


@settings(max_examples=30, deadline=None)
@given(
    n=st.integers(1, 2000),
    power=st.sampled_from([2, 4]),
    seed=st.integers(0, 2**31 - 1),
    scale=st.floats(1e-6, 1e4),
)
def test_quantization_matches_reference(n, power, seed, scale):
    """The reference's property (per-element error <= power/127 *
    blockmax) holds, and codes, scales and dequantized values equal the
    reference's bit for bit."""
    r = np.random.default_rng(seed)
    x = (r.normal(size=n) * scale).astype(np.float32)
    if power == 4:
        x = np.abs(x)
    q, s = opt_mod._quant(torch.from_numpy(x), power=power)
    back = opt_mod._dequant(q, s, x.shape, power=power).numpy()
    bmax = np.maximum(opt_mod._blocks(torch.from_numpy(x)).abs().amax(dim=1).numpy(), 1e-20)
    tol = (power / 127.0) * np.repeat(bmax, opt_mod.QBLOCK)[:n] + 1e-12
    assert (np.abs(back - x) <= tol).all()
    rq, rs = ref_opt._quant(jnp.asarray(x), power=power)
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(rs))
    np.testing.assert_array_equal(back, np.asarray(ref_opt._dequant(rq, rs, x.shape,
                                                                    power=power)))


def test_quantization_preserves_sign_and_zero():
    x = torch.tensor([-1.0, 0.0, 1e-9, 5.0])
    q, s = opt_mod._quant(x, power=2)
    back = opt_mod._dequant(q, s, x.shape, power=2)
    assert back[0] < 0 and back[1] == 0 and back[3] > 0
    rq, rs = ref_opt._quant(jnp.asarray(x.numpy()), power=2)
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    np.testing.assert_array_equal(back.numpy(), np.asarray(ref_opt._dequant(rq, rs, (4,))))


@pytest.mark.parametrize("quantized", [False, True])
def test_apply_updates_matches_reference(quantized):
    """Three AdamW steps on the same flat leaves (one of them no multiple
    of the 256-element block): parameters and moments equal the
    reference's (float32 within 1e-6 relative; the int8 codes exactly)."""
    rng = np.random.default_rng(7)
    shapes = {"w": (40, 16), "b": (300,), "n": (5,)}
    p0 = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    kw = dict(lr=1e-2, warmup_steps=1, total_steps=10, quantized=quantized)
    ocfg, ref_cfg = OptConfig(**kw), RefOptConfig(**kw)
    params = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    state = init_state(params, ocfg)
    rp = {k: jnp.asarray(v) for k, v in p0.items()}
    rstate = ref_init_state(rp, ref_cfg)
    for _ in range(3):
        g = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
        state = opt_mod.apply_updates(params, {k: torch.from_numpy(v) for k, v in g.items()},
                                      state, ocfg)
        rp, rstate = ref_opt.apply_updates(rp, {k: jnp.asarray(v) for k, v in g.items()},
                                           rstate, ref_cfg)
    assert int(state["step"]) == int(rstate["step"]) == 3
    for k in shapes:
        np.testing.assert_allclose(params[k].numpy(), np.asarray(rp[k]), rtol=1e-6, atol=1e-7)
        for mom in ("m", "v"):
            got, want = state[mom][k], rstate[mom][k]
            if quantized:
                np.testing.assert_array_equal(got["q"].numpy(), np.asarray(want["q"]))
                np.testing.assert_allclose(got["scale"].numpy(), np.asarray(want["scale"]),
                                           rtol=1e-6)
            else:
                np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "qwen2-vl-2b", "hubert-xlarge"])
def test_synthetic_lm_matches_reference(arch):
    """Token and label batches (and a frontend config's embeddings) equal
    the reference's bit for bit, for several steps and shards."""
    cfg, ref_cfg = smoke_config(arch), ref_smoke_config(arch)
    ours, theirs = SyntheticLM(cfg, 24, 8, seed=3), RefSyntheticLM(ref_cfg, 24, 8, seed=3)
    for step, shard, shards in [(0, 0, 1), (17, 0, 1), (5, 1, 4), (5, 3, 4)]:
        a, b = ours.batch(step, shard, shards), theirs.batch(step, shard, shards)
        assert set(a) == set(b)
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


def test_straggler_monitor():
    for cls in (StragglerMonitor, RefStragglerMonitor):
        mon = cls(threshold=2.0, warmup=3)
        for _ in range(10):
            assert not mon.record(1.0)
        assert mon.record(5.0)  # 5x EWMA -> flagged
        assert mon.flags[-1]["action"] == "rebalance-or-replace"
        assert not mon.record(1.0)  # EWMA not poisoned by the straggler
        assert mon.ewma == pytest.approx(1.0, rel=0.05)


def test_data_determinism_and_restart_safety(setup):
    cfg = setup[0]
    d1 = SyntheticLM(cfg, 32, 4, seed=3)
    d2 = SyntheticLM(cfg, 32, 4, seed=3)
    b1 = d1.batch(17)
    b2 = d2.batch(17)  # a "restarted job" regenerating step 17
    for k in b1:
        np.testing.assert_array_equal(b1[k], b2[k])
    b3 = d1.batch(18)
    assert not np.array_equal(b1["labels"], b3["labels"])


def test_data_sharding_partitions_batch(setup):
    cfg = setup[0]
    d = SyntheticLM(cfg, 32, 8, seed=4)
    full_rows = [d.batch(5, shard=s, shards=4)["labels"] for s in range(4)]
    assert all(r.shape[0] == 2 for r in full_rows)
    assert not np.array_equal(full_rows[0], full_rows[1])


def test_train_step_from_carried_state_matches_reference(setup):
    """One reference step gives weights and a float32 AdamW state with
    nonzero moments; both carried across (params_from_numpy,
    opt_state_from_numpy), one more step (two microbatches) on each side:
    the loss, grad norm and lr, and every updated parameter, within
    1e-5."""
    cfg, params, data = setup
    ref_cfg = ref_smoke_config("qwen3-0.6b")
    ref_model = RefModel(ref_cfg, dtype=jnp.float32)
    kw = dict(lr=3e-3, warmup_steps=2, total_steps=10)
    ref_step = jax.jit(ref_make_train_step(ref_model, RefOptConfig(**kw), n_microbatches=2))
    rp = jax.tree.map(jnp.asarray, params)
    rstate = ref_init_state(rp, RefOptConfig(**kw))
    b0, b1 = (data.batch(i) for i in range(2))
    rp, rstate, _ = ref_step(rp, rstate, {k: jnp.asarray(v) for k, v in b0.items()})

    model = _model(cfg, jax.tree.map(np.asarray, rp))
    state = opt_state_from_numpy(cfg, jax.tree.map(np.asarray, rstate))
    assert int(state["step"]) == 1
    step = make_train_step(model, OptConfig(**kw), n_microbatches=2)
    state, metrics = step(state, {k: torch.from_numpy(v) for k, v in b1.items()})
    rp, rstate, rmetrics = ref_step(rp, rstate, {k: jnp.asarray(v) for k, v in b1.items()})
    for key in ("loss", "xent", "grad_norm", "lr"):
        assert float(metrics[key]) == pytest.approx(float(rmetrics[key]), rel=1e-5), key
    want = _flatten(jax.tree.map(np.asarray, rp))
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name], rtol=1e-5, atol=1e-5,
                                   err_msg=name)
    mom = _flatten(jax.tree.map(np.asarray, rstate["m"]))
    for name, m in state["m"].items():
        np.testing.assert_allclose(m.numpy(), mom[name], rtol=1e-4, atol=1e-7, err_msg=name)


def test_quantized_state_is_not_carried(setup):
    _, params, _ = setup
    rp = jax.tree.map(jnp.asarray, params)
    qstate = ref_init_state(rp, RefOptConfig(quantized=True))
    with pytest.raises(ValueError, match="8-bit"):
        opt_state_from_numpy(smoke_config("qwen3-0.6b"), jax.tree.map(np.asarray, qstate))


@pytest.mark.parametrize("remat", [False, True])
def test_train_step_sets_remat_both_ways(setup, remat):
    """``make_train_step(..., remat=)`` sets ``Model.remat`` to what it is
    given, whatever the model held before, and a step runs either way."""
    cfg, params, data = setup
    model = _model(cfg, params)
    model.remat = not remat
    ocfg = OptConfig(lr=1e-3, warmup_steps=1, total_steps=4)
    ts = make_train_step(model, ocfg, remat=remat)
    assert model.remat is remat
    _, metrics = ts(init_state(dict(model.named_parameters()), ocfg), _batch(data, 0))
    assert np.isfinite(float(metrics["loss"]))
