"""The port's LM stack against the reference's, on the CPU.

The same weights (the reference's ``Model.init`` pytree, carried across by
``params_from_numpy``) and the same numpy-seeded tokens go through both
packages in float32; on the CPU the port's kernels run their plain
versions. Tolerances: logits within ``1e-4 * max(1, |logits|)`` (the two
sum in different orders; ``tests/test_models.py`` allows 2e-3 between its
own decode and forward), MoE ``drop_fraction`` exact and
``load_balance_loss`` within 1e-6, generated token ids equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS
from repro.configs import get_config as ref_get_config
from repro.configs import smoke_config as ref_smoke_config
from repro.launch import serve as ref_serve
from repro.models import Model as RefModel
from repro.models import layers as ref_layers
from repro.models import moe as ref_moe
from repro_torch.configs import get_config, smoke_config
from repro_torch.launch import serve
from repro_torch.models import Model, layers, moe, params_from_numpy

LM_ARCHS = ["qwen3-0.6b", "granite-20b", "deepseek-coder-33b", "kimi-k2-1t-a32b"]
LOGIT_RTOL = 1e-4


def _ref_model(arch: str, seed: int = 1, **overrides):
    cfg = ref_smoke_config(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    m = RefModel(cfg, dtype=jnp.float32)
    params = m.init(jax.random.PRNGKey(seed))
    return cfg, m, params


def _port_model(arch: str, params, **overrides):
    cfg = smoke_config(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return params_from_numpy(cfg, jax.tree.map(np.asarray, params), device="cpu",
                             dtype=torch.float32)


def _assert_logits_close(got: torch.Tensor, want, what: str):
    want = np.asarray(want)
    got = got.numpy()
    assert got.shape == want.shape, what
    err = float(np.abs(got - want).max())
    scale = max(1.0, float(np.abs(want).max()))
    assert err <= LOGIT_RTOL * scale, f"{what}: max |port - reference| {err} (scale {scale})"


def _tokens(cfg, b: int, s: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


# --------------------------------------------------------------------------
# configs
# --------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_configs_match_reference(arch):
    """The copied registry loads the port's own modules, with the same
    numbers."""
    cfg, ref = get_config(arch), ref_get_config(arch)
    assert type(cfg).__module__ == "repro_torch.configs.base"
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
    assert dataclasses.asdict(smoke_config(arch)) == dataclasses.asdict(ref_smoke_config(arch))
    assert cfg.param_count() == ref.param_count()


# --------------------------------------------------------------------------
# layers
# --------------------------------------------------------------------------


def test_rmsnorm_and_rope_match_reference():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 5, 3, 32)).astype(np.float32)
    w = rng.normal(size=(32,)).astype(np.float32)
    pos = np.tile(np.arange(5, dtype=np.int32), (2, 1))
    np.testing.assert_allclose(
        layers.rmsnorm(torch.from_numpy(x), torch.from_numpy(w), 1e-6).numpy(),
        np.asarray(ref_layers.rmsnorm(jnp.asarray(x), jnp.asarray(w), 1e-6)),
        rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6).numpy(),
        np.asarray(ref_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6)),
        rtol=1e-5, atol=1e-5)


def test_rmsnorm_casts_before_the_weight_in_bf16():
    """The reference normalises in float32, casts to the input dtype, then
    multiplies by the weight in that dtype."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(4, 64)).astype(np.float32)
    w = rng.normal(size=(64,)).astype(np.float32)
    want = np.asarray(ref_layers.rmsnorm(jnp.asarray(x, jnp.bfloat16),
                                         jnp.asarray(w, jnp.bfloat16)).astype(jnp.float32))
    got = layers.rmsnorm(torch.from_numpy(x).bfloat16(), torch.from_numpy(w).bfloat16())
    np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("gated", [True, False])
def test_mlp_matches_reference(gated):
    """Gated SwiGLU, and the plain MLP whose GELU is jax.nn.gelu's tanh form."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 3, 16)).astype(np.float32) * 2
    p = {"wi": rng.normal(size=(16, 24)).astype(np.float32),
         "wo": rng.normal(size=(24, 16)).astype(np.float32) * 0.2}
    if gated:
        p["wg"] = rng.normal(size=(16, 24)).astype(np.float32)
    want = ref_layers.mlp_apply({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), gated)
    got = layers.mlp_apply({k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x),
                           gated)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


# --------------------------------------------------------------------------
# MoE
# --------------------------------------------------------------------------


@pytest.mark.parametrize("n_groups,capacity_factor", [(0, 0.0), (1, 0.0), (2, 0.5), (4, 1.0)])
def test_moe_apply_matches_reference_with_drops(n_groups, capacity_factor):
    """Capacity overflow: the stable expert sort keeps the reference's
    tokens, so outputs and the drop fraction agree exactly in which
    assignments survive."""
    cfg = ref_smoke_config("kimi-k2-1t-a32b")
    p, _ = ref_moe.moe_init(jax.random.PRNGKey(4), cfg, jnp.float32)
    x = np.random.default_rng(5).normal(size=(2, 32, cfg.d_model)).astype(np.float32)
    want, want_aux = ref_moe.moe_apply(p, cfg, jnp.asarray(x), capacity_factor, n_groups)
    pt = {k: torch.from_numpy(np.array(v)) for k, v in p.items()}
    got, aux = moe.moe_apply(pt, smoke_config("kimi-k2-1t-a32b"), torch.from_numpy(x),
                             capacity_factor, n_groups)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    assert float(aux["drop_fraction"]) == float(want_aux["drop_fraction"])
    assert float(aux["drop_fraction"]) > 0.0 or n_groups == 0
    np.testing.assert_allclose(float(aux["load_balance_loss"]),
                               float(want_aux["load_balance_loss"]), rtol=1e-6)


def test_moe_dispatch_groups_match_reference():
    for t in (1, 2, 3, 4, 6, 64, 96, 4096, 4100):
        assert moe._dispatch_groups(t) == ref_moe._dispatch_groups(t), t


# --------------------------------------------------------------------------
# the model: forward, decode, generate
# --------------------------------------------------------------------------


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_forward_and_decode_match_reference(arch):
    """Forward logits, and every decode step's logits (16 steps through the
    KV cache), agree with the reference's; MoE aux metrics agree."""
    cfg, ref, params = _ref_model(arch)
    port = _port_model(arch, params)
    toks = _tokens(cfg, 2, 16)
    want, want_aux = jax.jit(ref.forward)(params, {"tokens": jnp.asarray(toks)})
    got, aux = port.forward(torch.from_numpy(toks).long())
    _assert_logits_close(got, want, f"{arch} forward")
    if cfg.moe:
        np.testing.assert_allclose(float(aux["load_balance_loss"]),
                                   float(want_aux["load_balance_loss"]), rtol=1e-6)
    else:
        assert aux == {} and dict(want_aux) == {}
    cache, pcache = ref.init_cache(2, 16), port.init_cache(2, 16)
    dec = jax.jit(ref.decode_step)
    for t in range(16):
        want_t, cache = dec(params, cache, jnp.asarray(toks[:, t:t + 1]))
        got_t, pcache = port.decode_step(pcache, torch.from_numpy(toks[:, t:t + 1]).long())
        _assert_logits_close(got_t, want_t, f"{arch} decode t={t}")
    assert pcache["pos"] == 16


def test_decode_past_the_buffer_matches_reference():
    """Past a full (non-ring) cache both overwrite the last slot."""
    cfg, ref, params = _ref_model("qwen3-0.6b")
    port = _port_model("qwen3-0.6b", params)
    toks = _tokens(cfg, 1, 7, seed=6)
    cache, pcache = ref.init_cache(1, 4), port.init_cache(1, 4)
    dec = jax.jit(ref.decode_step)
    for t in range(7):
        want, cache = dec(params, cache, jnp.asarray(toks[:, t:t + 1]))
        got, pcache = port.decode_step(pcache, torch.from_numpy(toks[:, t:t + 1]).long())
        _assert_logits_close(got, want, f"t={t}")


def test_sliding_window_forward_matches_reference():
    """The kernel's window mask through a whole model (h2o-danube's window
    of 32 at the smoke size, over 48 tokens)."""
    cfg, ref, params = _ref_model("h2o-danube-3-4b")
    port = _port_model("h2o-danube-3-4b", params)
    toks = _tokens(cfg, 1, 48, seed=7)
    want, _ = jax.jit(ref.forward)(params, {"tokens": jnp.asarray(toks)})
    got, _ = port.forward(torch.from_numpy(toks).long())
    _assert_logits_close(got, want, "h2o-danube forward")
    # its decode keeps the reference's ring of min(max_len, window) slots
    # (held to the reference step by step in tests/test_torch_lm_families.py)
    assert port.init_cache(1, 48)["kv"][0]["k"].shape == (1, 32, cfg.n_kv_heads, cfg.head_dim)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_generate_matches_reference(arch):
    """Greedy serving: the same 8 generated token ids after a 4-token
    prompt."""
    cfg, ref, params = _ref_model(arch, seed=2)
    port = _port_model(arch, params)
    prompts = _tokens(cfg, 2, 4, seed=8)
    want = np.asarray(ref_serve.generate(ref, params, jnp.asarray(prompts), 8))
    got = serve.generate(port, torch.from_numpy(prompts).long(), 8)
    np.testing.assert_array_equal(got.numpy(), want)


def test_sampled_generate_is_seeded():
    model = Model(smoke_config("qwen3-0.6b"), dtype=torch.float32, device="cpu")
    model.init(torch.Generator().manual_seed(0))
    prompts = torch.from_numpy(_tokens(model.cfg, 2, 3)).long()
    a = serve.generate(model, prompts, 6, greedy=False, seed=5)
    b = serve.generate(model, prompts, 6, greedy=False, seed=5)
    assert torch.equal(a, b) and a.shape == (2, 6)


def test_init_draws_scaled_normals_from_the_generator():
    cfg = smoke_config("kimi-k2-1t-a32b")
    a = Model(cfg, dtype=torch.float32, device="cpu").init(torch.Generator().manual_seed(3))
    b = Model(cfg, dtype=torch.float32, device="cpu").init(torch.Generator().manual_seed(3))
    for (name, pa), pb in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(pa, pb), name
    assert torch.equal(a.final_norm, torch.ones(cfg.d_model))
    wi = a.blocks[0].moe["wi"]  # [E, D, F], scale 1/sqrt(D)
    assert abs(float(wi.std()) * cfg.d_model ** 0.5 - 1.0) < 0.05
    assert a.blocks[0].moe["router"].dtype == torch.float32
    c = Model(cfg, dtype=torch.float32, device="cpu").init(torch.Generator().manual_seed(4))
    assert not torch.equal(a.embed, c.embed)


def test_chunked_init_fills_every_slice(monkeypatch):
    """A weight larger than one draw is filled slice by slice, every
    element drawn."""
    monkeypatch.setattr(layers, "INIT_CHUNK_ELEMS", 100)
    p = layers.weight((7, 30), 0.5, torch.float32, "cpu")
    p.data.fill_(float("nan"))
    layers.init_normal_(p, 0.5, torch.Generator().manual_seed(0))
    assert torch.isfinite(p).all() and float(p.std()) > 0.3


def test_params_from_numpy_rejects_a_mismatched_tree():
    cfg, _, params = _ref_model("qwen3-0.6b")
    tree = jax.tree.map(np.asarray, params)
    tree["embed"] = tree["embed"][:, :8]
    with pytest.raises(ValueError, match="embed"):
        params_from_numpy(smoke_config("qwen3-0.6b"), tree, device="cpu", dtype=torch.float32)
    del tree["embed"]
    with pytest.raises(ValueError, match="names differ"):
        params_from_numpy(smoke_config("qwen3-0.6b"), tree, device="cpu", dtype=torch.float32)


def test_model_without_device_needs_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: Model() without a device uses it")
    with pytest.raises(Exception, match="no CUDA device"):
        Model(smoke_config("qwen3-0.6b"), dtype=torch.float32)


# --------------------------------------------------------------------------
# the serving CLI
# --------------------------------------------------------------------------


def test_serve_cli_runs_on_the_cpu(capsys):
    assert serve.main(["--arch", "kimi-k2-1t-a32b", "--smoke", "--device", "cpu", "--batch",
                       "2", "--prompt-len", "4", "--gen-len", "3"]) == 0
    assert "generated (2, 3) tokens on cpu" in capsys.readouterr().out


def test_serve_cli_refuses_graph_and_a_missing_gpu(tmp_path, capsys):
    # graph serving: the local and the distributed backend serve, an
    # unknown backend is refused
    for backend in ("local", "distributed"):
        assert serve.main(["--graph", "bfs", "--device", "cpu", "--queries", "2",
                           "--vertices", "200", "--edges", "1000", "--backend", backend,
                           "--artifact-dir", str(tmp_path)]) == 0
        out = capsys.readouterr().out
        assert "answered 2 queries" in out and f"{backend} backend" in out
    with pytest.raises(SystemExit):
        serve.main(["--graph", "bfs", "--device", "cpu", "--backend", "mesh"])
    if not torch.cuda.is_available():
        with pytest.raises(Exception, match="no CUDA device"):
            serve.main(["--smoke"])
        with pytest.raises(Exception, match="no CUDA device"):
            serve.main(["--graph", "bfs", "--queries", "1", "--vertices", "200",
                        "--edges", "1000", "--artifact-dir", str(tmp_path)])
