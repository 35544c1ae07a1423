"""The attention families beyond the dense and GQA-MoE ones, held to the
reference on the CPU: deepseek-v2 (MLA, absorbed decode), h2o-danube-3
(sliding window, ring-buffer decode), qwen2-vl (M-RoPE, the vision
frontend stub) and hubert (the audio frontend stub, bidirectional,
encoder-only).

The same weights (the reference's ``Model.init`` pytree, carried across by
``params_from_numpy``) and the same numpy-seeded tokens or embeddings go
through both packages in float32; on the CPU the port's kernels run their
plain versions. Tolerances as in ``tests/test_torch_models.py``: logits
within ``1e-4 * max(1, |logits|)``, MoE ``drop_fraction`` exact and
``load_balance_loss`` within 1e-6, generated token ids equal. The port is
held to the reference mode by mode (forward against forward, decode
against decode): for an MoE model the two modes differ by the reference's
own capacity routing, so "decode matches forward" is checked per MLA
layer.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS
from repro.configs import smoke_config as ref_smoke_config
from repro.launch import serve as ref_serve
from repro.models import Model as RefModel
from repro.models import attention as ref_attn
from repro.models import layers as ref_layers
from repro.models import moe as ref_moe
from repro_torch.configs import smoke_config
from repro_torch.kernels import ref
from repro_torch.launch import serve
from repro_torch.models import Model, attention, layers, moe, params_from_numpy
from repro_torch.models.convert import _flatten

DECODERS = ["deepseek-v2-236b", "h2o-danube-3-4b", "qwen2-vl-2b"]
LOGIT_RTOL = 1e-4
STEPS = 16


def _ref_model(arch: str, seed: int = 1):
    cfg = ref_smoke_config(arch)
    m = RefModel(cfg, dtype=jnp.float32)
    return cfg, m, m.init(jax.random.PRNGKey(seed))


def _port_model(arch: str, params):
    return params_from_numpy(smoke_config(arch), jax.tree.map(np.asarray, params), device="cpu",
                             dtype=torch.float32)


def _assert_logits_close(got: torch.Tensor, want, what: str):
    want = np.asarray(want)
    got = got.numpy()
    assert got.shape == want.shape, what
    err = float(np.abs(got - want).max())
    scale = max(1.0, float(np.abs(want).max()))
    assert err <= LOGIT_RTOL * scale, f"{what}: max |port - reference| {err} (scale {scale})"


def _inputs(cfg, b: int, s: int, seed: int = 0) -> np.ndarray:
    """Token ids [B, S], or frame/patch embeddings [B, S, D] for a frontend config."""
    rng = np.random.default_rng(seed)
    if cfg.frontend != "none":
        return rng.normal(size=(b, s, cfg.d_model)).astype(np.float32)
    return rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


def _batch(cfg, x: np.ndarray) -> dict:
    return {"embeds" if cfg.frontend != "none" else "tokens": jnp.asarray(x)}


def _port_in(x: np.ndarray) -> torch.Tensor:
    t = torch.from_numpy(x)
    return t if t.is_floating_point() else t.long()


def _port_forward(port, cfg, x: np.ndarray):
    if cfg.frontend != "none":
        return port.forward(embeds=_port_in(x))
    return port.forward(_port_in(x))


# --------------------------------------------------------------------------
# what the port holds
# --------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_config_builds_with_the_reference_names_and_shapes(arch):
    """Every one of the ten configs builds on the CPU, and its parameters
    are the reference pytree's leaves, name for name and shape for shape
    (the stacked layer and group axes split into per-layer modules)."""
    cfg = smoke_config(arch)
    model = Model(cfg, dtype=torch.float32, device="cpu")
    assert hasattr(model, "frontend_proj") == (cfg.frontend != "none")
    ref = RefModel(ref_smoke_config(arch), dtype=jnp.float32).abstract_params()
    want = {name: tuple(leaf.shape) for name, leaf in _flatten(
        jax.tree.map(lambda leaf: np.empty(leaf.shape, np.float32), ref)).items()}
    got = {name: tuple(p.shape) for name, p in model.named_parameters()}
    assert got == want


# --------------------------------------------------------------------------
# whole models: forward, decode, generate
# --------------------------------------------------------------------------


@pytest.mark.parametrize("arch", DECODERS + ["hubert-xlarge"])
def test_forward_matches_reference(arch):
    """Forward logits over 16 tokens (embeddings for a frontend config)
    agree with the reference's; for deepseek-v2 its mean
    ``load_balance_loss`` too."""
    cfg, ref_m, params = _ref_model(arch)
    port = _port_model(arch, params)
    x = _inputs(cfg, 2, STEPS)
    want, want_aux = jax.jit(ref_m.forward)(params, _batch(cfg, x))
    got, aux = _port_forward(port, cfg, x)
    _assert_logits_close(got, want, f"{arch} forward")
    if cfg.moe:
        np.testing.assert_allclose(float(aux["load_balance_loss"]),
                                   float(want_aux["load_balance_loss"]), rtol=1e-6)
    else:
        assert aux == {} and dict(want_aux) == {}


@pytest.mark.parametrize("arch", DECODERS)
def test_decode_matches_reference(arch):
    """Every decode step's logits (16 steps through the KV or latent cache;
    one embedding a step for qwen2-vl) agree with the reference's."""
    cfg, ref_m, params = _ref_model(arch)
    port = _port_model(arch, params)
    x = _inputs(cfg, 2, STEPS, seed=3)
    cache, pcache = ref_m.init_cache(2, STEPS), port.init_cache(2, STEPS)
    dec = jax.jit(ref_m.decode_step)
    for t in range(STEPS):
        want_t, cache = dec(params, cache, jnp.asarray(x[:, t:t + 1]))
        got_t, pcache = port.decode_step(pcache, _port_in(x[:, t:t + 1]))
        _assert_logits_close(got_t, want_t, f"{arch} decode t={t}")
    assert pcache["pos"] == STEPS


@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "h2o-danube-3-4b"])
def test_generate_matches_reference(arch):
    """Greedy serving: the same 8 generated token ids after a 4-token
    prompt (the frontend configs take embeddings, not the CLI's tokens)."""
    cfg, ref_m, params = _ref_model(arch, seed=2)
    port = _port_model(arch, params)
    prompts = _inputs(cfg, 2, 4, seed=8)
    want = np.asarray(ref_serve.generate(ref_m, params, jnp.asarray(prompts), 8))
    got = serve.generate(port, torch.from_numpy(prompts).long(), 8)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n_groups,capacity_factor", [(0, 0.0), (2, 0.5)])
def test_deepseek_moe_matches_reference_with_drops(n_groups, capacity_factor):
    """deepseek-v2's MoE layer (a shared expert beside the routed ones):
    outputs, ``drop_fraction`` exactly and ``load_balance_loss`` within
    1e-6."""
    cfg = ref_smoke_config("deepseek-v2-236b")
    p, _ = ref_moe.moe_init(jax.random.PRNGKey(6), cfg, jnp.float32)
    x = np.random.default_rng(7).normal(size=(2, 32, cfg.d_model)).astype(np.float32)
    want, want_aux = ref_moe.moe_apply(p, cfg, jnp.asarray(x), capacity_factor, n_groups)
    pt = {k: torch.from_numpy(np.array(v)) for k, v in p.items()}
    got, aux = moe.moe_apply(pt, smoke_config("deepseek-v2-236b"), torch.from_numpy(x),
                             capacity_factor, n_groups)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    assert float(aux["drop_fraction"]) == float(want_aux["drop_fraction"])
    assert float(aux["drop_fraction"]) > 0.0 or n_groups == 0
    np.testing.assert_allclose(float(aux["load_balance_loss"]),
                               float(want_aux["load_balance_loss"]), rtol=1e-6)


# --------------------------------------------------------------------------
# h2o-danube: the ring buffer
# --------------------------------------------------------------------------


def test_ring_buffer_wraps_as_the_reference_does():
    """h2o-danube's smoke config (window 32) decodes 40 steps into a
    40-slot cache: the ring holds 32 slots and wraps at step 32. Each
    step's logits agree with the reference's, and after the last step
    every layer's ring holds the reference's K and V slot for slot."""
    cfg, ref_m, params = _ref_model("h2o-danube-3-4b", seed=4)
    port = _port_model("h2o-danube-3-4b", params)
    steps = 40
    toks = _inputs(cfg, 1, steps, seed=9)
    cache, pcache = ref_m.init_cache(1, steps), port.init_cache(1, steps)
    assert cfg.sliding_window == 32 and pcache["kv"][0]["k"].shape[1] == 32
    dec = jax.jit(ref_m.decode_step)
    for t in range(steps):
        want_t, cache = dec(params, cache, jnp.asarray(toks[:, t:t + 1]))
        got_t, pcache = port.decode_step(pcache, _port_in(toks[:, t:t + 1]))
        _assert_logits_close(got_t, want_t, f"ring decode t={t}")
    for layer, kv in enumerate(pcache["kv"]):
        for name in ("k", "v"):
            np.testing.assert_allclose(kv[name].numpy(), np.asarray(cache["kv"][name][layer]),
                                       rtol=1e-5, atol=1e-5, err_msg=f"layer {layer} {name}")


def test_sliding_window_decode_matches_its_own_forward_past_the_wrap():
    """Past the wrap the ring's decode still sees exactly the window: each
    of 48 teacher-forced steps agrees with the windowed forward's logits at
    that position."""
    cfg = smoke_config("h2o-danube-3-4b")
    model = Model(cfg, dtype=torch.float32, device="cpu").init(torch.Generator().manual_seed(0))
    toks = _port_in(_inputs(cfg, 2, 48, seed=10))
    full, _ = model.forward(toks)
    cache = model.init_cache(2, 48)
    for t in range(48):
        step, cache = model.decode_step(cache, toks[:, t:t + 1])
        err = float((step[:, 0] - full[:, t]).abs().max())
        assert err <= 1e-5 * max(1.0, float(full[:, t].abs().max())), (t, err)


# --------------------------------------------------------------------------
# qwen2-vl: M-RoPE
# --------------------------------------------------------------------------


@pytest.mark.parametrize("head_dim", [32, 128])
def test_mrope_matches_reference_with_distinct_sections(head_dim):
    """``apply_mrope`` and a whole M-RoPE attention layer with distinct t,
    h and w positions (the model's ``_inputs`` repeats one, so only here do
    the sections show), against the reference's."""
    assert layers.mrope_sections(head_dim) == ref_layers.mrope_sections(head_dim)
    rng = np.random.default_rng(head_dim)
    x = rng.normal(size=(2, 6, 3, head_dim)).astype(np.float32)
    pos = rng.integers(0, 50, size=(3, 2, 6)).astype(np.int32)
    assert not (pos[0] == pos[1]).all() and not (pos[1] == pos[2]).all()
    sections = layers.mrope_sections(head_dim)
    got = layers.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos), 1e6, sections)
    want = ref_layers.apply_mrope(jnp.asarray(x), jnp.asarray(pos), 1e6, sections)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    one = np.broadcast_to(pos[:1], pos.shape)  # equal t, h, w: plain RoPE
    np.testing.assert_allclose(
        layers.apply_mrope(torch.from_numpy(x), torch.from_numpy(one.copy()), 1e6,
                           sections).numpy(),
        layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos[0]), 1e6).numpy(),
        rtol=1e-6, atol=1e-6)

    # the layer: the reference masks by the t positions of row 0, the kernel by
    # the sequence order, so t is arange(S) there and h, w are distinct
    pos[0] = np.arange(6, dtype=np.int32)
    cfg = dataclasses.replace(ref_smoke_config("qwen2-vl-2b"), head_dim=head_dim)
    p, _ = ref_attn.gqa_init(jax.random.PRNGKey(1), cfg, jnp.float32)
    h = rng.normal(size=(2, 6, cfg.d_model)).astype(np.float32)
    want = ref_attn.gqa_forward(p, cfg, jnp.asarray(h), jnp.asarray(pos))
    pcfg = dataclasses.replace(smoke_config("qwen2-vl-2b"), head_dim=head_dim)
    pt = {k: torch.from_numpy(np.array(v)) for k, v in p.items()}
    got = attention.gqa_forward(pt, pcfg, torch.from_numpy(h), torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_mrope_sections_must_cover_half_the_head():
    x = torch.zeros(1, 2, 1, 32)
    with pytest.raises(ValueError, match="sections"):
        layers.apply_mrope(x, torch.zeros(3, 1, 2, dtype=torch.int32), 1e4, (4, 4, 4))


# --------------------------------------------------------------------------
# hubert: bidirectional, encoder-only
# --------------------------------------------------------------------------


def test_hubert_attends_both_ways_and_takes_embeddings():
    """A later frame changes an earlier frame's logits (no causal mask),
    and the model takes frame embeddings, not tokens."""
    cfg = smoke_config("hubert-xlarge")
    assert not cfg.causal and not cfg.has_decoder
    model = Model(cfg, dtype=torch.float32, device="cpu").init(torch.Generator().manual_seed(1))
    x = torch.from_numpy(_inputs(cfg, 1, 8, seed=2))
    a, _ = model.forward(embeds=x)
    y = x.clone()
    y[:, -1] += 1.0
    b, _ = model.forward(embeds=y)
    assert not torch.allclose(a[:, 0], b[:, 0])
    with pytest.raises(ValueError, match="embeds"):
        model.forward(torch.zeros(1, 8, dtype=torch.long))


# --------------------------------------------------------------------------
# MLA alone
# --------------------------------------------------------------------------


def _mla_layer(seed: int = 3):
    cfg = ref_smoke_config("deepseek-v2-236b")
    p, _ = ref_attn.mla_init(jax.random.PRNGKey(seed), cfg, jnp.float32)
    pt = {k: torch.from_numpy(np.array(v)) for k, v in p.items()}
    assert set(pt) == set(attention.mla_init(smoke_config("deepseek-v2-236b"), torch.float32,
                                             "cpu"))
    return cfg, p, pt


def test_mla_forward_and_absorbed_decode_match_reference():
    """``mla_forward`` and, step by step, the absorbed ``mla_decode`` (the
    reference's ``absorb=True``) agree with the reference's; after the last
    step the latent cache holds the reference's ``ckv`` and ``krope``; and
    the port's decode agrees with its own forward within 1e-5."""
    cfg, p, pt = _mla_layer()
    pcfg = smoke_config("deepseek-v2-236b")
    s = 12
    x = np.random.default_rng(11).normal(size=(2, s, cfg.d_model)).astype(np.float32)
    pos = np.tile(np.arange(s, dtype=np.int32), (2, 1))
    want = np.asarray(ref_attn.mla_forward(p, cfg, jnp.asarray(x), jnp.asarray(pos)))
    got = attention.mla_forward(pt, pcfg, torch.from_numpy(x), torch.from_numpy(pos)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    cache = ref_attn.mla_init_cache(cfg, 2, s, jnp.float32)
    pcache = attention.mla_init_cache(pcfg, 2, s, torch.float32, "cpu")
    assert pcache["ckv"].data_ptr() == pcache["latent"].data_ptr()
    scale = max(1.0, float(np.abs(want).max()))
    for t in range(s):
        want_t, cache = ref_attn.mla_decode(p, cfg, cache, jnp.asarray(x[:, t:t + 1]), t,
                                            absorb=True)
        got_t, pcache = attention.mla_decode(pt, pcfg, pcache, torch.from_numpy(x[:, t:t + 1]), t)
        np.testing.assert_allclose(got_t.numpy(), np.asarray(want_t), rtol=1e-5, atol=1e-5,
                                   err_msg=f"t={t}")
        assert float(np.abs(got_t.numpy()[:, 0] - got[:, t]).max()) <= 1e-5 * scale, t
    for name in ("ckv", "krope"):
        np.testing.assert_allclose(pcache[name].numpy(), np.asarray(cache[name]), rtol=1e-6,
                                   atol=1e-6)


def test_mla_calls_the_kernel_with_its_widths(monkeypatch):
    """The prefill is one call at (Dqk, Dv) = (hd + rope, v_head_dim) with
    as many kv heads as heads; the absorbed decode one at (kv_lora + rope,
    kv_lora) over one kv head whose values are a view of its keys; both
    scaled 1/sqrt(hd + rope)."""
    _, _, pt = _mla_layer()
    cfg = smoke_config("deepseek-v2-236b")
    calls = []
    real = attention.flash_attention

    def spy(q, k, v, causal=True, window=0, scale=None):
        calls.append((tuple(q.shape), tuple(k.shape), tuple(v.shape), v.data_ptr() == k.data_ptr(),
                      scale))
        return real(q, k, v, causal=causal, window=window, scale=scale)

    monkeypatch.setattr(attention, "flash_attention", spy)
    x = torch.from_numpy(np.random.default_rng(12).normal(size=(2, 5, cfg.d_model))
                         .astype(np.float32))
    attention.mla_forward(pt, cfg, x, torch.arange(5)[None].expand(2, 5))
    cache = attention.mla_init_cache(cfg, 2, 8, torch.float32, "cpu")
    attention.mla_decode(pt, cfg, cache, x[:, :1], 0)
    attention.mla_decode(pt, cfg, cache, x[:, 1:2], 1)
    h, hd, rhd, kvlr = cfg.n_heads, cfg.resolved_head_dim, cfg.rope_head_dim, cfg.kv_lora_rank
    scale = 1.0 / math.sqrt(hd + rhd)
    assert calls == [
        ((2, h, 5, hd + rhd), (2, h, 5, hd + rhd), (2, h, 5, cfg.resolved_v_head_dim), False,
         scale),
        ((2, h, 1, kvlr + rhd), (2, 1, 1, kvlr + rhd), (2, 1, 1, kvlr), True, scale),
        ((2, h, 1, kvlr + rhd), (2, 1, 2, kvlr + rhd), (2, 1, 2, kvlr), True, scale),
    ]


# --------------------------------------------------------------------------
# the plain attention with narrow values and a scale
# --------------------------------------------------------------------------


@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 3)])
def test_flash_attention_ref_takes_narrow_values_a_scale_and_a_view(causal, window):
    """Dv < Dqk, an explicit scale and values that are a view of the keys'
    first Dv columns (MLA's latent), against a numpy einsum."""
    rng = np.random.default_rng(13)
    b, h, hkv, lq, lk, dqk, dv, scale = 2, 4, 1, 3, 9, 24, 16, 0.37
    q = rng.normal(size=(b, h, lq, dqk)).astype(np.float32)
    k = rng.normal(size=(b, hkv, lk, dqk)).astype(np.float32)
    v = k[..., :dv]
    logits = np.einsum("bhqd,bkd->bhqk", q, k[:, 0]) * scale
    qp = np.arange(lq)[:, None] + lk - lq
    kp = np.arange(lk)[None, :]
    ok = np.ones((lq, lk), bool)
    if causal:
        ok &= kp <= qp
    if window:
        ok &= kp > qp - window
    logits = np.where(ok, logits, -np.inf)
    e = np.exp(logits - logits.max(-1, keepdims=True))
    want = np.einsum("bhqk,bkd->bhqd", e / e.sum(-1, keepdims=True), v[:, 0])
    kt = torch.from_numpy(k)
    got = ref.flash_attention_ref(torch.from_numpy(q), kt, kt[..., :dv], causal, window,
                                  scale=scale)
    assert got.shape == (b, h, lq, dv)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


# --------------------------------------------------------------------------
# the serving CLI
# --------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "h2o-danube-3-4b"])
def test_serve_cli_runs_mla_and_the_ring_on_the_cpu(arch, capsys):
    assert serve.main(["--arch", arch, "--smoke", "--device", "cpu", "--batch", "2",
                       "--prompt-len", "4", "--gen-len", "3"]) == 0
    assert "generated (2, 3) tokens on cpu" in capsys.readouterr().out


def test_serve_cli_refuses_the_frontend_configs():
    """hubert is encoder-only: both CLIs refuse it. qwen2-vl takes patch
    embeddings, which a token prompt is not: the reference's CLI fails
    inside its decode step, the port's refuses it up front."""
    args = ["--arch", "hubert-xlarge", "--smoke", "--batch", "1", "--prompt-len", "2",
            "--gen-len", "1"]
    for cli, extra in ((serve.main, ["--device", "cpu"]), (ref_serve.main, [])):
        with pytest.raises(SystemExit, match="encoder-only"):
            cli(args + extra)
    with pytest.raises(SystemExit, match="embeddings"):
        serve.main(["--arch", "qwen2-vl-2b", "--smoke", "--device", "cpu", "--batch", "1",
                    "--prompt-len", "2", "--gen-len", "1"])
    with pytest.raises(TypeError):
        ref_serve.main(["--arch", "qwen2-vl-2b", "--smoke", "--batch", "1", "--prompt-len", "2",
                        "--gen-len", "1"])
