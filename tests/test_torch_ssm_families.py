"""The recurrent families held to the reference on the CPU: zamba2 (Mamba2
blocks in groups, each group followed by the one shared windowed
attention block) and xLSTM (mLSTM and sLSTM blocks).

The same weights (the reference's pytree, carried across by
``params_from_numpy``) and the same numpy-seeded tokens or activations go
through both packages in float32; on the CPU the port's attention kernel
runs its plain version. Tolerances as in ``tests/test_torch_models.py``:
logits within ``1e-4 * max(1, |logits|)``, generated token ids equal; a
single layer's output within ``1e-5 * max(1, |output|)``, and its caches
within 1e-5 (rtol and atol).
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
from repro.models import ssm as ref_ssm
from repro.models import xlstm as ref_xlstm
from repro_torch.configs import get_config, smoke_config
from repro_torch.launch import serve
from repro_torch.models import Model, params_from_numpy, ssm, xlstm
from repro_torch.models.convert import _flatten

LOGIT_RTOL = 1e-4
LAYER_TOL = 1e-5
ZAMBA, XLSTM = "zamba2-2.7b", "xlstm-125m"
#: the two families' models: zamba2, xlstm and xlstm with no sLSTM block run
FAMILIES = [(ZAMBA, {}), (XLSTM, {}), (XLSTM, {"slstm_every": 0})]
FAMILY_IDS = ["zamba2", "xlstm", "xlstm-mlstm-only"]


def _cfgs(arch: str, overrides: dict):
    ref_cfg, cfg = ref_smoke_config(arch), smoke_config(arch)
    if overrides:
        ref_cfg = dataclasses.replace(ref_cfg, **overrides)
        cfg = dataclasses.replace(cfg, **overrides)
    return ref_cfg, cfg


def _models(arch: str, overrides: dict, seed: int = 1):
    ref_cfg, cfg = _cfgs(arch, overrides)
    ref_m = RefModel(ref_cfg, dtype=jnp.float32)
    params = ref_m.init(jax.random.PRNGKey(seed))
    port = params_from_numpy(cfg, jax.tree.map(np.asarray, params), device="cpu",
                             dtype=torch.float32)
    return ref_cfg, ref_m, params, port


def _assert_logits_close(got: torch.Tensor, want, what: str):
    want = np.asarray(want)
    got = got.numpy()
    assert got.shape == want.shape, what
    err = float(np.abs(got - want).max())
    scale = max(1.0, float(np.abs(want).max()))
    assert err <= LOGIT_RTOL * scale, f"{what}: max |port - reference| {err} (scale {scale})"


def _tokens(cfg, b: int, s: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


def _torch_params(p) -> dict:
    return {k: torch.from_numpy(np.array(v)) for k, v in p.items()}


def _close(got: torch.Tensor, want, what: str = "", rtol: float = LAYER_TOL):
    """max |got - want| within ``rtol * max(1, max |want|)``."""
    want = np.asarray(want)
    assert got.shape == want.shape, what
    err = float(np.abs(got.numpy() - want).max())
    scale = max(1.0, float(np.abs(want).max()))
    assert err <= rtol * scale, f"{what}: max |port - reference| {err} (scale {scale})"


def _close_state(got: torch.Tensor, want, what: str):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=LAYER_TOL, atol=LAYER_TOL,
                               err_msg=what)


def _activations(cfg, b: int, s: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).normal(size=(b, s, cfg.d_model)).astype(np.float32)


# --------------------------------------------------------------------------
# Mamba2
# --------------------------------------------------------------------------


def _mamba_layer(seed: int = 2):
    cfg = ref_smoke_config(ZAMBA)
    p, _ = ref_ssm.mamba2_init(jax.random.PRNGKey(seed), cfg, jnp.float32)
    pt = _torch_params(p)
    assert set(pt) == set(ssm.mamba2_init(smoke_config(ZAMBA), torch.float32, "cpu"))
    return cfg, p, pt


@pytest.mark.parametrize("s,chunk,n_chunks", [(16, 256, 1), (48, 16, 3), (96, 16, 6),
                                              (40, 16, 5)])
def test_mamba2_forward_matches_reference(s, chunk, n_chunks):
    """The chunked SSD forward at one chunk and at several (the carry over
    chunks), and at a length the chunk does not divide (halved to 8)."""
    cfg, p, pt = _mamba_layer()
    assert s // ssm.chunk_len(s, chunk) == n_chunks
    x = _activations(cfg, 2, s, seed=s)
    want = ref_ssm.mamba2_forward(p, cfg, jnp.asarray(x), chunk=chunk)
    got = ssm.mamba2_forward(pt, smoke_config(ZAMBA), torch.from_numpy(x), chunk=chunk)
    _close(got, want, f"s={s} chunk={chunk}")


def test_mamba2_forward_stays_finite_under_strong_decay():
    """With ``dt_bias`` at 8 each step decays by ``dt * A`` of up to -16 x 8:
    across a 64-step chunk the log-decay spans thousands, so exp overflows
    above the diagonal. The port masks before the exp: the output stays
    finite and agrees with the reference (which masks with ``where``)
    within the models' 1e-4 of the scale: steps of dt ~ 8 scale every term
    ahead of the gated norm by 8."""
    cfg, p, pt = _mamba_layer(seed=3)
    p = dict(p, dt_bias=jnp.full_like(p["dt_bias"], 8.0))
    pt["dt_bias"] = torch.full_like(pt["dt_bias"], 8.0)
    x = _activations(cfg, 2, 128, seed=4)
    dt = torch.nn.functional.softplus(torch.from_numpy(x) @ pt["w_dt"] + pt["dt_bias"])
    span = (dt.reshape(2, 2, 64, -1) * torch.exp(pt["a_log"])).sum(dim=2)
    assert float(span.max()) > 1000.0  # exp(span) is inf in float32
    want = ref_ssm.mamba2_forward(p, cfg, jnp.asarray(x), chunk=64)
    got = ssm.mamba2_forward(pt, smoke_config(ZAMBA), torch.from_numpy(x), chunk=64)
    assert bool(torch.isfinite(got).all())
    _close(got, want, "strong decay", rtol=LOGIT_RTOL)


def test_mamba2_decode_matches_reference():
    """Step by step through the conv window and the SSM state, against the
    reference's decode, its final caches, and the port's own forward."""
    cfg, p, pt = _mamba_layer(seed=5)
    pcfg = smoke_config(ZAMBA)
    s = 12
    x = _activations(cfg, 2, s, seed=6)
    cache = ref_ssm.mamba2_init_cache(cfg, 2, jnp.float32)
    pcache = ssm.mamba2_init_cache(pcfg, 2, torch.float32, "cpu")
    assert pcache["state"].shape == cache["state"].shape  # [B, N, H, P]
    assert pcache["conv"].shape == cache["conv"].shape
    full = ssm.mamba2_forward(pt, pcfg, torch.from_numpy(x))
    for t in range(s):
        want_t, cache = ref_ssm.mamba2_decode(p, cfg, cache, jnp.asarray(x[:, t:t + 1]))
        got_t, pcache = ssm.mamba2_decode(pt, pcfg, pcache, torch.from_numpy(x[:, t:t + 1]))
        _close(got_t, want_t, f"t={t}")
        _close(got_t[:, 0], full[:, t].numpy(), f"decode vs forward t={t}")
    for name in ("conv", "state"):
        _close_state(pcache[name], cache[name], name)


# --------------------------------------------------------------------------
# mLSTM and sLSTM
# --------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_xlstm_layers_match_reference(kind):
    """A layer's forward over 24 positions and, step by step, its decode
    (the recurrent form, the caches in place) against the reference's; the
    caches end equal; the decode agrees with the forward."""
    cfg = ref_smoke_config(XLSTM)
    pcfg = smoke_config(XLSTM)
    ref_init, ref_fwd, ref_dec, ref_cache = (getattr(ref_xlstm, f"{kind}_{op}") for op in
                                              ("init", "forward", "decode", "init_cache"))
    fwd, dec, init_cache = (getattr(xlstm, f"{kind}_{op}") for op in
                            ("forward", "decode", "init_cache"))
    p, _ = ref_init(jax.random.PRNGKey(7), cfg, jnp.float32)
    pt = _torch_params(p)
    s = 24
    x = _activations(cfg, 2, s, seed=8)
    want = ref_fwd(p, cfg, jnp.asarray(x))
    got = fwd(pt, pcfg, torch.from_numpy(x))
    _close(got, want, "forward")
    cache, pcache = ref_cache(cfg, 2), init_cache(pcfg, 2, "cpu")
    for t in range(s):
        want_t, cache = ref_dec(p, cfg, cache, jnp.asarray(x[:, t:t + 1]))
        got_t, pcache = dec(pt, pcfg, pcache, torch.from_numpy(x[:, t:t + 1]))
        _close(got_t, want_t, f"decode t={t}")
        _close(got_t[:, 0], got[:, t].numpy(), f"decode vs forward t={t}")
    for name, arr in cache.items():
        _close_state(pcache[name], arr, name)


def test_xlstm_head_width_follows_dims():
    """The head width is d_model * ssm_expand / n_heads (384 at
    xlstm-125m), not cfg.head_dim (192)."""
    cfg = get_config(XLSTM)
    assert xlstm._dims(cfg) == ref_xlstm._dims(ref_get_config(XLSTM)) == (1536, 4, 384)
    assert cfg.head_dim == 192
    shapes = {k: tuple(v.shape) for k, v in xlstm.slstm_init(smoke_config(XLSTM), torch.float32,
                                                             "cpu").items()}
    assert shapes["w_h"] == (4, 64, 256)


# --------------------------------------------------------------------------
# whole models
# --------------------------------------------------------------------------


@pytest.mark.parametrize("arch,overrides", FAMILIES, ids=FAMILY_IDS)
def test_forward_matches_reference(arch, overrides):
    ref_cfg, ref_m, params, port = _models(arch, overrides)
    toks = _tokens(ref_cfg, 2, 48)
    want, want_aux = jax.jit(ref_m.forward)(params, {"tokens": jnp.asarray(toks)})
    got, aux = port.forward(torch.from_numpy(toks).long())
    _assert_logits_close(got, want, f"{arch} {overrides} forward")
    assert aux == {} and dict(want_aux) == {}


@pytest.mark.parametrize("arch,overrides", FAMILIES, ids=FAMILY_IDS)
def test_decode_matches_reference(arch, overrides):
    """Every decode step's logits (24 steps through the recurrent caches,
    and zamba2's per-group KV caches) agree with the reference's."""
    ref_cfg, ref_m, params, port = _models(arch, overrides, seed=2)
    toks = _tokens(ref_cfg, 2, 24, seed=3)
    cache, pcache = ref_m.init_cache(2, 24), port.init_cache(2, 24)
    dec = jax.jit(ref_m.decode_step)
    for t in range(24):
        want_t, cache = dec(params, cache, jnp.asarray(toks[:, t:t + 1]))
        got_t, pcache = port.decode_step(pcache, torch.from_numpy(toks[:, t:t + 1]).long())
        _assert_logits_close(got_t, want_t, f"{arch} {overrides} decode t={t}")
    assert pcache["pos"] == 24


@pytest.mark.parametrize("arch,overrides", FAMILIES, ids=FAMILY_IDS)
def test_generate_matches_reference(arch, overrides):
    """Greedy serving: the same 8 generated token ids after a 4-token prompt."""
    ref_cfg, ref_m, params, port = _models(arch, overrides, seed=3)
    prompts = _tokens(ref_cfg, 2, 4, seed=8)
    want = np.asarray(ref_serve.generate(ref_m, params, jnp.asarray(prompts), 8))
    got = serve.generate(port, torch.from_numpy(prompts).long(), 8)
    np.testing.assert_array_equal(got.numpy(), want)


def test_zamba2_ring_decodes_past_the_wrap():
    """zamba2's shared attention keeps a ring of ``window`` (32) slots per
    group: 48 teacher-forced steps wrap it at step 32. Each step's logits
    agree with the reference's and with the port's own windowed forward,
    and the rings end holding the reference's K and V slot for slot (within
    the logits' tolerance: a later group's K and V come after the earlier
    groups' layers)."""
    ref_cfg, ref_m, params, port = _models(ZAMBA, {}, seed=4)
    steps = 48
    toks = _tokens(ref_cfg, 1, steps, seed=9)
    cache, pcache = ref_m.init_cache(1, steps), port.init_cache(1, steps)
    g = len(port.mamba_groups)
    assert ref_cfg.sliding_window == 32 and len(pcache["attn"]) == g == 2
    assert all(kv["k"].shape[1] == 32 for kv in pcache["attn"])
    full, _ = port.forward(torch.from_numpy(toks).long())
    dec = jax.jit(ref_m.decode_step)
    for t in range(steps):
        want_t, cache = dec(params, cache, jnp.asarray(toks[:, t:t + 1]))
        got_t, pcache = port.decode_step(pcache, torch.from_numpy(toks[:, t:t + 1]).long())
        _assert_logits_close(got_t, want_t, f"ring decode t={t}")
        _assert_logits_close(got_t[:, 0], full[:, t].numpy(), f"decode vs forward t={t}")
    for group, kv in enumerate(pcache["attn"]):
        for name in ("k", "v"):
            _close(kv[name], cache["attn"][name][group], f"group {group} {name}",
                   rtol=LOGIT_RTOL)


# --------------------------------------------------------------------------
# parameters: constants, dtypes, the shared block
# --------------------------------------------------------------------------


@pytest.mark.parametrize("arch", [ZAMBA, XLSTM])
def test_init_gives_reference_constants_and_dtypes(arch):
    """In a bf16 model every parameter has the reference's name, shape and
    dtype (``w_dt``, ``a_log``, ``d_skip``, ``dt_bias``, ``wif`` and ``w_h``
    float32, the rest bf16); after ``init`` Mamba2's ``a_log`` is
    ``log(linspace(1, 16, H))``, ``d_skip`` ones and ``dt_bias``, ``conv_b``
    zeros, as the reference's, and the drawn weights have their scale."""
    ref_params = RefModel(ref_smoke_config(arch), dtype=jnp.bfloat16).init(jax.random.PRNGKey(0))
    model = Model(smoke_config(arch), dtype=torch.bfloat16, device="cpu")
    model.init(torch.Generator().manual_seed(0))
    want = _flatten(jax.tree.map(np.asarray, ref_params))
    got = dict(model.named_parameters())
    assert set(got) == set(want)
    f32 = {"w_dt", "a_log", "d_skip", "dt_bias", "wif", "w_h"}
    for name, p in got.items():
        assert tuple(p.shape) == want[name].shape, name
        assert str(p.dtype).split(".")[-1] == str(want[name].dtype), name
        assert (p.dtype == torch.float32) == (name.split(".")[-1] in f32), name
        leaf = name.split(".")[-1]
        if leaf in ("a_log", "d_skip", "dt_bias", "conv_b"):
            np.testing.assert_allclose(p.float().numpy(), want[name].astype(np.float32),
                                       rtol=1e-6, atol=0, err_msg=name)
    if arch == ZAMBA:
        w_dt = got["mamba_groups.0.0.mamba.w_dt"]
        assert abs(float(w_dt.std()) * model.cfg.d_model ** 0.5 - 1.0) < 0.1
        assert float(got["mamba_groups.1.1.mamba.a_log"][-1]) == pytest.approx(np.log(16.0))


def test_zamba2_holds_one_shared_attention_block():
    """At full config the port's parameter bytes equal the reference's
    abstract pytree's (one ``shared_attn`` tree, not one a group: 4.85 GB
    bf16), allocated but never drawn here; every group's call reads the
    same tensors."""
    cfg = get_config(ZAMBA)
    ref = RefModel(ref_get_config(ZAMBA), dtype=jnp.bfloat16).abstract_params()
    want = sum(int(np.prod(leaf.shape)) * leaf.dtype.itemsize for leaf in jax.tree.leaves(ref))
    model = Model(cfg, dtype=torch.bfloat16, device="cpu")
    assert model.param_bytes() == want
    shared = sum(p.numel() * p.element_size() for p in model.shared_attn.parameters())
    mamba = sum(p.numel() * p.element_size() for p in model.mamba_groups.parameters())
    head = sum(p.numel() * p.element_size() for name, p in model.named_parameters()
               if "." not in name)
    assert len(model.mamba_groups) == 9 and len(model.mamba_groups[0]) == 6
    assert want == mamba + shared + head
    assert sum(1 for name, _ in model.named_parameters() if name.startswith("shared_attn.")) \
        == len(dict(model.shared_attn.named_parameters()))


@pytest.mark.parametrize("arch,stack,leaf", [(ZAMBA, "mamba_groups", ("mamba", "w_z")),
                                             (XLSTM, "mlstm_groups", ("mlstm", "wq")),
                                             (XLSTM, "slstm_blocks", ("slstm", "w_h"))])
def test_params_from_numpy_rejects_a_mismatched_stack(arch, stack, leaf):
    """A stacked leaf cut short, or a missing one, raises, naming it."""
    _, _, params, _ = _models(arch, {})
    tree = jax.tree.map(np.asarray, params)
    sub = tree[stack][leaf[0]]
    sub[leaf[1]] = sub[leaf[1]][..., :3]
    with pytest.raises(ValueError, match=leaf[1]):
        params_from_numpy(smoke_config(arch), tree, device="cpu", dtype=torch.float32)
    del sub[leaf[1]]
    with pytest.raises(ValueError, match="names differ"):
        params_from_numpy(smoke_config(arch), tree, device="cpu", dtype=torch.float32)


# --------------------------------------------------------------------------
# the serving CLI
# --------------------------------------------------------------------------


@pytest.mark.parametrize("arch", [ZAMBA, XLSTM])
def test_serve_cli_serves_zamba2_and_xlstm_as_the_reference(arch, monkeypatch, capsys):
    """``--arch zamba2-2.7b --smoke`` and ``--arch xlstm-125m --smoke`` on
    the CPU, the model loaded with the reference's weights: the CLI's
    generated tokens are the reference's ``generate``'s on the same
    prompts, and it prints them."""
    ref_cfg, ref_m, params, _ = _models(arch, {}, seed=5)
    tree = jax.tree.map(np.asarray, params)

    def loaded(cfg, dtype, device):
        model = params_from_numpy(cfg, tree, device=device, dtype=dtype)
        model.init = lambda generator: model
        return model

    seen = []
    real_generate = serve.generate

    def recorded(model, prompts, gen_len, **kw):
        seen.append((prompts.numpy().copy(), real_generate(model, prompts, gen_len, **kw)))
        return seen[-1][1]

    monkeypatch.setattr(serve, "Model", loaded)
    monkeypatch.setattr(serve, "generate", recorded)
    assert serve.main(["--arch", arch, "--smoke", "--device", "cpu", "--batch", "2",
                       "--prompt-len", "4", "--gen-len", "5"]) == 0
    out = capsys.readouterr().out
    assert "generated (2, 5) tokens on cpu" in out
    prompts, got = seen[0]
    want = np.asarray(ref_serve.generate(ref_m, params, jnp.asarray(prompts), 5))
    np.testing.assert_array_equal(got.numpy(), want)
    assert str(want[:2]) in out


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_serve_cli_serves_every_token_config(arch, capsys):
    """Every config whose input is tokens serves through the CLI on the
    CPU (zamba2 and xlstm among them); hubert (encoder-only) and qwen2-vl
    (patch embeddings) are refused."""
    args = ["--arch", arch, "--smoke", "--device", "cpu", "--batch", "1", "--prompt-len", "2",
            "--gen-len", "2"]
    cfg = smoke_config(arch)
    if not cfg.has_decoder:
        with pytest.raises(SystemExit, match="encoder-only"):
            serve.main(args)
    elif cfg.frontend != "none":
        with pytest.raises(SystemExit, match="embeddings"):
            serve.main(args)
    else:
        assert serve.main(args) == 0
        assert "generated (1, 2) tokens on cpu" in capsys.readouterr().out
