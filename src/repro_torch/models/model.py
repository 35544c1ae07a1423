"""Model assembly: all ten architectures behind one interface.

The port of the reference's ``models/model.py``: the dense, MoE, vision
and audio configs (qwen3-0.6b, granite-20b, deepseek-coder-33b, kimi-k2,
deepseek-v2 with MLA, h2o-danube-3 with the sliding window and its
ring-buffer decode, qwen2-vl with M-RoPE and the vision frontend stub,
hubert with the audio frontend stub, bidirectional and encoder-only),
zamba2 (Mamba2 with one shared attention block) and xlstm (mLSTM and
sLSTM). Per-layer modules replace the reference's stacked axes; the names
are the reference's, so ``blocks.3.attn.wq`` is layer 3 of its
``params["blocks"]["attn"]["wq"]`` and ``mamba_groups.2.5.mamba.w_xbc``
block 5 of group 2 of its ``params["mamba_groups"]["mamba"]["w_xbc"]``.
Layer order is the reference's:

* dense, vlm, audio: ``blocks`` (attention + MLP) ``n_layers`` times;
* moe: ``dense_blocks`` (the first ``first_dense_layers``), then ``blocks``
  (attention + MoE);
* hybrid (zamba2): ``n_layers // attn_every`` groups, each ``attn_every``
  Mamba2 blocks (``mamba_groups``) followed by the ONE ``shared_attn``
  block (attention + MLP): one weight set, a KV cache per group;
* ssm (xlstm): ``n_layers // slstm_every`` groups, each ``slstm_every -
  1`` mLSTM blocks (``mlstm_groups``) and one sLSTM block
  (``slstm_blocks``); ``slstm_every = 0`` is one group of ``n_layers``
  mLSTM blocks, whose sLSTM block is built and never run, as in the
  reference.

A frontend config (``cfg.frontend != "none"``) takes precomputed patch or
frame embeddings ``[B, S, D]`` through ``frontend_proj`` where the others
look tokens up in ``embed``, as the reference's stubs do.

The public surface:
    Model(cfg, dtype, device)           weights allocated, not drawn
    init(generator)                     draw every weight (in slices)
    forward(tokens=None, embeds=None)   (logits, aux) for a whole sequence
    init_cache(batch, max_len)          KV, latent or recurrent caches, ``pos`` = 0
    decode_step(cache, tokens)          one-token serve step -> (logits, cache);
                                        a frontend config takes embeds [B, 1, D]

Every attention call goes through the hand-written flash kernel and every
MoE dispatch through the hand-written gather kernel (on a CUDA device;
their plain versions on the CPU). The Mamba2 and xLSTM recurrences are
plain PyTorch, as the reference's are plain JAX. ``device=None`` means
``"cuda"`` and raises without a GPU, as ``bind()`` does.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from ..configs.base import ArchConfig
from ..core.session import resolve_device
from . import attention as attn
from . import moe as moe_mod
from . import ssm as ssm_mod
from . import xlstm as xlstm_mod
from .layers import init_normal_, mlp_apply, mlp_init, rmsnorm, weight

Cache = Dict[str, object]

#: a recurrent block's (init, forward, decode) by its kind
RECURRENT = {
    "mamba": (ssm_mod.mamba2_init, ssm_mod.mamba2_forward, ssm_mod.mamba2_decode),
    "mlstm": (xlstm_mod.mlstm_init, xlstm_mod.mlstm_forward, xlstm_mod.mlstm_decode),
    "slstm": (xlstm_mod.slstm_init, xlstm_mod.slstm_forward, xlstm_mod.slstm_decode),
}


def _xlstm_groups(cfg: ArchConfig) -> Tuple[int, int]:
    """(groups, mLSTM blocks a group) of an xLSTM config."""
    if not cfg.slstm_every:
        return 1, cfg.n_layers  # one group, all mLSTM, no sLSTM run
    if cfg.n_layers % cfg.slstm_every:
        raise ValueError(f"{cfg.name}: n_layers {cfg.n_layers} is not a multiple of "
                         f"slstm_every {cfg.slstm_every}")
    return cfg.n_layers // cfg.slstm_every, cfg.slstm_every - 1


def _hybrid_groups(cfg: ArchConfig) -> Tuple[int, int]:
    """(groups, Mamba2 blocks a group) of a hybrid config."""
    if cfg.n_layers % cfg.attn_every:
        raise ValueError(f"{cfg.name}: n_layers {cfg.n_layers} is not a multiple of "
                         f"attn_every {cfg.attn_every}")
    return cfg.n_layers // cfg.attn_every, cfg.attn_every


class Block(nn.Module):
    """Pre-norm attention + MLP (dense) or + MoE."""

    def __init__(self, cfg: ArchConfig, moe: bool, dtype: torch.dtype, device):
        super().__init__()
        d = cfg.d_model
        self.ln1 = weight((d,), None, dtype, device)
        self.attn = (attn.mla_init if cfg.mla else attn.gqa_init)(cfg, dtype, device)
        self.ln2 = weight((d,), None, dtype, device)
        if moe:
            self.moe = moe_mod.moe_init(cfg, dtype, device)
        else:
            self.mlp = mlp_init(d, cfg.d_ff, cfg.gated_mlp, dtype, device)

    def _ffn(self, cfg: ArchConfig, x: torch.Tensor, aux: List[dict]) -> torch.Tensor:
        h = rmsnorm(x, self.ln2, cfg.norm_eps)
        if hasattr(self, "moe"):
            mo, a = moe_mod.moe_apply(self.moe, cfg, h)
            aux.append(a)
            return x + mo
        return x + mlp_apply(self.mlp, h, cfg.gated_mlp)

    def forward(self, cfg: ArchConfig, x: torch.Tensor, pos: torch.Tensor,
                aux: List[dict]) -> torch.Tensor:
        fwd = attn.mla_forward if cfg.mla else attn.gqa_forward
        x = x + fwd(self.attn, cfg, rmsnorm(x, self.ln1, cfg.norm_eps), pos)
        return self._ffn(cfg, x, aux)

    def decode(self, cfg: ArchConfig, cache: dict, x: torch.Tensor, pos: int,
               aux: List[dict]) -> torch.Tensor:
        dec = attn.mla_decode if cfg.mla else attn.gqa_decode
        dh, _ = dec(self.attn, cfg, cache, rmsnorm(x, self.ln1, cfg.norm_eps), pos)
        return self._ffn(cfg, x + dh, aux)


class RecurrentBlock(nn.Module):
    """Pre-norm residual around one Mamba2, mLSTM or sLSTM layer, held
    under its kind's name (``mamba``, ``mlstm``, ``slstm``)."""

    def __init__(self, cfg: ArchConfig, kind: str, dtype: torch.dtype, device):
        super().__init__()
        self.kind = kind
        self.ln1 = weight((cfg.d_model,), None, dtype, device)
        setattr(self, kind, RECURRENT[kind][0](cfg, dtype, device))

    def forward(self, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
        h = rmsnorm(x, self.ln1, cfg.norm_eps)
        return x + RECURRENT[self.kind][1](getattr(self, self.kind), cfg, h)

    def decode(self, cfg: ArchConfig, cache: dict, x: torch.Tensor) -> torch.Tensor:
        h = rmsnorm(x, self.ln1, cfg.norm_eps)
        return x + RECURRENT[self.kind][2](getattr(self, self.kind), cfg, cache, h)[0]


def _groups(cfg: ArchConfig, kind: str, n_groups: int, per: int, dtype, device) -> nn.ModuleList:
    return nn.ModuleList(
        nn.ModuleList(RecurrentBlock(cfg, kind, dtype, device) for _ in range(per))
        for _ in range(n_groups))


class Model(nn.Module):
    def __init__(self, cfg: ArchConfig, dtype: torch.dtype = torch.bfloat16,
                 device: Optional[str] = None):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.device = torch.device(resolve_device(device))
        dev, d = self.device, cfg.d_model
        self.embed = weight((cfg.vocab_size, d), 1.0 / math.sqrt(d), dtype, dev)
        self.final_norm = weight((d,), None, dtype, dev)
        if not cfg.tie_embeddings:
            self.lm_head = weight((d, cfg.vocab_size), 1.0 / math.sqrt(d), dtype, dev)
        if cfg.frontend != "none":
            self.frontend_proj = weight((d, d), 1.0 / math.sqrt(d), dtype, dev)
        if cfg.xlstm:
            g, rem = _xlstm_groups(cfg)
            self.mlstm_groups = _groups(cfg, "mlstm", g, rem, dtype, dev)
            self.slstm_blocks = nn.ModuleList(RecurrentBlock(cfg, "slstm", dtype, dev)
                                              for _ in range(g))
        elif cfg.ssm:
            g, per = _hybrid_groups(cfg)
            self.mamba_groups = _groups(cfg, "mamba", g, per, dtype, dev)
            self.shared_attn = Block(cfg, False, dtype, dev)  # ONE weight set, every group
        else:
            n_dense = cfg.first_dense_layers if cfg.moe else 0
            self.dense_blocks = nn.ModuleList(Block(cfg, False, dtype, dev)
                                              for _ in range(n_dense))
            self.blocks = nn.ModuleList(Block(cfg, cfg.moe, dtype, dev)
                                        for _ in range(cfg.n_layers - n_dense))
        #: the MoE layers' aux metrics of the last forward or decode step
        self.last_aux: Dict[str, torch.Tensor] = {}

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "Model":
        """Draw every weight from ``generator`` (on the model's device) as
        ``N(0, 1) * scale``, in a fixed order; norm weights stay ones and
        the other constants (Mamba2's ``a_log``, ``d_skip``, ``dt_bias``,
        ``conv_b``) keep the values they were built with."""
        for p in self.parameters():
            if p.init_scale is not None:
                init_normal_(p, p.init_scale, generator)
        return self

    def param_bytes(self) -> int:
        return sum(p.numel() * p.element_size() for p in self.parameters())

    def _head(self, x: torch.Tensor) -> torch.Tensor:
        x = rmsnorm(x, self.final_norm, self.cfg.norm_eps)
        head = self.embed.T if self.cfg.tie_embeddings else self.lm_head
        return x @ head

    def _record(self, aux: List[dict]) -> Dict[str, torch.Tensor]:
        out = {}
        if aux:
            out = {key: torch.stack([a[key] for a in aux]).mean() for key in aux[0]}
        self.last_aux = out
        return out

    # ------------------------------------------------------------------
    # forward (prefill)
    # ------------------------------------------------------------------
    def _embed(self, inputs: Optional[torch.Tensor]) -> torch.Tensor:
        """The residual stream's input: embeds [B, S, D] through
        ``frontend_proj`` for a frontend config, token ids [B, S] looked up
        in ``embed`` otherwise."""
        if self.cfg.frontend != "none":
            if inputs is None or inputs.dim() != 3:
                raise ValueError(f"{self.cfg.name} takes embeds [B, S, {self.cfg.d_model}] "
                                 "(its frontend is a stub), not tokens")
            return inputs.to(self.dtype) @ self.frontend_proj
        if inputs is None:
            raise ValueError(f"{self.cfg.name} takes tokens [B, S]")
        return self.embed[inputs]

    @torch.no_grad()
    def forward(self, tokens: Optional[torch.Tensor] = None,
                embeds: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """tokens [B, S] (or embeds [B, S, D] for a frontend config) ->
        (logits [B, S, vocab], aux); aux holds the MoE layers' mean
        ``load_balance_loss`` and ``drop_fraction``."""
        x = self._embed(embeds if self.cfg.frontend != "none" else tokens)
        b, s = x.shape[0], x.shape[1]
        pos = torch.arange(s, dtype=torch.int32, device=x.device)[None].expand(b, s)
        if self.cfg.mrope:  # the reference's _inputs: equal t, h and w position ids
            pos = pos[None].expand(3, b, s)
        aux: List[dict] = []
        cfg = self.cfg
        if cfg.xlstm:
            for group, sblk in zip(self.mlstm_groups, self.slstm_blocks):
                for blk in group:
                    x = blk(cfg, x)
                if cfg.slstm_every:
                    x = sblk(cfg, x)
        elif cfg.ssm:
            for group in self.mamba_groups:
                for blk in group:
                    x = blk(cfg, x)
                x = self.shared_attn(cfg, x, pos, aux)
        else:
            for blk in (*self.dense_blocks, *self.blocks):
                x = blk(cfg, x, pos, aux)
        return self._head(x), self._record(aux)

    # ------------------------------------------------------------------
    # serving: cache init + single-token decode
    # ------------------------------------------------------------------
    def init_cache(self, batch: int, max_len: int) -> Cache:
        """``kv`` per ``blocks`` layer, ``kv_dense`` per dense-first layer
        (MoE family), and ``pos``, the index of the next token (an int).
        A layer's cache is its K/V (a ring of ``min(max_len, window)``
        slots under a sliding window) or, for MLA, its latent. zamba2 keeps
        ``mamba`` (per group, per block: conv frames and SSM state) and
        ``attn`` (one K/V ring per group: the shared block's weights, each
        call its own cache); xlstm keeps ``mlstm`` (per group, per block)
        and ``slstm`` (per group)."""
        cfg, dev = self.cfg, self.device
        if cfg.xlstm:
            return {"mlstm": [[xlstm_mod.mlstm_init_cache(cfg, batch, dev) for _ in group]
                              for group in self.mlstm_groups],
                    "slstm": [xlstm_mod.slstm_init_cache(cfg, batch, dev)
                              for _ in self.slstm_blocks], "pos": 0}
        if cfg.ssm:
            return {"mamba": [[ssm_mod.mamba2_init_cache(cfg, batch, self.dtype, dev)
                               for _ in group] for group in self.mamba_groups],
                    "attn": [attn.gqa_init_cache(cfg, batch, max_len, self.dtype, dev)
                             for _ in self.mamba_groups], "pos": 0}
        init = attn.mla_init_cache if cfg.mla else attn.gqa_init_cache

        def one():
            return init(cfg, batch, max_len, self.dtype, dev)
        cache: Cache = {"kv": [one() for _ in self.blocks], "pos": 0}
        if self.cfg.moe and self.cfg.first_dense_layers:
            cache["kv_dense"] = [one() for _ in self.dense_blocks]
        return cache

    @torch.no_grad()
    def decode_step(self, cache: Cache, tokens: torch.Tensor) -> Tuple[torch.Tensor, Cache]:
        """One serve step: tokens [B, 1] (embeds [B, 1, D] for a frontend
        config) -> (logits [B, 1, vocab], cache). The caches are written in
        place; the returned cache has ``pos`` advanced by one."""
        pos = cache["pos"]
        x = self._embed(tokens)
        aux: List[dict] = []
        cfg = self.cfg
        if cfg.xlstm:
            for group, sblk, mc, sc in zip(self.mlstm_groups, self.slstm_blocks,
                                           cache["mlstm"], cache["slstm"]):
                for blk, c in zip(group, mc):
                    x = blk.decode(cfg, c, x)
                if cfg.slstm_every:
                    x = sblk.decode(cfg, sc, x)
        elif cfg.ssm:
            for group, mc, ac in zip(self.mamba_groups, cache["mamba"], cache["attn"]):
                for blk, c in zip(group, mc):
                    x = blk.decode(cfg, c, x)
                x = self.shared_attn.decode(cfg, ac, x, pos, aux)
        else:
            for blk, c in zip(self.dense_blocks, cache.get("kv_dense", [])):
                x = blk.decode(cfg, c, x, pos, aux)
            for blk, c in zip(self.blocks, cache["kv"]):
                x = blk.decode(cfg, c, x, pos, aux)
        self._record(aux)
        return self._head(x), dict(cache, pos=pos + 1)
