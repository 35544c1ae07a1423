"""Model assembly: the dense family and the MoE family with GQA attention.

The port of the reference's ``models/model.py`` for qwen3-0.6b,
granite-20b, deepseek-coder-33b and kimi-k2 (any config of the ``dense``
or ``moe`` family without MLA, M-RoPE, a sliding window or a frontend).
Per-layer modules replace the reference's stacked ``blocks`` axis; the
names are the reference's, so ``blocks.3.attn.wq`` is layer 3 of its
``params["blocks"]["attn"]["wq"]``. Layer order is the reference's:

* dense: ``blocks`` (attention + MLP) ``n_layers`` times;
* moe: ``dense_blocks`` (the first ``first_dense_layers``), then ``blocks``
  (attention + MoE).

The public surface:
    Model(cfg, dtype, device)           weights allocated, not drawn
    init(generator)                     draw every weight (in slices)
    forward(tokens)                     (logits, aux) for a whole sequence
    init_cache(batch, max_len)          KV caches, ``pos`` = 0
    decode_step(cache, tokens)          one-token serve step -> (logits, cache)

Every attention call goes through the hand-written flash kernel and every
MoE dispatch through the hand-written gather kernel (on a CUDA device;
their plain versions on the CPU). ``device=None`` means ``"cuda"`` and
raises without a GPU, as ``bind()`` does.
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
from .layers import init_normal_, mlp_apply, mlp_init, rmsnorm, weight

Cache = Dict[str, object]


def check_supported(cfg: ArchConfig) -> None:
    """Raise ``NotImplementedError`` for what this slice does not port."""
    if cfg.xlstm or cfg.ssm:
        raise NotImplementedError(f"{cfg.name}: the SSM and xLSTM families are not ported "
                                  "yet: ROADMAP queue A, the LM stack's later slice")
    if cfg.frontend != "none":
        raise NotImplementedError(f"{cfg.name}: the vision/audio frontends are not ported "
                                  "yet: ROADMAP queue A, the LM stack's later slice")
    if cfg.family not in ("dense", "moe"):
        raise NotImplementedError(f"{cfg.name}: family {cfg.family!r} is not ported yet: "
                                  "ROADMAP queue A, the LM stack's later slice")
    attn.check_supported(cfg)


class Block(nn.Module):
    """Pre-norm attention + MLP (dense) or + MoE."""

    def __init__(self, cfg: ArchConfig, moe: bool, dtype: torch.dtype, device):
        super().__init__()
        d = cfg.d_model
        self.ln1 = weight((d,), None, dtype, device)
        self.attn = attn.gqa_init(cfg, dtype, device)
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
        x = x + attn.gqa_forward(self.attn, cfg, rmsnorm(x, self.ln1, cfg.norm_eps), pos)
        return self._ffn(cfg, x, aux)

    def decode(self, cfg: ArchConfig, cache: dict, x: torch.Tensor, pos: int,
               aux: List[dict]) -> torch.Tensor:
        dh, _ = attn.gqa_decode(self.attn, cfg, cache, rmsnorm(x, self.ln1, cfg.norm_eps), pos)
        return self._ffn(cfg, x + dh, aux)


class Model(nn.Module):
    def __init__(self, cfg: ArchConfig, dtype: torch.dtype = torch.bfloat16,
                 device: Optional[str] = None):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        self.dtype = dtype
        self.device = torch.device(resolve_device(device))
        dev, d = self.device, cfg.d_model
        self.embed = weight((cfg.vocab_size, d), 1.0 / math.sqrt(d), dtype, dev)
        self.final_norm = weight((d,), None, dtype, dev)
        if not cfg.tie_embeddings:
            self.lm_head = weight((d, cfg.vocab_size), 1.0 / math.sqrt(d), dtype, dev)
        n_dense = cfg.first_dense_layers if cfg.moe else 0
        self.dense_blocks = nn.ModuleList(Block(cfg, False, dtype, dev) for _ in range(n_dense))
        self.blocks = nn.ModuleList(Block(cfg, cfg.moe, dtype, dev)
                                    for _ in range(cfg.n_layers - n_dense))
        #: the MoE layers' aux metrics of the last forward or decode step
        self.last_aux: Dict[str, torch.Tensor] = {}

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "Model":
        """Draw every weight from ``generator`` (on the model's device) as
        ``N(0, 1) * scale``, in a fixed order; norm weights stay ones."""
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
    @torch.no_grad()
    def forward(self, tokens: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """tokens [B, S] -> (logits [B, S, vocab], aux); aux holds the MoE
        layers' mean ``load_balance_loss`` and ``drop_fraction``."""
        b, s = tokens.shape
        x = self.embed[tokens]
        pos = torch.arange(s, dtype=torch.int32, device=x.device)[None].expand(b, s)
        aux: List[dict] = []
        for blk in (*self.dense_blocks, *self.blocks):
            x = blk(self.cfg, x, pos, aux)
        return self._head(x), self._record(aux)

    # ------------------------------------------------------------------
    # serving: cache init + single-token decode
    # ------------------------------------------------------------------
    def init_cache(self, batch: int, max_len: int) -> Cache:
        """``kv`` per ``blocks`` layer, ``kv_dense`` per dense-first layer
        (MoE family), and ``pos``, the index of the next token (an int)."""
        def one():
            return attn.gqa_init_cache(self.cfg, batch, max_len, self.dtype, self.device)
        cache: Cache = {"kv": [one() for _ in self.blocks], "pos": 0}
        if self.cfg.moe and self.cfg.first_dense_layers:
            cache["kv_dense"] = [one() for _ in self.dense_blocks]
        return cache

    @torch.no_grad()
    def decode_step(self, cache: Cache, tokens: torch.Tensor) -> Tuple[torch.Tensor, Cache]:
        """One serve step: tokens [B, 1] -> (logits [B, 1, vocab], cache).
        The KV caches are written in place; the returned cache has
        ``pos`` advanced by one."""
        pos = cache["pos"]
        x = self.embed[tokens]
        aux: List[dict] = []
        for blk, c in zip(self.dense_blocks, cache.get("kv_dense", [])):
            x = blk.decode(self.cfg, c, x, pos, aux)
        for blk, c in zip(self.blocks, cache["kv"]):
            x = blk.decode(self.cfg, c, x, pos, aux)
        self._record(aux)
        return self._head(x), dict(cache, pos=pos + 1)
