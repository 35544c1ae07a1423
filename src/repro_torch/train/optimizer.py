"""Optimizers built from scratch: AdamW and 8-bit AdamW.

The port of the reference's ``train/optimizer.py`` as plain functions on
tensors (not ``torch.optim.AdamW``, whose clipping, schedule and 8-bit
state differ):

``adamw``      — float32 moments;
``adamw8bit``  — block-wise int8 moments with the reference's power-law
                 code (1 + 1 bytes a parameter instead of 4 + 4).

Both clip by the global norm and decay the weights decoupled. The state is
a dict: ``m`` and ``v`` keyed by parameter name (float32 tensors of the
parameter's shape, or ``{"q": int8 [n], "scale": float32 [n_blocks]}``
when quantized, on the parameter's device) and ``step`` (an int32 0-d
tensor on the CPU, so the schedule never waits for the card).
:func:`apply_updates` updates the parameters and the state in place, under
``no_grad``, in the reference's order of operations (clip, moments, bias
corrections, ``u + wd * p``, then ``(p - lr * u)`` cast to the parameter's
dtype), so float32 steps match the reference wherever torch and XLA round
alike. A leaf is updated in slices of ``CHUNK`` elements (a multiple of
the quantization block, so the blocks and the results are those of one
pass) to bound the float32 temporaries of a large leaf.

A quantized leaf is blocked over its own flattened elements. The
reference's leaves are stacked across layers (``[n_layers, ...]``), the
port's are per layer, so where a layer's slice is no multiple of
``QBLOCK`` the two packages' blocks differ and their 8-bit states are not
comparable leaf for leaf; on the same flat leaf they are.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Tuple

import torch

QBLOCK = 256  # quantization block (elements)
#: elements of a leaf updated at once (a multiple of QBLOCK)
CHUNK = 1 << 26

Params = Dict[str, torch.Tensor]


@dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    quantized: bool = False  # int8 moments
    acc_dtype: str = "float32"  # microbatch grad accumulator dtype


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x).to(torch.float32)


def lr_schedule(cfg: OptConfig, step) -> torch.Tensor:
    """Linear warmup + cosine decay to min_lr_ratio: a float32 0-d tensor
    on the CPU for an int (or CPU tensor) step."""
    step = _f32(step)
    warm = cfg.lr * step / max(cfg.warmup_steps, 1)
    prog = torch.clamp(
        (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.lr * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5
                    * (1 + torch.cos(math.pi * prog)))
    return torch.where(step < cfg.warmup_steps, warm, cos)


# --------------------------------------------------------------------------
# int8 block quantization
# --------------------------------------------------------------------------


def _blocks(flat: torch.Tensor) -> torch.Tensor:
    n = flat.shape[0]
    nb = (n + QBLOCK - 1) // QBLOCK
    return torch.nn.functional.pad(flat, (0, nb * QBLOCK - n)).reshape(nb, QBLOCK)


def _quant(x: torch.Tensor, power: int = 2) -> Tuple[torch.Tensor, torch.Tensor]:
    """Block-wise nonlinear int8 quantization (bitsandbytes-style): code
    value = sign(q) * (|q| / 127) ** power * blockmax. The power-law code
    concentrates resolution near zero; power 2 suits first moments, power
    4 the non-negative second moments. Returns ``(q int8 [n], scale
    float32 [n_blocks])``."""
    flat = x.reshape(-1)
    n = flat.shape[0]
    fb = _blocks(flat)
    scale = torch.amax(torch.abs(fb), dim=1)
    safe = torch.clamp_min(scale, 1e-20)
    frac = torch.clamp(torch.abs(fb) / safe[:, None], 0.0, 1.0)
    # the root in float64, rounded to float32: XLA's float32 power is closer
    # to that than to torch's float32 pow or sqrt (of 3M draws 21 and 2,102
    # differ by an ulp at power 2 and 4, against 19,530 and 44,063), and an
    # ulp can move a code that lies on a rounding boundary
    root = (frac.to(torch.float64) ** (1.0 / power)).to(torch.float32)
    q = torch.round(127.0 * root) * torch.sign(fb)
    q = torch.clamp(q, -127, 127).to(torch.int8)
    return q.reshape(-1)[:n], scale.to(torch.float32)


def _integer_pow(x: torch.Tensor, y: int) -> torch.Tensor:
    """``x ** y`` by repeated squaring, as XLA's integer power takes it
    (``x ** 4 = (x * x) * (x * x)``)."""
    acc = None
    while y > 0:
        if y & 1:
            acc = x if acc is None else acc * x
        y >>= 1
        if y > 0:
            x = x * x
    return acc


def _dequant(q: torch.Tensor, scale: torch.Tensor, shape, power: int = 2) -> torch.Tensor:
    fb = _blocks(q.to(torch.float32))
    frac = torch.abs(fb) / 127.0
    vals = torch.sign(fb) * _integer_pow(frac, power) * scale[:, None]
    n = q.shape[0]
    return vals.reshape(-1)[:n].reshape(shape)


# --------------------------------------------------------------------------
# state construction
# --------------------------------------------------------------------------


def init_state(params: Params, cfg: OptConfig) -> Dict[str, object]:
    """Zero moments for every parameter (on its device), ``step`` 0."""
    def moment(p: torch.Tensor):
        if not cfg.quantized:
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        n = p.numel()
        nb = (n + QBLOCK - 1) // QBLOCK
        return {"q": torch.zeros(n, dtype=torch.int8, device=p.device),
                "scale": torch.zeros(nb, dtype=torch.float32, device=p.device)}

    return {"m": {name: moment(p) for name, p in params.items()},
            "v": {name: moment(p) for name, p in params.items()},
            "step": torch.zeros((), dtype=torch.int32)}


def _sq_sum(t: torch.Tensor) -> torch.Tensor:
    """sum(t.float() ** 2), taken in slices of CHUNK elements."""
    flat = t.reshape(-1)
    if flat.numel() <= CHUNK:
        return torch.sum(flat.to(torch.float32) ** 2)
    return sum(torch.sum(part.to(torch.float32) ** 2) for part in flat.split(CHUNK))


def global_norm(tree: Params) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, float32, in the leaves'
    order (a 0-d tensor on their device)."""
    return torch.sqrt(sum(_sq_sum(leaf) for leaf in tree.values()))


@torch.no_grad()
def apply_updates(params: Params, grads: Params, state: Dict[str, object],
                  cfg: OptConfig) -> Dict[str, object]:
    """One AdamW step (float32 or int8 moments): ``params`` and the state's
    moments are updated in place, ``state["step"]`` advanced; returns the
    state."""
    step = state["step"] + 1
    lr = float(lr_schedule(cfg, step))
    gn = global_norm(grads)
    # true divisions (not a reciprocal times the scalar) by 0-d tensors
    # filled on the device: a copy from the host would wait for the card
    clip = torch.clamp(torch.full_like(gn, cfg.grad_clip) / torch.clamp(gn, min=1e-9), max=1.0)
    step_f = _f32(step)
    bc1 = float(1.0 - _f32(cfg.b1) ** step_f)  # float32 values, exact as Python floats
    bc2 = float(1.0 - _f32(cfg.b2) ** step_f)
    on_device: Dict[torch.device, Tuple[torch.Tensor, torch.Tensor]] = {}

    for name, p in params.items():
        if p.device not in on_device:
            on_device[p.device] = tuple(torch.full((), bc, device=p.device) for bc in (bc1, bc2))
        bc1_d, bc2_d = on_device[p.device]
        pf, gf = p.view(-1), grads[name].reshape(-1)
        m_s, v_s = state["m"][name], state["v"][name]
        for s in range(0, pf.shape[0], CHUNK):
            part = slice(s, s + CHUNK)
            g = gf[part].to(torch.float32) * clip
            if cfg.quantized:
                blocks = slice(s // QBLOCK, (s + CHUNK) // QBLOCK)
                m = _dequant(m_s["q"][part], m_s["scale"][blocks], g.shape, power=2)
                v = _dequant(v_s["q"][part], v_s["scale"][blocks], g.shape, power=4)
            else:
                m, v = m_s.view(-1)[part], v_s.view(-1)[part]
            m = cfg.b1 * m + (1 - cfg.b1) * g
            v = cfg.b2 * v + (1 - cfg.b2) * g * g
            u = (m / bc1_d) / (torch.sqrt(v / bc2_d) + cfg.eps)
            u = u + cfg.weight_decay * pf[part].to(torch.float32)
            pf[part].copy_((pf[part].to(torch.float32) - lr * u).to(p.dtype))
            del u
            if cfg.quantized:
                for moment, new, power in ((m_s, m, 2), (v_s, v, 4)):
                    q, sc = _quant(new, power=power)
                    moment["q"][part].copy_(q)
                    moment["scale"][blocks].copy_(sc)
            else:
                m_s.view(-1)[part].copy_(m)
                v_s.view(-1)[part].copy_(v)
    state["step"] = step
    return state
