"""Carry the reference's parameter pytree into the port's :class:`Model`.

The reference's ``Model.init`` returns nested dicts whose layer stacks
carry leading axes: ``blocks`` and ``slstm_blocks`` one (layer or group),
``mamba_groups`` and ``mlstm_groups`` two (group, block in the group);
the MoE family adds a ``dense_blocks`` list and zamba2 one unstacked
``shared_attn`` tree. With every leaf turned into a numpy array,
:func:`params_from_numpy` loads it into the port's per-layer modules, so
the two packages compute with the same weights. :func:`opt_state_from_numpy`
splits the reference's float32 AdamW state (its ``m`` and ``v`` trees,
stacked as the parameters are) the same way, into the port's
:func:`repro_torch.train.init_state` layout; gradient trees map by
:func:`_flatten` alike.
"""
from __future__ import annotations

from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from ..configs.base import ArchConfig
from .model import Model


def _leaves(tree, prefix: str) -> Iterator[Tuple[str, np.ndarray]]:
    if isinstance(tree, dict):
        for key, sub in tree.items():
            yield from _leaves(sub, f"{prefix}{key}.")
    elif isinstance(tree, (list, tuple)):
        for i, sub in enumerate(tree):
            yield from _leaves(sub, f"{prefix}{i}.")
    else:
        yield prefix[:-1], np.asarray(tree)


#: the reference's stacked subtrees and their number of leading layer axes
STACKED = {"blocks": 1, "slstm_blocks": 1, "mamba_groups": 2, "mlstm_groups": 2}


def _flatten(tree) -> Dict[str, np.ndarray]:
    """``{"blocks.3.attn.wq": array, "mamba_groups.1.4.mamba.w_z": array,
    ...}``: the stacked leaves split along their leading layer axes, the
    other leaves by their path."""
    flat: Dict[str, np.ndarray] = dict(
        _leaves({k: v for k, v in tree.items() if k not in STACKED}, ""))
    for key, axes in STACKED.items():
        for name, arr in _leaves(tree.get(key, {}), ""):
            for index in np.ndindex(*arr.shape[:axes]):
                flat[".".join([key, *map(str, index), name])] = arr[index]
    return flat


def params_from_numpy(cfg: ArchConfig, tree, device: Optional[str] = None,
                      dtype: torch.dtype = torch.bfloat16) -> Model:
    """A :class:`Model` holding the reference pytree's weights (numpy
    leaves). Raises if a name or shape does not match."""
    model = Model(cfg, dtype=dtype, device=device)
    flat = _flatten(tree)
    params = dict(model.named_parameters())
    if set(flat) != set(params):
        raise ValueError(f"parameter names differ: only in the tree "
                         f"{sorted(set(flat) - set(params))[:5]}, only in the model "
                         f"{sorted(set(params) - set(flat))[:5]}")
    with torch.no_grad():
        for name, p in params.items():
            arr = flat[name]
            if tuple(arr.shape) != tuple(p.shape):
                raise ValueError(f"{name}: shape {arr.shape} != {tuple(p.shape)}")
            p.copy_(torch.from_numpy(np.array(arr, dtype=np.float32)))
    return model


def _quantized(tree) -> bool:
    """Whether a moment tree holds the 8-bit ``{"q", "scale"}`` leaves."""
    if isinstance(tree, dict):
        return set(tree) == {"q", "scale"} or any(_quantized(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return any(_quantized(v) for v in tree)
    return False


def opt_state_from_numpy(cfg: ArchConfig, state, device: Optional[str] = None
                         ) -> Dict[str, object]:
    """The port's optimizer state from the reference's float32 AdamW state
    (numpy leaves): ``m`` and ``v`` split into per-layer leaves by
    parameter name (float32, on ``device``), ``step`` an int32 0-d tensor
    on the CPU (the names are the parameters', as :func:`params_from_numpy`
    loads them). The 8-bit state cannot be carried: the reference quantises
    each stacked leaf in blocks that run across its layers, the port each
    layer's leaf alone, so a layer's blocks are not the reference's;
    ``ValueError`` says so."""
    if _quantized(state["m"]) or _quantized(state["v"]):
        raise ValueError("the 8-bit optimizer state cannot be carried across: the reference "
                         "quantises each stacked [n_layers, ...] leaf in blocks of 256 that "
                         "run across layers, the port each layer's leaf on its own")
    out: Dict[str, object] = {}
    for key in ("m", "v"):
        out[key] = {name: torch.tensor(np.asarray(arr, dtype=np.float32), device=device)
                    for name, arr in _flatten(state[key]).items()}
    if {n: t.shape for n, t in out["m"].items()} != {n: t.shape for n, t in out["v"].items()}:
        raise ValueError(f"{cfg.name}: the m and v trees differ in names or shapes")
    out["step"] = torch.tensor(int(np.asarray(state["step"])), dtype=torch.int32)
    return out
