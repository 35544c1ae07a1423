"""Train step builder: layer remat + microbatch accumulation.

The port of the reference's ``train/train_step.py``.
``make_train_step(model, opt_cfg, n_microbatches)`` returns
``train_step(opt_state, batch) -> (opt_state, metrics)``: the batch's
leading dim is split into ``n_microbatches`` microbatches (rows ``i * b /
n`` on of the batch for microbatch ``i``, as the reference's reshape cuts
them), each microbatch's gradient taken by ``loss.backward()`` and added
into a float32 accumulator (``opt_cfg.acc_dtype``), the sum divided by
``n``; the metrics are each microbatch's averaged, as the reference's
``lax.scan`` stacks and averages them. Then ``grad_norm``, the optimizer
step (the model's parameters updated in place) and ``lr`` of the new step.
The batch is a dict of tensors on the model's device; the metrics are
0-d float32 tensors (the device's; ``lr`` the CPU's).
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from ..models.model import Model
from . import optimizer as opt_mod
from .optimizer import OptConfig


def make_train_step(
    model: Model,
    opt_cfg: OptConfig,
    n_microbatches: int = 1,
    remat: bool = True,  # layer-level remat of the model's units: sets Model.remat
    grad_transform: Optional[Callable] = None,  # grads dict -> grads dict
):
    model.remat = remat
    model.requires_grad_(True)
    params = dict(model.named_parameters())
    acc_dt = getattr(torch, opt_cfg.acc_dtype)

    def grads_of(batch) -> tuple:
        model.zero_grad(set_to_none=True)
        loss, metrics = model.loss(batch)
        loss.backward()
        # a parameter the loss does not use (hubert's token embedding) has
        # no gradient: zeros, as the reference's
        return ({name: torch.zeros_like(p) if p.grad is None else p.grad
                 for name, p in params.items()},
                {key: t.detach() for key, t in metrics.items()})

    def train_step(opt_state: Dict[str, object], batch: Dict[str, torch.Tensor]):
        if n_microbatches > 1:
            b = next(iter(batch.values())).shape[0]
            if b % n_microbatches:
                raise ValueError(f"batch {b} is not a multiple of {n_microbatches} microbatches")
            size = b // n_microbatches
            grads = {name: torch.zeros(p.shape, dtype=acc_dt, device=p.device)
                     for name, p in params.items()}
            metricses = []
            for i in range(n_microbatches):
                mb = {key: v[i * size:(i + 1) * size] for key, v in batch.items()}
                g, metrics = grads_of(mb)
                for name, acc in grads.items():
                    acc.add_(g[name].to(acc_dt))
                metricses.append(metrics)
            model.zero_grad(set_to_none=True)
            for acc in grads.values():
                acc.div_(n_microbatches)
            metrics = {key: torch.stack([m[key] for m in metricses]).mean()
                       for key in metricses[0]}
        else:
            grads, metrics = grads_of(batch)
        if grad_transform is not None:
            grads = grad_transform(grads)
        metrics["grad_norm"] = opt_mod.global_norm(grads)
        opt_state = opt_mod.apply_updates(params, grads, opt_state, opt_cfg)
        del grads
        model.zero_grad(set_to_none=True)
        metrics["lr"] = opt_mod.lr_schedule(opt_cfg, opt_state["step"])
        return opt_state, metrics

    return train_step


def make_eval_step(model: Model):
    @torch.no_grad()
    def eval_step(batch):
        _, metrics = model.loss(batch)
        return metrics

    return eval_step
