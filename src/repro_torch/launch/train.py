"""Training driver: config -> data -> train loop -> checkpoints.

The port of the reference's ``launch/train.py`` on one device:
* the model in bf16 at its full config (float32 under ``--smoke``), its
  weights drawn from ``--seed``, layer remat on;
* deterministic restart-safe data (batch = f(seed, step));
* atomic async checkpoints every ``--ckpt-every`` steps and a final one,
  with resume from the newest valid step;
* the straggler monitor fed by the step times;
* metrics printed as CSV (step, loss, grad_norm, lr, step_time_s), one
  line every ``--log-every`` steps and at the last; ``step_time_s`` is the
  time since the previous line, ended by reading the loss (which waits for
  the device).

Examples:
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b --smoke \
        --device cpu --steps 20
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \
        --seq-len 2048 --global-batch 4 --microbatches 2 --steps 10

Without ``--device`` it needs a GPU and raises without one. The port has
no LM sharding yet, so ``--data-shards`` and ``--model-shards`` must be 1.
"""
from __future__ import annotations

import argparse
import time

import torch

from ..checkpoint.manager import CheckpointManager
from ..configs import ARCH_IDS, get_config, smoke_config
from ..core.session import resolve_device
from ..data import SyntheticLM
from ..distributed.compression import StragglerMonitor
from ..models import Model
from ..train import OptConfig, init_state, make_train_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="qwen3-0.6b")
    ap.add_argument("--smoke", action="store_true", help="reduced config, float32")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", type=str, default="")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--data-shards", type=int, default=1)
    ap.add_argument("--model-shards", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="'cuda' (default: needs a GPU) or 'cpu' (the kernels' plain versions)")
    args = ap.parse_args(argv)
    if args.data_shards != 1 or args.model_shards != 1:
        raise ValueError("--data-shards and --model-shards must be 1: the port has no LM "
                         "sharding yet (distributed/sharding.py and the device mesh are not "
                         "ported)")
    device = resolve_device(args.device)

    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model = Model(cfg, dtype=torch.float32 if args.smoke else torch.bfloat16, device=device)
    model.init(torch.Generator(device).manual_seed(args.seed))
    opt_cfg = OptConfig(lr=args.lr, warmup_steps=min(20, args.steps // 5 + 1),
                        total_steps=args.steps)
    params = dict(model.named_parameters())
    opt_state = init_state(params, opt_cfg)

    start_step = 0
    mgr = None
    if args.ckpt_dir:
        mgr = CheckpointManager(args.ckpt_dir)
        step_found, state = mgr.restore_latest({"params": params, "opt": opt_state})
        if step_found is not None:
            with torch.no_grad():
                for name, p in params.items():
                    p.copy_(state["params"][name])
            opt_state = state["opt"]
            start_step = step_found
            print(f"# resumed from step {start_step}")

    step_fn = make_train_step(model, opt_cfg, n_microbatches=args.microbatches)
    data = SyntheticLM(cfg, args.seq_len, args.global_batch, seed=args.seed)
    monitor = StragglerMonitor()
    print("step,loss,grad_norm,lr,step_time_s")
    t_last = time.perf_counter()
    for step in range(start_step, args.steps):
        batch = {k: torch.from_numpy(v).to(device) for k, v in data.batch(step).items()}
        opt_state, metrics = step_fn(opt_state, batch)
        if step % args.log_every == 0 or step == args.steps - 1:
            loss = float(metrics["loss"])
            t_now = time.perf_counter()
            dt = t_now - t_last
            t_last = t_now
            monitor.record(dt)
            print(f"{step},{loss:.4f},{float(metrics['grad_norm']):.3f},"
                  f"{float(metrics['lr']):.2e},{dt:.3f}")
        if mgr and (step + 1) % args.ckpt_every == 0:
            mgr.save_async(step + 1, {"params": params, "opt": opt_state})
    if mgr:
        mgr.save(args.steps, {"params": params, "opt": opt_state})
        mgr.wait()
    if monitor.flags:
        print(f"# straggler events: {monitor.flags}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
