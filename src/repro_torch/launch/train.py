"""Training launcher: the end-to-end loop wiring every substrate together.

    PYTHONPATH=src python -m repro_torch.launch.train --arch rwkv6-1.6b \
        --batch 8 --seq 1024 --steps 4
    PYTHONPATH=src python -m repro_torch.launch.train --arch rwkv6-1.6b \
        --smoke --device cpu --steps 3

Port of ``repro/launch/train.py``: synthetic data pipeline (prefetch
thread) -> train step (``distributed/step``: autograd, optional int8
error-feedback gradient compression, AdamW) -> async checkpointing ->
resilient loop (straggler monitor, heartbeat, a checkpoint every
``--ckpt-every`` steps, the final one only on clean completion, resume
from the latest).  One card: ``--model-axis`` above 1 is multi-card work
and raises.  The hand kernels on the path depend on the family
(``PATH_KERNELS``): an ssm (rwkv6) model's WKV recurrence runs ``wkv``
forward (twice a layer a step under ``remat="full"``: the pass and its
recompute) and ``wkv_bwd`` backward; the attention families train
through ``attention.flash_attention`` (torch ops) and launch none.
Weights are random, made from ``--seed``.  Runs on the card unless
``--device cpu`` is given; with no card, ``--device cuda`` raises.
"""

import argparse
import dataclasses
import os
import time

from repro_torch.checkpoint import ckpt
from repro_torch.configs import get_config
from repro_torch.data.pipeline import PrefetchIterator, SyntheticDataset
from repro_torch.distributed import fault
from repro_torch.distributed.step import (TrainStepConfig, init_train_state,
                                          make_train_step, train_state_specs)
from repro_torch.kernels import build, rwkv_wkv
from repro_torch.models.config import smoke_variant
from repro_torch.models.model import Model
from repro_torch.optim.adamw import AdamWConfig

#: The hand kernels each family's training path launches.
PATH_KERNELS = {"ssm": {"wkv": rwkv_wkv.KERNEL,
                        "wkv_bwd": rwkv_wkv.KERNEL_BWD}}


def build_step(args):
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_variant(cfg)
    if args.remat:
        cfg = dataclasses.replace(cfg, remat=args.remat)
    if args.model_axis != 1:
        raise NotImplementedError(
            f"--model-axis {args.model_axis}: model parallelism is "
            f"multi-card work; the port trains on one card")
    model = Model(cfg, device=args.device)
    step_cfg = TrainStepConfig(
        opt=AdamWConfig(lr=args.lr, total_steps=args.steps,
                        warmup_steps=max(args.steps // 20, 5)),
        compress_grads=args.compress_grads,
        param_dtype=cfg.dtype)
    return cfg, model, step_cfg, make_train_step(model, step_cfg)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--remat", default=None)
    ap.add_argument("--model-axis", type=int, default=1)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)

    cfg, model, step_cfg, train_step = build_step(args)
    dev = model.device
    print(f"[train] arch={cfg.name} params={model.param_count():,} "
          f"device={dev}")
    if dev.type == "cuda":
        # Build (or load) the path's kernels before any clock starts.
        kernels = PATH_KERNELS.get(cfg.family, {})
        build.load_all([kern.library for kern in kernels.values()])
        for kern in kernels.values():
            kern.fn()

    start_step = 0
    state = None
    checkpointer = None
    if args.ckpt_dir:
        # The heartbeat writes there from the first step on.
        os.makedirs(args.ckpt_dir, exist_ok=True)
        checkpointer = ckpt.AsyncCheckpointer(args.ckpt_dir)
        last = ckpt.latest_step(args.ckpt_dir)
        if last is not None:
            specs = train_state_specs(model, step_cfg)
            state, start_step = ckpt.restore(specs, args.ckpt_dir,
                                             device=dev)
            print(f"[train] restored step {start_step} from {args.ckpt_dir}")
    if state is None:
        state = init_train_state(model, args.seed, step_cfg)

    ds = SyntheticDataset(cfg, args.batch, args.seq, seed=args.seed + 1)
    it = PrefetchIterator(ds, start_step=start_step)
    monitor = fault.StragglerMonitor()
    heartbeat = (fault.Heartbeat(os.path.join(args.ckpt_dir, "heartbeat"))
                 if args.ckpt_dir else None)

    losses = []
    completed = False
    try:
        for _ in range(start_step, args.steps):
            step_no, batch = next(it)
            monitor.start()
            state, metrics = train_step(state, batch)
            loss = float(metrics["loss"])
            losses.append(loss)
            if monitor.stop():
                print(f"[train] straggler at step {step_no} "
                      f"(median {monitor.median_s*1e3:.0f} ms)")
            if heartbeat:
                heartbeat.beat(step_no)
            if checkpointer and (step_no + 1) % args.ckpt_every == 0:
                checkpointer.save(state, step_no + 1)
            if step_no % args.log_every == 0 or step_no == args.steps - 1:
                print(f"[train] step {step_no:5d} loss {loss:.4f} "
                      f"gnorm {float(metrics['grad_norm']):.3f} "
                      f"lr {float(metrics['lr']):.2e}")
        completed = True
    finally:
        it.close()
        if checkpointer:
            if completed:
                # Final checkpoint only on clean completion -- a crash must
                # leave the last *good* checkpoint as the restore point.
                checkpointer.save(state, args.steps)
            checkpointer.close()

    if losses:
        print(f"[train] done: first loss {losses[0]:.4f} -> "
              f"last {losses[-1]:.4f}")
    else:
        print("[train] nothing to do (already at target step)")
    return losses


if __name__ == "__main__":
    main()
