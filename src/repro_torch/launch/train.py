"""End-to-end training driver of the port (``repro.launch.train`` in
PyTorch).

Features wired in, as in the reference: deterministic resumable data
pipeline, AdamW + warmup/cosine schedule, atomic checkpoints + auto-resume
(fault tolerance), straggler monitor, failure injection (tests), SIGTERM
checkpoint.  Checkpoints hold the training state in the reference's
layout (``convert.train_state_tree``), so a run either package trained
resumes in the other.  Runs on ``cuda`` unless the caller asks for another
device.  It takes no mesh: the reference's accepts one and ignores it;
sharded steps run through ``launch.sharding`` and ``pspec.activation_mesh``
(``chip_smoke.py`` phase 15).

Usage:
    PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b \\
        --smoke --steps 200 --batch 8 --seq 128 --ckpt-dir /tmp/run1 \\
        [--device cpu]
"""

from __future__ import annotations

import argparse
import signal
from dataclasses import replace
from typing import Optional

import numpy as np
import torch

from ..ckpt import CheckpointManager
from ..configs import get_config, get_smoke_config
from ..convert import train_state_from_numpy, train_state_tree
from ..data import DataConfig, TokenPipeline, synthetic_source
from ..device import DeviceLike, resolve_device
from ..optim import AdamWConfig, linear_warmup_cosine
from ..runtime import FailureInjector, Metrics, StragglerMonitor
from .steps import init_train_state, make_train_step

__all__ = ["train_loop", "main"]


def train_loop(cfg, *, steps: int, batch: int, seq: int,
               ckpt_dir: Optional[str] = None, ckpt_every: int = 50,
               lr: float = 3e-4, seed: int = 0, fail_at_step: int = -1,
               log_every: int = 10, print_fn=print,
               device: DeviceLike = None):
    """Returns (params, metrics).  Restartable: rerun with the same
    ckpt_dir to resume from the newest committed checkpoint.  The initial
    parameters are drawn from a CPU ``torch.Generator(seed)``, so every
    device starts from the same weights."""
    dev = resolve_device(device)
    opt_cfg = AdamWConfig(lr=lr, schedule=linear_warmup_cosine(
        max(1, steps // 20), steps))
    step_fn = make_train_step(cfg, opt_cfg)

    dcfg = DataConfig(seq_len=seq, global_batch=batch,
                      vocab_size=cfg.vocab_size, seed=seed)
    start_step = 0
    mgr = CheckpointManager(ckpt_dir, ckpt_every) if ckpt_dir else None
    restored, extra = mgr.restore_or_none() if mgr else (None, None)
    if restored is not None:
        params, opt_state = train_state_from_numpy(
            cfg, restored["params"], restored["opt"], dev)
        start_step = int(extra["data_step"])
        print_fn(f"[resume] restored step {start_step} from {mgr.directory}")
    else:
        params, opt_state = init_train_state(
            cfg, torch.Generator().manual_seed(seed), dev)

    pipe = TokenPipeline(dcfg, synthetic_source(dcfg), start_step=start_step)
    monitor = StragglerMonitor()
    injector = FailureInjector(fail_at_step)
    metrics = Metrics()

    # SIGTERM -> checkpoint + clean exit (preemption handling)
    stop = {"now": False}

    def _sigterm(signum, frame):  # pragma: no cover - signal path
        stop["now"] = True

    old = signal.signal(signal.SIGTERM, _sigterm)

    def make_batch(np_batch):
        extra = {}
        if cfg.n_patches:
            extra["patches"] = torch.zeros((batch, cfg.n_patches,
                                            cfg.d_model), device=dev)
        if cfg.enc_dec is not None:
            extra["frames"] = torch.zeros(
                (batch, cfg.enc_dec.encoder_len, cfg.d_model), device=dev)
        return {"tokens": torch.from_numpy(np_batch["tokens"]).to(dev),
                "labels": torch.from_numpy(np_batch["labels"]).to(dev),
                **extra}

    def save(step: int) -> None:
        mgr.save(train_state_tree(params, opt_state), step,
                 extra={"data_step": pipe.state()["step"],
                        "arch": cfg.arch_id})

    try:
        for step in range(start_step, steps):
            injector.check(step)
            np_batch = next(pipe)
            monitor.start()
            params, opt_state, m = step_fn(params, opt_state,
                                           make_batch(np_batch))
            loss = float(m["loss"])
            straggler = monitor.stop()
            metrics.log(step, loss=loss, grad_norm=float(m["grad_norm"]),
                        lr=float(m["lr"]))
            if straggler:
                print_fn(f"[straggler] step {step} slow "
                         f"(median {np.median(monitor.times):.3f}s)")
            if step % log_every == 0:
                print_fn(f"step {step:5d} loss {loss:.4f} "
                         f"gnorm {float(m['grad_norm']):.3f}")
            if mgr is not None and (mgr.should_save(step + 1) or stop["now"]):
                save(step + 1)
            if stop["now"]:
                print_fn(f"[sigterm] checkpointed at step {step + 1}, exiting")
                break
    finally:
        pipe.close()
        signal.signal(signal.SIGTERM, old)
    if mgr is not None:
        save(steps)
    return params, metrics


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--fail-at-step", type=int, default=-1)
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (cpu to run without a "
                         "card)")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    cfg = replace(cfg, train_microbatches=1)
    _, metrics = train_loop(
        cfg, steps=args.steps, batch=args.batch, seq=args.seq,
        ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every, lr=args.lr,
        seed=args.seed, fail_at_step=args.fail_at_step, device=args.device)
    losses = [r["loss"] for r in metrics.rows]
    if losses:
        print(f"first loss {losses[0]:.4f} -> last loss {losses[-1]:.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
