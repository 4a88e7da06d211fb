"""Single-device trainer (port of :mod:`repro.launch.train`).

    PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-1.6b \
        --full --optimizer muon --steps 6 --global-batch 8 --seq-len 256

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
        --steps 3 --layers 1 --d-model 64 --d-ff 128

Runs on the card unless ``--device cpu`` is given (and raises when no
card is present and none was asked for).  It carries the reference's
single-device path: random init from ``--seed``, the deterministic data
pipeline (``--data-seed``), microbatched steps with global-norm
clipping, AdamW / AdamW-8bit / Muon (whose Newton–Schulz chain runs on
the ``rank_update`` / ``sym_stream`` kernels, one launch per stacked
parameter and call), the straggler monitor on every step, and the
reference's JSON summary, with the port's timings beside it.

Waiting, each raising a clear error: ``--ckpt-dir`` (ROADMAP A6,
checkpoints), ``--compress-grads`` and ``--fail-at`` (A8, distributed
state and faults), more than one device (A7, the mesh), and training an
xlstm config (its sLSTM kernel has no backward yet).
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import time
from typing import Any, Dict

import torch

from ..blas.routing import capture_routes
from ..configs import get_config, get_smoke_config
from ..data import DataConfig, make_train_iterator
from ..device import describe, resolve_device
from ..distributed import StepTimer, StragglerMonitor
from ..kernels import counts
from ..models.model import init_model
from .steps import (describe_blas_routing, init_opt_state, make_optimizer,
                    make_train_step)


def build_config(args):
    cfg = get_smoke_config(args.arch) if args.smoke \
        else get_config(args.arch)
    overrides: Dict[str, Any] = {}
    if args.layers:
        overrides["n_layers"] = args.layers
    if args.d_model:
        overrides["d_model"] = args.d_model
        overrides["d_ff"] = args.d_ff or args.d_model * 4
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg


def _refuse_waiting(args, cfg) -> None:
    """The reference's options this slice does not carry yet."""
    if args.ckpt_dir:
        raise NotImplementedError("--ckpt-dir: checkpoints wait for ROADMAP "
                                  "A6 (the single-process checkpoint "
                                  "format)")
    if args.compress_grads:
        raise NotImplementedError("--compress-grads: ErrorFeedbackInt8 "
                                  "waits for ROADMAP A8 (distributed "
                                  "state)")
    if args.fail_at is not None:
        raise NotImplementedError("--fail-at: fault injection and restart "
                                  "wait for ROADMAP A8")
    if args.devices != 1:
        raise NotImplementedError(f"--devices {args.devices}: a mesh of "
                                  "more than one device waits for ROADMAP "
                                  "A7 (the mesh schedules)")
    if any(s.mixer in ("mlstm", "slstm") for s in cfg.pattern):
        raise NotImplementedError(
            f"training {cfg.name} waits: the sLSTM kernel (slstm_scan) has "
            "no backward yet (ROADMAP A5, xlstm training)")


def train(args) -> Dict[str, Any]:
    cfg = build_config(args)
    _refuse_waiting(args, cfg)
    dev = resolve_device(args.device)
    model = init_model(cfg, seed=args.seed, device=dev)
    opt = make_optimizer(cfg, args.optimizer, lr=args.lr,
                         track_gram=args.track_gram)
    step_fn = make_train_step(model, opt, microbatches=args.microbatches,
                              loss_chunk=args.loss_chunk)
    tree = model.param_tree()
    shapes = [((len(ps),) if k[0] == "periods" else ()) + tuple(ps[0].shape)
              for k, ps in tree.items()]
    n_params = sum(p.numel() for p in model.parameters())
    if args.optimizer.startswith("muon"):
        print("[train] symmetric-BLAS routing (repro_torch.blas):")
        for line in describe_blas_routing(shapes, device=dev):
            print(line)
    opt_state = init_opt_state(model, opt)

    dcfg = DataConfig(seq_len=args.seq_len, global_batch=args.global_batch,
                      vocab_size=cfg.vocab, seed=args.data_seed)
    it = make_train_iterator(dcfg, device=dev)
    monitor = StragglerMonitor(threshold=args.straggler_threshold)
    timer = StepTimer(monitor)
    losses, step_s, split = [], [], []
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    counts.reset_launch_counts()
    t_train0 = time.time()
    routes = collections.Counter()
    for step in range(args.steps):
        batch = next(it)
        with timer, capture_routes() as log:
            opt_state, metrics = step_fn(opt_state, batch)
            loss = float(metrics["loss"])
        routes.update((r.op, r.n1, r.n2, r.path, r.batch) for r in log)
        losses.append(loss)
        step_s.append(timer.last)
        split.append({k: metrics[k] for k in
                      ("loss_backward_s", "clip_s", "opt_s")})
        if timer.event is not None:
            print(f"[straggler] step {step}: {timer.event.action} "
                  f"({timer.event.ratio:.1f}x median)")
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"[train] step {step:5d} loss {loss:.4f} "
                  f"({timer.last * 1e3:.0f} ms)")
    it.close()
    mean_step = (time.time() - t_train0) / max(args.steps, 1)
    launches = counts.launch_counts()
    timed = step_s[1:] or step_s
    out = {"arch": cfg.name, "params": n_params, "steps": args.steps,
           "final_loss": losses[-1] if losses else None,
           "first_loss": losses[0] if losses else None,
           "mean_step_s": mean_step,
           "straggler_events": len(monitor.events),
           "resumed": False, "mesh": {"data": 1, "model": 1}}
    print("[train] done:", json.dumps(out))
    out.update({
        "device": describe(dev), "optimizer": args.optimizer,
        "layers": cfg.n_layers, "d_model": cfg.d_model, "d_ff": cfg.d_ff,
        "vocab": cfg.vocab, "losses": losses, "step_s": step_s,
        "split_s": split,
        "tokens_per_s": args.global_batch * args.seq_len
        * len(timed) / sum(timed) if timed else None,
        "kernel_launches": launches,
        "peak_memory_bytes": torch.cuda.max_memory_allocated(dev)
        if dev.type == "cuda" else None,
        # every blas call planned on this thread during the steps:
        # [op, n1, n2, path, batched, calls]
        "routes": [list(k) + [n] for k, n in sorted(routes.items())]})
    return out


def build_argparser():
    ap = argparse.ArgumentParser(description="single-device LM training")
    ap.add_argument("--arch", default="stablelm-1.6b")
    ap.add_argument("--smoke", action="store_true", default=True,
                    help="reduced same-family config (CPU-runnable)")
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' to run "
                         "on the host)")
    ap.add_argument("--devices", type=int, default=1,
                    help="devices to train on (more than one waits for "
                         "the mesh slice)")
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--d-model", type=int, default=0)
    ap.add_argument("--d-ff", type=int, default=0)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--optimizer", default="adamw",
                    choices=["adamw", "adamw8bit", "muon", "muon-syrk"])
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--loss-chunk", type=int, default=256)
    ap.add_argument("--max-model", type=int, default=4,
                    help="cap of the mesh's model axis (one device: "
                         "no effect)")
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--track-gram", action="store_true",
                    help="EMA packed momentum-Grams in the Muon state")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--ckpt-keep", type=int, default=3)
    ap.add_argument("--fresh", action="store_true",
                    help="ignore existing checkpoints")
    ap.add_argument("--fail-at", type=int, default=None)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--data-seed", type=int, default=0)
    ap.add_argument("--straggler-threshold", type=float, default=3.0)
    return ap


def main(argv=None):
    args = build_argparser().parse_args(argv)
    train(args)


if __name__ == "__main__":
    main()
