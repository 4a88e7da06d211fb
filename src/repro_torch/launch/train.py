"""The trainer, on one device or a mesh (port of
:mod:`repro.launch.train`).

    PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-1.6b \
        --full --optimizer muon --steps 6 --global-batch 8 --seq-len 256

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
        --steps 3 --layers 1 --d-model 64 --d-ff 128

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
        --steps 4 --layers 1 --d-model 64 --d-ff 128 \
        --ckpt-dir /path/to/ckpt --ckpt-every 2    # resumes when re-run

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
        --steps 4 --layers 1 --d-model 64 --d-ff 128 \
        --ckpt-dir /path/to/ckpt --ckpt-every 2 --fail-at 3   # crashes

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
        --steps 3 --layers 1 --d-model 64 --d-ff 128 --compress-grads

Runs on the card unless ``--device cpu`` is given (and raises when no
card is present and none was asked for).  It carries the reference's
single-device path: random init from ``--seed``, the deterministic data
pipeline (``--data-seed``, sought to the resumed step), microbatched
steps with global-norm clipping, AdamW / AdamW-8bit / Muon (whose
Newton–Schulz chain runs on the ``rank_update`` / ``sym_stream``
kernels, one launch per stacked parameter and call), the straggler
monitor on every step, and the reference's JSON summary, with the
port's timings beside it.  ``--compress-grads`` passes the clipped
gradients through block-wise int8 quantization with error feedback
(:class:`~repro_torch.distributed.ErrorFeedbackInt8`) before the
optimizer, the numerics of a compressed data-parallel all-reduce, and
times it (``compress_s``).

With ``--ckpt-dir`` it resumes from the newest checkpoint there (unless
``--fresh``), checks the restore with ``verify_restored``, saves
``{"params": <the reference's param tree>, "opt": <optimizer state>}``
(and ``"ef": <the EF state>`` under ``--compress-grads``) every
``--ckpt-every`` steps on a background thread (keeping ``--ckpt-keep``)
and once more, blocking, at the end; the files are the reference's
(:mod:`repro_torch.distributed.checkpoint`).

Failures, as the reference injects them (before a step, and only in a
run that did not resume): ``--fail-at N`` raises ``RuntimeError`` at
step N, and an armed ``train:step`` fault (:mod:`..distributed.faults`,
``REPRO_FAULTS`` in a subprocess) raises ``DeviceLossError``; either
first commits the checkpoints still being written, so a restart
(:mod:`.recovery`) resumes from the last one.  ``train:straggler``
fires inside the step timer (a ``delay`` there drives the straggler
monitor's escalation).  Each prints the port's ``[train] port:`` line
(losses and kernel launches so far) before it raises.

``--devices N`` > 1 trains on a (data, model) mesh of N
``torch.distributed`` ranks, a process each (``run_ranks``, gloo; on
one card all ranks share it and the wire goes through the host), as
the reference's trainer does on its mesh: the mesh planned from N by
``plan_shape(N, max_model=--max-model)``, the parameters and optimizer
state held as each rank's blocks under ``param_specs`` (stablelm
tensor-parallel over 'model'), each data rank on its rows of the global
batch (``batch_specs``), the gradients averaged over 'data' (int8 on
the wire under ``--compress-grads``), and Muon's ``syrk-1d`` running
the 1D schedule on the blocks.  Every rank must report the same losses;
rank 0's summary is printed, with the mesh and each rank's words and
bytes by collective kind:

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
        --devices 4 --max-model 2 --steps 3 --optimizer muon-syrk

On a mesh ``--track-gram`` keeps the Gram of embed and unembed (split
over 'model' along their long side) as each rank's slice of the 1D
SYRK's reduce-scatter (words under the optimizer phase);
``--ckpt-dir`` saves the reference's files, each split leaf gathered to
rank 0, which writes (the gathers' words: ``ckpt_words_a_rank``), and
restores any checkpoint onto this mesh, whatever mesh or device count
wrote it; ``--fail-at`` and a ``train:step`` kill stop every rank at the
same step after rank 0 committed its writes, and the launcher raises
the failure as one device does.  A kill, then a resume on another
device count:

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
        --devices 4 --max-model 2 --steps 4 --optimizer muon-syrk \
        --track-gram --ckpt-dir /path/to/ckpt --ckpt-every 2 --fail-at 3
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
        --devices 2 --max-model 2 --steps 4 --optimizer muon-syrk \
        --track-gram --ckpt-dir /path/to/ckpt --ckpt-every 2

xlstm trains with the same flags, on one device or a mesh (its sLSTM
layers on ``slstm_scan`` with a stash forward and the ``slstm_scan_bwd``
kernel backward, on a mesh each rank on its own channels; its mLSTM
layers under autograd):

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
        --arch xlstm-350m --smoke --steps 3 --optimizer muon-syrk
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
        --arch xlstm-350m --smoke --devices 4 --max-model 2 --steps 3 \
        --optimizer muon-syrk
    PYTHONPATH=src python -m repro_torch.launch.train --arch xlstm-350m \
        --full --optimizer muon-syrk --steps 4 --seq-len 256

The dense families train with the same flags: gemma2-9b, gemma3-12b
(post-block norms, scaled embeddings, sliding windows, softcaps),
granite-20b (the ungated ``gelu_mlp``, one KV head) and pixtral-12b (on
text tokens, as the reference's trainer feeds it).  At full width on a
mesh their ``fsdp_params`` also split the weights over 'data' (ZeRO-3:
each weight gathered where it is used, its gradient reduce-scattered);
granite's single KV head keeps its model axis at 1:

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
        --arch gemma3-12b --smoke --steps 3 --optimizer muon-syrk
    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma2-9b \
        --full --layers 2 --devices 4 --max-model 2 --steps 2 \
        --global-batch 2 --seq-len 256
    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-20b \
        --full --layers 1 --devices 4 --max-model 1 --steps 2

musicgen-large takes frames, and the trainer feeds tokens as the
reference's does (whose trainer fails on it): it refuses before any
weight is drawn (:func:`refuse_frames`); ``steps.make_train_step``
trains it on ``make_train_iterator(frontend="embeddings")`` batches.

A model axis that does not divide a headed mixer's head count raises
``ValueError`` before any rank starts (a rank runs whole heads).
Waiting, each raising a clear error that names its ROADMAP item:
``--ckpt-dir`` on a mesh with state that is each rank's own (the 8-bit
AdamW moments; the EF residuals of ``--compress-grads`` over a data
axis: A8b); ``--compress-grads`` over a data axis with weights split
over it (``fsdp_params``: A11g).

jamba trains on one device with the same flags: its Mamba mixers under
autograd, its routed MoE through the dropless forms (T ≤ 256 tokens a
layer) or the capacity form's hand-written backward
(``models.moe.CapacityExperts``), its periods under the "names" remat
policy, and Muon on each (n_periods, E, d, f) expert stack as one batched
call a product.  On a mesh its Mamba mixers are tensor-parallel over
their d_inner channels and its MoE over every expert's f (one all-reduce
a layer); the published config's ``fsdp_params`` also splits their
weights over 'data'.  jamba's 8 KV heads (2 in the smoke config) bound
``--max-model``:

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
        --arch jamba-v0.1-52b --smoke --steps 3 --optimizer muon-syrk
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
        --arch jamba-v0.1-52b --smoke --devices 4 --max-model 2 \
        --steps 3 --optimizer muon-syrk

deepseek-v2 and deepseek-v3 train on one device with the same flags:
MLA and the MTP block under autograd, the unscanned prefix blocks
outside the per-period remat (as the reference runs them), the shared
experts beside the routed ones.  At full width no whole step with a
deepseek MoE layer fits one card; ``_run(args, cfg, dev)`` with
``cfg = dataclasses.replace(get_config("deepseek-v3-671b"), n_layers=2,
prefix=cfg.prefix[:2])`` trains its first two dense blocks and the MTP
block (no periods):

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
        --arch deepseek-v3-671b --smoke --steps 3 --optimizer muon-syrk

On a mesh MLA is tensor-parallel over its heads (its three latents
gathered whole over 'model'), the prefix blocks and the MTP block are
split as the periods' blocks are, and the published configs'
``fsdp_params`` also split their weights over 'data'; the MTP term is
the whole batch's t+2 mean.  The smoke configs' 4 heads bound
``--max-model``:

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
        --arch deepseek-v3-671b --smoke --devices 4 --max-model 2 \
        --steps 3 --optimizer muon-syrk
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import json
import math
import time
from typing import Any, Callable, Dict, List

import torch

from ..blas.routing import capture_routes
from ..configs import get_config, get_smoke_config
from ..data import DataConfig, make_train_iterator
from ..device import describe, resolve_device
from ..distributed import (ErrorFeedbackInt8, StepTimer, StragglerMonitor,
                           checkpoint_bytes, collectives, faults,
                           latest_step, plan_mesh, plan_shape, recover_stale,
                           restore_checkpoint, save_checkpoint,
                           verify_restored, wait_for_saves)
from ..distributed.launch import run_ranks
from ..kernels import counts
from ..models.model import (Model, check_head_split, init_model,
                            preload_remat)
from ..models.sharding import (batch_specs, global_shape, param_specs,
                               shard_leaf)
from .steps import (_delta, describe_blas_routing, init_opt_state,
                    make_optimizer, make_train_step)


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


class InjectedFailure(RuntimeError):
    """``--fail-at N``: the run stops before step N."""


def refuse_frames(cfg) -> None:
    """The trainer feeds tokens, as the reference's: raise
    ``NotImplementedError`` for the "embeddings" frontend (musicgen),
    before any weight is drawn."""
    if cfg.frontend == "embeddings":
        raise NotImplementedError(
            f"{cfg.name} takes frames, and the trainer, as the reference's, "
            "feeds tokens (the reference's fails with KeyError: 'embeds'); "
            "train frames through launch.steps.make_train_step on batches "
            "of data.make_train_iterator(frontend='embeddings', d_model=...)")


def _refuse_waiting(args, cfg) -> None:
    """The reference's options the port does not carry yet, and a mesh
    the port cannot split the model over (checked before any rank
    starts)."""
    if args.devices < 1:
        raise ValueError(f"--devices {args.devices}")
    if args.devices == 1:
        return
    data, model = plan_shape(args.devices, max_model=args.max_model)
    local = None
    if args.ckpt_dir is not None and args.optimizer == "adamw8bit":
        local = "the 8-bit AdamW moments, quantized in each rank's blocks,"
    elif args.ckpt_dir is not None and args.compress_grads and data > 1:
        local = "the error-feedback residuals, each data rank's own,"
    if local:
        raise NotImplementedError(
            f"--ckpt-dir with --devices {args.devices}: {local} have no "
            "layout-free form to save; checkpoints of rank-local "
            "optimizer state on a mesh wait for ROADMAP A8b")
    shapes = Model(cfg, torch.Generator(),
                   torch.device("meta")).stacked_shapes()
    specs = param_specs(cfg, shapes, {"data": data, "model": model})
    check_head_split(cfg, specs, model)
    if args.compress_grads and data > 1 \
            and any("data" in spec for spec in specs.values()):
        raise NotImplementedError(
            f"--compress-grads with --devices {args.devices} (data {data}):"
            f" {cfg.name} splits its weights over 'data' (fsdp_params), "
            "whose gradients are reduce-scattered, not all-reduced; the "
            "int8 error-feedback wire for reduce-scattered leaves waits "
            "for ROADMAP A11g")


def train(args) -> Dict[str, Any]:
    """Train as the flags say: on one device, or with ``--devices`` > 1
    on a mesh of that many ranks (rank 0's summary returned, with
    ``"ranks"``: every rank's)."""
    cfg = build_config(args)
    refuse_frames(cfg)
    _refuse_waiting(args, cfg)
    if args.devices > 1:
        return _train_on_mesh(args)
    return _run(args, cfg, resolve_device(args.device))


def _train_on_mesh(args) -> Dict[str, Any]:
    data, _ = plan_shape(args.devices, max_model=args.max_model)
    if args.global_batch % data:
        raise SystemExit(f"--global-batch must divide data axis {data}")
    ranks = run_ranks("repro_torch.launch.train:train_rank", args.devices,
                      backend="gloo", device=args.device,
                      kwargs={"flags": vars(args)}, timeout=3600)
    out = ranks[0]
    for line in out.pop("log"):
        print(line)
    print("[train] ranks: " + json.dumps(
        {k: [r["port"][k] for r in ranks]
         for k in ("losses", "kernel_launches", "ckpt_words")}))
    if "error" in out:
        raise out["error"]            # every rank's injected failure
    out.pop("port")
    out["ranks"] = [{k: r[k] for k in ("losses", "peak_memory_bytes",
                                       "words", "bytes", "step_s",
                                       "split_s", "kernel_launches",
                                       "ckpt_words_a_rank", "leaf_routes")}
                    for r in ranks]
    return out


def train_rank(mesh_x, flags: Dict[str, Any]) -> Dict[str, Any]:
    """One rank of ``train --devices N`` (the ``run_ranks`` target):
    the (data, model) mesh planned as the reference plans it, then the
    train loop on this rank's blocks and rows.  Rank 0 keeps its log
    lines for the launcher to print.  An injected failure (every rank
    meets it at the same step, after rank 0 committed its writes) is
    returned under ``"error"`` for the launcher to raise; ``"port"`` is
    this rank's last ``[train] port:`` payload."""
    args = argparse.Namespace(**flags)
    cfg = build_config(args)
    preload_remat()
    mesh = plan_mesh(max_model=args.max_model, device=mesh_x.device)
    log: List[str] = []
    say = log.append if mesh.rank == 0 else (lambda line: None)
    ports: List[Dict[str, Any]] = []
    try:
        out = _run(args, cfg, mesh.device, mesh=mesh, say=say,
                   port=ports.append)
    except (faults.DeviceLossError, InjectedFailure) as e:
        out = {"error": e}
    out.update(log=log, port=ports[-1])
    return out


def _world_sum(mesh, x: int) -> int:
    """``x`` summed over every rank of ``mesh`` (collective: a barrier
    too)."""
    t = torch.tensor([x], dtype=torch.int64, device=mesh.device)
    for axis in mesh.shape:
        t = collectives.all_reduce(t, mesh.comm(axis))
    return int(t.item())


def _run(args, cfg, dev, mesh=None, say: Callable[[str], None] = print,
         port: Callable[[Dict[str, Any]], None] = lambda payload: None
         ) -> Dict[str, Any]:
    """The train loop on ``dev``: the whole model, or on ``mesh`` this
    rank's blocks of it.  ``port`` gets each ``[train] port:``
    payload."""
    model = init_model(cfg, seed=args.seed, device=dev,
                       **({} if mesh is None else {"mesh": mesh}))
    opt = make_optimizer(cfg, args.optimizer, lr=args.lr,
                         track_gram=args.track_gram, mesh=mesh,
                         specs=model.specs)
    compressor = ErrorFeedbackInt8() if args.compress_grads else None
    step_fn = make_train_step(model, opt, microbatches=args.microbatches,
                              loss_chunk=args.loss_chunk,
                              compressor=compressor)
    shapes = model.stacked_shapes()
    if mesh is not None:
        shapes = {k: global_shape(s, model.specs[k], mesh)
                  for k, s in shapes.items()}
    n_params = sum(math.prod(s) for s in shapes.values())
    if args.optimizer.startswith("muon"):
        say("[train] symmetric-BLAS routing (repro_torch.blas):")
        for line in describe_blas_routing(shapes.values(), device=dev,
                                          mesh=mesh):
            say(line)
    opt_state = init_opt_state(model, opt, compressor)

    def state_tree() -> Dict[str, Any]:
        """What a checkpoint holds, under the reference's keys."""
        if compressor is None:
            return {"params": model.stacked(), "opt": opt_state}
        return {"params": model.stacked(), "opt": opt_state[0],
                "ef": opt_state[1]}

    # on a mesh every rank takes its blocks (restore) and rank 0 writes
    # the gathered leaves (save); their words are the "ckpt" phase's
    on_mesh = {} if mesh is None else {"mesh": mesh, "specs": model.specs}
    ckpt_words: Dict[str, int] = collections.Counter()

    @contextlib.contextmanager
    def ckpt_phase():
        before = collectives.word_counts()
        yield
        ckpt_words.update(_delta(collectives.word_counts(), before))

    # ---- init or resume -------------------------------------------------
    start_step, resumed, ckpt_s, verified = 0, False, {}, None
    if args.ckpt_dir and mesh is not None:
        if mesh.rank == 0:
            recover_stale(args.ckpt_dir)
        with ckpt_phase():
            _world_sum(mesh, 0)        # every rank reads the same steps
    if args.ckpt_dir and latest_step(args.ckpt_dir) is not None \
            and not args.fresh:
        t0 = time.perf_counter()
        start_step, state = restore_checkpoint(args.ckpt_dir, state_tree(),
                                               **on_mesh)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t1 = time.perf_counter()
        with ckpt_phase():
            verified = verify_restored(args.ckpt_dir, state,
                                       step=start_step, **on_mesh)
            bad = len(verified["mismatches"]) if mesh is None \
                else _world_sum(mesh, len(verified["mismatches"]))
        ckpt_s.update(restore_s=t1 - t0,
                      verify_s=time.perf_counter() - t1)
        say(f"[train] restore verified: {verified['checked']} leaves, "
            f"{bad} mismatches")
        model.load_stacked(state["params"])
        opt_state = state["opt"] if compressor is None \
            else (state["opt"], state["ef"])
        del state
        resumed = True
        say(f"[train] resumed from step {start_step} ({args.ckpt_dir})")

    saved = start_step if resumed else None
    snapshot_s: List[float] = []

    def save(at: int, blocking: bool = False) -> None:
        """Checkpoint the state after ``at`` steps, once per step."""
        nonlocal saved
        if at == saved:
            return
        saved = at
        t0 = time.perf_counter()
        with ckpt_phase():
            save_checkpoint(args.ckpt_dir, at, state_tree(),
                            keep=args.ckpt_keep, blocking=blocking,
                            extra={"global_batch": args.global_batch,
                                   "seq_len": args.seq_len}, **on_mesh)
        if blocking:
            ckpt_s["save_s"] = time.perf_counter() - t0
        else:
            snapshot_s.append(time.perf_counter() - t0)

    dcfg = DataConfig(seq_len=args.seq_len, global_batch=args.global_batch,
                      vocab_size=cfg.vocab, seed=args.data_seed)
    it = make_train_iterator(dcfg, start_step=start_step, device=dev)
    # each rank takes its rows of the global batch (batch_specs)
    bspecs = batch_specs(cfg, mesh, args.global_batch, False) \
        if mesh is not None else None
    monitor = StragglerMonitor(threshold=args.straggler_threshold)
    timer = StepTimer(monitor)
    losses, step_s, split, words, nbytes = [], [], [], [], []
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    counts.reset_launch_counts()
    t_train0 = time.time()
    routes = collections.Counter()

    def report(**extra) -> None:
        """The port's line beside the reference's summary: the losses
        so far and ``extra`` (what a restart reads); on a mesh rank 0's
        words a step by phase and the checkpoints' words."""
        if mesh is not None:
            extra.update(words=words, ckpt_words=dict(ckpt_words))
        payload = {"start_step": start_step, "losses": losses, **extra}
        port(payload)
        say("[train] port: " + json.dumps(payload))

    def flush() -> None:
        """Before an injected failure surfaces: commit the checkpoints
        still being written (the writer is a daemon thread, so a dying
        process would leave a ``.tmp`` directory), so the restart
        resumes from the last one."""
        it.close()
        wait_for_saves()
        report(kernel_launches=counts.launch_counts(),
               ckpt_s=dict(ckpt_s, snapshot_s=snapshot_s))

    for step in range(start_step, args.steps):
        if args.fail_at is not None and step == args.fail_at \
                and not resumed:
            flush()
            raise InjectedFailure(f"injected failure at step {step}")
        if not resumed:
            try:
                faults.maybe_fail("train:step", step)
            except faults.DeviceLossError:
                flush()                 # a host dropped out
                raise
        batch = next(it)
        if bspecs is not None:
            batch = {k: shard_leaf(v, bspecs[k], mesh)
                     for k, v in batch.items()}
        with timer, capture_routes() as log:
            faults.maybe_fail("train:straggler", step)
            opt_state, metrics = step_fn(opt_state, batch)
            loss = float(metrics["loss"])
        routes.update((r.op, r.n1, r.n2, r.path, r.batch) for r in log)
        losses.append(loss)
        step_s.append(timer.last)
        split.append({k: metrics[k] for k in
                      ("loss_backward_s", "reduce_s", "clip_s",
                       "compress_s", "opt_s")})
        words.append(metrics["words"])
        nbytes.append(metrics["bytes"])
        if timer.event is not None:
            say(f"[straggler] step {step}: {timer.event.action} "
                f"({timer.event.ratio:.1f}x median)")
        asked = timer.event is not None \
            and timer.event.action == "checkpoint"
        if args.ckpt_dir and mesh is not None:
            with ckpt_phase():          # one rank's straggler: all save
                asked = _world_sum(mesh, int(asked)) > 0
        if asked and args.ckpt_dir:
            save(step + 1)
        if step % args.log_every == 0 or step == args.steps - 1:
            comp = f", compress {metrics['compress_s'] * 1e3:.0f} ms" \
                if compressor is not None else ""
            say(f"[train] step {step:5d} loss {loss:.4f} "
                f"({timer.last * 1e3:.0f} ms{comp})")
        # the last step's state is saved once, blocking, below
        if args.ckpt_dir and args.ckpt_every and step + 1 < args.steps \
                and (step + 1) % args.ckpt_every == 0:
            save(step + 1)
    it.close()
    run_steps = args.steps - start_step
    mean_step = (time.time() - t_train0) / max(run_steps, 1)
    launches = counts.launch_counts()
    if args.ckpt_dir:
        wait_for_saves()
        save(args.steps, blocking=True)
        if mesh is not None:
            with ckpt_phase():
                _world_sum(mesh, 0)     # rank 0's last save committed
    timed = step_s[1:] or step_s
    # on a mesh: each Muon matrix leaf's route and this rank's words for
    # it in the last step (``Muon.shard_route``)
    leaf_routes = {"/".join(k): [route, w] for k, (route, w)
                   in sorted(getattr(opt, "routes", {}).items())}
    if leaf_routes:
        say("[train] Muon routes (the last step, this rank's words): "
            + json.dumps(leaf_routes))
    out = {"arch": cfg.name, "params": n_params, "steps": run_steps,
           "final_loss": losses[-1] if losses else None,
           "first_loss": losses[0] if losses else None,
           "mean_step_s": mean_step,
           "straggler_events": len(monitor.events),
           "resumed": resumed,
           "mesh": dict(mesh.shape) if mesh is not None
           else {"data": 1, "model": 1}}
    if args.ckpt_dir:
        out["ckpt_bytes"] = checkpoint_bytes(args.ckpt_dir)["total"]
    if mesh is not None:
        # this rank's collectives over the run, by kind
        out["words_a_rank"] = _by_kind(words)
        out["bytes_a_rank"] = _by_kind(nbytes)
        out["ckpt_words_a_rank"] = dict(ckpt_words)
    say("[train] done: " + json.dumps(out))
    report(kernel_launches=launches,
           ckpt_s=dict(ckpt_s, snapshot_s=snapshot_s))
    out.update({
        "device": describe(dev), "optimizer": args.optimizer,
        "layers": cfg.n_layers, "d_model": cfg.d_model, "d_ff": cfg.d_ff,
        "vocab": cfg.vocab, "start_step": start_step, "losses": losses,
        "step_s": step_s, "split_s": split,
        "compress_grads": compressor is not None,
        "compress_s": [sp["compress_s"] for sp in split],
        "tokens_per_s": args.global_batch * args.seq_len
        * len(timed) / sum(timed) if timed else None,
        "kernel_launches": launches,
        "peak_memory_bytes": torch.cuda.max_memory_allocated(dev)
        if dev.type == "cuda" else None,
        # every blas call planned on this thread during the steps:
        # [op, n1, n2, path, batched, calls]
        "routes": [list(k) + [n] for k, n in sorted(routes.items())],
        "leaf_routes": leaf_routes,
        # restore_s / verify_s when resumed, snapshot_s of each async
        # save (the host copy; the write runs on), save_s of the last
        "ckpt_s": dict(ckpt_s, snapshot_s=snapshot_s),
        "restore_verified": verified,
        # this rank's collectives, a dict per step: {phase: {kind: n}}
        "words": words, "bytes": nbytes})
    return out


def _by_kind(per_step: List[Dict[str, Dict[str, int]]]) -> Dict[str, int]:
    total: Dict[str, int] = collections.Counter()
    for phases in per_step:
        for kinds in phases.values():
            total.update(kinds)
    return dict(total)


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
                    help="ranks to train on: more than one trains on a "
                         "(data, model) mesh of gloo ranks")
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
                    help="cap of the mesh's model axis (plan_shape)")
    ap.add_argument("--compress-grads", action="store_true",
                    help="int8 gradients with error feedback before the "
                         "optimizer (ErrorFeedbackInt8, block 256)")
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
    if args.devices == 1:
        preload_remat()              # the ranks of a mesh run their own
    train(args)


if __name__ == "__main__":
    main()
