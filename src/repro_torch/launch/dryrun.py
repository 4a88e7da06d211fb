"""Dry run of every (arch × shape) cell: the port of
:mod:`repro.launch.dryrun`.

    python -m repro_torch.launch.dryrun --all --out dryrun.jsonl

The reference lowers and compiles each cell for a TPU pod and reads
XLA's cost analysis; it never touches a TPU.  The port builds the model
on the meta device at the published config, runs the cell's own step
(``launch/steps.py``: ``make_train_step``, ``make_prefill_step``,
``make_decode_step``) on the cell's ``input_specs`` under
:class:`~repro_torch.analysis.op_cost.OpCounter`, and turns the count
into the H100 roofline (``analysis/roofline.py``).  It is device-free by
design, as the reference's is: meta tensors carry shapes and no data,
nothing is allocated on any device, no kernel is built, and it runs the
same on a host with or without a card.  It is not a host fallback: it
computes no values.  The hand-written kernels on the path
(``slstm_scan``, ``slstm_scan_bwd``) add their own costs from their
meta branches.  ``rank_update`` and ``sym_stream`` have none: a Muon
step at full width (its Newton–Schulz chain on them) is not a dry-run
cell; ``--optimizer`` AdamW, the reference's default, or its 8-bit
form.

One card: ``chips`` is 1.  ``--multi-pod`` / ``--both-meshes`` (TPU pod
shapes) raise, as ``launch/mesh.py::make_production_mesh`` does, and so
does ``--devices N`` > 1 (the dry run of one rank's block waits for
ROADMAP A12c).  Every config trains on one device, so every
``train_4k`` cell counts, deepseek's included (musicgen's too: its train
step takes frames, which the trainer's own refusal is about, not the
step); ``long_500k``
on a config that is not sub-quadratic is ``skipped``, as the
reference's.

The record keeps the reference's keys.  Those with no counterpart:
``lower_s`` is the counted run's host seconds (building the meta model
and tracing the step), ``compile_s``, ``raw_cost_analysis_*``,
``temp_bytes`` and ``generated_code_bytes`` are null (eager PyTorch
compiles nothing).  ``memory_analysis``'s ``argument_bytes`` are the
step's parameters, optimizer state and inputs (the cache for a decode
step), ``output_bytes`` what it returns (a train step's updated
parameters and state).  The port's own keys: ``scale`` and ``batch``,
``flops_by_dtype``, ``dot_flops_by_dtype``, ``ops``, ``kernels``.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
import traceback
from typing import Any, Dict, Optional

import torch

from ..analysis.op_cost import OpCounter
from ..analysis.roofline import build_roofline
from ..configs import ARCHS, get_config
from ..configs.shapes import SHAPES, cell_applicable, input_specs
from ..models.common import ArchConfig
from ..models.model import Model
from .steps import (init_opt_state, make_decode_step, make_optimizer,
                    make_prefill_step, make_train_step)

META = torch.device("meta")
#: the reference's status of a cell that ``cell_applicable`` refuses
SKIPPED = "skipped (full attention at 500k — DESIGN §5)"


def cell_status(cfg: ArchConfig, shape_name: str) -> Optional[str]:
    """The status of a cell the port does not count (the reference's
    skip), else None."""
    if not cell_applicable(cfg, shape_name):
        return SKIPPED
    return None


def _nbytes(tree) -> int:
    """Bytes of every tensor in a (nested) tree, each once."""
    seen, total = set(), 0

    def walk(x):
        nonlocal total
        if isinstance(x, torch.Tensor):
            if id(x) not in seen:
                seen.add(id(x))
                total += x.numel() * x.element_size()
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):     # the optimizers' states too
            for v in x:
                walk(v)
    walk(tree)
    return total


def model_flops(cfg: ArchConfig, kind: str, batch: int, seq_len: int
                ) -> float:
    """The reference's MODEL_FLOPS: 6·N_active·D (train), 2·N_active·D
    (prefill), 2·N_active·B (decode: one new token a sequence)."""
    n_active = cfg.active_param_count()
    if kind == "train":
        return 6.0 * n_active * batch * seq_len
    if kind == "prefill":
        return 2.0 * n_active * batch * seq_len
    return 2.0 * n_active * batch


def count_cell(cfg: ArchConfig, shape_name: str, *, optimizer: str = "adamw",
               microbatches: int = 1, loss_chunk: int = 512,
               scale: int = 1):
    """Run the cell's step on meta under the op counter: (OpCost,
    argument bytes, output bytes, batch)."""
    cell = SHAPES[shape_name]
    model = Model(cfg, torch.Generator(), META)
    specs = input_specs(cfg, shape_name, scale)
    params = list(model.parameters())
    if cell.kind == "train":
        opt = make_optimizer(cfg, optimizer)
        opt_state = init_opt_state(model, opt)
        step = make_train_step(model, opt, microbatches=microbatches,
                               loss_chunk=loss_chunk)
        args = (params, opt_state, specs)
        with OpCounter() as counter:
            out = step(opt_state, specs)
        out = (list(model.parameters()), out)
    elif cell.kind == "prefill":
        step = make_prefill_step(model, s_max=cell.seq_len)
        args = (params, specs)
        with OpCounter() as counter:
            out = step(specs.get("tokens"), embeds=specs.get("embeds"),
                       patch_embeds=specs.get("patch_embeds"))
    else:
        step = make_decode_step(model)
        args = (params, specs)
        frames = cfg.frontend == "embeddings"
        with OpCounter() as counter:
            out = step(None if frames else specs["token"], specs["pos"],
                       specs["cache"],
                       embeds=specs["token"] if frames else None)
    batch = next(iter(specs.values())).shape[0]
    return counter.cost, _nbytes(args), _nbytes(out), batch


def dryrun_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
                optimizer: str = "adamw", microbatches: int = 1,
                loss_chunk: int = 512, verbose: bool = True,
                cfg: Optional[ArchConfig] = None,
                scale: int = 1) -> Dict[str, Any]:
    """Count one (arch × shape) cell on meta and return its record.
    ``cfg`` overrides the published config (the tests' smoke configs);
    ``scale`` divides the cell's batch as ``input_specs`` does."""
    if multi_pod:
        raise NotImplementedError(
            "--multi-pod is a TPU pod shape (2x16x16); the port's dry run "
            "counts one H100 (chips 1)")
    cfg = cfg or get_config(arch)
    cell = SHAPES[shape_name]
    status = cell_status(cfg, shape_name)
    if status is not None:
        return {"arch": arch, "shape": shape_name, "multi_pod": False,
                "status": status}
    chips = 1
    t0 = time.perf_counter()
    cost, arg_bytes, out_bytes, batch = count_cell(
        cfg, shape_name, optimizer=optimizer, microbatches=microbatches,
        loss_chunk=loss_chunk, scale=scale)
    t_trace = time.perf_counter() - t0
    roof = build_roofline(cost, chips)
    mflops = model_flops(cfg, cell.kind, batch, cell.seq_len)
    rec = {
        "arch": arch, "shape": shape_name, "multi_pod": False,
        "chips": chips, "optimizer": optimizer if cell.kind == "train"
        else None,
        "status": "ok", "scale": scale, "batch": batch,
        "lower_s": round(t_trace, 1), "compile_s": None,
        "flops_per_device": roof.flops,
        "raw_cost_analysis_flops": None,
        "raw_cost_analysis_bytes": None,
        "model_flops_total": mflops,
        "model_vs_hlo_flops": mflops / max(roof.flops * chips, 1e-30),
        "unknown_trip_whiles": roof.unknown_trip_whiles,
        "hbm_bytes_per_device": roof.hbm_bytes,
        "collective_operand_bytes": roof.collective_bytes,
        "collective_wire_bytes": roof.wire_bytes,
        "collective_counts": dict(cost.collective_counts),
        "collective_by_kind": dict(cost.collective_by_kind),
        "compute_s": roof.compute_s,
        "memory_s": roof.memory_s,
        "collective_s": roof.collective_s,
        "dominant": roof.dominant,
        "roofline_fraction": roof.roofline_fraction(),
        "memory_analysis": {"output_bytes": out_bytes, "temp_bytes": None,
                            "argument_bytes": arg_bytes,
                            "generated_code_bytes": None},
        "flops_by_dtype": dict(cost.flops_by_dtype),
        "dot_flops_by_dtype": dict(cost.dot_flops_by_dtype),
        "ops": cost.ops, "kernels": dict(cost.kernels),
    }
    if verbose:
        print(f"[dryrun] {arch} × {shape_name} × 1 H100 (batch {batch}): "
              f"OK (trace {t_trace:.1f}s, {cost.ops} ops)")
        print(f"  cost: flops/device={roof.flops:.3e} by dtype "
              f"{ {k: f'{v:.3e}' for k, v in cost.flops_by_dtype.items()} } "
              f"eager bytes/device={roof.hbm_bytes:.3e}")
        print(f"  roofline: compute={roof.compute_s*1e3:.2f}ms "
              f"memory={roof.memory_s*1e3:.2f}ms "
              f"collective={roof.collective_s*1e3:.2f}ms "
              f"dominant={roof.dominant} "
              f"fraction={roof.roofline_fraction():.3f}")
        print(f"  model_flops={mflops:.3e} "
              f"useful-ratio={rec['model_vs_hlo_flops']:.3f}")
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="dry run of the shape cells on the meta device (no "
                    "card needed): op counts and the H100 roofline")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES) + [None])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="sweep every (arch x shape) cell")
    ap.add_argument("--optimizer", default="adamw")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--loss-chunk", type=int, default=512)
    ap.add_argument("--devices", type=int, default=1)
    ap.add_argument("--out", default=None, help="append JSONL records here")
    args = ap.parse_args(argv)
    if args.multi_pod or args.both_meshes:
        raise NotImplementedError(
            "--multi-pod / --both-meshes are TPU pod shapes; the port's dry "
            "run counts one H100 (chips 1)")
    if args.devices != 1:
        raise NotImplementedError(
            f"--devices {args.devices}: the dry run of one rank's block on "
            "a mesh waits for ROADMAP A12c; the port counts one H100")

    archs = ARCHS if (args.all or args.arch is None) else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape is None) \
        else [args.shape]
    failures = 0
    for arch in archs:
        for shape in shapes:
            try:
                rec = dryrun_cell(arch, shape, optimizer=args.optimizer,
                                  microbatches=args.microbatches,
                                  loss_chunk=args.loss_chunk)
            except Exception as e:  # noqa: BLE001
                traceback.print_exc()
                rec = {"arch": arch, "shape": shape, "multi_pod": False,
                       "status": f"FAILED: {e}"}
                failures += 1
            if rec["status"] != "ok":
                print(f"[dryrun] {arch} × {shape}: {rec['status']}")
            if args.out:
                with open(args.out, "a") as f:
                    f.write(json.dumps(rec) + "\n")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
