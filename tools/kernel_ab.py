#!/usr/bin/env python3
"""Time the symmetric kernels against variants of their own sources.

    python3 tools/kernel_ab.py [--turns 6]

Each variant is the kernels' CUDA source (``src/repro_torch/csrc``) with
one text substitution, built with the same ``nvcc`` flags into
``build/kernels/variants/`` and bound through the same C entry points:

- ``mixed_select``: ``sym_stream`` reads every panel through its
  per-element mode select, without the shortcut for panels whose
  sub-tiles all read one staged array;
- ``nan_guard``: the TF32 rounding of big with a guard that keeps a NaN
  a NaN (the kernels keep it in small instead);
- ``small_rounded``: the small part of the 3xTF32 split rounded to TF32
  as well, instead of left to the tensor cores' truncation (rounds the
  card's NaN to -0: for timing only).

Variants that change the arithmetic (``small_rounded``) are checked to
agree with the repo's kernel within the f32 tolerance, the others bit
for bit.

At the Newton–Schulz shapes (``sym_stream`` product at bm 128 and seed
at bm 32, ``rank_update`` SYRK, at d = 2048 and 1024) it runs the repo's
kernel and each variant on the same inputs, checks their outputs
against each other, and times them in turns (repo, variant,
variant, repo, ...), CUDA events around 20 back-to-back launches a
turn.  Prints the card's name and power limit and one JSON line; needs a
CUDA card and ``nvcc``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

#: variant name -> {file in csrc: (text, replacement)}
VARIANTS = {
    "mixed_select": {
        "sym_stream.cu": ("const int uniform = md[kMaxSub];",
                          "const int uniform = 2;")},
    "nan_guard": {
        "tile_mma.cuh": ("return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;",
                         "return ((__float_as_uint(x) + 0x1000u) & "
                         "0xFFFFE000u) | (x != x ? 0x7FFFFFFFu : 0u);")},
    "small_rounded": {
        "tile_mma.cuh": ("small = __float_as_uint(x - __uint_as_float(big));",
                         "small = rna_tf32(x - __uint_as_float(big));")},
}
#: variants whose arithmetic differs from the repo's: held to TOL_F32
INEXACT = ("small_rounded",)
TOL_F32 = 2e-5
REPS = 20


def build_variants(native):
    """Write each variant's sources and build them all at once (one nvcc
    per source); returns {variant: {entry point: bound function}}."""
    procs = []
    for name, edits in VARIANTS.items():
        out = native.build_dir() / "variants" / name
        out.mkdir(parents=True, exist_ok=True)
        for f in native.SOURCES + native.HEADERS:
            shutil.copy(native.CSRC / f, out / f)
        for f, (old, new) in edits.items():
            text = (out / f).read_text()
            if text.count(old) != 1:
                raise SystemExit(f"{name}: {old!r} not found once in {f}")
            (out / f).write_text(text.replace(old, new))
        for src in ("sym_stream.cu", "rank_update.cu"):
            lib = out / f"{src[:-3]}.so"
            procs.append((name, src, lib, subprocess.Popen(
                [native.nvcc_path(), *native.NVCC_FLAGS, "-I", str(out),
                 "-o", str(lib), str(out / src)], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)))
    funcs = {name: {} for name in VARIANTS}
    for name, src, lib, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed on {name}/{src}:\n{log}")
        handle = ctypes.CDLL(str(lib))
        for fn_name, argtypes in native.SIGNATURES[src].items():
            fn = getattr(handle, fn_name)
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
            funcs[name][fn_name] = fn
    return funcs


def symm_call(torch, trigrid, native, funcs, tiles, b, bm):
    """trigrid.sym_stream's wide path through the given entry point."""
    n1, n2 = b.shape
    nt, dev = n1 // bm, str(b.device)
    rows, cols = trigrid.symm_block(n1, n2, trigrid._sm_count(dev))
    sub, = trigrid._device_tables("subtiles", nt, dev, bm, rows)
    out = torch.empty_like(b)

    def run():
        rc = funcs["repro_sym_stream"](
            bm, rows, cols, tiles.data_ptr(), b.data_ptr(), nt, n2,
            sub.data_ptr(), 1.0, out.data_ptr(), 0,
            torch.cuda.current_stream().cuda_stream)
        native.check(rc, "sym_stream")
        return out
    return run


def syrk_call(torch, trigrid, native, funcs, a, bm):
    """trigrid.rank_update's SYRK through the given entry point."""
    n1, n2 = a.shape
    nt = n1 // bm
    blocks, = trigrid._device_tables("blocks", nt, str(a.device), bm)
    out = torch.empty((nt * (nt + 1) // 2, bm, bm), device=a.device)

    def run():
        rc = funcs["repro_rank_update"](
            0, bm, a.data_ptr(), None, n1, n2, blocks.data_ptr(),
            blocks.shape[0], None, 1.0, 0.0, 1.0, out.data_ptr(), 0,
            torch.cuda.current_stream().cuda_stream)
        native.check(rc, "rank_update")
        return out
    return run


def turn_ms(torch, fn):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(REPS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / REPS


def uniform_share(trigrid, nt, bm, rows):
    """Share of (block, panel) pairs whose sub-tiles all read one array."""
    modes = trigrid.symm_subtiles(nt, bm, rows) & 3
    reads_n = (modes != 1).any(axis=(2, 3))
    reads_t = ((modes == 1) | (modes == 2)).any(axis=(2, 3))
    return float((~(reads_n & reads_t)).mean())


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--turns", type=int, default=6)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.core.packing import TriTiles, pack_tril_tiles
    from repro_torch.device import ieee_f32
    from repro_torch.kernels import native, trigrid
    ieee_f32()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    base = native.load()
    variants = build_variants(native)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    cases = []
    for d in (2048, 1024):
        x = randn(d, d) / d ** 0.5
        g = randn(d, d)
        g = (g + g.T) / 2
        rows = trigrid.symm_block(d, d, trigrid._sm_count(str(dev)))[0]
        cases += [
            (f"sym_stream NS product {d}, bm 128",
             lambda f, x=x, y=randn(d, d): symm_call(
                 torch, trigrid, native, f, pack_tril_tiles(
                     x, 128).contiguous(), y, 128),
             uniform_share(trigrid, d // 128, 128, rows)),
            (f"sym_stream NS seed {d}, bm 32",
             lambda f, g=g, d=d: symm_call(
                 torch, trigrid, native, f, TriTiles.from_tril(
                     g, 32).tiles.contiguous(), torch.eye(d, device=dev), 32),
             uniform_share(trigrid, d // 32, 32, rows)),
            (f"rank_update NS SYRK {d}", lambda f, x=x: syrk_call(
                torch, trigrid, native, f, x, 128), None)]

    result = {"card": card, "reps_per_turn": REPS, "turns": args.turns,
              "cases": []}
    for label, make, share in cases:
        fns = {"repo": make(base)}
        fns.update({n: make(v) for n, v in variants.items()
                    if n != "mixed_select" or label.startswith("sym")})
        want = fns["repo"]().clone()
        for n, fn in fns.items():
            got = fn()
            same = torch.equal(got, want) if n not in INEXACT else float(
                (got - want).abs().max()) <= TOL_F32 * max(
                    1.0, float(want.abs().max()))
            if not same:
                raise SystemExit(f"{label}: {n} differs from the repo's")
        row = {"case": label, "uniform_panel_share": share}
        for n, fn in fns.items():
            if n == "repo":
                continue
            times = {"repo": [], n: []}
            for t in range(args.turns):
                order = ("repo", n) if t % 2 == 0 else (n, "repo")
                for who in order:
                    times[who].append(turn_ms(torch, fns[who]))
            row[n] = {"repo_ms": times["repo"], "variant_ms": times[n],
                      "median_ratio": statistics.median(times[n]) /
                      statistics.median(times["repo"])}
            print(f"{label:34s} {n:14s} repo "
                  f"{statistics.median(times['repo']):.4f} ms  variant "
                  f"{statistics.median(times[n]):.4f} ms", flush=True)
        result["cases"].append(row)
    print(card)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
