#!/usr/bin/env python3
"""Time the hand-written kernels against variants of their own sources.

    python3 tools/kernel_ab.py [--turns 6] [--kernels all|symmetric|slstm]
                               [--sass PATH]

Each variant is the kernels' CUDA source (``src/repro_torch/csrc``) with
its text substitutions, built with the same ``nvcc`` flags into
``build/kernels/variants/`` and bound through the same C entry points:

- ``mixed_select``: ``sym_stream`` reads every panel through its
  per-element mode select, without the shortcut for panels whose
  sub-tiles all read one staged array;
- ``nan_guard``: the TF32 rounding of big with a guard that keeps a NaN
  a NaN (the kernels keep it in small instead);
- ``small_rounded``: the small part of the 3xTF32 split rounded to TF32
  as well, instead of left to the tensor cores' truncation (rounds the
  card's NaN to -0: for timing only);
- ``no_ring``: ``slstm_scan`` loads each step's gate quad straight from
  memory instead of through its cp.async ring (no ring in shared
  memory);
- ``ahead_after_divisions``: ``slstm_scan`` reads the next group of
  steps and computes its state-free part after the group's divisions
  instead of between its c, n chain and its divisions;
- ``ring_16``, ``ring_64``: ``slstm_scan``'s ring of 16 or 64 steps a
  thread instead of 32 (8 or 56 steps ahead instead of 24);
- ``group_1``, ``group_4``, ``group_16``: ``slstm_scan`` works on 1, 4
  or 16 steps side by side instead of 8 (16 steps ahead with 16);
- ``two_divisions``: ``slstm_scan`` computes y as the plain version
  does, σ(o) = 1/(1 + e^{-o}) and then σ(o)·c / max(n, 1) (held to the
  kernel's tolerance, not bit for bit).

Variants of the symmetric kernels that change the arithmetic
(``small_rounded``) are checked to agree with the repo's kernel within
the f32 tolerance, the others bit for bit; ``slstm_scan``'s variants
within its tolerance (another instruction order may contract another
product into an FMA).

At the Newton–Schulz shapes (``sym_stream`` product at bm 128 and seed
at bm 32, ``rank_update`` SYRK, at d = 2048 and 1024) it runs the repo's
kernel and each variant on the same inputs, checks their outputs
against each other, and times them in turns (repo, variant,
variant, repo, ...), CUDA events around 20 back-to-back launches a
turn.  ``slstm_scan`` (the mixer's quad layout, warm state) runs the same
way at the reference's traffic shape (16, 4096, 1024) with f32 and bf16
gates, the serve's largest prefill bucket (1, 256, 1024) and a 4-slot
decode step, each variant held to the repo's within the kernel's
tolerance (y 2e-5, state 2e-4, relative and absolute).  Prints the
card's name and power limit and one JSON line; needs a CUDA card and
``nvcc``.
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

#: variant name -> {file in csrc: ((text, replacement), ...)}, each text
#: found exactly once
VARIANTS = {
    "mixed_select": {
        "sym_stream.cu": (("const int uniform = md[kMaxSub];",
                           "const int uniform = 2;"),)},
    "nan_guard": {
        "tile_mma.cuh": ((
            "return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;",
            "return ((__float_as_uint(x) + 0x1000u) & "
            "0xFFFFE000u) | (x != x ? 0x7FFFFFFFu : 0u);"),)},
    "small_rounded": {
        "tile_mma.cuh": ((
            "small = __float_as_uint(x - __uint_as_float(big));",
            "small = rna_tf32(x - __uint_as_float(big));"),)},
    "no_ring": {
        "slstm_scan.cu": (
            ("      for (int j = 0; j < kAhead; ++j) issue();\n", ""),
            ("    cp_async_wait<kAhead - K>();  // steps j .. j+K-1 have "
             "landed\n"
             "#pragma unroll\n"
             "    for (int u = 0; u < K; ++u) {\n"
             "      q[u] = G::unpack(ring[((j + u) & (kRing - 1)) * "
             "kChannels]);\n"
             "    }\n",
             "#pragma unroll\n"
             "    for (int u = 0; u < K; ++u) {\n"
             "      q[u] = G::unpack(__ldg(reinterpret_cast<const Q*>(\n"
             "          src + min(j + u, n - 1) * step)));\n"
             "    }\n"),
            ("    for (int u = 0; u < K; ++u) issue();\n", ""),
            ("return kQuad ? kRing * kChannels * int(sizeof(typename "
             "G::Quad)) : 0;", "return 0;"))},
    "ahead_after_divisions": {
        "slstm_scan.cu": ((
            "        gate.template refill<kGroup>();\n"
            "        gate.template fetch<kGroup>(j + kGroup, qn);\n"
            "        frn.of(qn);\n"
            "      });\n",
            "        gate.template refill<kGroup>();\n"
            "      });\n"
            "      gate.template fetch<kGroup>(j + kGroup, qn);\n"
            "      frn.of(qn);\n"),)},
    "ring_16": {
        "slstm_scan.cu": (("constexpr int kRing = 32;",
                           "constexpr int kRing = 16;"),)},
    "ring_64": {
        "slstm_scan.cu": (("constexpr int kRing = 32;",
                           "constexpr int kRing = 64;"),)},
    "group_1": {
        "slstm_scan.cu": (("constexpr int kGroup = 8;",
                           "constexpr int kGroup = 1;"),)},
    "group_4": {
        "slstm_scan.cu": (("constexpr int kGroup = 8;",
                           "constexpr int kGroup = 4;"),)},
    "group_16": {
        "slstm_scan.cu": (("constexpr int kGroup = 8;",
                           "constexpr int kGroup = 16;"),)},
    "two_divisions": {
        "slstm_scan.cu": (("    fr.den[u] *= fmaxf(nn, 1.0f);\n"
                           "    cy[u] = c;",
                           "    cy[u] = 1.0f / fr.den[u] * c;\n"
                           "    fr.den[u] = fmaxf(nn, 1.0f);"),)},
}
#: the sources each edited file is built into
BUILDS = {"tile_mma.cuh": ("sym_stream.cu", "rank_update.cu")}
#: (B, S, d, gate dtype) of the slstm_scan cases
SLSTM_AB = ((16, 4096, 1024, "f32"), (16, 4096, 1024, "bf16"),
            (1, 256, 1024, "bf16"), (4, 1, 1024, "bf16"))
#: variants whose arithmetic differs from the repo's: held to TOL_F32
INEXACT = ("small_rounded",)
#: the variants of the symmetric kernels (the rest are slstm_scan's)
SYMM_VARIANTS = ("mixed_select", "nan_guard", "small_rounded")

TOL_F32 = 2e-5
REPS = 20


def variant_sources(csrc, edits):
    """{file: text} of a variant's edited files (``edits`` one entry of
    ``VARIANTS``); raises where a text is not found exactly once."""
    out = {}
    for f, pairs in edits.items():
        text = (csrc / f).read_text()
        for old, new in pairs:
            if text.count(old) != 1:
                raise SystemExit(f"{old!r} not found once in {f}")
            text = text.replace(old, new)
        out[f] = text
    return out


def build_variants(native, kernels="all"):
    """Write each variant's sources and build them all at once (one nvcc
    per source); returns {variant: {entry point: bound function}}."""
    procs = []
    for name, edits in VARIANTS.items():
        if kernels != "all" and (name in SYMM_VARIANTS) != (
                kernels == "symmetric"):
            continue
        out = native.build_dir() / "variants" / name
        out.mkdir(parents=True, exist_ok=True)
        for f in native.SOURCES + native.HEADERS:
            shutil.copy(native.CSRC / f, out / f)
        srcs = []
        for f, text in variant_sources(native.CSRC, edits).items():
            (out / f).write_text(text)
            srcs += BUILDS.get(f, (f,))
        for src in srcs:
            lib = out / f"{src[:-3]}.so"
            procs.append((name, src, lib, subprocess.Popen(
                [native.nvcc_path(), *native.NVCC_FLAGS, "-I", str(out),
                 "-o", str(lib), str(out / src)], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)))
    funcs = {name: {} for name, *_ in procs}
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
            bm, rows, cols, tiles.data_ptr(), b.data_ptr(), nt, n2, 1,
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
            0, bm, a.data_ptr(), None, n1, n2, 1, blocks.data_ptr(),
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


def symm_same(torch, got, want, exact):
    if exact:
        return torch.equal(got, want)
    return float((got - want).abs().max()) <= TOL_F32 * max(
        1.0, float(want.abs().max()))


def slstm_same(torch, got, want, exact):
    """Bit for bit, or within the kernel's tolerance of the repo's."""
    if exact:
        return all(torch.equal(g, w) for g, w in zip(got, want))
    return all(bool(((g - w).abs() <= tol * (1 + w.abs())).all())
               for g, w, tol in zip(got, want, (2e-5,) + (2e-4,) * 3))


def ab_row(torch, label, fns, turns, exact, same):
    """Check every variant against the repo's output (``exact(name)``:
    bit for bit, else ``same``'s tolerance), then time each against the
    repo's in turns; returns the case's row."""
    def snap(x):
        return tuple(t.clone() for t in x) if isinstance(x, tuple) \
            else x.clone()
    want = snap(fns["repo"]())
    for n, fn in fns.items():
        if not same(torch, fn(), want, exact(n)):
            raise SystemExit(f"{label}: {n} differs from the repo's")
    row = {"case": label}
    for n, fn in fns.items():
        if n == "repo":
            continue
        times = {"repo": [], n: []}
        for t in range(turns):
            order = ("repo", n) if t % 2 == 0 else (n, "repo")
            for who in order:
                times[who].append(turn_ms(torch, fns[who]))
        row[n] = {"repo_ms": times["repo"], "variant_ms": times[n],
                  "median_ratio": statistics.median(times[n]) /
                  statistics.median(times["repo"])}
        print(f"{label:38s} {n:14s} repo "
              f"{statistics.median(times['repo']):.4f} ms  variant "
              f"{statistics.median(times[n]):.4f} ms", flush=True)
    return row


def slstm_rows(torch, base, variants, randn, dev, turns):
    """``slstm_scan`` on the mixer's quad views (warm state): the repo's
    build against the source variants."""
    from repro_torch.kernels import slstm
    rows = []
    scale = torch.tensor([1.0, 2.5, 2.5, 1.0], device=dev)
    for b, s, d, dt in SLSTM_AB:
        dtype = torch.float32 if dt == "f32" else torch.bfloat16
        gates = (randn(b, s, d, 4) * scale).to(dtype).unbind(-1)
        st = (randn(b, d), 1.0 + randn(b, d).abs(), randn(b, d))

        def run(funcs):
            return lambda: slstm._launch(funcs, gates, st, b, s, d)
        fns = {"repo": run(base)}
        fns.update({n: run(f) for n, f in variants.items()
                    if n not in SYMM_VARIANTS})
        rows.append(ab_row(torch, f"slstm_scan ({b}, {s}, {d}) {dt}", fns,
                           turns, lambda n: False, slstm_same))
    return rows


def uniform_share(trigrid, nt, bm, rows):
    """Share of (block, panel) pairs whose sub-tiles all read one array."""
    modes = trigrid.symm_subtiles(nt, bm, rows) & 3
    reads_n = (modes != 1).any(axis=(2, 3))
    reads_t = ((modes == 1) | (modes == 2)).any(axis=(2, 3))
    return float((~(reads_n & reads_t)).mean())


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--turns", type=int, default=6)
    ap.add_argument("--kernels", choices=("all", "symmetric", "slstm"),
                    default="all")
    ap.add_argument("--sass", metavar="PATH",
                    help="also write cuobjdump -sass of the slstm_scan "
                         "library to PATH")
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
    if args.sass:
        tool = os.path.join(os.path.dirname(native.nvcc_path()), "cuobjdump")
        with open(args.sass, "w") as f:
            subprocess.run([tool, "-sass", str(native._lib_path(
                "slstm_scan.cu"))], stdout=f, check=True)
    variants = build_variants(native, args.kernels)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    cases = []
    for d in (2048, 1024) if args.kernels in ("all", "symmetric") else ():
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
                    if n in SYMM_VARIANTS and (
                        n != "mixed_select" or label.startswith("sym"))})
        row = ab_row(torch, label, fns, args.turns,
                     lambda n: n not in INEXACT, symm_same)
        row["uniform_panel_share"] = share
        result["cases"].append(row)
    if args.kernels in ("all", "slstm"):
        result["cases"] += slstm_rows(torch, base, variants, randn, dev,
                                      args.turns)
    print(card)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
