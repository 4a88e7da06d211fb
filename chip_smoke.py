#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero):

1. probe   — the card's name and power limit, torch / CUDA / nvcc /
             triton versions;
2. build   — compiles the hand-written kernels (``src/repro_torch/csrc``,
             one nvcc per source, in parallel) and reports the seconds;
3. kernels — runs ``rank_update`` (SYRK / SYR2K bodies, epilogue
             variants, every tile size), ``sym_stream`` (SYMM) and
             ``slstm_scan`` (the sLSTM recurrence) on the card at the
             serving paths' shapes and holds each against its plain
             PyTorch version on the same inputs, with the tolerance
             printed beside the error (and a 1xTF32 emulation that must
             miss it); times the kernel, the plain version and, where
             one exists, one PyTorch call computing the same function
             (``torch.matmul``; none for the sLSTM recurrence), and the
             embedding and Gram update also inside a CUDA graph (device
             time without the host).  ``slstm_scan`` runs f32 and bf16
             gates in the mixer's quad layout and in other views, its
             edges (S = 1, S below the ring's lookahead, S not a
             multiple of the step group, ragged d, n0 in (0, 1)) and a
             long single prefill, every case also in a CUDA graph,
             beside its byte bound and an issue bound read from the
             SASS of its step loop;
4. serve   — serves stablelm-1.6b at full width (24 layers, d_model
             2048, vocab 100352; random weights from a seed) with the
             whitening cache on, and asserts that every request
             completes, every embedding is finite, a factor was
             refreshed and both symmetric kernels launched;
5. xlstm   — serves xlstm-350m at full width (24 layers, d_model 1024,
             vocab 50304, 6 sLSTM layers; random weights from a seed)
             the same way, and asserts that ``slstm_scan`` launched
             exactly 6 times per model forward the server ran, always
             on the mixer's bf16 quad views and never through its plain
             version, and both symmetric kernels launched; then times
             one prefill per block kind (host clock, a sync after every
             block);
6. check   — reduced stablelm and xlstm models on the card against the
             same weights on the CPU, and the full-width Newton–Schulz
             whitening on the kernels against the eigh oracle, then
             timed alone at d = 2048 and 1024;
7. train   — ``rank_update`` (SYRK, with and without the accumulate
             epilogue) and ``sym_stream`` at every shape the Muon step
             gives them against their plain versions, each matrix of a
             stack bit for bit against its own launch, timed against k
             launches, the plain version and ``torch.bmm``; autodiff through ``blas.syrk`` /
             ``syr2k`` / ``symm`` (every fill) on the kernels against the
             dense IEEE route; one Muon NS of a (24, 2048, 5632) momentum
             on the kernels against the plain versions, and one of each
             leaf shape of the model, timed (where the optimizer's time
             goes); then trains stablelm-1.6b at full width (24 layers,
             d_model 2048, d_ff 5632, vocab 100352; random bf16 init from
             seed 0; 8 x 256 tokens a step) for 6 Muon steps and 2 AdamW
             steps, printing the losses, the split of each step,
             tokens/s, peak memory, the kernels' launches a step and the
             captured routes, and asserting that every NS SYRK / SYMM
             with n1 >= 256 ran on the kernels, one launch per blas call;
8. mesh    — the paper's parallel schedules behind ``blas.syrk`` /
             ``syr2k`` / ``symm(mesh=...)`` at the stablelm-1.6b MLP leaf
             Muon grams (n1 = 2048, n2 = 5632), P ranks as processes of
             one gloo group all on this card, the wire host-staged: 1d
             and ring at P = 4, 2d at P = 6, 3d and 3d-limited (under an
             ``M=`` budget the planner turns into it) at P = 12, each
             route pinned with ``blas.pinned(Route(...))``; each case
             against a dense f32 ``torch.matmul`` oracle on rank 0
             (relative error <= 2e-5), with its schedule's words a rank
             by collective kind, the words that replicate its result
             apart, the planner's predicted words, the lower
             bound and ms (CUDA events on rank 0, mean over a >= 25 ms
             window of >= 3 calls); one single-device blas call of each
             op timed beside them; the planner's own pick at each P;
             then Muon's
             ``orthogonalize_1d`` of a (24, 2048, 5632) stack on P = 4
             (its column shards gathered for the check) against the
             single-device ``orthogonalize_reference`` on the card
             (2e-3).  The mesh path launches none of the three
             kernels; its launch counts are printed and must read 0.

The line before the last is a JSON object with one entry per kernel;
the last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

#: published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, dense TF32
#: tensor-core FLOP/s, and FP32 FLOP/s outside the tensor cores.  The
#: symmetric kernels reach f32 accuracy with three TF32 products per
#: product (3xTF32), so their least time is max(bytes / HBM rate,
#: 3 · flops / TF32 rate); ``ffma_bound_ms`` keeps the FFMA-only bound
#: (flops / FP32 rate) of the earlier rows beside it.
PEAK_BYTES_S = 3.35e12
PEAK_TF32_FLOP_S = 495e12
PEAK_FP32_FLOP_S = 67e12
DEVICE = "cuda"
TOL_F32 = 2e-5      # max |kernel − plain| / max(1, max |plain|), f32 out
TOL_BF16 = 1e-2     # the same for a bf16 output (2^-8 relative rounding)

#: the sLSTM kernel's tolerances are the reference kernel test's
#: (tests/test_slstm_kernel.py): |got − want| ≤ tol·(1 + |want|)
SLSTM_Y_TOL = 2e-5
SLSTM_STATE_TOL = 2e-4
#: f32 operations per (b, t, channel) step of the sLSTM recurrence: adds,
#: subtractions, maxima, multiplies and divisions (an FMA counts 2), and
#: the three exp and one tanh counted once each
SLSTM_OPS_PER_STEP = 20

REPLACES = {
    "rank_update": "src/repro/kernels/trigrid.py:151",
    "sym_stream": "src/repro/kernels/trigrid.py:224",
    "slstm_scan": "src/repro/kernels/slstm.py:59",
}
SOURCES = {
    "rank_update": "src/repro_torch/csrc/rank_update.cu",
    "sym_stream": "src/repro_torch/csrc/sym_stream.cu",
    "slstm_scan": "src/repro_torch/csrc/slstm_scan.cu",
}


def log(*a):
    print(*a, flush=True)


def smi(query: str = "name,power.limit") -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip() \
        .splitlines()[0]


# --------------------------------------------------------------------------
# phase 1: probe
# --------------------------------------------------------------------------
def probe(torch):
    """The card's name and power limit, and its highest SM clock in MHz
    (the issue rate of the sLSTM kernel's bound)."""
    card = smi()
    clock = float(smi("clocks.max.sm").split()[0])
    log(f"[probe] gpu: {card}, max SM clock {clock:.0f} MHz")
    log(f"[probe] python {sys.version.split()[0]}  torch {torch.__version__}"
        f"  cuda {torch.version.cuda}  device "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    from repro_torch.kernels import native
    nv = subprocess.run([native.nvcc_path(), "--version"],
                        capture_output=True, text=True).stdout.strip()
    log(f"[probe] nvcc: {nv.splitlines()[-1] if nv else 'missing'}")
    try:
        import triton
        log(f"[probe] triton {triton.__version__}")
    except ImportError:
        log("[probe] triton not importable")
    return card, clock


# --------------------------------------------------------------------------
# phase 2: build
# --------------------------------------------------------------------------
def build() -> float:
    from repro_torch.kernels import native
    t0 = time.perf_counter()
    native.load()
    secs = time.perf_counter() - t0
    log(f"[build] {len(native.SOURCES)} sources, built "
        f"{native.BUILD_INFO['built']} in {secs:.2f} s into "
        f"{native.build_dir()}")
    for ln in str(native.BUILD_INFO["ptxas"]).splitlines():
        if "registers" in ln or "spill" in ln and " 0 bytes" not in ln:
            log("[build]   " + ln.strip())
    return secs


# --------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# --------------------------------------------------------------------------
def cuda_ms(torch, fn, window_ms: float = 25.0, warmup: int = 3) -> float:
    """Mean device ms per call over a window of at least ``window_ms``
    (at least 10 calls), so that a short kernel is timed over enough
    launches for the clocks to settle."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)

    def timed(reps):
        torch.cuda.synchronize()
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    fn()                                  # first call: lazy set-up
    est = timed(warmup)
    return timed(max(10, int(window_ms / max(est, 1e-3)) + 1))


def graph_ms(torch, fn, reps: int = 50) -> float:
    """Device ms per call with the host out of the way: ``reps`` calls
    captured in one CUDA graph, replayed and timed with events.  For a
    call whose back-to-back rate (``cuda_ms``) is set by its host cost."""
    fn()                                  # lazy set-up outside the graph
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    return cuda_ms(torch, graph.replay) / reps


def bound_ms(nbytes: float, flops: float, tensor: bool = True):
    """(least ms, what bounds it) for moving ``nbytes`` through HBM and
    doing ``flops`` f32-accurate operations: on the tensor cores in
    3xTF32 (``tensor``), else in FP32 FFMA."""
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = (3 * flops / PEAK_TF32_FLOP_S if tensor else
             flops / PEAK_FP32_FLOP_S) * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations")


def compare(torch, name, got, want, out_dtype, nans=False):
    """got within the tolerance of want, and finite; with ``nans``, NaN
    exactly where want has NaN (somewhere) and within it elsewhere."""
    got, want = got.float(), want.float()
    where_nan = torch.isnan(want)
    nan_ok = bool(torch.equal(torch.isnan(got), where_nan))
    if nans:
        nan_ok = nan_ok and bool(where_nan.any())
        got, want = got[~where_nan], want[~where_nan]
    err = float((got - want).abs().max())
    scale = max(1.0, float(want.abs().max()))
    tol = TOL_BF16 if out_dtype == torch.bfloat16 else TOL_F32
    ok = err / scale <= tol and bool(torch.isfinite(got).all()) and nan_ok
    log(f"[kernels] {name:44s} max_abs_err {err:.3e} (rel {err / scale:.2e}"
        f" <= {tol:.0e}){' NaN where plain has' if nans else ''} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"kernel {name} disagrees with its plain version")
    return err


def kernel_phase(torch, card_clock_mhz):
    from repro_torch.core.packing import TriTiles, pack_tril_tiles
    from repro_torch.kernels import trigrid

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    f32, bf16 = torch.float32, torch.bfloat16
    cases = {"rank_update": [], "sym_stream": [], "slstm_scan": []}

    def timing(row, kernel, plain, library, nbytes, flops, tensor=True):
        row["ms"] = cuda_ms(torch, kernel)
        row["plain_ms"] = cuda_ms(torch, plain)
        row["library_ms"] = cuda_ms(torch, library)
        row["bound_ms"], row["bound_by"] = bound_ms(nbytes, flops, tensor)
        log(f"[kernels]   ms {row['ms']:.4f}  plain {row['plain_ms']:.4f}"
            f"  library {row['library_ms']:.4f}  bound "
            f"{row['bound_ms']:.4f} ({row['bound_by']}; FFMA "
            f"{row['ffma_bound_ms']:.4f})")

    def rank_case(label, body, a, b=None, bm=128, ep=None, c0=None,
                  timed=False, main=False):
        ep = ep or trigrid.Epilogue()
        got = trigrid.rank_update(body, a, b, bm=bm, epilogue=ep, c0=c0)
        want = trigrid._rank_update_plain(body, a, b, bm, ep, c0)
        err = compare(torch, f"rank_update {label}", got, want,
                      ep.out_dtype)
        n1, n2 = a.shape
        m = 1 if body == "syrk" else 2
        T = (n1 // bm) * (n1 // bm + 1) // 2
        out_b = T * bm * bm * (2 if ep.out_dtype == bf16 else 4)
        nbytes = m * n1 * n2 * 4 + out_b + (out_b if c0 is not None else 0)
        flops = m * n1 * (n1 + 1) * n2        # useful half, 2 flops / FMA
        row = {"case": label, "max_abs_err": err, "main": main,
               "bound_ms": bound_ms(nbytes, flops)[0],
               "ffma_bound_ms": bound_ms(nbytes, flops, False)[0]}
        if timed:
            lib = (lambda: a @ a.T) if body == "syrk" else \
                (lambda: torch.addmm(a @ b.T, b, a.T))
            timing(row, lambda: trigrid.rank_update(
                body, a, b, bm=bm, epilogue=ep, c0=c0),
                lambda: trigrid._rank_update_plain(body, a, b, bm, ep, c0),
                lib, nbytes, flops)
        cases["rank_update"].append(row)

    def symm_case(label, tiles, b, bm, ds=1.0, out_dtype=f32, dense=None,
                  timed=False, main=False):
        got = trigrid.sym_stream(tiles, b, bm=bm, out_dtype=out_dtype,
                                 diag_scale=ds)
        nt = b.shape[0] // bm
        want = trigrid._sym_stream_plain(tiles, b, nt, ds, out_dtype)
        err = compare(torch, f"sym_stream {label}", got, want, out_dtype)
        n1, n2 = b.shape
        nbytes = tiles.numel() * 4 + n1 * n2 * 4 + n1 * n2 * (
            2 if out_dtype == bf16 else 4)
        flops = 2 * n1 * n1 * n2
        # n2 <= 8 runs the FFMA matrix-vector kernel, wider B 3xTF32
        tensor = n2 > trigrid.NARROW_MAX_N2
        row = {"case": label, "max_abs_err": err, "main": main,
               "bound_ms": bound_ms(nbytes, flops, tensor)[0],
               "ffma_bound_ms": bound_ms(nbytes, flops, False)[0]}
        if timed:
            timing(row, lambda: trigrid.sym_stream(
                tiles, b, bm=bm, out_dtype=out_dtype, diag_scale=ds),
                lambda: trigrid._sym_stream_plain(tiles, b, nt, ds,
                                                  out_dtype),
                lambda: dense @ b, nbytes, flops, tensor)
        cases["sym_stream"].append(row)
        return got

    d = 2048
    # Gram updates: feats (2048, bucket) for every prefill bucket
    for bucket in (16, 32, 64, 128, 256):
        rank_case(f"syrk packed 2048x{bucket}", "syrk", randn(d, bucket),
                  timed=bucket == 64)
    gram = cases["rank_update"][2]
    a_g = randn(d, 64)
    gram["device_ms"] = graph_ms(torch, lambda: trigrid.rank_update(
        "syrk", a_g, bm=128))
    gram["library_device_ms"] = graph_ms(torch, lambda: a_g @ a_g.T)
    log(f"[kernels]   in a CUDA graph (device time, no host): ms "
        f"{gram['device_ms']:.4f}  library {gram['library_device_ms']:.4f}")
    # Newton–Schulz T² (fill="full") and the SYR2K body
    t = randn(d, d) / d ** 0.5
    rank_case("syrk full 2048x2048 (NS T^2)", "syrk", t, timed=True,
              main=True)
    rank_case("syr2k 2048x2048", "syr2k", t, randn(d, d) / d ** 0.5,
              timed=True)
    # xlstm's refresh at d = 1024: 64-blocks
    t1 = randn(1024, 1024) / 1024 ** 0.5
    rank_case("syrk full 1024x1024 (xlstm NS T^2)", "syrk", t1, timed=True)
    rank_case("syrk packed 1024x64 (xlstm Gram)", "syrk", randn(1024, 64),
              timed=True)
    # epilogue variants: alpha, beta·C0, diag_scale, bf16 out, every bm
    a64, b64 = randn(d, 64), randn(d, 64)
    c0 = randn(136, 128, 128)
    rank_case("syrk alpha 0.5 beta 2 c0", "syrk", a64, ep=trigrid.Epilogue(
        alpha=0.5, beta=2.0, accumulate=True), c0=c0)
    rank_case("syr2k diag_scale 0.5", "syr2k", a64, b64,
              ep=trigrid.Epilogue(diag_scale=0.5))
    rank_case("syr2k diag_scale 2 bf16 out", "syr2k", a64, b64,
              ep=trigrid.Epilogue(diag_scale=2.0, out_dtype=bf16))
    rank_case("syrk bf16 out beta c0", "syrk", a64, ep=trigrid.Epilogue(
        beta=1.0, accumulate=True, out_dtype=bf16), c0=c0)
    c0_nan = randn(36, 128, 128)
    up = torch.triu(torch.ones(128, 128, device=dev, dtype=torch.bool), 1)
    diag_t = torch.arange(8, device=dev) * (torch.arange(8, device=dev) + 3)
    c0_nan[diag_t // 2] = torch.where(up, float("nan"), c0_nan[diag_t // 2])
    rank_case("syrk 1024x64 beta c0, NaN in C0's upper halves", "syrk",
              randn(1024, 64), ep=trigrid.Epilogue(
                  beta=0.5, accumulate=True), c0=c0_nan)
    for bm in (8, 16, 32, 64):
        n = 16 * bm
        rank_case(f"syrk {n}x40 bm {bm} ragged k", "syrk", randn(n, 40),
                  bm=bm)
        rank_case(f"syr2k {n}x24 bm {bm}", "syr2k", randn(n, 24),
                  randn(n, 24), bm=bm)
    rank_case("syrk 160x37 bm 32 (4 B copies, ragged blocks)", "syrk",
              randn(160, 37), bm=32)
    rank_case("syr2k 1024x37 bm 128 (4 B copies)", "syr2k",
              randn(1024, 37), randn(1024, 37))

    # SYMM: NS seed (Gram TriTiles bm 32 times I), NS products (bm 128),
    # the embedding (n2 = 1, unpadded as the serve calls it, and padded to
    # 128), poison
    g = randn(d, d)
    g = (g + g.T) / 2
    gt = TriTiles.from_tril(g, 32).tiles.contiguous()
    eye = torch.eye(d, device=dev)
    symm_case("TriTiles bm 32 x I (NS seed)", gt, eye, 32, dense=g,
              timed=True)
    x = randn(d, d) / d ** 0.5
    xt = pack_tril_tiles(x, 128).contiguous()
    xs = torch.tril(x) + torch.tril(x, -1).T
    y = randn(d, d)
    got_ns = symm_case("dense 2048^2 x 2048^2 (NS)", xt, y, 128, dense=xs,
                       timed=True, main=True)
    tf32_case(torch, got_ns, xs, y)
    p = torch.zeros(d, 128, device=dev)
    p[:, 0] = randn(d)
    symm_case("2048^2 x (2048, 1) padded to 128", xt, p, 128, dense=xs,
              timed=True)
    p1 = p[:, :1].contiguous()
    symm_case("2048^2 x (2048, 1) unpadded (embedding)", xt, p1, 128,
              dense=xs, timed=True)
    emb = cases["sym_stream"][-1]
    emb["device_ms"] = graph_ms(torch, lambda: trigrid.sym_stream(
        xt, p1, bm=128))
    emb["library_device_ms"] = graph_ms(torch, lambda: xs @ p1)
    log(f"[kernels]   in a CUDA graph (device time, no host): ms "
        f"{emb['device_ms']:.4f}  library {emb['library_device_ms']:.4f}")
    symm_case("diag_scale 2 bf16 out", xt, randn(d, 96), 128, ds=2.0,
              out_dtype=bf16)
    for bm in (8, 16, 64):
        n = 16 * bm
        a = randn(n, n)
        symm_case(f"{n}^2 x {n}x72 bm {bm}", pack_tril_tiles(
            a, bm).contiguous(), randn(n, 72), bm,
            ds=2.0 if bm == 8 else 1.0)
    # xlstm's refresh at d = 1024
    g1 = randn(1024, 1024)
    g1 = (g1 + g1.T) / 2
    symm_case("1024 TriTiles bm 32 x I (xlstm NS seed)", TriTiles.from_tril(
        g1, 32).tiles.contiguous(), torch.eye(1024, device=dev), 32,
        dense=g1, timed=True)
    x1s = torch.tril(t1) + torch.tril(t1, -1).T
    symm_case("dense 1024^2 x 1024^2 (xlstm NS)", pack_tril_tiles(
        t1, 128).contiguous(), randn(1024, 1024), 128, dense=x1s,
        timed=True)
    # ragged shapes: rows past a 128-block, 4 B copies, narrow widths
    a160 = randn(160, 160)
    t160 = pack_tril_tiles(a160, 32).contiguous()
    symm_case("160^2 x 160x50 bm 32 (4 B copies)", t160, randn(160, 50), 32)
    for bm, n2 in ((8, 3), (32, 8), (128, 2), (16, 5)):
        n = 16 * bm if bm < 128 else 1024
        symm_case(f"{n}^2 x {n}x{n2} bm {bm} (matrix-vector)",
                  pack_tril_tiles(randn(n, n), bm).contiguous(),
                  randn(n, n2), bm, ds=0.5 if n2 == 5 else 1.0)
    # poison: the upper halves of diagonal tiles never reach the output
    clean = TriTiles.from_tril(randn(512, 512), 32).tiles.contiguous()
    poisoned = clean.clone()
    ii = torch.arange(16, device=dev)
    up = torch.triu(torch.ones(32, 32, device=dev, dtype=torch.bool), 1)
    diag = poisoned[ii * (ii + 3) // 2]
    poisoned[ii * (ii + 3) // 2] = torch.where(up, float("nan"), diag)
    for n2 in (64, 1):
        bb = randn(512, n2)
        got = trigrid.sym_stream(poisoned, bb, bm=32)
        want = trigrid._sym_stream_plain(clean, bb, 16, 1.0, f32)
        compare(torch, f"sym_stream poison (NaN upper halves), n2 {n2}",
                got, want, f32)
    nan_cases(torch, dev, t, x, y)

    slstm_cases(torch, randn, cases["slstm_scan"], card_clock_mhz)
    torch.cuda.synchronize()
    return cases


def nan_cases(torch, dev, t, x, y):
    """A NaN in a live element of an operand reaches the output where the
    plain version puts it, through every symmetric kernel at the NS
    shapes: 0/0 made on the card and a NaN with every bit set (bits the
    TF32 rounding must not carry into a number) in A, the latter in B."""
    from repro_torch.core.packing import pack_tril_tiles
    from repro_torch.kernels import trigrid
    zero = torch.zeros((), device=dev)
    nan_a = zero / zero
    nan_b = torch.tensor(-1, dtype=torch.int32, device=dev).view(
        torch.float32)
    log(f"[kernels] NaN cases: 0/0 on the card has bits "
        f"{int(nan_a.view(torch.int32)) & 0xFFFFFFFF:#010x}, B's NaN "
        f"{int(nan_b.view(torch.int32)) & 0xFFFFFFFF:#010x}")
    ta, tb = t.clone(), t.clone().T.contiguous()
    ta[1000, 77] = nan_a
    ta[600, 1999] = nan_b
    tb[300, 1500] = nan_b
    ep = trigrid.Epilogue()
    for body, b in (("syrk", None), ("syr2k", tb)):
        got = trigrid.rank_update(body, ta, b, bm=128, epilogue=ep)
        want = trigrid._rank_update_plain(body, ta, b, 128, ep, None)
        compare(torch, f"rank_update {body} 2048^2, NaN in a live element",
                got, want, torch.float32, nans=True)
    # A: an off-diagonal tile and the lower half of a diagonal tile
    xa = x.clone()
    xa[1000, 300] = nan_a
    xa[130, 129] = nan_b
    yb = y.clone()
    yb[5, 77] = nan_b
    for bm, b in ((128, yb), (32, yb), (128, yb[:, :1].contiguous())):
        tiles = pack_tril_tiles(xa, bm).contiguous()
        got = trigrid.sym_stream(tiles, b, bm=bm)
        want = trigrid._sym_stream_plain(tiles, b, 2048 // bm, 1.0,
                                         torch.float32)
        where = "A and B" if bool(torch.isnan(b).any()) else "A"
        compare(torch, f"sym_stream bm {bm} n2 {b.shape[1]}, NaN in {where}",
                got, want, torch.float32, nans=True)


def tf32_case(torch, got, dense, b):
    """The tolerance has teeth: at the NS shape one TF32 product
    (emulated, ``trigrid.matmul_tf32(passes=1)``) misses ``TOL_F32``
    against the IEEE f32 product, while the kernel (3xTF32) and its
    emulation meet it.  No global TF32 flag is touched."""
    from repro_torch.kernels import trigrid
    want = dense @ b
    scale = max(1.0, float(want.abs().max()))

    def rel(x):
        return float((x - want).abs().max()) / scale
    one, three, kern = rel(trigrid.matmul_tf32(dense, b, 1)), \
        rel(trigrid.matmul_tf32(dense, b, 3)), rel(got)
    ok = one > TOL_F32 and three <= TOL_F32 and kern <= TOL_F32
    log(f"[kernels] 1xTF32 emulation rel {one:.2e} (> {TOL_F32:.0e}), "
        f"3xTF32 emulation {three:.2e}, kernel {kern:.2e} (<= "
        f"{TOL_F32:.0e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("the 1xTF32 tolerance case failed")


def slstm_close(torch, name, got, want, tol):
    """max |got − want| and whether |got − want| ≤ tol·(1 + |want|)
    everywhere (relative and absolute, as ``assert_allclose``)."""
    diff = (got - want).abs()
    ok = bool((diff <= tol * (1 + want.abs())).all()) and \
        bool(torch.isfinite(got).all())
    err = float(diff.max())
    log(f"[kernels] {name:60s} max_abs_err {err:.3e} (<= {tol:.0e}·(1+|x|))"
        f" {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"kernel {name} disagrees with its plain version")
    return err


def resource_usage(lib: str) -> dict:
    """{kernel: (registers, static shared bytes, local bytes)} from
    ``cuobjdump -res-usage`` of a built library (local memory holds any
    spills)."""
    from pathlib import Path
    from repro_torch.kernels import native
    tool = str(Path(native.nvcc_path()).parent / "cuobjdump")
    text = subprocess.run([tool, "-res-usage", lib], capture_output=True,
                          text=True, check=True).stdout
    table, name = {}, None
    for ln in text.splitlines():
        ln = ln.strip()
        if ln.startswith("Function "):
            name = ln[len("Function "):].rstrip(":")
        elif ln.startswith("REG:") and name:
            f = dict(kv.split(":", 1) for kv in ln.split() if ":" in kv)
            table[name] = (int(f["REG"]), int(f.get("SHARED", 0)),
                           int(f.get("LOCAL", 0)))
            name = None
    return table


def sass_loop_sizes(lib: str) -> dict:
    """{kernel: instructions in its longest innermost loop} from
    ``cuobjdump -sass`` of a built library: a loop is a branch back to a
    lower address, innermost if no other loop lies inside it, and its
    size counts every instruction between target and branch (both sides
    of any branch inside; subroutines called from it excluded)."""
    from pathlib import Path
    from repro_torch.kernels import native
    tool = str(Path(native.nvcc_path()).parent / "cuobjdump")
    return loop_sizes(subprocess.run([tool, "-sass", lib],
                                     capture_output=True, text=True,
                                     check=True).stdout)


def loop_sizes(text: str) -> dict:
    """``sass_loop_sizes`` of cuobjdump's text."""
    sizes, fn, labels, branches, pending = {}, None, {}, [], []

    def close():
        if fn:
            loops = {(labels.get(t, t), a) for a, t in branches
                     if isinstance(labels.get(t, t), int) and
                     labels.get(t, t) <= a}
            inner = [(a - t) // 16 + 1 for t, a in loops
                     if not any(o != (t, a) and t <= o[0] and o[1] <= a
                                for o in loops)]
            sizes[fn] = max(inner, default=0)
    for ln in text.splitlines():
        ln = ln.strip()
        if ln.startswith("Function :"):
            close()
            fn, labels, branches, pending = ln.split(":", 1)[1].strip(), \
                {}, [], []
        elif ln.startswith(".L") and ln.endswith(":"):
            pending.append(ln[:-1])
        elif ln.startswith("/*") and "*/" in ln and fn:
            head = ln[2:ln.index("*/")]
            try:
                addr = int(head, 16)
            except ValueError:
                continue
            for lab in pending:
                labels[lab] = addr
            pending = []
            body = ln[ln.index("*/") + 2:].split(";")[0]
            if re.search(r"\bBRA\b", body):    # target: the last operand
                tgt = body.split("BRA", 1)[1].split(",")[-1]
                lab = re.search(r"\((\.L\w+)\)", tgt)
                num = re.search(r"0x[0-9a-fA-F]+", tgt)
                if lab or num:
                    branches.append((addr, lab.group(1) if lab else
                                     int(num.group(0), 16)))
    close()
    return sizes


#: steps in one iteration of the kernel's step loop (kGroup)
SLSTM_GROUP = 8


def slstm_issue(card_clock_mhz):
    """Instructions per step of the kernel (quad layout, f32 and bf16
    gates) from the SASS of its loop body, and the ms a B·S·d scan needs
    to issue them: instructions a step × steps / 32 lanes / (132 SMs × 4
    schedulers × clock)."""
    from repro_torch.kernels import native
    sizes = sass_loop_sizes(str(native._lib_path("slstm_scan.cu")))
    for k, v in sizes.items():
        if "slstm_kernel" in k:
            log(f"[kernels] SASS {k[-24:]}: longest innermost loop {v} "
                f"instructions")
    per_step = {}
    for tag, key in (("F32", "f32"), ("BF16", "bf16")):
        found = [v for k, v in sizes.items() if "slstm_kernel" in k and
                 re.search(rf"{len(tag)}{tag}E?Lb1E", k)]
        if len(found) != 1 or not found[0]:
            raise SystemExit(f"no step loop of the {key} quad kernel in "
                             f"the SASS: {sizes}")
        per_step[key] = found[0] / SLSTM_GROUP
    log(f"[kernels] slstm_scan, SASS of the step loop: "
        f"{per_step} instructions a step (step loop / {SLSTM_GROUP}; "
        f"issue at {card_clock_mhz} MHz)")
    rate = 132 * 4 * card_clock_mhz * 1e6          # warp instructions / s

    def issue_ms(dtype, steps):
        return per_step[dtype] * steps / 32 / rate * 1e3
    return per_step, issue_ms


#: (B, S, d, gate dtype, layout, state, label).  "quad": the four views of
#: one (B, S, d, 4) tensor, as the serving mixer hands them; "separate":
#: four contiguous tensors; "gate-major": views of a (B, S, 4, d) tensor.
#: The kernel runs 8 steps at a time and its ring 24 steps ahead.
SLSTM_CASES = (
    (1, 64, 1024, "bf16", "quad", "cold", "prefill bucket 64"),
    (1, 256, 1024, "bf16", "quad", "cold", "prefill bucket 256"),
    (4, 1, 1024, "bf16", "quad", "warm", "decode, 4 slots (S = 1)"),
    (16, 4096, 1024, "bf16", "quad", "warm", "reference traffic shape"),
    (1, 64, 1024, "f32", "quad", "cold", "prefill bucket 64"),
    (4, 1, 1024, "f32", "quad", "warm", "decode, 4 slots"),
    (2, 96, 256, "f32", "quad", "warm", "S not a power of two"),
    (16, 4096, 1024, "f32", "quad", "warm", "reference traffic shape"),
    (2, 96, 256, "f32", "separate", "warm", "general path"),
    (2, 96, 256, "bf16", "gate-major", "warm", "general path"),
    (2, 5, 256, "bf16", "quad", "warm", "S below the ring's lookahead"),
    (2, 99, 200, "bf16", "quad", "warm", "S not a multiple of 8, ragged d"),
    (2, 100, 256, "f32", "quad", "n0<1", "n0 in (0, 1)"),
    (2, 100, 256, "f32", "separate", "n0<1", "n0 in (0, 1), general path"),
    (1, 4096, 1024, "bf16", "quad", "warm", "long single prefill"),
)
SLSTM_MAIN = 0          # the serve's prefill: the kernels line's row


def slstm_cases(torch, randn, rows, card_clock_mhz):
    """``slstm_scan`` against its plain version (on the f32 upcast of the
    same gates), input/forget gates scaled by 2.5 as in the reference
    kernel test; each case timed back to back, inside a CUDA graph
    (device time) and as the plain version."""
    from repro_torch.kernels import native, slstm
    ring = native.load()["repro_slstm_ring_bytes"]
    usage = resource_usage(str(native._lib_path("slstm_scan.cu")))
    if sum("slstm_kernel" in k for k in usage) != 4:
        raise SystemExit(f"not the 4 slstm_scan kernels' resources: {usage}")
    for k, (regs, smem, local) in usage.items():
        if "slstm_kernel" in k:
            dyn = ring(int("BF16" in k)) if "Lb1E" in k else 0
            log(f"[build] {k}: {regs} registers, {smem} B static smem "
                f"(+ {dyn} B ring), {local} B local (spills)")
    _, issue_ms = slstm_issue(card_clock_mhz)
    dtypes = {"f32": torch.float32, "bf16": torch.bfloat16}
    scale = torch.tensor([1.0, 2.5, 2.5, 1.0], device=DEVICE)
    for i, (b, s, d, dt, layout, kind, label) in enumerate(SLSTM_CASES):
        pre = (randn(b, s, d, 4) * scale).to(dtypes[dt])
        if layout == "quad":
            gates = pre.unbind(-1)
        elif layout == "separate":
            gates = [g.contiguous() for g in pre.unbind(-1)]
        else:
            gates = pre.permute(0, 1, 3, 2).contiguous().unbind(2)
        if kind == "cold":
            st = (torch.zeros(b, d, device=DEVICE),
                  torch.ones(b, d, device=DEVICE),
                  torch.zeros(b, d, device=DEVICE))
        elif kind == "warm":
            st = (randn(b, d), 1.0 + randn(b, d).abs(), randn(b, d))
        else:
            st = (0.3 * randn(b, d), 0.05 + 0.9 * torch.rand(
                b, d, device=DEVICE), randn(b, d))

        def run(gates=gates, st=st):
            return slstm.slstm_scan(*gates, *st)
        f32_gates = [g.float() for g in gates]
        name = f"slstm_scan ({b}, {s}, {d}) {dt} {layout} {label}"
        assert (slstm._quad_base(gates) is not None) == (layout == "quad")
        got = run()
        want = slstm._slstm_scan_plain(*f32_gates, *st)
        err = slstm_close(torch, name + " y", got[0], want[0], SLSTM_Y_TOL)
        err_s = max(slstm_close(torch, f"{name} {k}1", g, w,
                                SLSTM_STATE_TOL)
                    for k, g, w in zip("cnm", got[1:], want[1:]))
        del want
        steps = b * s * d
        nbytes = steps * (4 * pre.element_size() + 4) + 6 * b * d * 4
        bound, by = bound_ms(nbytes, SLSTM_OPS_PER_STEP * steps,
                             tensor=False)
        row = {"case": f"({b}, {s}, {d}) {dt} {layout} {label}",
               "main": i == SLSTM_MAIN, "dtype": dt, "layout": layout,
               "max_abs_err": err,
               "max_abs_err_state": err_s, "bound_ms": bound,
               "bound_by": by, "ffma_bound_ms": bound,
               "issue_bound_ms": issue_ms(dt, steps), "library_ms": None,
               "ms": cuda_ms(torch, run),
               "device_ms": graph_ms(torch, run,
                                     reps=10 if steps > 1e7 else 50),
               "plain_ms": cuda_ms(torch, lambda: slstm._slstm_scan_plain(
                   *f32_gates, *st))}
        log(f"[kernels]   ms {row['ms']:.4f}  device "
            f"{row['device_ms']:.4f}  plain {row['plain_ms']:.4f}  library "
            f"none  bound {bound:.4f} ({by})  issue bound "
            f"{row['issue_bound_ms']:.4f}")
        rows.append(row)


# --------------------------------------------------------------------------
# phases 4-5: serve at full width with the whitening cache
# --------------------------------------------------------------------------
def run_serve(torch, arch):
    """Serve 8 requests of 8–47 prompt tokens on 4 slots (s_max 256, 16
    new tokens, one tenant, whitening cache with refresh stride 2); the
    launch counts are set to 0 just before and read just after."""
    from repro_torch.kernels import counts
    from repro_torch.launch.serve import serve
    args = argparse.Namespace(
        arch=arch, smoke=False, device=DEVICE, requests=8,
        slots=4, s_max=256, max_new=16, prompt_lo=8, prompt_hi=48,
        tenants=1, whiten="cache", refresh_stride=2, no_eos=True, seed=0)
    counts.reset_launch_counts()
    out = serve(args)
    launches = counts.launch_counts()
    tag = f"[{arch}]"
    log(f"{tag} {out['arch']} layers {out['layers']} d_model "
        f"{out['d_model']} vocab {out['vocab']} on {out['device']}")
    log(f"{tag} completed {out['completed']}/{out['requests']}  tokens/s "
        f"{out['tokens_per_s']:.2f}  ttft (embedding included) mean "
        f"{out['mean_ttft_s']:.4f} p50 {out['p50_ttft_s']:.4f} s p99 "
        f"{out['p99_ttft_s']:.4f} s  latency mean {out['mean_latency_s']:.4f}"
        f" s  startup {out['startup_s']:.2f} s")
    log(f"{tag} host s (each ends in a sync): serve {out['serve_s']:.4f}"
        f"  prefill {out['prefill_s']:.4f}  embed {out['embed_s']:.4f}"
        f"  decode {out['decode_s']:.4f} over {out['decode_steps']} steps")
    log(f"{tag} refreshes {out['cache']['refreshes']} (s: "
        f"{[round(s, 4) for s in out['refresh_s']]})  ns_fallbacks "
        f"{out['cache']['ns_fallbacks']}  forwards {out['model_forwards']}"
        f" ({out['warmup_forwards']} warm-up)  launches {launches}, of "
        f"which after warm-up {out['kernel_launches']}")
    assert out["completed"] == out["requests"], out
    assert out["embeddings_finite"], "non-finite embedding"
    assert out["cache"]["factors_ready"] >= 1 and \
        out["cache"]["refreshes"] >= 1, out["cache"]
    assert out["cache"]["failed_refreshes"] == 0, out["cache"]
    assert launches["rank_update"] > 0 and launches["sym_stream"] > 0, \
        launches
    return out, launches


def serve_phase(torch):
    out, launches = run_serve(torch, "stablelm-1.6b")
    assert (out["layers"], out["d_model"], out["vocab"]) == (24, 2048,
                                                             100352)
    assert launches["slstm_scan"] == 0, launches
    return out, launches


def xlstm_phase(torch):
    from repro_torch.configs import get_config
    cfg = get_config("xlstm-350m")
    n_slstm = sum(cfg.pattern[i % cfg.period].mixer == "slstm"
                  for i in range(cfg.n_layers))
    from repro_torch.kernels import slstm
    from repro_torch.models import ssm
    seen = set()
    scan, plain = ssm.slstm_scan, slstm._slstm_scan_plain

    def spy(*args, **kw):            # the gates the mixer hands the kernel
        seen.add((str(args[0].dtype), slstm._quad_base(args[:4])
                  is not None))
        return scan(*args, **kw)

    def guard(*args):
        assert not args[0].is_cuda, "a CUDA tensor reached the plain scan"
        return plain(*args)
    ssm.slstm_scan, slstm._slstm_scan_plain = spy, guard
    try:
        out, launches = run_serve(torch, "xlstm-350m")
    finally:
        ssm.slstm_scan, slstm._slstm_scan_plain = scan, plain
    log(f"[xlstm] slstm_scan gates (dtype, quad views): {sorted(seen)}")
    assert seen == {("torch.bfloat16", True)}, seen
    assert (out["layers"], out["d_model"], out["vocab"]) == (24, 1024,
                                                             50304)
    assert n_slstm == 6
    # every forward (ladder warm-ups, admits, decode steps) ran every
    # sLSTM layer on the kernel, once
    assert launches["slstm_scan"] == n_slstm * out["model_forwards"], \
        (launches, out["model_forwards"])
    assert out["kernel_launches"]["slstm_scan"] == n_slstm * (
        out["model_forwards"] - out["warmup_forwards"]), out
    log(f"[xlstm] slstm_scan launches {launches['slstm_scan']} = "
        f"{n_slstm} x {out['model_forwards']} forwards")
    out["prefill_split"] = prefill_split(torch, cfg)
    return out, launches


def prefill_split(torch, cfg):
    """Host seconds by block kind in one full-width prefill per bucket
    and one 4-slot decode step, with a sync after every block (so the
    split, not the sum, is the point)."""
    from repro_torch.models.model import init_model
    model = init_model(cfg, seed=0, device=DEVICE)
    split = {}

    def timed(fn):
        by_kind, t0 = {}, [0.0]    # blocks run one after another

        def pre(_m, _a):
            torch.cuda.synchronize()
            t0[0] = time.perf_counter()

        def post(blk, _a, _o):
            torch.cuda.synchronize()
            kind = blk.spec.mixer
            by_kind[kind] = by_kind.get(kind, 0.0) + \
                time.perf_counter() - t0[0]
        handles = []
        for blk in model.blocks:
            handles += [blk.register_forward_pre_hook(pre),
                        blk.register_forward_hook(post)]
        torch.cuda.synchronize()
        start = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        total = time.perf_counter() - start
        for h in handles:
            h.remove()
        return {"total_s": total, **{f"{k}_s": v for k, v in
                                     by_kind.items()}}

    for bucket in (16, 64, 128, 256):
        toks = torch.ones((1, bucket), dtype=torch.long, device=DEVICE)
        model.prefill(toks, 256)                       # warm
        split[f"prefill {bucket}"] = timed(lambda: model.prefill(toks, 256))
    cache = model.init_cache(4, 256)
    tok = torch.ones((4, 1), dtype=torch.long, device=DEVICE)
    model.decode_step(tok, tok, cache)
    split["decode 4 slots"] = timed(lambda: model.decode_step(tok, tok,
                                                              cache))
    for k, v in split.items():
        log(f"[xlstm] {k}: " + "  ".join(f"{n} {x:.4f}" for n, x in
                                         v.items()))
    del model
    torch.cuda.empty_cache()
    return split


# --------------------------------------------------------------------------
# phase 6: the port on the card against references
# --------------------------------------------------------------------------
def check_phase(torch):
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.model import init_model
    from repro_torch.optim.gram import packed_gram, whitening_from_packed
    from repro_torch.kernels import counts

    # reduced model: same weights on the card and on the CPU
    cfg = get_smoke_config("stablelm-1.6b")
    m_cpu = init_model(cfg, seed=0, device="cpu")
    m_gpu = init_model(cfg, seed=1, device=DEVICE)
    m_gpu.load_state_dict(m_cpu.state_dict())
    toks = torch.randint(1, cfg.vocab, (2, 24),
                         generator=torch.Generator().manual_seed(0))
    lc, _, hc = m_cpu.prefill(toks, 32, return_hidden=True)
    lg, _, hg = m_gpu.prefill(toks.to(DEVICE), 32, return_hidden=True)
    err = float((lg.cpu() - lc).abs().max())
    log(f"[check] smoke prefill logits card vs cpu: max_abs_err {err:.3e}"
        f" (<= 5e-2, bf16 activations)")
    assert lg.shape == (2, 1, cfg.vocab) and bool(torch.isfinite(lg).all())
    assert err <= 5e-2, err

    # full-width NS whitening on the kernels vs the eigh oracle
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    x = torch.randn(2048, 4096, generator=gen, device=DEVICE)
    before = counts.launch_counts()
    g = packed_gram(x)
    w = whitening_from_packed(g, 2048, eps=1e-3, method="ns")
    after = counts.launch_counts()
    alone = {}
    for d in (2048, 1024):        # one refresh's NS alone, nothing beside
        gd = packed_gram(x[:d])
        whitening_from_packed(gd, d, eps=1e-3, method="ns")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        whitening_from_packed(gd, d, eps=1e-3, method="ns")
        torch.cuda.synchronize()
        alone[d] = time.perf_counter() - t0
    log(f"[check] NS whitening alone (host s, ends in a sync): d=2048 "
        f"{alone[2048]:.4f}  d=1024 {alone[1024]:.4f}")
    we = whitening_from_packed(g, 2048, eps=1e-3, method="eigh")
    rel = float(torch.linalg.norm(w - we) / torch.linalg.norm(we))
    log(f"[check] NS whitening d=2048 vs eigh: rel {rel:.3e} (<= 1e-3); "
        f"launches {before} -> {after}")
    assert rel <= 1e-3, rel
    assert after["rank_update"] > before["rank_update"] and \
        after["sym_stream"] > before["sym_stream"]
    xlstm_check(torch)


def xlstm_check(torch):
    """The xlstm smoke model (three mLSTM blocks and one sLSTM block at
    d_model 64: a ragged 128-channel block for the kernel) on the card
    against the same weights on the CPU: prefill and 4 decode steps."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import counts
    from repro_torch.models.model import init_model

    cfg = get_smoke_config("xlstm-350m")
    m_cpu = init_model(cfg, seed=0, device="cpu")
    m_gpu = init_model(cfg, seed=1, device=DEVICE)
    m_gpu.load_state_dict(m_cpu.state_dict())
    toks = torch.randint(1, cfg.vocab, (2, 40),
                         generator=torch.Generator().manual_seed(1))
    before = counts.launch_counts()["slstm_scan"]
    lc, cc, hc = m_cpu.prefill(toks, 64, return_hidden=True)
    lg, cg, hg = m_gpu.prefill(toks.to(DEVICE), 64, return_hidden=True)
    errs = [float((lg.cpu() - lc).abs().max())]
    h_err = float((hg.cpu().float() - hc.float()).abs().max())
    nxt = lc[:, -1].argmax(-1)[:, None]
    for k in range(4):
        pos = torch.full((2, 1), 40 + k)
        lc, cc = m_cpu.decode_step(nxt, pos, cc)
        lg, cg = m_gpu.decode_step(nxt.to(DEVICE), pos.to(DEVICE), cg)
        errs.append(float((lg.cpu() - lc).abs().max()))
        assert bool(torch.isfinite(lg).all())
        nxt = lc[:, -1].argmax(-1)[:, None]
    launched = counts.launch_counts()["slstm_scan"] - before
    log(f"[check] xlstm smoke card vs cpu: logits max_abs_err prefill "
        f"{errs[0]:.3e}, decode {[f'{e:.3e}' for e in errs[1:]]} "
        f"(<= 5e-2), hidden {h_err:.3e} (<= 6.25e-2); slstm_scan "
        f"launches {launched} (1 sLSTM layer x 5 forwards)")
    assert lg.shape == (2, 1, cfg.vocab)
    assert max(errs) <= 5e-2 and h_err <= 6.25e-2, (errs, h_err)
    assert launched == 5, launched


# --------------------------------------------------------------------------
# phase 7: train stablelm-1.6b at full width with Muon on the kernels
# --------------------------------------------------------------------------
#: the Muon NS check's bound: the reference's own (tests/test_optim.py,
#: 1D NS against the reference NS), |got − want| ≤ 2e-3 + 2e-3·|want|
MUON_TOL = 2e-3


#: (k, n2, accumulate epilogue cases) of the stacked checks: k = 4 with
#: and without the epilogue, the train path's own k = 24 stacks (the 24
#: layers' (2048, 2048) and (2048, 5632) leaves), and k = 1 at the
#: short side of the (100352, 2048) embeddings, which NS takes unbatched
BATCHED_CASES = ((4, 2048, (False, True)), (4, 5632, (False, True)),
                 (24, 2048, (False,)), (24, 5632, (False,)),
                 (1, 100352, (False,)))


def batched_cases(torch, cases):
    """``rank_update`` (SYRK) and ``sym_stream`` at every shape the Muon
    step gives them (``BATCHED_CASES``): each against its plain version
    on the same inputs within ``TOL_F32``, each matrix of a stack bit for
    bit against its own unbatched launch, one launch a call, and timed
    against k unbatched launches, the plain version and one ``torch.bmm``
    (``torch.matmul`` for k = 1) in IEEE f32."""
    from repro_torch.core.packing import pack_tril_tiles
    from repro_torch.kernels import trigrid
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(7)
    d = 2048

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    def checked_row(name, label, k, got, plain, singles, run, library,
                    nbytes, flops):
        want = plain()
        err = compare(torch, f"{name} {label}", got, want, torch.float32)
        del want
        row = {"case": label, "max_abs_err": err, "main": False,
               "batch": k}
        if k > 1:
            same = all(torch.equal(got[i], singles(i)) for i in range(k))
            log(f"[train]   each matrix bit-equal to its unbatched launch: "
                f"{same}")
            if not same:
                raise SystemExit(f"{name} {label}: a batched matrix differs"
                                 " from its unbatched launch")
            row["bit_equal_unbatched"] = same
        before = getattr(trigrid, name).launches
        run()
        assert getattr(trigrid, name).launches == before + 1
        row["ms"] = cuda_ms(torch, run)
        if k > 1:
            row["unbatched_ms"] = cuda_ms(
                torch, lambda: [singles(i) for i in range(k)])
        row["plain_ms"] = cuda_ms(torch, plain)
        row["library_ms"] = cuda_ms(torch, library)
        row["library"] = "torch.bmm" if k > 1 else "torch.matmul"
        row["ffma_bound_ms"] = bound_ms(nbytes, flops, False)[0]
        row["bound_ms"], row["bound_by"] = bound_ms(nbytes, flops)
        log(f"[train]   ms {row['ms']:.4f} (k = {k})"
            + (f"  {k} unbatched {row['unbatched_ms']:.4f}" if k > 1
               else "")
            + f"  plain {row['plain_ms']:.4f}"
            + f"  {row['library']} {row['library_ms']:.4f}  bound "
            f"{row['bound_ms']:.4f} ({row['bound_by']})")
        cases[name].append(row)

    for k, n2, accs in BATCHED_CASES:
        lead = (k,) if k > 1 else ()
        shape = str(lead + (d, n2)).replace(",)", ")")
        kind = "batched" if k > 1 else "unbatched"
        mm = torch.bmm if k > 1 else torch.matmul
        a = randn(*lead, d, n2) / n2 ** 0.5
        T = (d // 128) * (d // 128 + 1) // 2
        out_b = k * T * 128 * 128 * 4
        flops = k * d * (d + 1) * n2
        for acc in accs:
            c0 = randn(*lead, T, 128, 128) if acc else None
            ep = trigrid.Epilogue(beta=1.0, accumulate=True) if acc else \
                trigrid.Epilogue()

            def run(a=a, ep=ep, c0=c0):
                return trigrid.rank_update("syrk", a, bm=128, epilogue=ep,
                                           c0=c0)

            def single(i, a=a, ep=ep, c0=c0):
                return trigrid.rank_update(
                    "syrk", a[i], bm=128, epilogue=ep,
                    c0=None if c0 is None else c0[i])
            checked_row(
                "rank_update", f"syrk {shape} {kind}"
                + (" beta c0" if acc else ""), k, run(),
                lambda a=a, ep=ep, c0=c0: trigrid._rank_update_plain(
                    "syrk", a, None, 128, ep, c0),
                single, run, lambda a=a: mm(a, a.mT),
                k * d * n2 * 4 + out_b * (2 if acc else 1), flops)
        # the NS products: S·S (n2 = d) and sym(Y)·X (n2 > d)
        s = randn(*lead, d, d) / d ** 0.5
        tiles = pack_tril_tiles(s, 128).contiguous()
        sym = torch.tril(s) + torch.tril(s, -1).mT
        del s
        b = randn(*lead, d, n2)

        def srun(tiles=tiles, b=b):
            return trigrid.sym_stream(tiles, b, bm=128)

        def ssingle(i, tiles=tiles, b=b):
            return trigrid.sym_stream(tiles[i], b[i], bm=128)
        checked_row(
            "sym_stream", f"{str(lead + (d, d)).replace(',)', ')')} x "
            f"{shape} {kind}", k, srun(),
            lambda tiles=tiles, b=b: trigrid._sym_stream_plain(
                tiles, b, d // 128, 1.0, torch.float32),
            ssingle, srun, lambda sym=sym, b=b: mm(sym, b),
            tiles.numel() * 4 + 2 * k * d * n2 * 4, 2 * k * d * d * n2)
        del a, tiles, sym, b
        torch.cuda.empty_cache()


def autodiff_check(torch):
    """``torch.autograd.grad`` through ``blas.syrk`` / ``syr2k`` / ``symm``
    at n1 = 2048, n2 = 512 on the kernel route, every fill, against the
    same on the dense IEEE route.  The loss is linear in the output
    (⟨C, W⟩), so the backward ops' kernels alone make the difference."""
    from repro_torch import blas
    from repro_torch.blas.routing import Route
    from repro_torch.kernels import counts
    gen = torch.Generator(device=DEVICE).manual_seed(3)
    n1, n2 = 2048, 512

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=DEVICE)
    a, b = randn(n1, n2) / n2 ** 0.5, randn(n1, n2) / n2 ** 0.5
    s = randn(n1, n1) / n1 ** 0.5
    worst = 0.0
    for op in ("syrk", "syr2k", "symm"):
        for fill in (("tril", "full", "packed") if op != "symm" else
                     ("dense", "tritiles")):
            def run(dense, op=op, fill=fill):
                xs = [t.clone().requires_grad_(True) for t in
                      ((a,) if op == "syrk" else (a, b) if op == "syr2k"
                       else (s, b))]
                oracle = Route(op, "dense", "the dense IEEE oracle", n1, n2)
                with blas.pinned(oracle if dense else None):
                    if op == "syrk":
                        c = blas.syrk(xs[0], fill=fill)
                    elif op == "syr2k":
                        c = blas.syr2k(xs[0], xs[1], fill=fill)
                    else:
                        sa = xs[0] if fill == "dense" else \
                            blas.TriTiles.from_tril(xs[0], 128)
                        c = blas.symm(sa, xs[1])
                w = torch.randn(c.shape, generator=torch.Generator(
                    device=DEVICE).manual_seed(5), device=DEVICE)
                return torch.autograd.grad((c * w).sum(), xs)
            before = counts.launch_counts()
            got = run(False)
            after = counts.launch_counts()
            want = run(True)
            errs = [float((g - r).abs().max()) / max(1.0, float(
                r.abs().max())) for g, r in zip(got, want)]
            ok = max(errs) <= TOL_F32 and all(
                bool(torch.isfinite(g).all()) for g in got)
            launched = {k: after[k] - before[k] for k in after
                        if after[k] != before[k]}
            log(f"[train] autodiff {op} {fill:8s} kernel vs dense IEEE: rel "
                f"{max(errs):.2e} (<= {TOL_F32:.0e}), kernel launches "
                f"{launched} {'ok' if ok else 'FAIL'}")
            if not ok or not launched:
                raise SystemExit(f"autodiff of {op} ({fill}) on the card "
                                 "disagrees with the dense route")
            worst = max(worst, max(errs))
    return worst


def muon_check(torch):
    """One Muon orthogonalisation of a (24, 2048, 5632) momentum (5 NS
    steps) on the kernels against the same on their plain versions (the
    wrappers swapped for the plain functions on the card)."""
    from repro_torch.kernels import counts, trigrid
    from repro_torch.optim.muon import orthogonalize_reference
    gen = torch.Generator(device=DEVICE).manual_seed(11)
    m = torch.randn(24, 2048, 5632, generator=gen, device=DEVICE)
    before = counts.launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = orthogonalize_reference(m, steps=5)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    after = counts.launch_counts()
    rank, sym = trigrid.rank_update, trigrid.sym_stream

    def rank_plain(body, a, b=None, *, bm, epilogue=None, c0=None):
        return trigrid._rank_update_plain(body, a, b, bm,
                                          epilogue or trigrid.Epilogue(), c0)

    def sym_plain(a_tiles, b, *, bm, out_dtype=torch.float32,
                  diag_scale=1.0):
        return trigrid._sym_stream_plain(a_tiles, b, b.shape[-2] // bm,
                                         diag_scale, out_dtype)
    trigrid.rank_update, trigrid.sym_stream = rank_plain, sym_plain
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = orthogonalize_reference(m, steps=5)
        torch.cuda.synchronize()
        plain_secs = time.perf_counter() - t0
    finally:
        trigrid.rank_update, trigrid.sym_stream = rank, sym
    diff = (got - want).abs()
    err = float(diff.max())
    ok = bool((diff <= MUON_TOL + MUON_TOL * want.abs()).all()) and \
        bool(torch.isfinite(got).all())
    launched = {k: after[k] - before[k] for k in after}
    log(f"[train] Muon NS (24, 2048, 5632), 5 steps, kernels vs plain: "
        f"max_abs_err {err:.3e} (<= {MUON_TOL:.0e} + {MUON_TOL:.0e}|x|), "
        f"max |x| {float(want.abs().max()):.3f}; host s {secs:.4f} (plain "
        f"{plain_secs:.4f}); launches {launched} {'ok' if ok else 'FAIL'}")
    assert launched["rank_update"] == 5 and launched["sym_stream"] == 10, \
        launched
    if not ok:
        raise SystemExit("Muon NS on the kernels disagrees with the plain "
                         "versions")
    return {"max_abs_err": err, "s": secs, "plain_s": plain_secs}


def muon_split(torch):
    """Where a Muon step's optimizer time goes: one orthogonalisation (5
    NS steps, kernels) of each distinct leaf shape of stablelm-1.6b's
    tree, host clock around work that ends in a sync, times the leaves
    of that shape."""
    from repro_torch.optim.muon import orthogonalize_reference
    gen = torch.Generator(device=DEVICE).manual_seed(13)
    leaves = (((24, 2048, 2048), 4, "attention wq wk wv wo"),
              ((24, 2048, 5632), 2, "mlp wi wg"),
              ((24, 5632, 2048), 1, "mlp wo"),
              ((100352, 2048), 1, "embed"), ((2048, 100352), 1, "unembed"),
              ((24, 2048), 4, "norm scales and biases (dense route)"))
    rows, total = [], 0.0
    for shape, count, what in leaves:
        m = torch.randn(shape, generator=gen, device=DEVICE)
        orthogonalize_reference(m)                      # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        orthogonalize_reference(m)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        total += secs * count
        rows.append({"shape": list(shape), "leaves": count, "what": what,
                     "s_each": secs})
        log(f"[train] Muon NS {str(shape):18s} x {count} ({what}): "
            f"{secs:.4f} s each")
        del m
    log(f"[train] Muon NS, all matrix leaves: {total:.4f} s a step")
    torch.cuda.empty_cache()
    return {"leaves": rows, "total_s": total}


def run_train(torch, optimizer, steps):
    """stablelm-1.6b at its published widths (nothing cut), random bf16
    init from seed 0, global batch 8 x 256 tokens; the launch counts set
    to 0 just before and read just after (inside ``train``)."""
    from repro_torch.launch.train import build_argparser, train
    args = build_argparser().parse_args([
        "--arch", "stablelm-1.6b", "--full", "--device", DEVICE,
        "--optimizer", optimizer, "--steps", str(steps),
        "--global-batch", "8", "--seq-len", "256", "--loss-chunk", "256",
        "--seed", "0", "--log-every", "1"])
    out = train(args)
    tag = f"[train {optimizer}]"
    log(f"{tag} {out['arch']} layers {out['layers']} d_model "
        f"{out['d_model']} d_ff {out['d_ff']} vocab {out['vocab']} params "
        f"{out['params']} on {out['device']}")
    log(f"{tag} losses {[round(x, 4) for x in out['losses']]}")
    for i, (t, sp) in enumerate(zip(out["step_s"], out["split_s"])):
        log(f"{tag} step {i}{' (warm-up)' if i == 0 else ''}: "
            f"{t:.4f} s = loss+backward {sp['loss_backward_s']:.4f} + clip "
            f"{sp['clip_s']:.4f} + optimizer {sp['opt_s']:.4f}")
    launches = out["kernel_launches"]
    per_step = {k: v / steps for k, v in launches.items()}
    log(f"{tag} tokens/s {out['tokens_per_s']:.1f} (after warm-up); peak "
        f"memory {out['peak_memory_bytes'] / 2**30:.2f} GiB; launches "
        f"{launches} ({per_step} a step)")
    assert (out["layers"], out["d_model"], out["d_ff"], out["vocab"]) == \
        (24, 2048, 5632, 100352), out
    assert all(map(math.isfinite, out["losses"])), out["losses"]
    return out, launches


def train_phase(torch, cases):
    batched_cases(torch, cases)
    grad_err = autodiff_check(torch)
    muon = muon_check(torch)
    muon["split"] = muon_split(torch)
    torch.cuda.empty_cache()
    out, launches = run_train(torch, "muon", 6)
    routes = out["routes"]                 # [op, n1, n2, path, batched, n]
    big = [r for r in routes if r[1] >= 256]
    log("[train muon] routes (op, n1, n2, path, batched): calls over the "
        "run: " + "; ".join(f"{tuple(r[:5])}: {r[5]}" for r in routes))
    assert big and all(r[3] == "kernel" for r in big), routes
    # one launch per blas call on the kernel route, stacks included
    n_syrk = sum(r[5] for r in big if r[0] == "syrk")
    n_symm = sum(r[5] for r in big if r[0] == "symm")
    assert launches["rank_update"] == n_syrk and \
        launches["sym_stream"] == n_symm, (launches, n_syrk, n_symm)
    assert launches["rank_update"] > 0 and launches["sym_stream"] > 0
    assert launches["slstm_scan"] == 0, launches
    torch.cuda.empty_cache()
    adamw, _ = run_train(torch, "adamw", 2)
    torch.cuda.empty_cache()
    return {"muon": {k: v for k, v in out.items() if k != "routes"},
            "adamw": {k: v for k, v in adamw.items() if k != "routes"},
            "autodiff_rel_err": grad_err, "muon_ns": muon}, launches


# --------------------------------------------------------------------------
# phase 8: the mesh schedules on a gloo group, all ranks on this card
# --------------------------------------------------------------------------
MESH_N1, MESH_N2 = 2048, 5632
MESH_TOL = 2e-5
#: the §IX budget (f32 words a device) under which the planner turns
#: this shape on 12 ranks into the streamed 3d-limited schedule
MESH_M = 500_000
#: (P, route name, path, choice kwargs); 3d-limited is planned, not pinned
MESH_ROUTES = ((4, "1d", {}), (4, "ring", {}), (6, "2d", {"c": 2}),
               (12, "3d", {"c": 2, "p2": 2}), (12, "3d-limited", None))


def _mesh_choice(path, P, kw):
    from repro_torch.core.dispatch import AlgoChoice
    if path == "ring":
        return AlgoChoice("ring", 3, P, p1=P, p2=1)
    if path == "1d":
        return AlgoChoice("1d", 1, P, p1=1, p2=P)
    c = kw["c"]
    return AlgoChoice(path, 3, P, c=c, p1=c * (c + 1), p2=kw.get("p2", 1))


def _mesh_ms(torch, dist, fn, rank):
    """Mean ms a call over a >= 25 ms window of at least 3 calls, CUDA
    events on rank 0; every rank runs the same number of calls (the
    collectives pair up), agreed on by an all-reduce of the first call's
    time outside the counted collectives."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    est = torch.tensor([time.perf_counter() - t0])
    dist.all_reduce(est, op=dist.ReduceOp.MAX)
    reps = max(3, math.ceil(0.025 / max(float(est), 1e-6)))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps if rank == 0 else None


def _mesh_predicted(route, op, n1, n2):
    from repro_torch.core.dispatch import (predicted_words_1d,
                                           predicted_words_2d,
                                           predicted_words_3d, ring_nb)
    m, ch, P = (1 if op == "syrk" else 2), route.choice, route.P
    if route.path == "1d":
        return predicted_words_1d(n1, P)
    if route.path == "ring":
        return m * (P // 2) * ring_nb(n1, P) * n2
    if route.path == "2d":
        return predicted_words_2d(n1, n2, m, ch.c)
    return predicted_words_3d(n1, n2, m, ch.c, ch.p2)


def mesh_rank(mesh, cases, muon=False):
    """One rank of the mesh phase: every (route, op) case, then (rank 0
    of 4) Muon's orthogonalize_1d against the single-device chain."""
    import torch
    import torch.distributed as dist
    from repro_torch import blas
    from repro_torch.blas.routing import Route
    from repro_torch.core.lower_bounds import memory_independent_lower_bound
    from repro_torch.core.packing import pack_tril
    from repro_torch.distributed import collectives
    from repro_torch.kernels import counts
    P, rank, dev = mesh.shape["x"], mesh.rank, mesh.device
    gen = torch.Generator(device=dev).manual_seed(7)
    n1, n2 = MESH_N1, MESH_N2
    a = torch.randn(n1, n2, generator=gen, device=dev)
    b = torch.randn(n1, n2, generator=gen, device=dev)
    s = torch.randn(n1, n1, generator=gen, device=dev)
    out = {"cases": [], "picks": {}}
    for op in ("syrk", "syr2k", "symm"):
        r = blas.plan_route(op, n1, n2, device=dev, mesh=mesh)
        out["picks"][op] = r.describe()
    launched = {}
    for name, path, kw in cases:
        if kw is None:                 # planned under the budget
            route = blas.plan_route("syrk", n1, n2, device=dev, mesh=mesh,
                                    M=MESH_M)
            assert route.path == path, route.describe()
        else:
            route = Route("syrk", path, "pinned by chip_smoke", n1, n2,
                          P=P, axis="x", choice=_mesh_choice(path, P, kw))
        for op in ("syrk", "syr2k", "symm"):
            def call():
                if op == "syrk":
                    return blas.syrk(a, fill="packed", mesh=mesh)
                if op == "syr2k":
                    return blas.syr2k(a, b, fill="packed", mesh=mesh)
                return blas.symm(s, b, mesh=mesh)
            with blas.pinned(route):
                assert blas.plan_route(op, n1, n2, device=dev,
                                       mesh=mesh).path == path
                counts.reset_launch_counts()
                collectives.reset_word_counts()
                got = call()
                torch.cuda.synchronize()
                words = collectives.word_counts()
                launches = counts.launch_counts()
                ms = _mesh_ms(torch, dist, call, rank)
            for k, v in launches.items():
                launched[k] = launched.get(k, 0) + v
            row = {"P": P, "route": name, "op": op, "words": words,
                   "predicted": _mesh_predicted(route, op, n1, n2),
                   "lower_bound": memory_independent_lower_bound(
                       n1, n2, P, 1 if op == "syrk" else 2).bound,
                   "ms": ms, "describe": route.describe()}
            if rank == 0:
                if op == "symm":
                    sym = torch.tril(s) + torch.tril(s, -1).T
                    want = sym @ b
                else:
                    g = a @ (a if op == "syrk" else b).T
                    want = pack_tril(g if op == "syrk" else g + g.T)
                err = float((got - want).abs().max())
                row["rel_err"] = err / float(want.abs().max())
                row["finite"] = bool(torch.isfinite(got).all())
                if not (row["rel_err"] <= MESH_TOL and row["finite"]):
                    raise SystemExit(f"mesh {name} {op} P={P}: rel err "
                                     f"{row['rel_err']:.3e} > {MESH_TOL}")
            del got
            out["cases"].append(row)
    out["launches"] = launched
    if muon:
        out["muon"] = _mesh_muon(torch, mesh, counts, collectives)
    return out


def _mesh_muon(torch, mesh, counts, collectives):
    """orthogonalize_1d of a (24, 2048, 5632) stack on this mesh against
    the single-device orthogonalize_reference (on the kernels) on rank
    0, at 2e-3."""
    from repro_torch.core.onedim import gather_columns
    from repro_torch.optim.muon import (orthogonalize_1d,
                                        orthogonalize_reference)
    dev = mesh.device
    gen = torch.Generator(device=dev).manual_seed(11)
    g = torch.randn(24, 2048, 5632, generator=gen, device=dev)
    counts.reset_launch_counts()
    collectives.reset_word_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    shard = orthogonalize_1d(g, mesh, "x", steps=5)
    torch.cuda.synchronize()
    res = {"s": time.perf_counter() - t0,
           "words": collectives.word_counts(),
           "launches": counts.launch_counts()}
    # the result stays column-sharded; gathered here only for the check
    got = gather_columns(shard, mesh.comm("x"))
    if mesh.rank == 0:
        want = orthogonalize_reference(g, steps=5)
        diff = (got - want).abs()
        res["max_abs_err"] = float(diff.max())
        res["ok"] = bool((diff <= MUON_TOL + MUON_TOL * want.abs()).all()) \
            and bool(torch.isfinite(got).all())
        if not res["ok"]:
            raise SystemExit("orthogonalize_1d disagrees with the single-"
                             "device orthogonalize_reference")
    return res


def mesh_phase(torch):
    """Phase 8: P gloo ranks, all on this card, one launch per P."""
    from repro_torch import blas
    from repro_torch.core.packing import pack_tril
    from repro_torch.distributed.launch import run_ranks
    card = torch.cuda.get_device_name(0)
    # one single-device blas call of each op at the same shape (kernels)
    gen = torch.Generator(device=DEVICE).manual_seed(7)
    a = torch.randn(MESH_N1, MESH_N2, generator=gen, device=DEVICE)
    b = torch.randn(MESH_N1, MESH_N2, generator=gen, device=DEVICE)
    s = torch.randn(MESH_N1, MESH_N1, generator=gen, device=DEVICE)
    single = {"syrk": cuda_ms(torch, lambda: blas.syrk(a, fill="packed")),
              "syr2k": cuda_ms(torch, lambda: blas.syr2k(a, b,
                                                         fill="packed")),
              "symm": cuda_ms(torch, lambda: blas.symm(s, b))}
    del a, b, s
    torch.cuda.empty_cache()
    log(f"[mesh] single-device blas at ({MESH_N1}, {MESH_N2}), kernels: "
        + ", ".join(f"{k} {v:.4f} ms" for k, v in single.items()))
    rows, picks, launched, muon = [], {}, {}, None
    for P in (4, 6, 12):
        cases = [(name, name, kw) for P_, name, kw in MESH_ROUTES
                 if P_ == P]
        log(f"[mesh] gloo, host-staged wire, {P} ranks on one {card}")
        t0 = time.perf_counter()
        res = run_ranks("chip_smoke:mesh_rank", P, backend="gloo",
                        device="cuda:0", paths=[ROOT], timeout=500,
                        kwargs={"cases": cases, "muon": P == 4})
        log(f"[mesh] P={P}: {len(cases) * 3} cases in "
            f"{time.perf_counter() - t0:.1f} s (process start included)")
        picks[P] = res[0]["picks"]
        for op, d in picks[P].items():
            log(f"[mesh]   planner's own pick, P={P}: {d}")
        for i, row in enumerate(res[0]["cases"]):
            for r in res[1:]:
                assert r["cases"][i]["words"] == row["words"], (
                    "ranks moved different words", row, r["cases"][i])
            sched = {k: v for k, v in row["words"].items()
                     if k != "replicate"}
            log(f"[mesh]   {row['route']:10s} {row['op']:5s} P={P}: rel err "
                f"{row['rel_err']:.2e} (<= {MESH_TOL:.0e}); schedule words a "
                f"rank {sched} = {sum(sched.values())}, replication "
                f"{row['words'].get('replicate', 0)}; predicted "
                f"{row['predicted']:.6g}; lower bound "
                f"{row['lower_bound']:.6g}; {row['ms']:.3f} ms")
            rows.append(row)
        for r in res:
            for k, v in r["launches"].items():
                launched[k] = launched.get(k, 0) + v
        if P == 4:
            muon = res[0]["muon"]
            log(f"[mesh] Muon orthogonalize_1d (24, 2048, 5632), P=4, 5 NS "
                f"steps vs single-device orthogonalize_reference: "
                f"max_abs_err {muon['max_abs_err']:.3e} (<= {MUON_TOL:.0e} + "
                f"{MUON_TOL:.0e}|x|); words a rank {muon['words']}; host s "
                f"{muon['s']:.3f}; mesh launches {muon['launches']}")
            for r in res:
                for k, v in r["muon"]["launches"].items():
                    launched[k] = launched.get(k, 0) + v
    log(f"[mesh] kernel launches on the mesh path (every rank): {launched}")
    assert all(v == 0 for v in launched.values()), launched
    return {"cases": rows, "single_device_ms": single, "picks": picks,
            "muon_1d": muon}, launched


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.device import ieee_f32
    ieee_f32()
    t_start = time.perf_counter()
    card, clock = probe(torch)
    build_s = build()
    cases = kernel_phase(torch, clock)
    _, launches = serve_phase(torch)
    xout, xlaunches = xlstm_phase(torch)
    check_phase(torch)
    tout, tlaunches = train_phase(torch, cases)
    mout, mlaunches = mesh_phase(torch)
    log(f"[done] build {build_s:.2f} s, total "
        f"{time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"xlstm_serve": {k: v for k, v in xout.items()
                                    if k not in ("cache",)}}))
    log(json.dumps({"train": tout}))
    log(json.dumps({"mesh": mout}))

    kernels = []
    for name, rows in cases.items():
        [main_row] = [r for r in rows if r["main"]]
        by_path = {"stablelm-1.6b": launches[name],
                   "xlstm-350m": xlaunches[name],
                   "train stablelm-1.6b muon": tlaunches[name],
                   "mesh": mlaunches.get(name, 0)}
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name],
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"],
            "bound_by": main_row["bound_by"],
            "ffma_bound_ms": main_row["ffma_bound_ms"],
            "library_ms": main_row["library_ms"],
            "shape": main_row["case"], "cases": rows})
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
