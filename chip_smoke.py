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
             kernels; its launch counts are printed and must read 0;
9. ckpt    — checkpoints and resume: trains stablelm-1.6b at its
             published widths with Muon and ``--track-gram`` in a temp
             dir (its free space printed first; the depth, never the
             widths, cut only if three checkpoints would not fit), run A
             3 steps with ``--ckpt-every 2 --ckpt-keep 2`` (its step-3
             checkpoint set aside), run B ``--steps 3`` on the same dir,
             which resumes from step 2; asserts that B resumed with 0
             mismatches from ``verify_restored``, that B's loss is A's
             step 2 bit for bit, that every leaf of B's step-3
             checkpoint has A's crc apart from the packed Grams (bf16
             words, within 1e-2), and that both runs launched
             ``rank_update`` and ``sym_stream``; prints the bytes, the
             blocking save's, the async snapshot's, the restore's and
             ``verify_restored``'s seconds, and deletes the dir;
10. warm   — the serving cache's save and warm start: serves
             stablelm-1.6b at full width (the phase 4 traffic over 2
             tenants) with ``--save-cache``, then again from
             ``--warm-start``; asserts that both keys were restored, on
             the card, their bf16 EMA words bit-equal to the files, that
             the tokens of both serves are identical, and that the warm
             serve ran every refresh's Newton–Schulz chain on
             ``rank_update`` / ``sym_stream`` (never ``slstm_scan``);
             saves 3 keys of (2048, 64) features from a synchronous
             cache and warm-starts a fresh one, each warm factor
             bit-equal to the live one; serves once more under a
             persistent ``serve:refresh`` fault (tokens identical,
             failures counted, the breaker naming both keys) and saves
             that cache under 2 ``ckpt:fsync`` and 1 ``ckpt:rename``
             transient faults (committed, 0 mismatches); prints the
             bytes on disk, the save's, the warm start's and the warm
             refreshes' seconds, and both serves' tokens/s and TTFT;
11. faults — ABFT and restart: ``checked_syrk`` / ``checked_syr2k`` /
             ``checked_symm`` on the local route at the stablelm-1.6b
             MLP leaf's Muon Gram shape (2048, 5632; a packed S at 2048
             for SYMM), f32 from a seed: each must run on the kernel
             route and launch ``rank_update`` / ``sym_stream``, detect
             nothing when clean (the largest honest residual printed as
             a fraction of its threshold, < 1), detect a bitflip and a
             nan on band 0 and retry once to an output bit-equal to the
             clean one, raise ``AbftError`` under a persistent fault,
             and (SYRK / SYR2K) rebuild from the clean output at c = 2
             bit-equal; the unchecked call, the check alone and the
             checked call timed with CUDA events.  Then
             ``checked_syrk`` on the 1d route on 4 gloo ranks sharing
             the card, a bitflip on rank 3's band: detected with
             primary 3, bit-equal on every rank, a retry's words twice
             the schedule's.  Then the uninterrupted single-device run at
             stablelm-1.6b's published widths and 2 layers (``muon-syrk``,
             ``--track-gram``, phase 7's traffic, 2 steps; its Grams read
             from its last checkpoint), and ``run_recovery`` of the same
             run in a temp dir (its free space printed first): phase 1
             killed by ``train:step`` before step 1 after step 1's
             checkpoint committed, phase 2 resumed from step 1 with 0
             mismatches, completed, every loss of both phases the
             uninterrupted run's bit for bit, both phases launching the
             symmetric kernels; prints each phase's, the restore's and
             the verify's seconds;
12. compress — int8 gradient compression with error feedback: (a)
             trains stablelm-1.6b at full width with Muon and
             ``--compress-grads`` 4 steps on phase 7's traffic, asserting
             the kernel routes and launches as phase 7 does and step 0's
             loss phase 7's bit for bit (init, batch and loss precede any
             update), printing steps 1-3 beside phase 7's, ``compress_s``
             a step and peak memory; (b) quantizes and dequantizes the
             (24, 2048, 5632) MLP stack, f32 from a seed, on the card and
             on the host, bit-equal, timed with CUDA events beside its
             byte bound (and one ``ErrorFeedbackInt8.compress`` of it);
             (c) a resume with the EF state at the published widths, 2
             layers deep (run A 4 steps saving at 2, run B from 2): B's
             losses A's bit for bit, 0 mismatches, every leaf's crc
             equal, the manifest's ``ef`` leaves, the bytes and seconds;
             (d) ``compressed_allreduce`` of a (2048, 5632) matrix and
             ``compressed_allreduce_sym`` of a symmetric 2048² one, each
             rank its own (seed = rank), on 4 gloo ranks sharing the
             card: rank 0's result bit-equal to a numpy oracle and within
             the reference test's atol of the exact mean, the same on
             every rank, the bytes a rank the byte model's exactly
             (17,571,840 and 3,196,440, against 69,206,016 for the f32
             ``all_reduce``), ms on rank 0, no kernel launch;
13. meshtrain — ``train --devices 4`` (gloo ranks sharing the card,
             the wire host-staged) with ``muon-syrk`` on phase 7's
             traffic, 2 steps, stablelm-1.6b at its published widths
             cut to 2 layers, on (data 2, model 2) at ``--max-model 2``
             (tensor- and data-parallel), its losses within 1e-4 of
             phase 11's uninterrupted single-device run at that depth a
             step (step 0: init, batch and loss before any update); the
             (data 1, model 4) run is phase 14's phase 1.  It asserts
             that
             every rank's losses are identical, that every rank's
             optimizer words a step are the closed form of its leaves
             (the 1D schedule, or a gather where ``_use_1d`` declines),
             and that every rank launched ``rank_update`` /
             ``sym_stream`` (the gathered stacks' chain); prints the
             Muon path of each leaf, s per step and its split (loss +
             backward, reduce, clip, optimizer), words and bytes a rank
             by phase and kind, and each rank's peak memory.  The
             kernels line's ``train mesh`` launches are the mesh ranks'
             alone;
14. elastic — ``run_recovery`` with ``--devices 4 --devices-after 2
             --max-model 4`` of ``muon-syrk`` with ``--track-gram`` at
             stablelm-1.6b's published widths and 2 layers, phase 7's
             traffic, gloo ranks sharing the card: phase 1 on (data 1,
             model 4) killed before step 1 after its step-1 checkpoint
             (every leaf gathered to rank 0, which writes) committed,
             phase 2 on (data 1, model 2) from that checkpoint (each
             rank its block, each Gram its slice), 0 mismatches,
             completed; every rank's losses identical, every loss within
             1e-4 of phase 11's
             single-device run's, the Grams of phase 2's last
             checkpoint within 1e-2 (bf16 words) of its; every rank's
             optimizer words a step the NS closed form plus the Grams'
             reduce-scatter (embed and unembed, (1 - 1/P)·Lp each);
             ``rank_update`` (the Grams and the gathered stacks' NS) and
             ``sym_stream`` launched on every rank of both phases, in
             the counts the paths give; prints each phase's seconds, the
             restore's, the verify's, the words of each phase (the
             checkpoint's gathers apart) and the checkpoint's bytes.

The seconds of each phase are printed on the ``[done]`` line.
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
    from repro_torch.models.model import preload_remat
    t0 = time.perf_counter()
    preload = preload_remat()       # while nvcc runs, not in phase 7
    native.load()
    secs = time.perf_counter() - t0
    preload.join()
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
def run_serve(torch, arch, tenants=1, label="", warm_start=None,
              save_cache=None):
    """Serve 8 requests of 8–47 prompt tokens on 4 slots (s_max 256, 16
    new tokens, ``tenants`` tenants, whitening cache with refresh stride
    2, optionally warm-started from / saved to a dir); the launch counts
    are set to 0 just before and read just after."""
    from repro_torch.kernels import counts
    from repro_torch.launch.serve import serve
    args = argparse.Namespace(
        arch=arch, smoke=False, device=DEVICE, requests=8,
        slots=4, s_max=256, max_new=16, prompt_lo=8, prompt_hi=48,
        tenants=tenants, whiten="cache", refresh_stride=2,
        warm_start=warm_start, save_cache=save_cache, no_eos=True, seed=0)
    counts.reset_launch_counts()
    out = serve(args)
    launches = counts.launch_counts()
    tag = f"[{arch}{label}]"
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


def run_train(torch, optimizer, steps, compress=False):
    """stablelm-1.6b at its published widths (nothing cut), random bf16
    init from seed 0, global batch 8 x 256 tokens; the launch counts set
    to 0 just before and read just after (inside ``train``)."""
    from repro_torch.launch.train import build_argparser, train
    args = build_argparser().parse_args([
        "--arch", "stablelm-1.6b", "--full", "--device", DEVICE,
        "--optimizer", optimizer, "--steps", str(steps),
        "--global-batch", "8", "--seq-len", "256", "--loss-chunk", "256",
        "--seed", "0", "--log-every", "1"]
        + (["--compress-grads"] if compress else []))
    out = train(args)
    tag = f"[train {optimizer}{' compressed' if compress else ''}]"
    log(f"{tag} {out['arch']} layers {out['layers']} d_model "
        f"{out['d_model']} d_ff {out['d_ff']} vocab {out['vocab']} params "
        f"{out['params']} on {out['device']}")
    log(f"{tag} losses {[round(x, 4) for x in out['losses']]}")
    for i, (t, sp) in enumerate(zip(out["step_s"], out["split_s"])):
        log(f"{tag} step {i}{' (warm-up)' if i == 0 else ''}: "
            f"{t:.4f} s = loss+backward {sp['loss_backward_s']:.4f} + clip "
            f"{sp['clip_s']:.4f} + compress {sp['compress_s']:.4f} + "
            f"optimizer {sp['opt_s']:.4f}")
    launches = out["kernel_launches"]
    per_step = {k: v / steps for k, v in launches.items()}
    log(f"{tag} tokens/s {out['tokens_per_s']:.1f} (after warm-up); peak "
        f"memory {out['peak_memory_bytes'] / 2**30:.2f} GiB; launches "
        f"{launches} ({per_step} a step)")
    assert (out["layers"], out["d_model"], out["d_ff"], out["vocab"]) == \
        (24, 2048, 5632, 100352), out
    assert all(map(math.isfinite, out["losses"])), out["losses"]
    return out, launches


def assert_kernel_routes(out, launches, tag):
    """Every NS SYRK / SYMM with n1 >= 256 of a Muon run took the kernel
    route, one launch per blas call, stacks included."""
    routes = out["routes"]                 # [op, n1, n2, path, batched, n]
    big = [r for r in routes if r[1] >= 256]
    log(f"{tag} routes (op, n1, n2, path, batched): calls over the "
        "run: " + "; ".join(f"{tuple(r[:5])}: {r[5]}" for r in routes))
    assert big and all(r[3] == "kernel" for r in big), routes
    n_syrk = sum(r[5] for r in big if r[0] == "syrk")
    n_symm = sum(r[5] for r in big if r[0] == "symm")
    assert launches["rank_update"] == n_syrk and \
        launches["sym_stream"] == n_symm, (launches, n_syrk, n_symm)
    assert launches["rank_update"] > 0 and launches["sym_stream"] > 0
    assert launches["slstm_scan"] == 0, launches


def train_phase(torch, cases):
    batched_cases(torch, cases)
    grad_err = autodiff_check(torch)
    muon = muon_check(torch)
    muon["split"] = muon_split(torch)
    torch.cuda.empty_cache()
    out, launches = run_train(torch, "muon", 6)
    assert_kernel_routes(out, launches, "[train muon]")
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


# --------------------------------------------------------------------------
# phase 9: checkpoints and resume of the full-width Muon trainer
# --------------------------------------------------------------------------
#: Muon's packed Grams resume from bf16-narrowed words (the reference
#: checkpoint test's bound on such words)
GRAM_TOL = 1e-2


def _ckpt_estimate(cfg, layers: int) -> int:
    """Bytes of one checkpoint at ``layers``: bf16 parameters and their
    f32 momentum (attention, MLP, embedding and head; norms and the
    packed Grams are a rounding error)."""
    d = cfg.d_model
    n = layers * (4 * d * d + 3 * d * cfg.d_ff) + 2 * cfg.vocab * d
    return n * (2 + 4)


def _gram_bits(path: str):
    """The bf16 words of a packed leaf file, as int16."""
    import numpy as np
    import torch
    return torch.from_numpy(np.load(path).view(np.int16))


def _gram_words(path: str):
    import torch
    return _gram_bits(path).view(torch.bfloat16).float()


def ckpt_phase(torch):
    """Run A trains stablelm-1.6b (published widths) with Muon and the
    packed Gram 3 steps, saving every 2 (async) and at the end
    (blocking); its step-3 checkpoint is set aside.  Run B, on the same
    dir, resumes from step 2 and writes step 3 again.  B's losses must
    equal A's step 2 and every leaf of B's step 3 A's (crc), the Grams
    (bf16 words) within GRAM_TOL."""
    import gc
    import shutil
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.launch.train import build_argparser, train
    root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        free = shutil.disk_usage(root).free
        cfg = get_config("stablelm-1.6b")
        layers = cfg.n_layers
        log(f"[ckpt] free space at {root}: {free} bytes; one checkpoint "
            f"~{_ckpt_estimate(cfg, layers)} bytes at {layers} layers")
        while layers > 1 and 3 * _ckpt_estimate(cfg, layers) > free:
            layers -= 1
        if layers != cfg.n_layers:
            log(f"[ckpt] depth cut to {layers} of {cfg.n_layers} layers "
                "(widths kept) so that three checkpoints fit")
        d = os.path.join(root, "ckpt")
        argv = ["--arch", "stablelm-1.6b", "--full", "--device", DEVICE,
                "--optimizer", "muon", "--track-gram", "--steps", "3",
                "--ckpt-dir", d, "--ckpt-every", "2", "--ckpt-keep", "2",
                "--global-batch", "8", "--seq-len", "256",
                "--loss-chunk", "256", "--seed", "0", "--log-every", "1"]
        if layers != cfg.n_layers:
            argv += ["--layers", str(layers)]
        runs = {}
        for name in ("A", "B"):
            runs[name] = train(build_argparser().parse_args(argv))
            gc.collect()
            torch.cuda.empty_cache()
            if name == "A":
                os.rename(os.path.join(d, "step_00000003"),
                          os.path.join(root, "A_step_00000003"))
        a, b = runs["A"], runs["B"]
        for name, r in runs.items():
            log(f"[ckpt {name}] layers {r['layers']} d_model {r['d_model']} "
                f"d_ff {r['d_ff']} vocab {r['vocab']}: steps "
                f"{r['start_step']}..{r['start_step'] + r['steps'] - 1}, "
                f"losses {r['losses']}, resumed {r['resumed']}, "
                f"launches {r['kernel_launches']}, times {r['ckpt_s']}")
        assert (a["d_model"], a["d_ff"], a["vocab"]) == \
            (cfg.d_model, cfg.d_ff, cfg.vocab), a
        assert not a["resumed"] and len(a["losses"]) == 3, a
        assert b["resumed"] and b["start_step"] == 2, b
        vr = b["restore_verified"]
        log(f"[ckpt B] restore verified: {vr['checked']} leaves "
            f"({vr['packed']} packed), {len(vr['mismatches'])} mismatches")
        assert vr["mismatches"] == [], vr
        diff = max(abs(x - y) for x, y in zip(a["losses"][2:], b["losses"]))
        bit_equal = a["losses"][2:] == b["losses"]
        log(f"[ckpt] B's losses {b['losses']} vs A's step 2 "
            f"{a['losses'][2:]}: bit-equal {bit_equal}, largest "
            f"difference {diff}")
        assert bit_equal, (a["losses"], b["losses"])
        with open(os.path.join(root, "A_step_00000003",
                               "manifest.json")) as f:
            ma = json.load(f)["leaves"]
        with open(os.path.join(d, "step_00000003", "manifest.json")) as f:
            mb = json.load(f)["leaves"]
        assert sorted(ma) == sorted(mb), (sorted(ma), sorted(mb))
        grams = [k for k in ma if k.startswith("opt__.gram__")
                 and "packed" in ma[k]]
        differ = [k for k in ma if ma[k]["crc"] != mb[k]["crc"]
                  and k not in grams]
        log(f"[ckpt] step 3, B against A: {len(ma)} leaves, crc differs "
            f"in {differ} apart from the {len(grams)} packed Grams")
        assert differ == [], differ
        gram_err = 0.0
        for k in grams:
            ga = _gram_words(os.path.join(root, "A_step_00000003",
                                          k + ".npy"))
            gb = _gram_words(os.path.join(d, "step_00000003", k + ".npy"))
            gram_err = max(gram_err, float((ga - gb).abs().max()
                                           / ga.abs().max()))
        log(f"[ckpt] packed Grams, B against A: largest relative "
            f"difference {gram_err} (tolerance {GRAM_TOL})")
        assert grams and gram_err <= GRAM_TOL, (grams, gram_err)
        for r in (a, b):
            n = r["kernel_launches"]
            assert n["rank_update"] > 0 and n["sym_stream"] > 0, n
        nbytes = b["ckpt_bytes"]
        assert nbytes == a["ckpt_bytes"] == sum(m["bytes"]
                                                for m in mb.values())
        times = {"async_snapshot_s": a["ckpt_s"]["snapshot_s"],
                 "blocking_save_s": [a["ckpt_s"]["save_s"],
                                     b["ckpt_s"]["save_s"]],
                 "restore_s": b["ckpt_s"]["restore_s"],
                 "verify_s": b["ckpt_s"]["verify_s"]}
        log(f"[ckpt] checkpoint {nbytes} bytes ({len(mb)} leaves); "
            f"{json.dumps(times)}")
        launches = {k: a["kernel_launches"].get(k, 0)
                    + b["kernel_launches"].get(k, 0)
                    for k in set(a["kernel_launches"])
                    | set(b["kernel_launches"])}
        return {"layers": layers, "free_bytes": free, "ckpt_bytes": nbytes,
                "leaves": len(mb), "losses_A": a["losses"],
                "losses_B": b["losses"], "bit_equal": bit_equal,
                "gram_rel_err": gram_err, **times}, launches
    finally:
        shutil.rmtree(root, ignore_errors=True)


# --------------------------------------------------------------------------
# phase 10: the serving cache's save and warm start at full width
# --------------------------------------------------------------------------
#: Newton–Schulz launches of one whitening refresh: a SYRK (T²) an
#: iteration, two SYMMs (X·T, T²·M) an iteration and one for the seed
NS_ITERS = 30


def _dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(r, f))
               for r, _, files in os.walk(path) for f in files)


def _state_by_key(cache):
    return {(t, a, layer): v for (t, a), mon in cache._monitors.items()
            for layer, v in mon._state.items()}


def warm_phase(torch):
    """Serve stablelm-1.6b (published widths, 2 tenants) saving the
    whitening cache, serve it again warm-started from the save, check
    save -> warm start bit-exact in-process at d = 2048, then serve under
    persistent refresh faults and save under transient I/O faults."""
    import gc
    import shutil
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.core.packing import PackedTriangle, tril_size
    from repro_torch.distributed import faults
    from repro_torch.distributed.checkpoint import (read_manifest,
                                                    restore_checkpoint,
                                                    verify_restored)
    from repro_torch.launch import serve as serve_mod
    from repro_torch.launch.serving_cache import ServingGramCache
    from repro_torch.models.model import init_model
    arch, tenants = "stablelm-1.6b", 2
    root = tempfile.mkdtemp(prefix="chip_smoke_warm_")
    made, restored = [], []
    real_requests, real_warm = (serve_mod.synthetic_requests,
                                ServingGramCache.warm_start)

    def requests_spy(*a, **k):          # the requests serve() makes
        made.append(real_requests(*a, **k))
        return made[-1]

    def warm_spy(self, *a, **k):        # the state just restored
        n = real_warm(self, *a, **k)
        restored.append({k_: v.clone() for k_, v in
                         _state_by_key(self).items()})
        return n
    serve_mod.synthetic_requests = requests_spy
    ServingGramCache.warm_start = warm_spy
    try:
        # 1. save
        ck = os.path.join(root, "cache")
        cold, _ = run_serve(torch, arch, tenants, " save", save_cache=ck)
        cold_toks = [tuple(r.generated) for r in made[-1]]
        entries = read_manifest(ck)["extra"]["serving_cache"]["entries"]
        step_dir = os.path.join(ck, "step_00000000")
        disk = _dir_bytes(step_dir)
        gc.collect()
        torch.cuda.empty_cache()
        # 2. warm
        warm, launches = run_serve(torch, arch, tenants, " warm",
                                   warm_start=ck)
        warm_toks = [tuple(r.generated) for r in made[-1]]
        gc.collect()
        torch.cuda.empty_cache()
        wc, cc = warm["cache"], cold["cache"]
        log(f"[warm] saved {len(entries)} keys, {disk} bytes on disk; "
            f"factor_cold / factor_hits: cold serve {cc['factor_cold']} / "
            f"{cc['factor_hits']}, warm serve {wc['factor_cold']} / "
            f"{wc['factor_hits']}")
        assert (cold["layers"], cold["d_model"], cold["vocab"]) == (
            24, 2048, 100352), cold
        assert len(entries) == tenants and cc["keys"] == tenants, entries
        assert wc["warm_loaded"] == len(entries), wc
        [state] = restored
        for e in entries:
            got = state[(e["tenant"], e["arch"], e["layer"])]
            assert got.is_cuda and got.dtype == torch.bfloat16, got
            want = _gram_bits(os.path.join(step_dir, e["leaf"] + ".npy"))
            assert torch.equal(got.view(torch.int16).cpu(), want), e
        log(f"[warm] restored EMA words ({len(entries)} keys, on "
            f"{DEVICE}) bit-equal to the files")
        same = warm_toks == cold_toks
        log(f"[warm] tokens warm vs cold identical: {same}")
        assert same
        assert launches["slstm_scan"] == 0, launches
        # every refresh (the warm start's included) ran its NS chain on
        # the kernels, every update its Gram on rank_update
        assert launches["rank_update"] >= NS_ITERS * wc["refreshes"] + \
            wc["updates"], (launches, wc)
        assert launches["sym_stream"] >= (2 * NS_ITERS + 1) * \
            wc["refreshes"], (launches, wc)

        # 3. parity at d = 2048, in-process
        d = 2048
        keys = [("tA", "final"), ("tB", "final"), ("tA", "mid")]
        live = ServingGramCache(refresh_stride=1, synchronous=True)
        gen = torch.Generator(device=DEVICE).manual_seed(0)
        for tenant, layer in keys:
            live.update(tenant, arch, layer, torch.randn(
                d, 64, generator=gen, device=DEVICE))
        pdir = os.path.join(root, "parity")
        live.save(pdir, step=0)
        again = ServingGramCache(refresh_stride=1, synchronous=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n = again.warm_start(pdir, device=DEVICE)
        torch.cuda.synchronize()
        ready_s = time.perf_counter() - t0
        assert n == len(keys) and again.snapshot_stats()[
            "factors_ready"] == len(keys), again.snapshot_stats()
        for tenant, layer in keys:
            a = live.factor(tenant, arch, layer)
            b = again.factor(tenant, arch, layer)
            assert b.is_cuda and torch.equal(a, b), (tenant, layer)
        log(f"[warm] d = {d}: {n} keys saved and warm-started, each warm "
            f"factor bit-equal to the live one; warm start until every "
            f"factor ready {ready_s:.4f} s")

        # 4. chaos: persistent refresh faults, then transient I/O faults
        cfg = get_config(arch)
        model = init_model(cfg, seed=0, device=DEVICE)
        chaos = ServingGramCache(refresh_stride=1, refresh_retries=0,
                                 breaker_threshold=2)
        srv = serve_mod.Server(cfg, model, slots=4, s_max=256, max_new=16,
                               eos_id=-1, whiten="cache", gram_cache=chaos,
                               device=DEVICE)
        srv.warm_up()
        reqs = real_requests(8, cfg.vocab, 0, lo=8, hi=48, tenants=tenants)
        try:
            with faults.inject(faults.FaultSpec(
                    site="serve:refresh", kind="error", times=0)) as inj:
                serve_mod.run(srv, reqs, 8 * 16)
                chaos.drain()
        finally:
            chaos.close()
        st = chaos.snapshot_stats()
        chaos_toks = [tuple(r.generated) for r in reqs]
        stale = sorted(f"tenant{i}/{cfg.name}/final"
                       for i in range(tenants))
        log(f"[warm chaos] {len(inj.events)} injected refresh faults; "
            f"failed_refreshes {st['failed_refreshes']} of "
            f"{st['refreshes']}, stale {st['stale']}, tokens identical to "
            f"the fault-free serve: {chaos_toks == cold_toks}")
        assert all(r.done_t is not None for r in reqs)
        assert chaos_toks == cold_toks
        assert st["failed_refreshes"] >= 1 and st["stale"] == stale, st
        fdir = os.path.join(root, "io_faults")
        with faults.inject(
                faults.FaultSpec(site="ckpt:fsync", kind="error", times=2),
                faults.FaultSpec(site="ckpt:rename", kind="error",
                                 times=1)) as inj:
            chaos.save(fdir, step=0)
        fe = read_manifest(fdir)["extra"]["serving_cache"]["entries"]
        like = {e["leaf"]: PackedTriangle(torch.zeros(
            tril_size(e["d"]), dtype=torch.bfloat16, device=DEVICE),
            e["d"]) for e in fe}
        _, back = restore_checkpoint(fdir, like)
        vr = verify_restored(fdir, back)
        live_state = _state_by_key(chaos)
        exact = all(torch.equal(back[e["leaf"]].vec.view(torch.int16),
                                live_state[(e["tenant"], e["arch"],
                                            e["layer"])].view(torch.int16))
                    for e in fe)
        log(f"[warm chaos] save under {[e.site for e in inj.events]}: "
            f"committed, {vr['checked']} leaves verified, "
            f"{len(vr['mismatches'])} mismatches, words bit-equal {exact}")
        assert len(inj.events) == 3 and len(fe) == tenants
        assert vr["mismatches"] == [] and vr["checked"] == tenants and exact
        del srv, model
        gc.collect()
        torch.cuda.empty_cache()

        # 5. what it cost
        out = {"keys": len(entries), "bytes_on_disk": disk,
               "save_cache_s": cold["save_cache_s"],
               "warm_start_s": warm["warm_start_s"],
               "warm_start_until_ready_s_d2048": ready_s,
               "refresh_s_warm": warm["refresh_s"],
               "factor_cold_hits": {"cold": [cc["factor_cold"],
                                             cc["factor_hits"]],
                                    "warm": [wc["factor_cold"],
                                             wc["factor_hits"]]},
               **{f"{k}_{name}": r[k] for name, r in (("cold", cold),
                                                      ("warm", warm))
                  for k in ("tokens_per_s", "mean_ttft_s", "p50_ttft_s",
                            "p99_ttft_s")},
               "chaos_failed_refreshes": st["failed_refreshes"]}
        log(f"[warm] bytes on disk {disk}; save_cache_s "
            f"{out['save_cache_s']:.4f}  warm_start_s "
            f"{out['warm_start_s']:.4f}  warm start until ready (d = {d}, "
            f"{len(keys)} keys) {ready_s:.4f}  refresh s (warm serve) "
            f"{[round(x, 4) for x in warm['refresh_s']]}")
        for name, r in (("cold", cold), ("warm", warm)):
            log(f"[warm] {name} serve: tokens/s {r['tokens_per_s']:.2f}  "
                f"ttft mean {r['mean_ttft_s']:.4f} p50 "
                f"{r['p50_ttft_s']:.4f} p99 {r['p99_ttft_s']:.4f} s")
        return out, launches
    finally:
        serve_mod.synthetic_requests = real_requests
        ServingGramCache.warm_start = real_warm
        shutil.rmtree(root, ignore_errors=True)


# --------------------------------------------------------------------------
# phase 11: ABFT-checked SYRK / SYR2K / SYMM, and the kill -> resume run
# --------------------------------------------------------------------------
#: the stablelm-1.6b MLP leaf's Muon Gram shape
ABFT_N1, ABFT_N2 = 2048, 5632
#: the kernel each checked op's local route must launch
ABFT_KERNEL = {"syrk": "rank_update", "syr2k": "rank_update",
               "symm": "sym_stream"}


def abft_local(torch, n1=ABFT_N1, n2=ABFT_N2, device=DEVICE):
    """checked_syrk / syr2k / symm on the local route at (n1, n2), f32
    from a seed: a clean call (its routes, launches and largest honest
    residual as a fraction of its threshold), a bitflip and a nan on
    band 0 (the local route's one band), a persistent nan, a rebuild
    from the clean output at c = 2, and the ms of the unchecked call,
    of the check alone and of the checked call."""
    from repro_torch.blas.routing import capture_routes
    from repro_torch.core.packing import pack_tril
    from repro_torch.distributed import faults
    from repro_torch.distributed import resilience as res
    from repro_torch.kernels import counts
    gen = torch.Generator(device=device).manual_seed(23)
    a = torch.randn(n1, n2, generator=gen, device=device)
    b = torch.randn(n1, n2, generator=gen, device=device)
    s = pack_tril(torch.randn(n1, n1, generator=gen, device=device))
    checks = {"syrk": res._check_syrk, "syr2k": res._check_syr2k,
              "symm": res._check_symm}
    rows = {}
    for op, ops in (("syrk", (a,)), ("syr2k", (a, b)), ("symm", (s, b))):
        fn = getattr(res, f"checked_{op}")
        row = rows[op] = {}
        counts.reset_launch_counts()
        with capture_routes() as routes:
            clean, rep = fn(*ops)
        row["launches"] = counts.launch_counts()
        row["paths"] = sorted({r.path for r in routes})
        row["clean"] = (rep.detected, rep.attempts, rep.action)
        resid, thr = res.checksum_residuals(op, *ops, out=clean)
        row["residual_fraction"] = float((resid / thr).max())
        row["faults"] = {}
        for kind in ("bitflip", "nan"):
            with faults.inject(faults.FaultSpec(
                    site=f"collective:{op}", kind=kind, device=0),
                    seed=5) as inj:
                got, rep = fn(*ops, backoff=0.0)
            row["faults"][kind] = {
                "events": len(inj.events), "detected": rep.detected,
                "primary": rep.primary, "action": rep.action,
                "attempts": rep.attempts,
                "bit_equal": bool(torch.equal(got, clean))}
        with faults.inject(faults.FaultSpec(
                site=f"collective:{op}", kind="nan", device=0, times=0)):
            try:
                fn(*ops, retries=1, backoff=0.0)
                row["persistent"] = "not raised"
            except res.AbftError as e:
                row["persistent"] = f"AbftError after {e.report.attempts}"
        if op != "symm":
            with faults.inject(faults.FaultSpec(
                    site=f"collective:{op}", kind="bitflip", device=0),
                    seed=5):
                got, rep = fn(*ops, reference=clean, c=2)
            row["rebuild"] = {"action": rep.action, "devices": rep.devices,
                              "attempts": rep.attempts,
                              "bit_equal": bool(torch.equal(got, clean))}
        if device != "cpu":
            run = res.route_runner(op, "local")
            chk = checks[op](n1, res._default_rtol(n1, n2, torch.float32),
                             res.DEFAULT_ATOL)
            row["kernel_ms"] = cuda_ms(torch, lambda: run(*ops))
            # the check as the checked call runs it: flags, then the
            # flagged rows' indices to the host
            row["check_ms"] = cuda_ms(
                torch, lambda: torch.nonzero(chk(*ops, clean)).cpu())
            row["checked_ms"] = cuda_ms(torch, lambda: fn(*ops))
        del clean
    return rows


def abft_mesh_rank(mesh):
    """One rank of the mesh case: checked_syrk on the 1d route at
    (ABFT_N1, ABFT_N2), clean and under a bitflip on band 3, with the
    words of each call; rank 0 holds the clean result to a dense
    torch.matmul oracle."""
    import torch
    from repro_torch.core.packing import pack_tril
    from repro_torch.distributed import collectives, faults
    from repro_torch.distributed import resilience as res
    dev = mesh.device
    gen = torch.Generator(device=dev).manual_seed(29)
    a = torch.randn(ABFT_N1, ABFT_N2, generator=gen, device=dev)
    collectives.reset_word_counts()
    clean, rep0 = res.checked_syrk(a, route="1d", mesh=mesh)
    words = collectives.word_counts()
    collectives.reset_word_counts()
    with faults.inject(faults.FaultSpec(site="collective:syrk",
                                        kind="bitflip", device=3),
                       seed=3) as inj:
        got, rep = res.checked_syrk(a, route="1d", mesh=mesh, backoff=0.0)
    out = {"clean_detected": rep0.detected, "words": words,
           "retry_words": collectives.word_counts(),
           "events": len(inj.events), "detected": rep.detected,
           "primary": rep.primary, "action": rep.action,
           "attempts": rep.attempts, "bad_rows": rep.bad_rows,
           "bit_equal": bool(torch.equal(got, clean))}
    if mesh.rank == 0:
        want = pack_tril(a @ a.T)
        out["rel_err"] = float((clean - want).abs().max()
                               / want.abs().max())
    return out


def abft_phase(torch):
    """Phase 11 (a) and (b): the checked calls on the kernels, then the
    mesh case on 4 gloo ranks sharing the card."""
    from repro_torch.distributed.launch import run_ranks
    rows = abft_local(torch)
    launches = {}
    for op, row in rows.items():
        log(f"[abft] {op} local ({ABFT_N1}, {ABFT_N2}): routes "
            f"{row['paths']}, launches {row['launches']}; clean "
            f"{row['clean']}; largest honest residual "
            f"{row['residual_fraction']:.3e} of its threshold; faults "
            f"{row['faults']}; persistent: {row['persistent']}; rebuild "
            f"{row.get('rebuild')}; ms: kernel call {row['kernel_ms']:.4f}, "
            f"check alone {row['check_ms']:.4f}, checked call "
            f"{row['checked_ms']:.4f}")
        assert row["paths"] == ["kernel"], row["paths"]
        assert row["launches"][ABFT_KERNEL[op]] > 0, row["launches"]
        assert row["clean"] == (False, 1, "none"), row["clean"]
        assert row["residual_fraction"] < 1.0, row["residual_fraction"]
        for kind, f in row["faults"].items():
            assert f == {"events": 1, "detected": True, "primary": 0,
                         "action": "retry", "attempts": 2,
                         "bit_equal": True}, (op, kind, f)
        assert row["persistent"] == "AbftError after 2", row["persistent"]
        if op != "symm":
            rb = row["rebuild"]
            assert rb["action"] == "rebuild" and rb["devices"] \
                and rb["attempts"] == 1 and rb["bit_equal"], rb
        for k, v in row["launches"].items():
            launches[k] = launches.get(k, 0) + v
    card = torch.cuda.get_device_name(0)
    log(f"[abft] mesh: checked_syrk, 1d, 4 gloo ranks on one {card}")
    t0 = time.perf_counter()
    ranks = run_ranks("chip_smoke:abft_mesh_rank", 4, backend="gloo",
                      device="cuda:0", paths=[ROOT], timeout=300)
    mesh_s = time.perf_counter() - t0
    for r, m in enumerate(ranks):
        log(f"[abft] mesh rank {r}: {m}")
        assert not m["clean_detected"] and m["events"] == 1, m
        assert m["detected"] and m["primary"] == 3 and m["attempts"] == 2 \
            and m["action"] == "retry" and m["bit_equal"], m
        assert m["retry_words"] == {k: 2 * v for k, v in
                                    m["words"].items()}, m
    assert ranks[0]["rel_err"] <= MESH_TOL, ranks[0]["rel_err"]
    return {"local": rows, "mesh": ranks, "mesh_s": mesh_s}, launches


#: the depth of the kill -> resume runs (phases 11 (c) and 14) and of
#: phase 13 (b): stablelm-1.6b's published widths, 2 of its 24 layers
RESUME_LAYERS = 2
#: their steps, the kill before step 1, the checkpoint at step 1
RESUME_STEPS, RESUME_KILL, RESUME_EVERY = 2, 1, 1


def _train_argv(optimizer, steps, layers=0):
    """The train flags of phase 7's traffic (8 x 256 tokens, seed 0) at
    stablelm-1.6b's published widths."""
    argv = ["--arch", "stablelm-1.6b", "--full", "--optimizer", optimizer,
            "--steps", str(steps), "--global-batch", "8", "--seq-len",
            "256", "--loss-chunk", "256", "--seed", "0", "--data-seed",
            "0", "--log-every", "1"]
    return argv + (["--layers", str(layers)] if layers else [])


def _packed_grams(d: str):
    """{key: bf16 words as f32} of the packed Gram leaves of the newest
    checkpoint in ``d``."""
    from repro_torch.distributed import read_manifest
    m = read_manifest(d)
    step = os.path.join(d, f"step_{m['step']:08d}")
    return {k: _gram_words(os.path.join(step, k + ".npy"))
            for k, v in m["leaves"].items() if "packed" in v}


def single_resume_depth(torch):
    """The uninterrupted single-device run at ``RESUME_LAYERS``:
    ``muon-syrk`` with ``--track-gram`` on phase 7's traffic,
    ``RESUME_STEPS`` steps, its one checkpoint (the last step) read for
    its packed Grams and deleted.  Phases 11 (c), 13 (b) and 14 hold
    their runs to it (on one device ``muon`` and ``muon-syrk`` run the
    same chain)."""
    import gc
    import shutil
    import tempfile

    from repro_torch.launch.train import build_argparser, train
    gc.collect()
    torch.cuda.empty_cache()
    root = tempfile.mkdtemp(prefix="chip_smoke_single_")
    try:
        argv = _train_argv("muon-syrk", RESUME_STEPS, RESUME_LAYERS) + [
            "--device", DEVICE, "--track-gram", "--ckpt-dir", root,
            "--ckpt-every", "0"]
        t0 = time.perf_counter()
        out = train(build_argparser().parse_args(argv))
        out["wall_s"] = time.perf_counter() - t0
        out["grams"] = _packed_grams(root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(f"[single] {out['arch']} {out['layers']} layers, d_model "
        f"{out['d_model']} d_ff {out['d_ff']} vocab {out['vocab']}, "
        f"muon-syrk + Grams, one device: losses {out['losses']}, launches "
        f"{out['kernel_launches']}, {out['wall_s']:.1f} s (its checkpoint "
        "included)")
    assert len(out["grams"]) == 2, sorted(out["grams"])
    return out


def recovery_phase(torch, single):
    """Phase 11 (c): ``run_recovery`` at stablelm-1.6b's published widths
    and ``RESUME_LAYERS`` layers with ``muon-syrk`` and ``--track-gram``,
    phase 7's traffic: phase 1 killed before step ``RESUME_KILL``,
    phase 2 resumed from that step.  Both phases' losses must be the
    uninterrupted single-device run's at that depth, bit for bit."""
    import gc
    import shutil
    import tempfile

    from repro_torch.launch.recovery import run_recovery
    gc.collect()
    torch.cuda.empty_cache()          # the phases' processes need the card
    root = tempfile.mkdtemp(prefix="chip_smoke_recovery_")
    try:
        free = shutil.disk_usage(root).free
        log(f"[recovery] free space at {root}: {free} bytes")
        t0 = time.perf_counter()
        out = run_recovery(
            os.path.join(root, "ckpt"), devices=1, devices_after=1,
            steps=RESUME_STEPS, kill_step=RESUME_KILL,
            ckpt_every=RESUME_EVERY, global_batch=8, seq_len=256,
            layers=RESUME_LAYERS, optimizer="muon-syrk", track_gram=True,
            timeout=500, device=DEVICE,
            extra_args=["--full", "--loss-chunk", "256"])
        total = time.perf_counter() - t0
    finally:
        shutil.rmtree(root, ignore_errors=True)
    p1, p2 = out["phases"]
    summary = {k: v for k, v in out.items() if k != "phases"}
    log(f"[recovery] {json.dumps(summary)}")
    log(f"[recovery] phase 1: {p1['s']:.1f} s, losses {p1.get('losses')}, "
        f"launches {p1.get('kernel_launches')}")
    log(f"[recovery] phase 2: {p2['s']:.1f} s, losses {p2.get('losses')}, "
        f"launches {p2.get('kernel_launches')}, checkpoint s "
        f"{p2.get('ckpt_s')}")
    assert out["killed"] and out["kill_step"] == RESUME_KILL, out
    assert len(p1["losses"]) == RESUME_KILL, p1
    assert out["resumed_step"] == RESUME_EVERY, out
    assert out["mismatches"] == 0, out
    assert out["completed"] and out["final"]["resumed"], out
    want = single["losses"]
    got = p1["losses"] + p2["losses"]
    log(f"[recovery] losses {got} vs the uninterrupted single-device run's "
        f"{want}: bit-equal {got == want}")
    assert got == want, (got, want)
    launches = {}
    for p in (p1, p2):
        n = p["kernel_launches"]
        assert n["rank_update"] > 0 and n["sym_stream"] > 0, n
        for k, v in n.items():
            launches[k] = launches.get(k, 0) + v
    times = {"phase1_s": p1["s"], "phase2_s": p2["s"], "total_s": total,
             "restore_s": p2["ckpt_s"]["restore_s"],
             "verify_s": p2["ckpt_s"]["verify_s"],
             "save_s": p2["ckpt_s"].get("save_s")}
    log(f"[recovery] {json.dumps(times)}")
    return {"free_bytes": free, "layers": RESUME_LAYERS,
            "verified_leaves": out["verified_leaves"],
            "losses_phase1": p1["losses"], "losses_phase2": p2["losses"],
            "single_losses": want, **times}, launches


# --------------------------------------------------------------------------
# phase 12: int8 gradient compression with error feedback
# --------------------------------------------------------------------------
#: stablelm-1.6b's largest gradient leaf, the MLP Muon stack; one matrix
#: of it is the DP wire's leaf in (d), beside a symmetric 2048² one
COMPRESS_LEAF = (24, 2048, 5632)
COMPRESS_RANKS = 4
COMPRESS_BLOCK = 256
#: (c)'s depth; the widths are the published ones
COMPRESS_LAYERS = 2


def compress_train(torch, muon7):
    """(a) Muon with ``--compress-grads`` at full width, phase 7's
    traffic, 4 steps: the kernel routes, step 0's loss phase 7's bit for
    bit (init, batch and loss come before any update)."""
    out, launches = run_train(torch, "muon", 4, compress=True)
    tag = "[compress train]"
    assert_kernel_routes(out, launches, tag)
    assert out["compress_grads"], out
    want = muon7["losses"]
    log(f"{tag} step 0 loss {out['losses'][0]!r}, phase 7's "
        f"{want[0]!r}: bit-equal {out['losses'][0] == want[0]}")
    assert out["losses"][0] == want[0], (out["losses"], want)
    for i in range(1, len(out["losses"])):
        log(f"{tag} step {i}: loss {out['losses'][i]:.6f}, phase 7's "
            f"(uncompressed) {want[i]:.6f}")
    ef_bytes = 4 * out["params"]
    log(f"{tag} compress_s a step {out['compress_s']}; peak memory "
        f"{out['peak_memory_bytes']} bytes "
        f"({out['peak_memory_bytes'] / 2**30:.2f} GiB; phase 7's "
        f"{muon7['peak_memory_bytes'] / 2**30:.2f}); EF state {ef_bytes} "
        "bytes")
    keep = ("losses", "step_s", "split_s", "compress_s", "tokens_per_s",
            "peak_memory_bytes", "kernel_launches", "params")
    return dict({k: out[k] for k in keep}, ef_bytes=ef_bytes), launches


def compress_quantizer(torch):
    """(b) quantize / dequantize of the largest leaf, f32 from a seed,
    on the card and on the host: bit-equal; the card's timed."""
    from repro_torch.distributed.compression import (ErrorFeedbackInt8,
                                                     dequantize_int8,
                                                     quantize_int8)
    x = torch.randn(COMPRESS_LEAF, generator=torch.Generator()
                    .manual_seed(12))
    xd = x.to(DEVICE)
    q, s = quantize_int8(xd, COMPRESS_BLOCK)
    d = dequantize_int8(q, s, xd.shape)
    qh, sh = quantize_int8(x, COMPRESS_BLOCK)
    dh = dequantize_int8(qh, sh, x.shape)
    same = {"q": bool(torch.equal(q.cpu(), qh)),
            "scale": bool(torch.equal(s.cpu(), sh)),
            "dequantized": bool(torch.equal(d.cpu(), dh))}
    rel = float((dh - x).abs().max() / x.abs().max())
    del x, qh, sh, dh, d
    n = xd.numel()
    nb = n // COMPRESS_BLOCK
    row = {"shape": list(COMPRESS_LEAF), "bit_equal": same,
           "rel_err": rel,
           "quantize_ms": cuda_ms(torch, lambda: quantize_int8(
               xd, COMPRESS_BLOCK)),
           "dequantize_ms": cuda_ms(torch, lambda: dequantize_int8(
               q, s, xd.shape)),
           # each input read once, each output written once
           "quantize_bound_ms": bound_ms(4 * n + n + 4 * nb, 0)[0],
           "dequantize_bound_ms": bound_ms(n + 4 * nb + 4 * n, 0)[0]}
    comp = ErrorFeedbackInt8(COMPRESS_BLOCK)
    state = comp.init({"w": xd})
    row["ef_compress_ms"] = cuda_ms(torch, lambda: comp.compress(
        {"w": xd}, state))
    row["ef_compress_bound_ms"] = bound_ms(4 * n + 4 * n + 4 * n + 4 * n,
                                           0)[0]
    del xd, q, s, state
    torch.cuda.empty_cache()
    log(f"[compress quantizer] {COMPRESS_LEAF} f32, block "
        f"{COMPRESS_BLOCK}: card vs host bit-equal {same}; max |x - "
        f"dequantized| / max |x| {rel:.3e}; ms (bound): quantize "
        f"{row['quantize_ms']:.4f} ({row['quantize_bound_ms']:.4f}), "
        f"dequantize {row['dequantize_ms']:.4f} "
        f"({row['dequantize_bound_ms']:.4f}), ErrorFeedbackInt8.compress "
        f"{row['ef_compress_ms']:.4f} ({row['ef_compress_bound_ms']:.4f})")
    assert all(same.values()), same
    assert rel <= 1 / 127, rel
    return row


def compress_resume(torch):
    """(c) Muon with ``--compress-grads`` at the published widths and
    COMPRESS_LAYERS deep: run A 4 steps saving at 2 (its step-4
    checkpoint set aside), run B resumed from 2: B's losses A's steps
    2-3 bit for bit, 0 mismatches, every leaf of B's step 4 A's crc, the
    manifest holding the EF leaves."""
    import gc
    import shutil
    import tempfile

    from repro_torch.launch.train import build_argparser, train
    root = tempfile.mkdtemp(prefix="chip_smoke_compress_")
    try:
        log(f"[compress resume] free space at {root}: "
            f"{shutil.disk_usage(root).free} bytes")
        d = os.path.join(root, "ckpt")
        argv = ["--arch", "stablelm-1.6b", "--full", "--device", DEVICE,
                "--layers", str(COMPRESS_LAYERS), "--optimizer", "muon",
                "--compress-grads", "--steps", "4", "--ckpt-dir", d,
                "--ckpt-every", "2", "--ckpt-keep", "2",
                "--global-batch", "8", "--seq-len", "256",
                "--loss-chunk", "256", "--seed", "0", "--log-every", "1"]
        runs = {}
        for name in ("A", "B"):
            runs[name] = train(build_argparser().parse_args(argv))
            gc.collect()
            torch.cuda.empty_cache()
            if name == "A":
                os.rename(os.path.join(d, "step_00000004"),
                          os.path.join(root, "A_step_00000004"))
        a, b = runs["A"], runs["B"]
        assert (a["layers"], a["d_model"], a["d_ff"], a["vocab"]) == \
            (COMPRESS_LAYERS, 2048, 5632, 100352), a
        assert not a["resumed"] and b["resumed"] and b["start_step"] == 2
        vr = b["restore_verified"]
        bit_equal = b["losses"] == a["losses"][2:]
        log(f"[compress resume] A's losses {a['losses']}, B's "
            f"{b['losses']}: bit-equal {bit_equal}; restore verified "
            f"{vr['checked']} leaves, {len(vr['mismatches'])} mismatches")
        assert bit_equal and vr["mismatches"] == [], (a["losses"],
                                                      b["losses"], vr)
        with open(os.path.join(root, "A_step_00000004",
                               "manifest.json")) as f:
            ma = json.load(f)["leaves"]
        with open(os.path.join(d, "step_00000004", "manifest.json")) as f:
            mb = json.load(f)["leaves"]
        ef = sorted(k for k in mb if k.startswith("ef"))
        params = sorted(k for k in mb if k.startswith("params"))
        differ = [k for k in ma if ma[k]["crc"] != mb.get(k, {}).get("crc")]
        log(f"[compress resume] step 4, B against A: {len(mb)} leaves "
            f"({len(ef)} ef, {len(params)} params), crc differs in "
            f"{differ}")
        assert sorted(ma) == sorted(mb) and differ == [], differ
        assert ef and len(ef) == len(params), (ef, params)
        nbytes = b["ckpt_bytes"]
        times = {"async_snapshot_s": a["ckpt_s"]["snapshot_s"],
                 "blocking_save_s": [a["ckpt_s"]["save_s"],
                                     b["ckpt_s"]["save_s"]],
                 "restore_s": b["ckpt_s"]["restore_s"],
                 "verify_s": b["ckpt_s"]["verify_s"]}
        log(f"[compress resume] checkpoint {nbytes} bytes "
            f"({sum(mb[k]['bytes'] for k in ef)} of them EF); "
            f"{json.dumps(times)}")
        return {"layers": COMPRESS_LAYERS, "ckpt_bytes": nbytes,
                "leaves": len(mb), "ef_leaves": len(ef),
                "losses_A": a["losses"], "losses_B": b["losses"],
                "compress_s_A": a["compress_s"], **times}
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _compress_input(torch, kind, rank, device):
    """Rank ``rank``'s leaf in (d): an MLP matrix, or a symmetric
    2048² one ((a + aᵀ)/2, exactly symmetric)."""
    gen = torch.Generator(device=device).manual_seed(rank)
    if kind == "dense":
        return torch.randn(COMPRESS_LEAF[1:], generator=gen, device=device)
    a = torch.randn(2048, 2048, generator=gen, device=device)
    return (a + a.T) / 2


def compress_rank(mesh):
    """One rank of (d): compressed_allreduce of its own MLP matrix,
    compressed_allreduce_sym of its own symmetric leaf, and the f32
    all_reduce of the matrix; each one's words and bytes, its ms on
    rank 0 and a crc of its result."""
    import zlib

    import torch
    import torch.distributed as dist
    from repro_torch.distributed import collectives
    from repro_torch.distributed.compression import (
        compressed_allreduce, compressed_allreduce_sym)
    from repro_torch.kernels import counts
    comm, rank, dev = mesh.comm("x"), mesh.rank, mesh.device
    x = _compress_input(torch, "dense", rank, dev)
    s = _compress_input(torch, "sym", rank, dev)
    calls = {"dense": lambda: compressed_allreduce(x, comm, COMPRESS_BLOCK),
             "sym": lambda: compressed_allreduce_sym(s, comm,
                                                     COMPRESS_BLOCK),
             "all_reduce": lambda: collectives.all_reduce(x, comm)}
    counts.reset_launch_counts()
    out = {}
    for name, call in calls.items():
        collectives.reset_word_counts()
        y = call()
        torch.cuda.synchronize()
        row = {"words": collectives.word_counts(),
               "bytes": collectives.byte_counts()}
        host = y.cpu().numpy()
        row["crc"] = zlib.crc32(host.tobytes())
        if name == "sym":
            row["symmetric"] = bool(torch.equal(y, y.T))
        if rank == 0 and name != "all_reduce":
            row["y"] = host
        del y
        row["ms"] = _mesh_ms(torch, dist, call, rank)
        out[name] = row
    out["launches"] = counts.launch_counts()
    return out


def _np_quant(np, x, block):
    blocks = x.reshape(-1, block)
    scale = np.maximum(np.abs(blocks).max(axis=1, keepdims=True)
                       / np.float32(127.0), np.float32(1e-12))
    q = np.clip(np.round(blocks / scale), -127, 127).astype(np.int8)
    return q, scale.astype(np.float32)


def _np_allreduce(np, xs, block):
    """The numpy oracle of compressed_allreduce for lengths that
    ``block·P`` divides: each rank's blocks quantized, stripe j summed
    over the ranks as a left fold in rank order, / P, requantized."""
    P, n = len(xs), xs[0].size
    assert n % (block * P) == 0, (n, block, P)
    qs = [_np_quant(np, x.reshape(-1), block) for x in xs]
    stripe = n // block // P
    parts = []
    for j in range(P):
        rows = slice(j * stripe, (j + 1) * stripe)
        acc = qs[0][0][rows].astype(np.float32) * qs[0][1][rows]
        for q, sc in qs[1:]:
            acc = acc + q[rows].astype(np.float32) * sc[rows]
        q2, s2 = _np_quant(np, acc / np.float32(P), block)
        parts.append(q2.astype(np.float32) * s2)
    return np.concatenate(parts).reshape(xs[0].shape)


def compress_collectives(torch):
    """(d) the compressed all-reduces on COMPRESS_RANKS gloo ranks sharing
    the card, each with its own leaf: rank 0's result bit-equal to the
    numpy oracle and within the reference test's atol of the exact mean,
    every rank's the same, the bytes a rank the byte model's exactly."""
    import numpy as np

    from repro_torch.distributed.compression import wire_bytes_per_device
    from repro_torch.distributed.launch import run_ranks
    P = COMPRESS_RANKS
    card = torch.cuda.get_device_name(0)
    log(f"[compress wire] gloo, host-staged, {P} ranks on one {card}")
    t0 = time.perf_counter()
    ranks = run_ranks("chip_smoke:compress_rank", P, backend="gloo",
                      device="cuda:0", paths=[ROOT], timeout=300)
    wall = time.perf_counter() - t0
    n = COMPRESS_LEAF[1] * COMPRESS_LEAF[2]
    want_bytes = {
        "dense": wire_bytes_per_device(n, P, compressed=True,
                                       block=COMPRESS_BLOCK),
        "sym": wire_bytes_per_device(2048 * 2048, P, compressed=True,
                                     block=COMPRESS_BLOCK, sym_n=2048),
        "all_reduce": wire_bytes_per_device(n, P, compressed=False)}
    assert want_bytes == {"dense": 17_571_840, "sym": 3_196_440,
                          "all_reduce": 69_206_016}, want_bytes
    xs = {k: [_compress_input(torch, k, r, DEVICE).cpu().numpy()
              for r in range(P)] for k in ("dense", "sym")}
    tril = np.tril_indices(2048)
    packed = _np_allreduce(np, [x[tril] for x in xs["sym"]], COMPRESS_BLOCK)
    sym = np.zeros((2048, 2048), np.float32)
    sym[tril] = packed
    oracle = {"dense": _np_allreduce(np, xs["dense"], COMPRESS_BLOCK),
              "sym": np.where(np.eye(2048, dtype=bool), sym, sym + sym.T)}
    rows = {}
    for name in ("dense", "sym", "all_reduce"):
        per_rank = [r[name] for r in ranks]
        got_bytes = [sum(r["bytes"].values()) for r in per_rank]
        row = {"bytes_a_rank": got_bytes, "byte_model": want_bytes[name],
               "words_a_rank": per_rank[0]["words"],
               "bytes_by_kind": per_rank[0]["bytes"],
               "ms_rank0": per_rank[0]["ms"],
               "same_on_every_rank": len({r["crc"] for r in per_rank}) == 1}
        if name != "all_reduce":
            y = per_rank[0]["y"]
            mean = sum(xs[name]) / np.float32(P)
            row["bit_equal_oracle"] = bool(np.array_equal(y, oracle[name]))
            row["err_vs_mean"] = float(np.abs(y - mean).max()
                                       / np.abs(mean).max())
            row["tol"] = 1 / 50 if name == "dense" else 1 / 30
        if name == "sym":
            row["symmetric"] = all(r["symmetric"] for r in per_rank)
        rows[name] = row
        log(f"[compress wire] {name}: bytes a rank {got_bytes} (model "
            f"{want_bytes[name]:.0f}) {row['bytes_by_kind']}, words "
            f"{row['words_a_rank']}; {row['ms_rank0']:.3f} ms on rank 0; "
            + ", ".join(f"{k} {row[k]}" for k in
                        ("bit_equal_oracle", "err_vs_mean", "tol",
                         "symmetric", "same_on_every_rank") if k in row))
        assert got_bytes == [want_bytes[name]] * P, (name, got_bytes)
        assert row["same_on_every_rank"], name
        if name != "all_reduce":
            assert row["bit_equal_oracle"], name
            assert row["err_vs_mean"] <= row["tol"], row
        if name == "sym":
            assert row["symmetric"], row
    launched = {}
    for r in ranks:
        for k, v in r["launches"].items():
            launched[k] = launched.get(k, 0) + v
    log(f"[compress wire] {wall:.1f} s with process start; kernel "
        f"launches on every rank {launched}")
    assert all(v == 0 for v in launched.values()), launched
    return dict(rows, wall_s=wall, ranks=P)


def compress_phase(torch, train_out):
    """Phase 12: (a) compressed Muon at full width, (b) the quantizer
    card vs host, (c) a resume with the EF state, (d) the compressed
    all-reduces on gloo ranks sharing the card."""
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    train, launches = compress_train(torch, train_out["muon"])
    gc.collect()
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    quant = compress_quantizer(torch)
    t2 = time.perf_counter()
    resume = compress_resume(torch)
    t3 = time.perf_counter()
    wire = compress_collectives(torch)
    t4 = time.perf_counter()
    seconds = {"train_s": t1 - t0, "quantizer_s": t2 - t1,
               "resume_s": t3 - t2, "wire_s": t4 - t3}
    log(f"[compress] phase seconds {json.dumps(seconds)}")
    return {"train": train, "quantizer": quant, "resume": resume,
            "wire": wire, **seconds}, launches


# --------------------------------------------------------------------------
# phase 13: train --devices N on a (data, model) mesh of gloo ranks
# --------------------------------------------------------------------------
MESHTRAIN_STEPS = RESUME_STEPS
#: losses a step against the single-device trainer's: the ranks sum
#: bf16 products and gradients in another order (on the card 1.1e-5 at
#: most; ``tests/test_torch_train_mesh.py`` holds the CPU runs to 5e-4)
MESHTRAIN_RTOL = 1e-4


def _stablelm_leaves(cfg):
    """{path: whole stacked shape} of the model's parameter tree."""
    L, d, f, V = cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.vocab
    hq, hkv = cfg.n_heads * cfg.hd, cfg.n_kv_heads * cfg.hd
    leaves = {("embed",): (V, d), ("unembed",): (d, V),
              ("final_norm", "scale"): (d,), ("final_norm", "bias"): (d,)}
    for part, names in (("mixer", {"wq": (d, hq), "wk": (d, hkv),
                                   "wv": (d, hkv), "wo": (hq, d)}),
                        ("mlp", {"wi": (d, f), "wg": (d, f),
                                 "wo": (f, d)})):
        for n, shape in names.items():
            leaves[("periods", "b0", part, n)] = (L,) + shape
    for norm in ("norm1", "norm2"):
        for n in ("scale", "bias"):
            leaves[("periods", "b0", norm, n)] = (L, d)
    return leaves


def _ns_closed_form(cfg, data, P, steps=5):
    """A rank's Muon words a step on a (data, P) mesh, by kind, from the
    shapes alone, and the path each matrix leaf takes: the 1D schedule
    where the split is on the long side and Thm 9 case 1 holds (a packed
    reduce-scatter and all-gather of the short side's padded triangle a
    NS step, one all-reduce of the norms), else one gather of the block
    ((P - 1) blocks); a replicated leaf moves nothing."""
    from repro_torch.core.dispatch import choose_algorithm
    from repro_torch.core.packing import tril_size
    from repro_torch.models.sharding import param_specs
    shapes = _stablelm_leaves(cfg)
    specs = param_specs(cfg, shapes, {"data": data, "model": P})
    total, paths = {}, {}
    for k, shape in shapes.items():
        if len(shape) < 2 or min(shape[-2:]) < 8:
            continue                               # signSGD, no NS
        spec = specs[k]
        if P == 1 or all(a is None for a in spec):
            paths["/".join(k)] = "replicated chain"
            continue
        rows, cols = shape[-2:]
        lead = math.prod(shape[:-2])
        m, n = min(rows, cols), max(rows, cols)
        long_split = (spec[-1] is not None and rows <= cols) or \
            (spec[-2] is not None and rows >= cols)
        if long_split and choose_algorithm(m, n, P, m=1).case == 1:
            lp = lead * (-(-tril_size(m) // P) * P)
            words = {"reduce_scatter": steps * (lp * (P - 1) // P),
                     "all_gather": steps * (lp // P * (P - 1)),
                     "all_reduce": 2 * lead * (P - 1) // P}
            paths["/".join(k)] = "1d"
        else:
            words = {"all_gather": math.prod(shape) // P * (P - 1)}
            paths["/".join(k)] = "gather"
        for kind, w in words.items():
            total[kind] = total.get(kind, 0) + w
    return total, paths


def run_mesh_train(torch, devices, max_model, layers):
    """``train --devices N`` (gloo ranks sharing this card) on phase 7's
    traffic with ``muon-syrk`` at ``layers`` layers."""
    from repro_torch.launch.train import build_argparser, train
    argv = _train_argv("muon-syrk", MESHTRAIN_STEPS, layers) + [
        "--device", DEVICE, "--devices", str(devices),
        "--max-model", str(max_model)]
    t0 = time.perf_counter()
    out = train(build_argparser().parse_args(argv))
    out["wall_s"] = time.perf_counter() - t0
    return out


def meshtrain_check(tag, out, want, cfg, data, P):
    """Every rank's losses identical and within ``MESHTRAIN_RTOL`` of
    ``want`` a step, the optimizer's words a rank a step the closed
    form, the symmetric kernels launched on every rank (the gathered
    stacks' chain); prints the split, words, bytes and peaks."""
    assert out["mesh"] == {"data": data, "model": P}, out["mesh"]
    ranks = out["ranks"]
    losses = out["losses"]
    assert len(losses) == MESHTRAIN_STEPS and all(map(math.isfinite,
                                                      losses)), losses
    for i, r in enumerate(ranks):
        assert r["losses"] == losses, (f"rank {i} disagrees", r["losses"],
                                       losses)
    log(f"{tag} {cfg.name} {cfg.n_layers} layers, mesh (data {data}, model "
        f"{P}), {len(ranks)} gloo ranks on one card, muon-syrk; losses "
        f"{losses} vs the single-device trainer's {want}")
    for i, (got, ref) in enumerate(zip(losses, want)):
        rel = abs(got - ref) / abs(ref)
        log(f"{tag} step {i}: rel {rel:.3e} (<= {MESHTRAIN_RTOL:.0e})")
        assert rel <= MESHTRAIN_RTOL, (i, got, ref)
    predicted, paths = _ns_closed_form(cfg, data, P)
    log(f"{tag} Muon path per matrix leaf: {json.dumps(paths)}")
    log(f"{tag} Muon words a rank a step, closed form: {predicted}")
    for i, r in enumerate(ranks):
        for s, step in enumerate(r["words"]):
            assert step["opt"] == predicted, (i, s, step["opt"], predicted)
    r0 = ranks[0]
    for s, (t, sp) in enumerate(zip(r0["step_s"], r0["split_s"])):
        log(f"{tag} step {s}{' (warm-up)' if s == 0 else ''}: {t:.4f} s = "
            f"loss+backward {sp['loss_backward_s']:.4f} + reduce "
            f"{sp['reduce_s']:.4f} + clip {sp['clip_s']:.4f} + optimizer "
            f"{sp['opt_s']:.4f} (rank 0)")
    for phase in ("loss_backward", "reduce", "clip", "opt"):
        log(f"{tag} rank 0 a step, {phase}: words "
            f"{r0['words'][-1][phase]}, bytes {r0['bytes'][-1][phase]}")
    for i, r in enumerate(ranks):
        log(f"{tag} rank {i}: words over the run {_kinds(r['words'])}, "
            f"bytes {_kinds(r['bytes'])}; peak memory "
            f"{r['peak_memory_bytes'] / 2**30:.2f} GiB; launches "
            f"{r['kernel_launches']}")
        kl = r["kernel_launches"]
        assert kl["rank_update"] > 0 and kl["sym_stream"] > 0, kl
        assert kl["slstm_scan"] == 0, kl
    launches = {}
    for r in ranks:
        for k, v in r["kernel_launches"].items():
            launches[k] = launches.get(k, 0) + v
    log(f"{tag} wall {out['wall_s']:.1f} s (rank processes' start, init "
        "and build included)")
    return {"mesh": out["mesh"], "losses": losses, "want": want,
            "paths": paths, "ns_words": predicted,
            "step_s": [r["step_s"] for r in ranks],
            "split_s": r0["split_s"],
            "words": _kinds(r0["words"]), "bytes": _kinds(r0["bytes"]),
            "peak_memory_bytes": [r["peak_memory_bytes"] for r in ranks],
            "launches": [r["kernel_launches"] for r in ranks],
            "wall_s": out["wall_s"]}, launches


def _kinds(per_step):
    total = {}
    for phases in per_step:
        for kinds in phases.values():
            for k, v in kinds.items():
                total[k] = total.get(k, 0) + v
    return total


def meshtrain_phase(torch, single):
    """Phase 13: stablelm-1.6b at its published widths, cut to
    ``RESUME_LAYERS`` layers, on (data 2, model 2), held to the
    uninterrupted single-device run at that depth (phase 11's).  Its
    (data 1, model 4) run is phase 14's phase 1: the same path at that
    depth, with the Grams and a checkpoint."""
    import dataclasses
    import gc

    from repro_torch.configs import get_config
    gc.collect()
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(get_config("stablelm-1.6b"),
                              n_layers=RESUME_LAYERS)
    t0 = time.perf_counter()
    b = run_mesh_train(torch, 4, 2, layers=RESUME_LAYERS)
    rb, launches = meshtrain_check("[meshtrain b]", b,
                                   single["losses"][:MESHTRAIN_STEPS],
                                   cfg, 2, 2)
    seconds = {"b_s": time.perf_counter() - t0}
    log(f"[meshtrain] phase seconds {json.dumps(seconds)}")
    return {"b": rb, **seconds}, launches


# --------------------------------------------------------------------------
# phase 14: elastic kill -> resume on another device count
# --------------------------------------------------------------------------
ELASTIC_DEVICES, ELASTIC_AFTER, ELASTIC_MAX_MODEL = 4, 2, 4


def _gram_rs_words(cfg, P):
    """A rank's words a step of the Grams' reduce-scatter on (1, P):
    (1 - 1/P)·Lp for embed and for unembed, each split over 'model'
    along its width, Lp = n(n+1)/2 padded to a multiple of P."""
    from repro_torch.core.packing import padded_tril_size
    lp = padded_tril_size(cfg.d_model, P)
    return 2 * (lp * (P - 1) // P)


def elastic_phase(torch, single):
    """Phase 14: ``run_recovery`` of ``muon-syrk`` with ``--track-gram``
    at stablelm-1.6b's published widths and ``RESUME_LAYERS`` layers,
    phase 7's traffic: phase 1 on ``ELASTIC_DEVICES`` gloo ranks sharing
    the card, (data 1, model 4), killed by ``train:step`` before step
    ``RESUME_KILL`` after its step-2 checkpoint committed; phase 2
    resumed on ``ELASTIC_AFTER`` ranks, (data 1, model 2).  0
    mismatches; every loss within ``MESHTRAIN_RTOL`` of the single-device
    run's; the Grams of the last checkpoint within ``GRAM_TOL`` of its;
    every rank's optimizer words a step the NS closed form plus the
    Grams' reduce-scatter; the symmetric kernels launched on every rank
    of both phases, ``rank_update`` once a NS step a gathered stack plus
    once a step for each Gram."""
    import dataclasses
    import gc
    import shutil
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.distributed import checkpoint_bytes
    from repro_torch.launch.recovery import run_recovery
    gc.collect()
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(get_config("stablelm-1.6b"),
                              n_layers=RESUME_LAYERS)
    root = tempfile.mkdtemp(prefix="chip_smoke_elastic_")
    try:
        d = os.path.join(root, "ckpt")
        t0 = time.perf_counter()
        out = run_recovery(
            d, devices=ELASTIC_DEVICES, devices_after=ELASTIC_AFTER,
            max_model=ELASTIC_MAX_MODEL, steps=RESUME_STEPS,
            kill_step=RESUME_KILL, ckpt_every=RESUME_EVERY, global_batch=8,
            seq_len=256, layers=RESUME_LAYERS, optimizer="muon-syrk",
            track_gram=True, timeout=600,
            extra_args=["--full", "--loss-chunk", "256"])
        total = time.perf_counter() - t0
        grams = _packed_grams(d)
        nbytes = checkpoint_bytes(d)["total"]
    finally:
        shutil.rmtree(root, ignore_errors=True)
    p1, p2 = out["phases"]
    summary = {k: v for k, v in out.items() if k not in ("phases", "final")}
    log(f"[elastic] {json.dumps(summary)}; phase 2's mesh "
        f"{out['final']['mesh']}")
    assert out["killed"] and out["kill_step"] == RESUME_KILL, out
    assert out["resumed_step"] == RESUME_EVERY and out["mismatches"] == 0
    assert out["completed"] and out["final"]["resumed"], out
    assert out["final"]["mesh"] == {"data": 1, "model": ELASTIC_AFTER}
    for p in (p1, p2):
        assert all(r == p["losses"] for r in p["ranks"]["losses"]), \
            p["ranks"]["losses"]
    got, want = p1["losses"] + p2["losses"], single["losses"]
    log(f"[elastic] losses {got} vs the single-device run's {want}")
    assert len(got) == len(want) == RESUME_STEPS, (got, want)
    for i, (x, y) in enumerate(zip(got, want)):
        rel = abs(x - y) / abs(y)
        log(f"[elastic] step {i}: rel {rel:.3e} (<= {MESHTRAIN_RTOL:.0e})")
        assert rel <= MESHTRAIN_RTOL, (i, x, y)
    assert sorted(grams) == sorted(single["grams"]), sorted(grams)
    gram_err = max(float((grams[k] - g).abs().max() / g.abs().max())
                   for k, g in single["grams"].items())
    log(f"[elastic] packed Grams after phase 2 (gathered, bf16 words) vs "
        f"the single-device run's: largest relative difference {gram_err} "
        f"(tolerance {GRAM_TOL})")
    assert gram_err <= GRAM_TOL, gram_err
    launches, words, gathered = {}, {}, {}
    for p, P, steps in ((p1, ELASTIC_MAX_MODEL, RESUME_KILL),
                        (p2, ELASTIC_AFTER, RESUME_STEPS - RESUME_EVERY)):
        ns, paths = _ns_closed_form(cfg, 1, P)
        gram = _gram_rs_words(cfg, P)
        want_opt = dict(ns, reduce_scatter=ns.get("reduce_scatter", 0)
                        + gram)
        log(f"[elastic] (1, {P}): Muon paths {json.dumps(paths)}; words a "
            f"rank a step: NS {ns}, the Grams' reduce-scatter {gram}")
        log(f"[elastic] (1, {P}) rank 0: words a step by phase "
            f"{p['words'][-1]}; checkpoint words over the phase, by rank "
            f"{p['ranks']['ckpt_words']}")
        for s, step in enumerate(p["words"]):
            assert step["opt"] == want_opt, (P, s, step["opt"], want_opt)
        words[f"1x{P}"] = {"opt": p["words"][-1]["opt"],
                           "gram_reduce_scatter": gram,
                           "ckpt": p["ranks"]["ckpt_words"]}
        gathered[P] = (steps, sum(v == "gather" for v in paths.values()))
    for p, P in ((p1, ELASTIC_MAX_MODEL), (p2, ELASTIC_AFTER)):
        steps, stacks = gathered[P]
        for r, n in enumerate(p["ranks"]["kernel_launches"]):
            log(f"[elastic] (1, {P}) rank {r}: launches {n}")
            assert n["rank_update"] == steps * (5 * stacks + 2), (P, r, n)
            assert n["sym_stream"] == steps * 10 * stacks, (P, r, n)
            assert n["slstm_scan"] == 0, n
            for k, v in n.items():
                launches[k] = launches.get(k, 0) + v
    times = {"phase1_s": p1["s"], "phase2_s": p2["s"], "total_s": total,
             "restore_s": p2["ckpt_s"]["restore_s"],
             "verify_s": p2["ckpt_s"]["verify_s"],
             "save_s": p2["ckpt_s"].get("save_s"),
             "phase1_snapshot_s": p1["ckpt_s"]["snapshot_s"]}
    log(f"[elastic] checkpoint {nbytes} bytes; {json.dumps(times)}")
    return {"layers": RESUME_LAYERS, "ckpt_bytes": nbytes,
            "verified_leaves": out["verified_leaves"],
            "losses_phase1": p1["losses"], "losses_phase2": p2["losses"],
            "single_losses": want, "gram_rel_err": gram_err,
            "words": words, **times}, launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.device import ieee_f32
    ieee_f32()
    t_start = time.perf_counter()
    phase_s = {}

    def timed(name, fn, *a):
        t0 = time.perf_counter()
        try:
            return fn(*a)
        finally:
            phase_s[name] = round(time.perf_counter() - t0, 1)

    card, clock = timed("probe", probe, torch)
    build_s = timed("build", build)
    cases = timed("kernels", kernel_phase, torch, clock)
    _, launches = timed("serve", serve_phase, torch)
    xout, xlaunches = timed("xlstm", xlstm_phase, torch)
    timed("check", check_phase, torch)
    tout, tlaunches = timed("train", train_phase, torch, cases)
    mout, mlaunches = timed("mesh", mesh_phase, torch)
    cout, claunches = timed("ckpt", ckpt_phase, torch)
    wout, wlaunches = timed("warm", warm_phase, torch)
    aout, alaunches = timed("faults", abft_phase, torch)
    single = timed("single", single_resume_depth, torch)
    rout, rlaunches = timed("recovery", recovery_phase, torch, single)
    pout, plaunches = timed("compress", compress_phase, torch, tout)
    eout, elaunches = timed("meshtrain", meshtrain_phase, torch, single)
    lout, llaunches = timed("elastic", elastic_phase, torch, single)
    log(f"[done] build {build_s:.2f} s, total "
        f"{time.perf_counter() - t_start:.1f} s; by phase "
        f"{json.dumps(phase_s)}")
    log(json.dumps({"xlstm_serve": {k: v for k, v in xout.items()
                                    if k not in ("cache",)}}))
    log(json.dumps({"train": tout}))
    log(json.dumps({"mesh": mout}))
    log(json.dumps({"ckpt": cout}))
    log(json.dumps({"warm": wout}))
    log(json.dumps({"abft": aout}))
    log(json.dumps({"recovery": rout}))
    log(json.dumps({"compress": pout}))
    log(json.dumps({"meshtrain": eout}))
    log(json.dumps({"elastic": lout}))

    kernels = []
    for name, rows in cases.items():
        [main_row] = [r for r in rows if r["main"]]
        by_path = {"stablelm-1.6b": launches[name],
                   "xlstm-350m": xlaunches[name],
                   "train stablelm-1.6b muon": tlaunches[name],
                   "mesh": mlaunches.get(name, 0),
                   "train resume stablelm-1.6b muon": claunches.get(name, 0),
                   "serve warm stablelm-1.6b": wlaunches[name],
                   "abft local": alaunches.get(name, 0),
                   "kill/resume stablelm-1.6b muon": rlaunches.get(name,
                                                                   0),
                   "train compressed stablelm-1.6b muon": plaunches[name],
                   "train mesh stablelm-1.6b muon-syrk": elaunches[name],
                   "elastic kill/resume stablelm-1.6b muon-syrk":
                   llaunches.get(name, 0)}
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
