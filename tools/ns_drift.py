#!/usr/bin/env python3
"""Separate the symmetric kernels' own error from the Newton–Schulz
iteration's drift, at the whitening cache's widths.

    python3 tools/ns_drift.py [--d 3584 3840 4096 5120 6144]

For each d, on the card, with the inputs of ``chip_smoke.py``'s NS check
(a Gram of (d, 2d) f32 features from seed 29, eps 1e-3, 30 steps):

- one call of each kernel against its plain version on the same inputs:
  the packed Gram (SYRK), the NS seed (TriTiles bm 32 × I), an NS
  product sym(X)·T and T² (SYRK, full), each as max |err| / max(1,
  max |plain|);
- the NS factor on the kernels and on the plain versions, each against
  the same iteration in f64 (dense ``torch.matmul``) from the kernels'
  Gram: relative Frobenius error;
- the embedding sym(W)·pooled on the kernel and on the plain version
  with the same W, and with each route's own W.

Prints the card's name and power limit and one JSON line; needs a CUDA
card and ``nvcc``.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from chip_smoke import NS_ITERS, ns_f64, plain_symmetric_kernels  # noqa

DEVICE = "cuda"
EPS = 1e-3


def both(torch, fn):
    """``fn()`` on the kernels, then on the plain versions."""
    got = fn()
    restore = plain_symmetric_kernels(torch)
    try:
        want = fn()
    finally:
        restore()
    if DEVICE == "cuda":
        torch.cuda.synchronize()
    return got, want


def err(got, want):
    return float((got - want).abs().max()) / max(1.0, float(want.abs().max()))


def rel_fro(got, want):
    return float((got.double() - want).norm() / want.double().norm())


def one_width(torch, d):
    from repro_torch import blas
    from repro_torch.core.packing import TriTiles
    from repro_torch.optim.gram import packed_gram, whitening_from_packed
    gen = torch.Generator(device=DEVICE).manual_seed(29)
    x = torch.randn(d, 2 * d, generator=gen, device=DEVICE)
    pooled = x[:, :64].mean(dim=1)
    out = {}
    g, gp = both(torch, lambda: packed_gram(x))
    out["gram_err"] = err(g, gp)
    pn = g / float(g.abs().max())
    seed, seedp = both(torch, lambda: blas.symm(
        TriTiles.from_packed(pn, d, 32), torch.eye(d, device=DEVICE)))
    out["seed_err"] = err(seed, seedp)
    s = 0.5 * (seed + seed.T)
    t = 0.5 * (3.0 * torch.eye(d, device=DEVICE) - s)
    prod, prodp = both(torch, lambda: blas.symm(s, t))
    out["product_err"] = err(prod, prodp)
    sq, sqp = both(torch, lambda: blas.syrk(t, fill="full"))
    out["syrk_err"] = err(sq, sqp)
    del seed, seedp, s, t, prod, prodp, sq, sqp
    w, wp = both(torch, lambda: whitening_from_packed(
        g, d, eps=EPS, method="ns", iters=NS_ITERS))
    w64 = ns_f64(torch, g, d, EPS)
    out["ns_kernels_vs_f64"] = rel_fro(w, w64)
    out["ns_plain_vs_f64"] = rel_fro(wp, w64)
    out["ns_kernels_vs_plain"] = rel_fro(w, wp)
    e, ep = both(torch, lambda: blas.symm(w, pooled[:, None])[:, 0])
    out["embedding_same_w_err"] = err(e, ep)
    ep_own = blas.symm(wp, pooled[:, None])[:, 0]
    e64 = (w64 @ pooled.double()[:, None])[:, 0]
    out["embedding_own_w_err"] = err(e, ep_own)
    out["embedding_kernels_vs_f64"] = err(e.double(), e64)
    out["embedding_plain_vs_f64"] = err(ep_own.double(), e64)
    out["embedding_max"] = float(e64.abs().max())
    print(f"[ns_drift] d {d}: {json.dumps(out)}", flush=True)
    del w, wp, w64, g, gp, x
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    return out


def main() -> int:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--d", type=int, nargs="+",
                    default=[3584, 3840, 4096, 5120, 6144])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ns_drift: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.device import ieee_f32
    ieee_f32()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    print(card)
    rows = {d: one_width(torch, d) for d in args.d}
    print(json.dumps({"card": card, "ns_drift": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
