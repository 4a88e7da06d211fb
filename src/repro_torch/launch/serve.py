"""Batched serving loop (port of :mod:`repro.launch.serve`).

    PYTHONPATH=src python -m repro_torch.launch.serve --full \
        --arch stablelm-1.6b --whiten cache
    PYTHONPATH=src python -m repro_torch.launch.serve --full \
        --arch xlstm-350m --whiten cache

Requests with variable prompt lengths and a tenant id are packed into
fixed decode slots; prefill runs right-padded at a bucketed length
(16·2^k up to s_max) and writes the sequence's KV cache into its slot;
decode advances every live slot one token per step and refills finished
slots from the queue (continuous batching).  For a recurrent model
(xlstm) the slot holds the sequence's recurrent state instead of a KV
cache; as in the reference, the right-padded prefill feeds the pad
tokens into that state and the first token is read at the bucket's last
position.  With ``--whiten cache`` each admitted prompt's final-norm
features update the per-(tenant, arch, layer) packed Gram EMA (the SYRK
kernel) and its embedding is the latest ready whitening factor applied
to the pooled features (the SYMM kernel); the factor refresh (coupled Newton–Schulz on the SYMM/SYRK
kernels) runs on the cache's background worker.  ``--whiten sync`` is
the uncached baseline (from-scratch Gram + eigh per request), ``off``
skips statistics.  Generated tokens never depend on the whiten mode.

Runs on the GPU; ``--device cpu`` runs on the host.
"""
from __future__ import annotations

import argparse
import json
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import blas
from ..configs import get_config, get_smoke_config
from ..device import DeviceLike, describe, resolve_device
from ..kernels import counts
from ..models.model import Model, init_model
from ..optim.gram import packed_gram, whitening_from_packed
from .serving_cache import ServingGramCache
from .steps import make_decode_step, make_prefill_step


@dataclass
class Request:
    rid: int
    prompt: np.ndarray                 # (len,) int32
    tenant: str = "default"
    arrived: float = 0.0
    first_token_t: Optional[float] = None
    done_t: Optional[float] = None
    generated: List[int] = field(default_factory=list)
    embedding: Optional[np.ndarray] = None   # whitened prompt embedding


def synthetic_requests(n: int, vocab: int, seed: int = 0, lo: int = 8,
                       hi: int = 48, tenants: int = 1) -> List[Request]:
    rng = np.random.default_rng(seed)
    return [Request(rid=i, prompt=rng.integers(
        1, vocab, size=int(rng.integers(lo, hi))).astype(np.int32),
        tenant=f"tenant{i % max(1, tenants)}")
        for i in range(n)]


class Server:
    """Slot-based continuous batching around eager prefill/decode.

    ``whiten``: "off", "cache" (packed Gram EMA + async-refreshed factor
    from ``gram_cache``) or "sync" (from-scratch Gram + dense eigh per
    admitted request).  ``device`` must be the model's device; None
    means the GPU and raises without one."""

    def __init__(self, cfg, model: Model, *, slots: int, s_max: int,
                 max_new: int, eos_id: int = 0, whiten: str = "off",
                 gram_cache: Optional[ServingGramCache] = None,
                 device: DeviceLike = None):
        if whiten not in ("off", "cache", "sync"):
            raise ValueError(f"whiten must be off/cache/sync: {whiten!r}")
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model lives on {model.device}, server on "
                             f"{self.device}")
        if whiten == "cache" and gram_cache is None:
            gram_cache = ServingGramCache()
        self.cfg = cfg
        self.model = model
        self.slots = slots
        self.s_max = s_max
        self.max_new = max_new
        self.eos_id = eos_id
        self.whiten = whiten
        self.gram_cache = gram_cache
        self.decode = make_decode_step(model)
        self.prefill = make_prefill_step(model, s_max=s_max,
                                         return_hidden=whiten != "off")
        self.cache = model.init_cache(slots, s_max)
        self.pos = np.zeros(slots, np.int32)        # next position
        self.live: List[Optional[Request]] = [None] * slots
        self.last_tok = np.zeros((slots, 1), np.int32)
        #: host seconds per phase; each phase ends in a device sync
        self.timing = {"prefill_s": 0.0, "embed_s": 0.0, "decode_s": 0.0}
        #: model forwards run (prefills and decode steps), warm-up included
        self.forwards = 0

    def _bucket(self, n: int) -> int:
        b = 16
        while b < n:
            b *= 2
        return min(b, self.s_max)

    def bucket_ladder(self) -> List[int]:
        """Every bucket :meth:`_bucket` can emit."""
        ladder, b = [], 16
        while b < self.s_max:
            ladder.append(b)
            b *= 2
        return ladder + [self.s_max]

    def warm_up(self) -> None:
        """Run each prefill bucket, one decode step and the statistics
        path once on scratch inputs — the counterpart of the reference's
        precompiled ladder: lazy CUDA / cuBLAS initialisation, kernel
        builds and index tables land here, not in the first requests.
        No server or cache state is touched."""
        d = self.cfg.d_model
        for b in self.bucket_ladder():
            toks = torch.zeros((1, b), dtype=torch.long, device=self.device)
            out = self.prefill(toks)
            self.forwards += 1
            if self.whiten != "off":
                feats, pooled = self._prep(out[2], b)
                packed_gram(feats)
        zero = torch.zeros((self.slots, 1), dtype=torch.long,
                           device=self.device)
        self.decode(zero, zero, self.model.init_cache(self.slots,
                                                      self.s_max))
        self.forwards += 1
        if self.whiten != "off":
            blas.symm(torch.eye(d, device=self.device), pooled[:, None])
            whitening_from_packed(
                torch.zeros(d * (d + 1) // 2, device=self.device), d,
                iters=1)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _prep(self, hidden: torch.Tensor, L: int):
        """Bucket-length features (d, bucket) with padded columns zeroed
        (they add nothing to X·Xᵀ) and the mean over the true length."""
        feats = hidden[0].float()                        # (bucket, d)
        mask = (torch.arange(feats.shape[0], device=feats.device)
                < L)[:, None]
        feats = torch.where(mask, feats, torch.zeros((), device=feats.device))
        feats = feats.T.contiguous()                     # (d, bucket)
        return feats, feats.sum(dim=1) / float(L)

    def _embed(self, req: Request, hidden: torch.Tensor, L: int) -> None:
        feats, pooled = self._prep(hidden, L)
        if self.whiten == "cache":
            self.gram_cache.update(req.tenant, self.cfg.name, "final", feats)
            w = self.gram_cache.factor(req.tenant, self.cfg.name, "final")
            if w is None:                                 # cold start
                req.embedding = pooled.cpu().numpy()
                return
        else:                                             # "sync"
            w = whitening_from_packed(packed_gram(feats), self.cfg.d_model,
                                      method="eigh")
        req.embedding = blas.symm(w, pooled[:, None])[:, 0].cpu().numpy()

    def admit(self, req: Request, slot: int) -> None:
        """Prefill one request into a slot."""
        L = len(req.prompt)
        bucket = self._bucket(L)
        toks = np.zeros((1, bucket), np.int64)
        toks[0, :L] = req.prompt
        t0 = time.perf_counter()
        out = self.prefill(torch.as_tensor(toks, device=self.device))
        self.forwards += 1
        logits, cache1 = out[0], out[1]
        for dst, src in zip(self.cache, cache1):
            for name in dst:
                dst[name][slot] = src[name][0]
        nxt = int(torch.argmax(logits[0, -1]))
        t1 = time.perf_counter()
        self.timing["prefill_s"] += t1 - t0
        if self.whiten != "off":
            self._embed(req, out[2], L)
            self.timing["embed_s"] += time.perf_counter() - t1
        # as the reference: stamped once the admit's statistics are done,
        # so a request's TTFT includes its embedding
        req.first_token_t = time.perf_counter()
        req.generated.append(nxt)
        self.live[slot] = req
        self.pos[slot] = L
        self.last_tok[slot, 0] = nxt

    def step(self) -> None:
        """One decode step over every slot (dead slots idle on pad)."""
        tok = torch.as_tensor(self.last_tok.astype(np.int64),
                              device=self.device)
        pos = torch.as_tensor(self.pos[:, None].astype(np.int64),
                              device=self.device)
        t0 = time.perf_counter()
        nxt, _, self.cache = self.decode(tok, pos, self.cache)
        self.forwards += 1
        nxt = nxt.cpu().numpy()
        now = time.perf_counter()
        self.timing["decode_s"] += now - t0
        for s, req in enumerate(self.live):
            if req is None:
                continue
            t = int(nxt[s, 0])
            req.generated.append(t)
            self.pos[s] += 1
            self.last_tok[s, 0] = t
            if t == self.eos_id or len(req.generated) >= self.max_new \
                    or self.pos[s] >= self.s_max - 1:
                req.done_t = now
                self.live[s] = None

    def free_slot(self) -> Optional[int]:
        for s, r in enumerate(self.live):
            if r is None:
                return s
        return None


def run(srv: Server, reqs: List[Request], max_steps: int) -> int:
    """Serve ``reqs`` to completion (continuous batching); returns the
    number of decode steps."""
    queue = list(reqs)
    steps = 0
    while queue or any(r is not None for r in srv.live):
        while queue:
            s = srv.free_slot()
            if s is None:
                break
            srv.admit(queue.pop(0), s)
        srv.step()
        steps += 1
        if steps > max_steps:
            break
    return steps


def serve(args, device: DeviceLike = None) -> Dict:
    dev = resolve_device(device if device is not None else args.device)
    cfg = get_smoke_config(args.arch) if args.smoke \
        else get_config(args.arch)
    t_build = time.perf_counter()
    model = init_model(cfg, seed=args.seed, device=dev)
    reqs = synthetic_requests(args.requests, cfg.vocab, args.seed,
                              lo=args.prompt_lo, hi=args.prompt_hi,
                              tenants=args.tenants)
    gram_cache = None
    if args.whiten == "cache":
        gram_cache = ServingGramCache(refresh_stride=args.refresh_stride)
    try:
        srv = Server(cfg, model, slots=args.slots, s_max=args.s_max,
                     max_new=args.max_new, eos_id=-1 if args.no_eos else 0,
                     whiten=args.whiten, gram_cache=gram_cache, device=dev)
        # the clock starts when the server can admit: bring-up (weights,
        # warm-up) is reported as startup_s
        srv.warm_up()
        warmup_forwards = srv.forwards
        # launches of the serve proper; the counts themselves run on, so
        # a caller that zeroed them before serve() also sees the warm-up's
        before = counts.launch_counts()
        t0 = time.perf_counter()
        for r in reqs:
            r.arrived = t0
        steps = run(srv, reqs, args.requests * args.max_new)
        t1 = time.perf_counter()
        if gram_cache is not None:
            gram_cache.drain()
        launches = {k: n - before[k]
                    for k, n in counts.launch_counts().items()}
    finally:
        if gram_cache is not None:
            gram_cache.close()

    done = [r for r in reqs if r.done_t is not None]
    toks = sum(len(r.generated) for r in reqs)
    ttfts = [r.first_token_t - r.arrived for r in done]
    lats = [r.done_t - r.arrived for r in done]
    pct = lambda xs, q: float(np.percentile(xs, q)) if xs else None  # noqa
    out = {"arch": cfg.name, "device": describe(dev),
           "layers": cfg.n_layers, "d_model": cfg.d_model,
           "vocab": cfg.vocab, "requests": len(reqs),
           "tenants": args.tenants, "whiten": args.whiten,
           "completed": len(done), "decode_steps": steps,
           "total_new_tokens": toks, "tokens_per_s": toks / (t1 - t0),
           "startup_s": t0 - t_build,
           "mean_ttft_s": float(np.mean(ttfts)) if ttfts else None,
           "p50_ttft_s": pct(ttfts, 50), "p99_ttft_s": pct(ttfts, 99),
           "mean_latency_s": float(np.mean(lats)) if lats else None,
           "p50_latency_s": pct(lats, 50), "p99_latency_s": pct(lats, 99),
           "bucket_ladder": srv.bucket_ladder(),
           "serve_s": t1 - t0, **srv.timing,
           "model_forwards": srv.forwards,
           "warmup_forwards": warmup_forwards,
           "kernel_launches": launches,
           "embeddings_finite": all(
               r.embedding is not None and bool(np.isfinite(r.embedding)
                                                .all()) for r in done)
           if args.whiten != "off" else None}
    if gram_cache is not None:
        out["cache"] = gram_cache.snapshot_stats()
        out["refresh_s"] = list(gram_cache.refresh_seconds)
    print("[serve] done:", json.dumps(out))
    return out


def build_argparser():
    ap = argparse.ArgumentParser(description="batched serving loop "
                                 "(PyTorch / CUDA)")
    ap.add_argument("--arch", default="stablelm-1.6b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' to run "
                         "on the host)")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--s-max", type=int, default=256)
    ap.add_argument("--max-new", type=int, default=24)
    ap.add_argument("--prompt-lo", type=int, default=8)
    ap.add_argument("--prompt-hi", type=int, default=48)
    ap.add_argument("--tenants", type=int, default=1)
    ap.add_argument("--whiten", choices=("off", "cache", "sync"),
                    default="off")
    ap.add_argument("--refresh-stride", type=int, default=8)
    ap.add_argument("--no-eos", action="store_true", default=True)
    ap.add_argument("--seed", type=int, default=0)
    return ap


def main(argv=None):
    serve(build_argparser().parse_args(argv))


if __name__ == "__main__":
    main()
