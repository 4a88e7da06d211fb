"""Recurrent mixers: Mamba (selective SSM) and xLSTM (mLSTM + sLSTM).
Port of :mod:`repro.models.ssm`.

All three share the attention mixer's calling convention and run
eagerly.  Projections are bf16 (``x @ W``) and become f32 before the
recurrence, as in the reference (sLSTM: inside ``slstm_scan``, which
takes the bf16 gates).  State layouts (per layer, batch on dim 0):

  mamba : conv buffer (B, d_conv-1, d_inner) bf16, ssm (B, d_inner,
          d_state) f32
  mlstm : C (B, H, hd, hd), n (B, H, hd), m (B, H), f32
  slstm : c, n, m (B, d), f32

Mamba has no TPU kernel: the reference computes its scan in jnp, and
the port in plain PyTorch, with the reference's rule: the sequential
scan (``_selective_scan_seq``) at decode and at short prefills, the
chunked one (``_selective_scan``: chunks of ``SSM_CHUNK`` tokens, each
an associative scan in ``lax.associative_scan``'s association order)
where s % 64 == 0 and s > 64; each chunk's output is tagged
(``common.scan_out``) for the "names" remat policy, as the reference
names it.  Under autograd the mixer differentiates as it is (the conv's
bf16 adds, softplus, either scan).  jnp promotes bf16 against f32 silently
and ``torch.matmul`` refuses mixed dtypes, so the mixer promotes where
the reference does: the depthwise conv is a bf16 sum in index order,
its bias, the SiLU, the projections and the scan run in f32, and ``y``
returns to bf16 before the gate.

Tensor-parallel Mamba (``tp`` set by ``Model.shard_``, the reference's
specs): a rank runs d_inner / |model| channels.  It holds the columns of
``in_proj`` (its u and z channels together), ``conv_w`` and
``dt_proj`` and the rows of ``x_proj``, ``a_log`` and ``out_proj``; the
conv and the scan work channel by channel.  ``uc @ x_proj`` is then a
partial sum: it is all-reduced in f32, a (B, S, dt_rank + 2·d_state)
sum, before dt, B and C are read, and its gradient is all-reduced on the
way back (``copy_to_group``), since every channel reads B and C.  The
replicated ``conv_b``, ``dt_bias`` and ``d_skip`` are read through
``copy_to_group`` and sliced, so each arrives with its whole gradient on
every rank.  ``out_proj`` is row-parallel (``row_parallel``, f32).
Under ``fsdp_params`` each split weight is also split over 'data' and
gathered where it is used (``collectives.fsdp_weight``).  The state
caches are not split: a sharded model does not serve.

sLSTM: every call, prefill and decode alike, goes through
``kernels.slstm.slstm_scan`` — the hand-written kernel on a CUDA tensor,
its plain version (``_slstm_seq``'s loop) on a CPU tensor.  When the
pre-activation needs a gradient (training) it goes through
``kernels.slstm.SlstmScan`` instead: the same kernel with a stash of
every step's state, and the hand-written backward ``slstm_scan_bwd``.
The reference switches to an associative-scan form (``_slstm_parallel``)
for s > 8; that form is not ported, because on the card the kernel
takes its place and both compute the same stabilised recurrence.

Gradients at ties follow ``jax.grad`` of the reference: ``max(·, 1)`` is
``torch.maximum`` (half the gradient to each side at a tie, as
``jnp.maximum``), and the chunkwise mLSTM's running maximum is
:func:`_cummax`, ``lax.cummax``'s parallel prefix, whose gradient
splits at ties as jax's does.

mLSTM has no TPU kernel: the per-step recurrence (``_mlstm_seq``) and
the chunkwise-parallel form (``_mlstm_chunkwise``, each chunk's output
tagged as the reference's) are plain PyTorch, chosen by the reference's
rule (chunkwise iff s % 128 == 0 and s > 128).

Tensor-parallel (``tp`` set by ``Model.shard_``), a rank holds the
columns of ``wq`` / ``wk`` / ``wv`` / ``wif`` / ``wo_gate`` of its
n_heads / |model| whole heads (mLSTM) or the columns of ``wx`` of its
d / |model| channel quads (sLSTM), and the matching rows of ``wo``: the
recurrences work head by head and channel by channel, so each rank runs
them (the sLSTM kernels included) on its own heads or channels, with
the head and channel counts read off its weights.  The mixer enters
through ``copy_to_group`` and its output projection's partial sums are
all-reduced in f32, as attention's are.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from ..distributed.collectives import (copy_to_group, fsdp_weight,
                                       reduce_from_group, row_parallel)
from ..kernels.slstm import SlstmScan, _slstm_scan_plain, slstm_scan
from .common import ArchConfig, BlockSpec, dense_init, scan_out

State = Dict[str, torch.Tensor]


def _register(module: nn.Module, params: Dict[str, torch.Tensor]) -> None:
    for name, w in params.items():
        setattr(module, name, nn.Parameter(w))


# ===========================================================================
# Mamba (S6)
# ===========================================================================
def mamba_params(cfg: ArchConfig, gen: torch.Generator,
                 device: torch.device) -> Dict[str, torch.Tensor]:
    """bf16 projections; ``conv_b``, ``dt_bias``, ``a_log`` and
    ``d_skip`` f32, as the reference keeps them."""
    d = cfg.d_model
    di = cfg.mamba_expand * d
    ds, dc = cfg.mamba_d_state, cfg.mamba_d_conv
    dt_rank = max(d // 16, 1)
    f32 = torch.float32
    a = torch.arange(1, ds + 1, dtype=f32, device=device)
    return {
        "in_proj": dense_init((d, 2 * di), gen, device),
        "conv_w": dense_init((dc, di), gen, device),
        "conv_b": torch.zeros(di, dtype=f32, device=device),
        "x_proj": dense_init((di, dt_rank + 2 * ds), gen, device),
        "dt_proj": dense_init((dt_rank, di), gen, device),
        "dt_bias": torch.zeros(di, dtype=f32, device=device),
        "a_log": torch.log(a).expand(di, ds).clone(),
        "d_skip": torch.ones(di, dtype=f32, device=device),
        "out_proj": dense_init((di, d), gen, device),
    }


def mamba_state_init(cfg: ArchConfig, batch: int,
                     device: torch.device) -> State:
    di = cfg.mamba_expand * cfg.d_model
    return {"conv": torch.zeros((batch, cfg.mamba_d_conv - 1, di),
                                dtype=torch.bfloat16, device=device),
            "ssm": torch.zeros((batch, di, cfg.mamba_d_state),
                               dtype=torch.float32, device=device)}


def _selective_scan_seq(u, dt, A, B, C, D, h0
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sequential scan (decode, and the oracle of the chunked one).
    u, dt (B, S, di); A (di, ds); B, C (B, S, ds); D (di,); h0
    (B, di, ds); all f32."""
    dA = torch.exp(dt[..., None] * A)                       # (B,S,di,ds)
    dBu = dt[..., None] * B[:, :, None, :] * u[..., None]   # (B,S,di,ds)
    h, ys = h0, []
    for t in range(u.shape[1]):
        h = dA[:, t] * h + dBu[:, t]
        ys.append(torch.einsum("bds,bs->bd", h, C[:, t]))
    return torch.stack(ys, dim=1) + u * D, h


SSM_CHUNK = 64


def _associative_scan(combine, elems: List[torch.Tensor]
                      ) -> List[torch.Tensor]:
    """Inclusive scan of ``combine`` along dim 0, in
    ``lax.associative_scan``'s association order (its odd / even
    recursion), so that the rounding follows the reference's."""
    n = elems[0].shape[0]
    if n < 2:
        return elems
    odd = _associative_scan(combine, combine([e[0:n - 1:2] for e in elems],
                                             [e[1::2] for e in elems]))
    even = combine([e[:-1] for e in odd] if n % 2 == 0 else odd,
                   [e[2::2] for e in elems])
    out = []
    for e, ev, od in zip(elems, even, odd):
        ev = torch.cat([e[:1], ev])
        pairs = torch.stack([ev[:len(od)], od], dim=1).flatten(0, 1)
        out.append(torch.cat([pairs, ev[len(od):]]))
    return out


def _linear_combine(x, y):
    """Compose h ↦ a1·h + b1 then h ↦ a2·h + b2."""
    (a1, b1), (a2, b2) = x, y
    return [a1 * a2, b1 * a2 + b2]


def _selective_scan(u, dt, A, B, C, D, h0, chunk: int = SSM_CHUNK
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked selective scan: the state carried across chunks of L
    tokens, each chunk's recurrence an associative scan; the sequential
    scan unless s % L == 0 and s > L (the reference's rule)."""
    s = u.shape[1]
    if s % chunk or s <= chunk:
        return _selective_scan_seq(u, dt, A, B, C, D, h0)
    h, ys = h0, []
    for c0 in range(0, s, chunk):
        uc, dtc, Bc, Cc = (a[:, c0:c0 + chunk].movedim(1, 0)
                           for a in (u, dt, B, C))        # (L, B, ...)
        dA = torch.exp(dtc[..., None] * A)                  # (L,B,di,ds)
        dBu = dtc[..., None] * Bc[:, :, None, :] * uc[..., None]
        acc_a, acc_b = _associative_scan(_linear_combine, [dA, dBu])
        hs = acc_a * h + acc_b
        ys.append(scan_out(torch.einsum("lbds,lbs->lbd", hs, Cc)))
        h = hs[-1]
    return torch.cat(ys).movedim(0, 1) + u * D, h


def mamba_mixer(cfg: ArchConfig, p, x: torch.Tensor,
                state: Optional[State] = None
                ) -> Tuple[torch.Tensor, Optional[State]]:
    """Selective SSM (S6) over x (B, S, d) bf16; ``state`` carries the
    conv buffer and the ssm state across calls (decode).  ``p`` holds
    all d_inner channels, or a tensor-parallel rank's (``p.tp``): the
    columns of ``in_proj`` (its u and z of those channels, the
    ``sharding.Parts`` rule), ``conv_w`` and ``dt_proj``, the rows of
    ``x_proj``, ``a_log`` and ``out_proj``; it reads its slice of the
    replicated ``conv_b``, ``dt_bias`` and ``d_skip``."""
    tp = getattr(p, "tp", None)
    if tp is not None:
        x = copy_to_group(x, tp)
    b, s, d = x.shape
    ds, dc = cfg.mamba_d_state, cfg.mamba_d_conv
    dt_rank = max(d // 16, 1)
    xz = x @ fsdp_weight(p, "in_proj")
    di = xz.shape[-1] // 2                  # this rank's channels
    u, z = xz[..., :di], xz[..., di:]
    conv_b, dt_bias, d_skip = (_channels(getattr(p, n), di, tp)
                               for n in ("conv_b", "dt_bias", "d_skip"))
    # causal depthwise conv, carrying the (dc-1)-token buffer
    head = state["conv"].to(u.dtype) if state is not None \
        else u.new_zeros((b, dc - 1, di))
    upad = torch.cat([head, u], dim=1)
    new_conv = upad[:, -(dc - 1):]
    conv_w = fsdp_weight(p, "conv_w")
    uc = upad[:, :s] * conv_w[0]                   # bf16, in index order
    for i in range(1, dc):
        uc = uc + upad[:, i:i + s] * conv_w[i]
    uc = torch.nn.functional.silu(uc.float() + conv_b)           # f32
    proj = uc @ fsdp_weight(p, "x_proj").float()
    if tp is not None:
        # a partial sum over this rank's channels: summed in f32, and
        # dt, B and C of every channel read it, so its gradient is
        # summed over the ranks on the way back
        proj = copy_to_group(reduce_from_group(proj, tp), tp)
    dt = torch.nn.functional.softplus(
        proj[..., :dt_rank] @ fsdp_weight(p, "dt_proj").float() + dt_bias)
    Bm = proj[..., dt_rank:dt_rank + ds]
    Cm = proj[..., dt_rank + ds:]
    A = -torch.exp(fsdp_weight(p, "a_log"))
    h0 = state["ssm"] if state is not None \
        else torch.zeros((b, di, ds), dtype=torch.float32, device=x.device)
    y, h_last = _selective_scan(uc, dt, A, Bm, Cm, d_skip, h0)
    out = row_parallel(y.to(x.dtype) * torch.nn.functional.silu(z),
                       fsdp_weight(p, "out_proj"), tp)
    return out, (None if state is None else
                 {"conv": new_conv.to(torch.bfloat16), "ssm": h_last})


def _channels(w: torch.Tensor, n: int, tp) -> torch.Tensor:
    """A replicated per-channel vector's slice of this rank's ``n``
    channels (all of it off a mesh), through ``copy_to_group``: each
    rank's gradient is 0 off its slice, and the backward's all-reduce
    makes it the whole gradient on every rank."""
    if tp is None:
        return w
    return copy_to_group(w, tp)[tp.index * n:(tp.index + 1) * n]


# ===========================================================================
# mLSTM (xLSTM matrix memory)
# ===========================================================================
def mlstm_params(cfg: ArchConfig, gen: torch.Generator,
                 device: torch.device) -> Dict[str, torch.Tensor]:
    d, h = cfg.d_model, cfg.n_heads
    return {name: dense_init(shape, gen, device) for name, shape in (
        ("wq", (d, d)), ("wk", (d, d)), ("wv", (d, d)),
        ("wif", (d, 2 * h)),                 # input + forget gate logits
        ("wo_gate", (d, d)), ("wo", (d, d)))}


def mlstm_state_init(cfg: ArchConfig, batch: int, device: torch.device,
                     heads: Optional[int] = None) -> State:
    """The zero state of ``heads`` heads (default all of them: fewer on
    a tensor-parallel rank)."""
    hd = cfg.d_model // cfg.n_heads
    h = cfg.n_heads if heads is None else heads
    f32 = torch.float32
    return {"C": torch.zeros((batch, h, hd, hd), dtype=f32, device=device),
            "n": torch.zeros((batch, h, hd), dtype=f32, device=device),
            "m": torch.full((batch, h), -1e30, dtype=f32, device=device)}


MLSTM_CHUNK = 128


def _mlstm_seq(q, k, v, ig, fg, st: State) -> Tuple[torch.Tensor, State]:
    """Per-step stabilised recurrence (decode, and prefill at buckets
    the chunkwise form does not take).  q/k/v (B,S,H,hd), ig/fg (B,S,H)
    log-space gates, all f32."""
    C, n, m = st["C"], st["n"], st["m"]
    one = q.new_ones(())
    ys = []
    for t in range(q.shape[1]):
        qt, kt, vt, it, ft = q[:, t], k[:, t], v[:, t], ig[:, t], fg[:, t]
        m_new = torch.maximum(ft + m, it)                   # stabilizer
        i_ = torch.exp(it - m_new)
        f_ = torch.exp(ft + m - m_new)
        C = f_[..., None, None] * C + i_[..., None, None] \
            * (vt[..., :, None] * kt[..., None, :])
        n = f_[..., None] * n + i_[..., None] * kt
        num = (C @ qt[..., None])[..., 0]
        den = torch.maximum((n * qt).sum(-1).abs(), one)
        ys.append(num / den[..., None])
        m = m_new
    return torch.stack(ys, dim=1), {"C": C, "n": n, "m": m}


def _cummax(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The running maximum of ``x`` along ``dim`` as ``lax.cummax``
    differentiates it: ``lax.associative_scan``'s odd / even parallel
    prefix of ``maximum``.  The values are ``torch.cummax``'s; the
    gradient at equal values is jax's, split in halves down the prefix
    tree (``torch.cummax`` gives all of it to the last of them)."""
    x = x.movedim(dim, 0)

    def scan(e: torch.Tensor) -> torch.Tensor:
        n = e.shape[0]
        if n < 2:
            return e
        odd = scan(torch.maximum(e[0:n - 1:2], e[1::2]))
        even = torch.maximum(odd[:-1] if n % 2 == 0 else odd, e[2::2])
        even = torch.cat([e[:1], even])
        pairs = torch.stack([even[:len(odd)], odd], dim=1).flatten(0, 1)
        return torch.cat([pairs, even[len(odd):]])
    return scan(x).movedim(0, dim)


def _mlstm_chunkwise(q, k, v, ig, fg, st: State,
                     chunk: int = MLSTM_CHUNK) -> Tuple[torch.Tensor, State]:
    """Chunkwise-parallel mLSTM: the same stabilised recurrence (the
    same m_t) unrolled over chunks of L tokens,

        m_j = b_j + w_j,  b_j = Σ_{l≤j} f_l,
        w_j = max(m₀, cummax_{l≤j}(i_l − b_l)),

    an (L, L)-masked matmul chain per chunk plus one state update per
    chunk.  ``max(m₀, ·)`` keeps m₀ = −1e30 finite, so e^{m₀−w}
    underflows to 0.  The causal mask selects (``where``) instead of
    multiplying, so an overflowing e^{a_l−w_j} above the diagonal
    cannot turn into inf·0."""
    b, s, h, hd = q.shape
    C0, n0, m0 = st["C"], st["n"], st["m"]
    tri = torch.ones((chunk, chunk), dtype=torch.bool,
                     device=q.device).tril()[None, :, :, None]
    one = q.new_ones(())
    ys = []
    for j0 in range(0, s, chunk):
        sl = slice(j0, j0 + chunk)
        qt, kt, vt, it, ft = q[:, sl], k[:, sl], v[:, sl], ig[:, sl], \
            fg[:, sl]
        bcum = torch.cumsum(ft, dim=1)                        # (B,L,H)
        a_l = it - bcum                                       # i_l − b_l
        w = torch.maximum(m0[:, None], _cummax(a_l, dim=1))
        m_j = bcum + w
        D = torch.where(tri, torch.exp(a_l[:, None] - w[:, :, None]),
                        torch.zeros((), device=q.device))     # (B,j,l,H)
        S = torch.einsum("bjhd,blhd->bjlh", qt, kt) * D
        carry_scale = torch.exp(m0[:, None] - w)              # (B,L,H)
        num = torch.einsum("bjlh,blhd->bjhd", S, vt) \
            + carry_scale[..., None] \
            * torch.einsum("bjhe,bhde->bjhd", qt, C0)
        nq_j = S.sum(dim=2) \
            + carry_scale * torch.einsum("bjhe,bhe->bjh", qt, n0)
        ys.append(scan_out(num / torch.maximum(nq_j.abs(), one)[..., None]))
        scale_l = torch.exp(a_l - w[:, -1:])                  # (B,L,H)
        end_scale = torch.exp(m0 - w[:, -1])                  # (B,H)
        C0 = end_scale[..., None, None] * C0 + torch.einsum(
            "blhd,blhe->bhde", vt * scale_l[..., None], kt)
        n0 = end_scale[..., None] * n0 + (kt * scale_l[..., None]).sum(1)
        m0 = m_j[:, -1]
    return torch.cat(ys, dim=1), {"C": C0, "n": n0, "m": m0}


def mlstm_mixer(cfg: ArchConfig, p, x: torch.Tensor,
                state: Optional[State] = None
                ) -> Tuple[torch.Tensor, Optional[State]]:
    """Exponential-gated matrix-memory LSTM (xLSTM eq. 19–27),
    stabilised.  ``p`` holds wq, wk, wv, wif, wo_gate, wo (bf16): all
    heads, or a tensor-parallel rank's (``p.tp``)."""
    tp = getattr(p, "tp", None)
    if tp is not None:
        x = copy_to_group(x, tp)
    b, s, d = x.shape
    hd = d // cfg.n_heads
    h = p.wq.shape[1] // hd                 # this rank's heads
    q = (x @ p.wq).reshape(b, s, h, hd).float() * hd ** -0.5
    k = (x @ p.wk).reshape(b, s, h, hd).float() * hd ** -0.5
    v = (x @ p.wv).reshape(b, s, h, hd).float()
    gif = (x @ p.wif).reshape(b, s, h, 2).float()
    ig, fg = gif[..., 0], gif[..., 1]                    # log-space gates
    st = state if state is not None \
        else mlstm_state_init(cfg, b, x.device, heads=h)
    if s % MLSTM_CHUNK == 0 and s > MLSTM_CHUNK:
        ys, new_st = _mlstm_chunkwise(q, k, v, ig, fg, st)
    else:
        ys, new_st = _mlstm_seq(q, k, v, ig, fg, st)
    y = ys.reshape(b, s, h * hd).to(x.dtype)
    og = torch.sigmoid(x @ p.wo_gate)
    out = row_parallel(y * og, p.wo, tp)
    return out, (None if state is None else new_st)


# ===========================================================================
# sLSTM (xLSTM scalar memory)
# ===========================================================================
def slstm_params(cfg: ArchConfig, gen: torch.Generator,
                 device: torch.device) -> Dict[str, torch.Tensor]:
    d = cfg.d_model
    return {"wx": dense_init((d, 4 * d), gen, device),  # z, i, f, o
            "wo": dense_init((d, d), gen, device)}


def slstm_state_init(cfg: ArchConfig, batch: int, device: torch.device,
                     channels: Optional[int] = None) -> State:
    """The initial state of ``channels`` channels (default d_model:
    fewer on a tensor-parallel rank)."""
    d = cfg.d_model if channels is None else channels
    shape, f32 = (batch, d), torch.float32
    return {"c": torch.zeros(shape, dtype=f32, device=device),
            "n": torch.ones(shape, dtype=f32, device=device),
            "m": torch.zeros(shape, dtype=f32, device=device)}


def _slstm_seq(z, ig, fg, og, st: State) -> Tuple[torch.Tensor, State]:
    """Per-step recurrence with the reference's dict state: the
    kernel's plain version."""
    y, c, n, m = _slstm_scan_plain(z, ig, fg, og, st["c"], st["n"],
                                   st["m"])
    return y, {"c": c, "n": n, "m": m}


def slstm_mixer(cfg: ArchConfig, p, x: torch.Tensor,
                state: Optional[State] = None
                ) -> Tuple[torch.Tensor, Optional[State]]:
    """``p`` holds wx (d, 4d) and wo (d, d), bf16, or a tensor-parallel
    rank's (``p.tp``) columns of wx and rows of wo: its channels."""
    tp = getattr(p, "tp", None)
    if tp is not None:
        x = copy_to_group(x, tp)
    b, s, _ = x.shape
    d = p.wx.shape[1] // 4                  # this rank's channels
    # d-major gate layout, as the reference: (B,S,4d) -> (B,S,d,4), gate
    # g is channel stride 4 at offset g; the four strided bf16 views go
    # into the kernel as they are (it reads one quad a step and upcasts in
    # registers; on the CPU the wrapper upcasts the quads to f32)
    pre = (x @ p.wx).reshape(b, s, d, 4)
    st = state if state is not None \
        else slstm_state_init(cfg, b, x.device, channels=d)
    if torch.is_grad_enabled() and pre.requires_grad:
        ys, c, n, m = SlstmScan.apply(pre, st["c"], st["n"], st["m"])
    else:
        ys, c, n, m = slstm_scan(*pre.unbind(-1), st["c"], st["n"],
                                 st["m"])
    out = row_parallel(ys.to(x.dtype), p.wo, tp)
    return out, (None if state is None else {"c": c, "n": n, "m": m})


# ===========================================================================
# modules
# ===========================================================================
class _Recurrent(nn.Module):
    """A recurrent mixer as a module with the attention mixer's
    signature: ``forward(spec, x, positions, cache)``.  With a cache, the
    new state replaces the dict's entries in place and the same dict is
    returned (positions are not read).  Subclasses name their
    ``mixer`` and ``params`` functions."""

    def __init__(self, cfg: ArchConfig, gen: torch.Generator,
                 device: torch.device):
        super().__init__()
        self.cfg = cfg
        #: the 'model' axis group when the weights hold this rank's heads
        #: or channels (``Model.shard_``)
        self.tp = None
        _register(self, self.params(cfg, gen, device))

    def forward(self, spec: BlockSpec, x: torch.Tensor,
                positions: torch.Tensor, cache: Optional[State] = None
                ) -> Tuple[torch.Tensor, Optional[State]]:
        y, new = self.mixer(self.cfg, self, x, cache)
        if cache is not None:
            cache.update(new)
        return y, cache


class Mamba(_Recurrent):
    mixer = staticmethod(mamba_mixer)
    params = staticmethod(mamba_params)

    def __init__(self, cfg: ArchConfig, gen: torch.Generator,
                 device: torch.device):
        super().__init__(cfg, gen, device)
        #: the weights split over 'data' (``fsdp_params``): {name: (comm,
        #: dim)}, each gathered where it is used (``Model.shard_``)
        self.fsdp = {}


class MLSTM(_Recurrent):
    mixer = staticmethod(mlstm_mixer)
    params = staticmethod(mlstm_params)


class SLSTM(_Recurrent):
    mixer = staticmethod(slstm_mixer)
    params = staticmethod(slstm_params)
