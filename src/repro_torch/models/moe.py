"""The MLP blocks (port of :mod:`repro.models.moe`): the dense MLP
(SwiGLU / GeGLU, or the ungated ``gelu_mlp``) and the routed mixture of
experts (jamba, deepseek).

Dense MLP: tensor-parallel (``tp`` set by ``Model.shard_``), wi / wg
hold this rank's columns of d_ff and wo its rows, and the partial sums
are all-reduced in f32; under ``fsdp_params`` each is also split over
'data' and gathered where it is used.

MoE (:class:`MoE`): f32 router logits, softmax, top-k, the k gates
renormalised (their sum clipped at 1e-9), then the experts in one of the
reference's three ``impl=`` forms, ``"auto"`` taking ``gather`` for
T ≤ 256 tokens and ``capacity`` above:

  * ``gather``  — dropless.  The reference gathers each token's k
    expert slices as (T, k, d, f) tensors; at jamba's width and a
    256-token prefill that is 60 GB a weight.  The port computes the
    same function without the gather: the (token, slot) pairs sorted by
    expert (a stable sort, as ``jnp.argsort``), each active expert's
    three products on its rows (``_grouped_dropless``), no (T, k, d, f)
    tensor;
  * ``ragged``  — dropless, the reference's ``lax.ragged_dot`` oracle;
    the same grouped products as ``gather`` here;
  * ``capacity`` — each expert takes at most ``_capacity(T·k, E)`` of
    its sorted rows into its window; the rest of its pairs are dropped
    (contribute 0) by the reference's window index (``_window_index``,
    ``_capacity_gather``).

On the meta device (the dry run, ``launch/dryrun.py``) the routing has
no values: the groups are the sizes the reference's compiled program
multiplies (:func:`_meta_group_sizes`), with no host sync.

The k expert outputs are combined in their dtype (bf16 for the dropless
forms, f32 for ``capacity``, as the reference's), then cast to the
activation dtype.  Each pass reads the experts' row counts on the host
(one device sync a layer) to slice the groups.

Training.  The dropless forms run under autograd as they are: their
groups are concatenated out of place (:func:`_grouped`), so each
expert's products differentiate on their own rows.  The capacity form
is :class:`CapacityExperts`, the reference's ``_grouped_core`` with its
custom VJP: the forward keeps only its inputs (no (E, cap, d)
residual), the backward recomputes each expert's window inside its own
step and pulls back its three products.  Under the per-period remat
(``models.model``) the routing runs again in the recompute, and its
host-read sizes are the first pass's: the same deterministic ops
(softmax, ``topk``, a stable sort, ``bincount``) on the same input give
the same groups, so the recomputed tensors keep their shapes.  No
load-balancing loss is added: the reference's loss does not call its
``moe_aux_loss``.

On a mesh (``tp`` set by ``Model.shard_``) the MoE is tensor-parallel
over f, the reference's ``moe_apply`` under ``shard_map``: every rank
routes its (replicated) tokens alike and runs its f-slice of every
expert, ``wi`` / ``wg`` (E, d, f/P) and ``wo`` (E, f/P, d), in either
form (the capacity form's custom VJP as it is, on the slices), the
shared experts split the same way; the f32 partial output gets one
(T, d) all-reduce over 'model'.  x and the router enter through
``copy_to_group``, so that their partial gradients are summed.  The
host-read group sizes are then the same on every rank (the same ops on
the same replicated input).  Under ``fsdp_params`` the stacks are also
split over 'data' on d and gathered where they are used.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..distributed.collectives import (copy_to_group, fsdp_weight,
                                       reduce_from_group, row_parallel)
from .common import ArchConfig, MoECfg, dense_init


def act_fn(name: str):
    if name.startswith("gelu"):
        return lambda x: torch.nn.functional.gelu(x, approximate="tanh")
    return torch.nn.functional.silu


class MLP(nn.Module):
    """Gated MLP ``act(x·Wi) * (x·Wg) · Wo`` (SwiGLU / GeGLU), or with
    ``act="gelu_mlp"`` the ungated ``gelu(x·Wi) · Wo`` (granite,
    musicgen: no ``wg``); bf16 weights applied as ``x @ W``."""

    def __init__(self, cfg: ArchConfig, gen: torch.Generator,
                 device: torch.device, d_ff: Optional[int] = None):
        super().__init__()
        d, f = cfg.d_model, d_ff or cfg.d_ff
        self.act = act_fn(cfg.act)
        #: the 'model' axis group when wi / wg hold this rank's columns
        #: of f and wo its rows (``Model.shard_``)
        self.tp = None
        #: the weights split over 'data' (``fsdp_params``): {name: (comm,
        #: dim)}, each gathered where it is used (``Model.shard_``)
        self.fsdp = {}
        names = ("wi", "wo") if cfg.act == "gelu_mlp" else ("wi", "wg", "wo")
        for name in names:
            shape = (f, d) if name == "wo" else (d, f)
            setattr(self, name, nn.Parameter(
                dense_init(shape, gen, device)))
        if cfg.act == "gelu_mlp":
            self.wg = None

    def _hidden(self, x: torch.Tensor) -> torch.Tensor:
        h = self.act(x @ fsdp_weight(self, "wi"))
        if self.wg is not None:
            h = h * (x @ fsdp_weight(self, "wg"))
        return h

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.tp is not None:
            x = copy_to_group(x, self.tp)
        # tensor-parallel: partial sums over this rank's f
        return row_parallel(self._hidden(x), fsdp_weight(self, "wo"),
                            self.tp)

    def partial(self, x: torch.Tensor) -> torch.Tensor:
        """The f32 product of this rank's f columns and ``wo`` rows (the
        whole MLP off a mesh), not summed over the ranks: for a caller
        that sums it with its own partials in one all-reduce (the MoE's
        shared experts)."""
        return self._hidden(x).float() @ fsdp_weight(self, "wo").float()


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------
CAPACITY_FACTOR = 1.5     # slack over the mean tokens / expert
MIN_CAPACITY = 8
#: ``impl="auto"`` takes the dropless gather form up to this many tokens
GATHER_MAX_TOKENS = 256


def _capacity(t_k: int, n_experts: int,
              factor: Optional[float] = None) -> int:
    if factor is None:
        factor = CAPACITY_FACTOR          # module global: test-patchable
    cap = int(t_k * factor / n_experts) + 1
    return max((cap + 7) // 8 * 8, MIN_CAPACITY)


def _route(router: torch.Tensor, xf: torch.Tensor, k: int
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(gates (T, k) f32, experts (T, k)): top-k of the softmax of the
    f32 router logits, renormalised.  ``lax.top_k`` breaks ties toward
    the lower index and ``torch.topk`` does not promise to."""
    gates = torch.softmax(xf.float() @ router, dim=-1)        # (T, E)
    topg, tope = torch.topk(gates, k, dim=-1)
    topg = topg / torch.clamp(topg.sum(-1, keepdim=True), min=1e-9)
    return topg, tope


def _sort_by_expert(tope: torch.Tensor, n_experts: int):
    """The (token, slot) pairs grouped by expert: (order, inv,
    token_idx, group_sizes).  Sorted row r is pair ``order[r]`` (token
    ``token_idx[r]``); the sort is stable, so that each group keeps the
    pairs' order, as ``jnp.argsort`` does."""
    t, k = tope.shape
    flat_e = tope.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    inv = torch.argsort(order)
    token_idx = torch.div(torch.arange(t * k, device=tope.device), k,
                          rounding_mode="floor")[order]
    counts = flat_e.new_empty((n_experts,)) if flat_e.is_meta else \
        torch.bincount(flat_e, minlength=n_experts)
    return order, inv, token_idx, counts


def _window_index(offsets: torch.Tensor, n: int, e: int,
                  cap: int) -> torch.Tensor:
    """Sorted row r lives in expert e_r at slot r − off_e; slots ≥ cap
    are dropped (capacity overflow) and map to e·cap, past the end."""
    r = torch.arange(n, device=offsets.device)
    e_r = torch.searchsorted(offsets, r, right=True) - 1
    slot = r - offsets[e_r]
    return torch.where(slot < cap, e_r * cap + slot, e * cap)


def _expert_mm(act, blk, wi_e, wg_e, wo_e) -> torch.Tensor:
    return (act(blk @ wi_e) * (blk @ wg_e)) @ wo_e


def _grouped(xs: torch.Tensor, sizes, act, wi, wg, wo) -> torch.Tensor:
    """The dropless forms: each expert's three products on its rows of
    ``xs`` (sorted by expert, ``sizes`` rows an expert, every row in a
    group), concatenated in expert order, out of place."""
    outs, src = [], 0
    for e, n in enumerate(sizes):
        if n:
            outs.append(_expert_mm(act, xs[src:src + n], wi[e], wg[e],
                                   wo[e]))
        src += n
    return torch.cat(outs)


class CapacityExperts(torch.autograd.Function):
    """The capacity form's experts (the reference's ``_grouped_core``
    and its custom VJP): xs (N, d) sorted by expert, expert e's window
    the first ``min(size_e, cap)`` of its rows from ``offsets[e]``, out
    (E·cap + 1, d) f32 with row e·cap + slot holding the window's output
    and every other row 0 (the last one is where a dropped pair reads).

    The forward saves ``(xs, wi, wg, wo)`` and the host's offsets and
    sizes, no (E, cap, d) block.  The backward recomputes each window
    inside its own step and pulls ``dy`` (cast to the block's dtype, as
    the reference casts ``dy · valid``) back through the three products.
    Each expert's weight gradient is that one pull-back, in the block's
    dtype: the reference stacks it in f32 and casts the stack to the
    weights' dtype, which gives back the same words, so the port writes
    it in the weights' dtype at once (an f32 copy of the three (E, d, f)
    stacks would be 11 GB at jamba's width).  ``dxs`` takes each
    window's rows back where the forward read them (the reference's
    disjoint-window gather); a dropped row's is 0."""

    @staticmethod
    def forward(ctx, xs, wi, wg, wo, offsets, sizes, cap, act_name):
        e, d = wi.shape[0], xs.shape[1]
        act = act_fn(act_name)
        out = torch.zeros((e * cap + 1, d), dtype=torch.float32,
                          device=xs.device)
        for i, (o, n) in enumerate(zip(offsets, sizes)):
            n = min(n, cap)
            if n:
                out[i * cap:i * cap + n] = _expert_mm(
                    act, xs[o:o + n], wi[i], wg[i], wo[i]).float()
        ctx.save_for_backward(xs, wi, wg, wo)
        ctx.groups, ctx.cap, ctx.act_name = (offsets, sizes), cap, act_name
        return out

    @staticmethod
    def backward(ctx, dout):
        xs, wi, wg, wo = ctx.saved_tensors
        (offsets, sizes), cap = ctx.groups, ctx.cap
        act = act_fn(ctx.act_name)
        dxs = torch.zeros_like(xs)
        dws = [torch.zeros_like(w) for w in (wi, wg, wo)]
        for i, (o, n) in enumerate(zip(offsets, sizes)):
            n = min(n, cap)
            if not n:
                continue
            with torch.enable_grad():
                ins = [t.detach().requires_grad_() for t in
                       (xs[o:o + n], wi[i], wg[i], wo[i])]
                y = _expert_mm(act, *ins)
                grads = torch.autograd.grad(
                    y, ins, dout[i * cap:i * cap + n].to(y.dtype))
            dxs[o:o + n] = grads[0]
            for dw, g in zip(dws, grads[1:]):
                dw[i] = g
        return (dxs, *dws, None, None, None, None)


def _capacity_gather(ys_flat: torch.Tensor, idx: torch.Tensor,
                     inv: torch.Tensor) -> torch.Tensor:
    """Unsort ∘ capacity-reconstruct in one gather: a dropped pair's
    index, e·cap, reads the zero row past the windows."""
    return ys_flat[idx[inv]]


def _meta_group_sizes(xs: torch.Tensor, t_k: int, e: int, cap: int,
                      dropless: bool):
    """(sizes, xs) on the meta device, where the routing has no values
    to count: a shape function, not a fallback.  The sizes are the
    groups the reference's compiled program multiplies: the capacity
    form every window full at ``cap`` rows (``xs`` then the (E·cap, d)
    windows), the dropless forms T·k rows in all, split evenly (their
    products' flops do not depend on the split)."""
    if not dropless:
        # padded to the windows, so that a backward reaches xs
        return [cap] * e, torch.nn.functional.pad(
            xs, (0, 0, 0, e * cap - t_k))
    q, r = divmod(t_k, e)
    return [q + (i < r) for i in range(e)], xs


def moe_local(cfg: ArchConfig, p, xf: torch.Tensor,
              impl: str = "auto") -> torch.Tensor:
    """xf (T, d) -> (T, d): route, run the experts, combine.  With
    ``p.tp`` the experts (and shared experts) are this rank's f columns
    of each, and the f32 partial output is summed over the ranks once."""
    mo: MoECfg = cfg.moe
    t, d = xf.shape
    k, e = mo.top_k, mo.n_experts
    if impl not in ("auto", "gather", "ragged", "capacity"):
        raise ValueError(f"impl must be auto/gather/ragged/capacity: "
                         f"{impl!r}")
    tp = getattr(p, "tp", None)
    router = p.router
    if tp is not None:
        # every rank routes the same x alike; the gradients of x and the
        # router (through dgates = dout·y, y this rank's f slice) are
        # partial sums, all-reduced on the way back
        xf, router = copy_to_group(xf, tp), copy_to_group(router, tp)
    topg, tope = _route(router, xf, k)
    act = act_fn(cfg.act)
    _, inv, token_idx, group_sizes = _sort_by_expert(tope, e)
    xs = xf[token_idx]                                      # (T·k, d)
    dropless = impl in ("gather", "ragged") or (impl == "auto"
                                                and t <= GATHER_MAX_TOKENS)
    cap = _capacity(t * k, e)
    if xf.is_meta:
        sizes, xs = _meta_group_sizes(xs, t * k, e, cap, dropless)
    else:
        sizes = group_sizes.tolist()                        # a host sync
    offsets = [sum(sizes[:i]) for i in range(e)]
    wi, wg, wo = (fsdp_weight(p, n) for n in ("wi", "wg", "wo"))
    if dropless:
        y = _grouped(xs, sizes, act, wi, wg, wo)[inv].reshape(t, k, d)
    else:                                                   # capacity
        idx = _window_index(torch.tensor(offsets, device=xf.device), t * k,
                            e, cap)
        windows = CapacityExperts.apply(xs, wi, wg, wo, offsets, sizes,
                                        cap, cfg.act)
        y = _capacity_gather(windows, idx, inv).reshape(t, k, d)
    if tp is None:
        out = torch.einsum("tkd,tk->td", y, topg.to(y.dtype)).to(xf.dtype)
        if mo.n_shared:
            out = out + p.shared(xf)
        return out
    # each rank's y is a partial sum over its f slice: combined with the
    # gates and the shared experts' partial in f32 and summed over the
    # ranks once, in f32, as the attention and MLP exits are
    # (``row_parallel``): a bf16 sum would round every rank's partial
    # before the sum (the reference psums in the activation dtype)
    out = torch.einsum("tkd,tk->td", y.float(), topg)
    if mo.n_shared:
        out = out + p.shared.partial(xf)
    return reduce_from_group(out, tp).to(xf.dtype)


class MoE(nn.Module):
    """Routed experts: ``router`` (d, E) f32, ``wi`` / ``wg`` (E, d, f),
    ``wo`` (E, f, d) bf16, and ``shared`` (an :class:`MLP` of
    n_shared·f) where the config has shared experts."""

    def __init__(self, cfg: ArchConfig, gen: torch.Generator,
                 device: torch.device):
        super().__init__()
        mo: MoECfg = cfg.moe
        d, f, e = cfg.d_model, mo.d_ff_expert, mo.n_experts
        self.cfg = cfg
        #: the 'model' axis group when wi / wg hold this rank's f
        #: columns of every expert and wo its rows (``Model.shard_``)
        self.tp = None
        #: the stacks split over 'data' (``fsdp_params``): {name: (comm,
        #: dim)}, each gathered where it is used (``Model.shard_``)
        self.fsdp = {}
        self.router = nn.Parameter(
            dense_init((d, e), gen, device).float())
        for name, shape in (("wi", (e, d, f)), ("wg", (e, d, f)),
                            ("wo", (e, f, d))):
            setattr(self, name, nn.Parameter(
                dense_init(shape, gen, device)))
        if mo.n_shared:
            self.shared = MLP(cfg, gen, device,
                              d_ff=mo.d_ff_expert * mo.n_shared)

    def forward(self, x: torch.Tensor, impl: str = "auto") -> torch.Tensor:
        """x (B, S, d) -> (B, S, d)."""
        b, s, d = x.shape
        return moe_local(self.cfg, self, x.reshape(b * s, d),
                         impl).reshape(b, s, d)


def moe_aux_loss(cfg: ArchConfig, p, x: torch.Tensor) -> torch.Tensor:
    """Load-balancing auxiliary loss (Switch-style): E·Σ_e f_e·P_e."""
    mo = cfg.moe
    t = x.shape[0] * x.shape[1]
    gates = torch.softmax(x.reshape(t, -1).float() @ p.router, dim=-1)
    _, tope = torch.topk(gates, mo.top_k, dim=-1)
    frac = torch.bincount(tope.reshape(-1), minlength=mo.n_experts) \
        / (t * mo.top_k)
    return mo.n_experts * torch.sum(frac * gates.mean(0))
