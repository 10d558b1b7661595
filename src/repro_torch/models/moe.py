"""Mixture-of-Experts with capacity-based sort routing (twin of
``repro.models.moe``).

Tokens are sorted by expert id (stable: earlier tokens win capacity
ties), gathered into fixed-capacity ``[E, C, d]`` buckets, run through
one batched expert FFN, and folded back with their gates. Two places
differ in HOW the reference's arithmetic is carried out, not in what it
computes:

* **Expert products.** The reference multiplies bf16 operands with f32
  accumulation and rounds to bf16. The port does what ``common.dense``
  does: on the card one bf16 tensor-core product with an f32 result over
  the expert weights, which the load path holds as bf16 (the batched
  M-invariant kernel when serving, a differentiable ``bmm`` in
  training); on the CPU the
  operands widened to f32, experts a chunk at a time, so a full-width
  layer (a [160, 5120, 3072] ``w_gate_up``) never makes more than a
  ~1 GiB f32 copy of its weights per call.
* **Scatter back.** The reference's ``.at[st].add`` adds each token's k
  contributions in bf16, in sorted (expert-id) order, starting from zero.
  ``index_add_`` on a CUDA bf16 tensor uses atomics, whose order (and so
  rounding) changes from run to run; the port instead un-permutes the
  contributions into a [T, k] layout ordered by expert id and adds them
  left to right, which is that order on every device.

Laid out over a mesh (DTensor activations and weights), the dispatch
stays with the batch, as the reference's GSPMD layout keeps it: each
batch shard routes its own tokens against the one global capacity, its
tokens ranked after every lower shard's by an exclusive prefix of the
per-expert counts (an all-gather of [E] ints over the batch axes), so
earlier tokens win capacity ties across shards too and the slots and
drops are the single process's. Each rank fills only its own experts'
[E / model, C, d] buckets with its own tokens; every slot has one
writer, so summing the buckets over the batch axes (an all-reduce of a
``Partial`` DTensor) is exact. The combine goes one pair position j at a
time, in expert-id order (``_fold_split``): each rank picks the j-th
pair's row where its own experts hold it (zeros elsewhere) and sends it
to its token's shard, summed over the expert axis (one writer each:
exact) into that expert shard's part of the tokens, which scales the
rows by their gates and folds them on; the folded parts are gathered
over the expert axis. Where the down projection leaves d split over
batch axes (``w_down``'s FSDP split), a rank holds a slice of d of the
rows of every batch shard along those axes: it picks that slice for all
of their tokens (a plane of n d elements, n this shard's tokens) and an
all-to-all brings each token's slices together. No tensor holds a
token's k rows side by side, and no activation has more than this
shard's tokens on its token axis; the pair indices and ownership flags
([P n, k], P the batch shards along d's axes: the global token count on
the 16 x 16 mesh) are the only token-side tensors gathered.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.kernels import invariant_gemm
from repro_torch.models import common
from repro_torch.models.common import ParamSpec
from repro_torch.models.mlp import mlp_forward, mlp_schema


class MoEConfig(NamedTuple):
    num_experts: int
    top_k: int
    d_ff: int                    # per-expert hidden
    num_shared: int = 0          # always-active shared experts (DeepSeek-V2)
    capacity_factor: float = 1.25
    router_z_coef: float = 1e-3
    load_balance_coef: float = 1e-2


def moe_schema(d_model: int, cfg: MoEConfig) -> dict:
    e, ff = cfg.num_experts, cfg.d_ff
    s = {"router": ParamSpec((d_model, e), ("embed", None), init="fan_in"),
         "w_gate_up": ParamSpec((e, d_model, 2 * ff),
                               ("experts", "embed", "mlp"), init="fan_in"),
         "w_down": ParamSpec((e, ff, d_model),
                            ("experts", "mlp", "embed"), init="fan_in")}
    if cfg.num_shared:
        s["shared"] = mlp_schema(d_model, cfg.num_shared * ff)
    return s


def capacity(tokens: int, cfg: MoEConfig) -> int:
    c = math.ceil(tokens * cfg.top_k * cfg.capacity_factor / cfg.num_experts)
    return max(8, -(-c // 8) * 8)  # round up to a multiple of 8


def _top_k(probs: torch.Tensor, k: int):
    """``jax.lax.top_k``: the k largest per row, ties to the lower index
    (a stable descending sort)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def _expert_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """[E, C, d] x [E, d, f] -> [E, C, f] f32: bf16-rounded operands, f32
    products and sums, through ``invariant_gemm.product``: on the card
    the batched M-invariant kernel when autograd records nothing
    (serving), ``_Bf16BatchedProduct`` under autograd (training); on the
    CPU the operands widened to f32, a chunk of experts at a time. A
    DTensor product's partial sums are reduced in f32, as ``dense``
    does."""
    y = invariant_gemm.product(x, w)
    if type(y) is not torch.Tensor:
        from repro_torch.distributed.sharding import reduce_partial
        y = reduce_partial(y)
    return y


class _Shards:
    """Where the MoE layer's tokens and experts live: the mesh dims that
    split the token rows (the batch axes, ``bdims``) and those that split
    the experts (``edims``, from the expert weights). Plain tensors have
    none, and every method is then the identity."""

    def __init__(self, x: torch.Tensor, w: torch.Tensor, e: int):
        from torch.distributed.tensor import DTensor
        self.mesh = x.device_mesh if isinstance(x, DTensor) else None
        self.bdims, self.edims = [], []
        self.s, self.e_loc, self.e0 = 0, e, 0
        if self.mesh is None:
            return
        mesh = self.mesh
        self.bdims = [i for i, p in enumerate(x.placements)
                      if p.is_shard() and p.dim == 0]
        if isinstance(w, DTensor):
            self.edims = [i for i, p in enumerate(w.placements)
                          if p.is_shard() and p.dim == 0]
        if set(self.bdims) & set(self.edims):
            raise ValueError("the tokens and the experts split over the "
                             "same mesh dim")
        coord = mesh.get_coordinate()
        for i in self.bdims:            # the shard's index, mesh order
            self.s = self.s * mesh.size(i) + coord[i]
        r = 0
        for i in self.edims:
            r = r * mesh.size(i) + coord[i]
        self.e_loc = e // math.prod(mesh.size(i) for i in self.edims)
        self.e0 = r * self.e_loc

    def _pl(self, b=None, e=None) -> list:
        """Placements per mesh dim: ``b`` on the batch dims, ``e`` on the
        expert dims, ``Replicate()`` for None and on the rest."""
        from torch.distributed.tensor import Replicate
        return [(b if i in self.bdims else e if i in self.edims else None)
                or Replicate() for i in range(self.mesh.ndim)]

    def rows(self, x: torch.Tensor) -> torch.Tensor:
        """x with its rows split over the batch axes alone."""
        if self.mesh is None:
            return x
        from torch.distributed.tensor import Replicate, Shard
        return x.redistribute(self.mesh, self._pl(Shard(0), Replicate()))

    def local(self, x: torch.Tensor, *, partial_experts: bool = False
              ) -> torch.Tensor:
        """A DTensor's local rows, laid out by ``rows``.
        ``partial_experts``: each expert shard uses them for its own
        experts, so their gradient is a partial sum over the expert
        axis."""
        if self.mesh is None:
            return x
        from torch.distributed.tensor import Partial, Replicate, Shard
        grad = self._pl(Shard(0), Partial() if partial_experts
                        else Replicate())
        return self.rows(x).to_local(grad_placements=grad)

    def whole(self, local: torch.Tensor, shape: tuple) -> torch.Tensor:
        """Local rows back as the rows-laid DTensor of ``shape``."""
        if self.mesh is None:
            return local
        from torch.distributed.tensor import DTensor, Replicate, Shard
        return DTensor.from_local(local, self.mesh,
                                  self._pl(Shard(0), Replicate()),
                                  run_check=False, shape=torch.Size(shape),
                                  stride=_contiguous(shape))

    def replicated(self, t: torch.Tensor) -> torch.Tensor:
        if self.mesh is None:
            return t
        from torch.distributed.tensor import DTensor, Replicate
        return DTensor.from_local(t, self.mesh, [Replicate()] * self.mesh.ndim,
                                  run_check=False)

    def row_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum over the batch axes of each shard's ``t``."""
        if not self.bdims:
            return t
        from torch.distributed.tensor import DTensor, Partial, Replicate
        return DTensor.from_local(t, self.mesh, self._pl(Partial()),
                                  run_check=False).redistribute(
            self.mesh, [Replicate()] * self.mesh.ndim).to_local()

    def counts(self, counts: torch.Tensor):
        """(the tokens of the lower batch shards per expert, the global
        counts) from this shard's [E] counts."""
        if not self.bdims:
            return None, counts
        from torch.distributed.tensor import DTensor, Shard
        every = DTensor.from_local(counts[None], self.mesh,
                                   self._pl(Shard(0)),
                                   run_check=False).full_tensor()
        return every[:self.s].sum(0), every.sum(0)

    def buckets(self, xe: torch.Tensor, e: int) -> torch.Tensor:
        """This rank's [E / model, C, d] buckets, written with its own
        tokens only, summed over the batch axes: [E, C, d], experts split
        as the expert weights are."""
        if self.mesh is None:
            return xe
        from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
        shape = (e,) + tuple(xe.shape[1:])
        return DTensor.from_local(
            xe, self.mesh, self._pl(Partial(), Shard(0)), run_check=False,
            shape=torch.Size(shape), stride=_contiguous(shape)
        ).redistribute(self.mesh, self._pl(Replicate(), Shard(0)))

    def own_experts(self, ye: torch.Tensor) -> torch.Tensor:
        """This rank's experts' outputs [E / model, C, d]; each batch
        shard reads its own tokens' slots, so their gradient is a partial
        sum over the batch axes."""
        if self.mesh is None:
            return ye
        from torch.distributed.tensor import Partial, Replicate, Shard
        return ye.redistribute(self.mesh, self._pl(Replicate(), Shard(0))
                               ).to_local(grad_placements=self._pl(
                                   Partial(), Shard(0)))

    def expert_rows(self, ye: torch.Tensor) -> tuple:
        """(this rank's experts' outputs as [E / model * C, d / p], the
        mesh dims that split d into those p slices, the batch dims whose
        shards' tokens this rank picks rows for): d stays split over the
        batch axes where the expert product left it so (``w_down``'s
        FSDP split), whole elsewhere, and the rank picks rows for every
        shard along the batch dims from the first of those on (all of
        them after it in mesh order, so that the shards it serves are
        contiguous), for its own shard's alone along the others. There
        the rows' gradient is a partial sum over those others."""
        from torch.distributed.tensor import Partial, Replicate, Shard
        last = ye.ndim - 1
        ddims = [i for i in self.bdims if ye.placements[i] == Shard(last)]
        gdims = [i for i in self.bdims if ddims and i >= ddims[0]]
        pl = [Shard(last) if i in ddims else Shard(0) if i in self.edims
              else Replicate() for i in range(self.mesh.ndim)]
        local = ye.redistribute(self.mesh, pl).to_local(grad_placements=[
            Partial() if i in self.bdims and i not in gdims else p
            for i, p in enumerate(pl)])
        return local.reshape(-1, local.shape[-1]), ddims, gdims

    def batch_gather(self, x: torch.Tensor, dims: list) -> torch.Tensor:
        """The x [n, ...] (no gradient) of every batch shard that differs
        from this one on the mesh dims ``dims`` alone, stacked in shard
        order: [P_dims * n, ...]."""
        if not dims:
            return x
        from torch.distributed.tensor import DTensor, Replicate, Shard
        p = math.prod(self.mesh.size(i) for i in dims)
        shape = (p,) + tuple(x.shape)
        return DTensor.from_local(
            x[None], self.mesh, [Shard(0) if i in dims else Replicate()
                                 for i in range(self.mesh.ndim)],
            run_check=False, shape=torch.Size(shape),
            stride=_contiguous(shape)
        ).redistribute(self.mesh, [Replicate()] * self.mesh.ndim
                       ).to_local().reshape((-1,) + tuple(x.shape[1:]))

    def chunk(self, n: int) -> tuple[int, int]:
        """The rows [lo, hi) of this shard's n tokens that this expert
        shard folds: its part of n split over the expert axis (all n
        where it does not divide)."""
        m = math.prod(self.mesh.size(i) for i in self.edims)
        if n % m:
            return 0, n
        coord = self.mesh.get_coordinate()
        r = 0
        for i in self.edims:
            r = r * self.mesh.size(i) + coord[i]
        return r * (n // m), (r + 1) * (n // m)

    def to_owner(self, plane: torch.Tensor, gdims: list, ddims: list,
                 n: int, d: int, lo: int, hi: int) -> torch.Tensor:
        """A plane of rows [P_g * n, d / p] for the tokens of the batch
        shards of ``batch_gather(.., gdims)``, each row held by one expert
        shard (zeros on the others): summed over the expert axis (one
        writer a row: exact) into this expert shard's rows [lo, hi) of
        its own batch shard's tokens, with the d slices of ``ddims``
        brought together (an all-to-all over those axes, the rows going
        to their tokens' shard; a slice of the rest of ``gdims``).
        [hi - lo, d]."""
        from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
        p = math.prod(self.mesh.size(i) for i in self.bdims)
        shape = (p, n, d)
        src = [Shard(2) if i in ddims else Replicate() if i in gdims
               else Shard(0) if i in self.bdims
               else Partial() if i in self.edims else Replicate()
               for i in range(self.mesh.ndim)]
        return DTensor.from_local(
            plane.reshape(plane.shape[0] // n, n, -1), self.mesh, src,
            run_check=False, shape=torch.Size(shape),
            stride=_contiguous(shape)
        ).redistribute(self.mesh, self._pl(
            Shard(0), Replicate() if hi - lo == n else Shard(1))
        ).to_local().reshape(hi - lo, d)

    def rows_of(self, x: torch.Tensor, t: int, lo: int, hi: int
                ) -> torch.Tensor:
        """x [n, ...], the same on every expert shard, cut to this expert
        shard's rows [lo, hi); its gradient, which each expert shard has
        for its own rows alone, is gathered over the expert axis."""
        if hi - lo == x.shape[0]:
            return x
        from torch.distributed.tensor import DTensor, Replicate, Shard
        shape = (t,) + tuple(x.shape[1:])
        return DTensor.from_local(
            x, self.mesh, self._pl(Shard(0), Replicate()), run_check=False,
            shape=torch.Size(shape), stride=_contiguous(shape)
        ).redistribute(self.mesh, self._pl(Shard(0), Shard(0))).to_local()

    def expert_gather(self, y: torch.Tensor, n: int, t: int) -> torch.Tensor:
        """Each expert shard's folded rows (``chunk``) gathered over the
        expert axis: this batch shard's [n, d]."""
        if y.shape[0] == n:
            return y
        from torch.distributed.tensor import DTensor, Replicate, Shard
        return DTensor.from_local(
            y, self.mesh, self._pl(Shard(0), Shard(0)), run_check=False,
            shape=torch.Size((t, y.shape[1])), stride=(y.shape[1], 1)
        ).redistribute(self.mesh, self._pl(Shard(0), Replicate())
                       ).to_local()


def _fold_split(ye: torch.Tensor, src: torch.Tensor, own: torch.Tensor,
                gates: torch.Tensor, sh: _Shards, t: int) -> torch.Tensor:
    """The combine where the experts split over the mesh (ye the experts'
    [E, C, d] DTensor output; src, own, gates [n, k] this batch shard's
    pairs in expert-id order: slot, held by this expert shard, gate).
    Where d splits over batch axes (``expert_rows``: the ddims), each
    rank holds a slice of d of its experts' rows for the tokens of every
    batch shard along those axes, so it gathers their pairs' slots and
    flags (``batch_gather`` over the batch dims from the first ddim on,
    the gdims); elsewhere it reads its own tokens' rows whole. For each
    pair j it picks the rows its experts hold (zeros where another expert
    shard holds the row), a plane of n d elements where d splits over
    every gdim, and sends them to their tokens' shard, summed over the
    expert axis into this expert shard's chunk of the tokens, which
    scales them by their gates and folds them on, left to right; the
    folded chunks are gathered over the expert axis. The bits of the
    whole-rows fold; no [T / batch, k, d] tensor is made."""
    n, k = src.shape
    d = ye.shape[-1]
    lo, hi = sh.chunk(n)
    local, ddims, gdims = sh.expert_rows(ye)
    src_g, own_g = sh.batch_gather(src, gdims), sh.batch_gather(own, gdims)
    gates = sh.rows_of(gates, t, lo, hi)
    y = torch.zeros((hi - lo, d), dtype=ye.dtype, device=ye.device)
    for j in range(k):
        plane = local[src_g[:, j]] * own_g[:, j, None]
        row = sh.to_owner(plane, gdims, ddims, n, d, lo, hi)
        y = y + row * gates[:, j, None]
    return sh.expert_gather(y, n, t)


def _contiguous(shape: tuple) -> tuple:
    return tuple(math.prod(shape[i + 1:]) for i in range(len(shape)))


class Routing(NamedTuple):
    """One shard's routing of its T_loc tokens: ``top_e`` [T_loc, k], the
    assignments sorted by expert (``order``, expert ``se``, local token
    ``st``, renormalized gate ``sg``; [T_loc * k]), each one's global
    rank in its expert's queue, ``keep`` (rank < capacity), ``slot``
    (expert * C + rank, E * C when dropped) and the global per-expert
    ``counts`` [E]."""
    top_e: torch.Tensor
    order: torch.Tensor
    se: torch.Tensor
    st: torch.Tensor
    sg: torch.Tensor
    ranks: torch.Tensor
    keep: torch.Tensor
    slot: torch.Tensor
    counts: torch.Tensor


def _route(probs: torch.Tensor, cfg: MoEConfig, cap: int,
           sh: _Shards) -> Routing:
    """The reference's routing of probs [T_loc, E] (this shard's tokens):
    ranks within each expert in global token order, against the global
    capacity ``cap``."""
    e, k = cfg.num_experts, cfg.top_k
    top_p, top_e = _top_k(probs, k)                               # [T, k]
    top_p = top_p / torch.clamp_min(top_p.sum(-1, keepdim=True), 1e-9)
    flat_e = top_e.reshape(-1)                                    # [T*k]
    flat_gate = top_p.reshape(-1)
    order = torch.sort(flat_e, stable=True).indices
    se, st, sg = flat_e[order], order // k, flat_gate[order]
    # bincount's output length depends on the data; the expert ids are
    # below e, so the counts are these
    counts = torch.zeros(e, dtype=torch.int64, device=probs.device
                         ).scatter_add_(0, flat_e, torch.ones_like(flat_e))
    offsets = torch.cumsum(counts, 0) - counts
    ranks = torch.arange(flat_e.shape[0], device=probs.device) - offsets[se]
    before, counts = sh.counts(counts)
    if before is not None:
        ranks = ranks + before[se]
    keep = ranks < cap
    slot = torch.where(keep, se * cap + ranks,
                       torch.full_like(se, e * cap))              # drop -> sentinel
    return Routing(top_e, order, se, st, sg, ranks, keep, slot, counts)


def moe_forward(p: dict, x: torch.Tensor, cfg: MoEConfig
                ) -> tuple[torch.Tensor, dict]:
    """x [B, L, d] -> (y [B, L, d], aux losses dict)."""
    b, l, d = x.shape
    t = b * l
    e, k = cfg.num_experts, cfg.top_k
    cap = capacity(t, cfg)
    dev = x.device
    from repro_torch.distributed.sharding import shard_act
    sh = _Shards(x, p["w_gate_up"], e)
    xf = sh.rows(x).reshape(t, d)

    logits = sh.local(common.dense(xf, p["router"])).to(torch.float32)
    probs = torch.softmax(logits, dim=-1)                     # [T_loc, E]
    r = _route(probs, cfg, cap, sh)
    n = probs.shape[0]                                        # T_loc

    # ---- gather tokens into [E, C, d] buckets (this rank's experts) ------
    e_loc, e0 = sh.e_loc, sh.e0
    mine = r.keep if e_loc == e else \
        r.keep & (r.se >= e0) & (r.se < e0 + e_loc)
    slot = r.slot if e_loc == e else torch.where(
        mine, (r.se - e0) * cap + r.ranks, torch.full_like(r.se, e_loc * cap))
    slot_to_tok = torch.full((e_loc * cap + 1,), n, dtype=torch.int64,
                             device=dev)
    slot_to_tok[slot] = r.st
    slot_to_tok = slot_to_tok[:e_loc * cap]
    valid = slot_to_tok < n
    xl = sh.local(xf, partial_experts=True)
    xe = xl[torch.clamp(slot_to_tok, 0, n - 1)] * valid[:, None].to(xl.dtype)
    xe = shard_act(sh.buckets(xe.reshape(e_loc, cap, d), e),
                   "act_experts", None, None)

    # ---- batched expert FFN ----------------------------------------------
    gate, up = torch.chunk(_expert_matmul(xe, p["w_gate_up"]).to(xe.dtype),
                           2, dim=-1)
    ye = _expert_matmul(common.swiglu(gate, up), p["w_down"]).to(xe.dtype)

    # ---- weighted fold back to tokens, in sorted order --------------------
    # sorted position of each (token, expert) pair, then each token's k
    # pairs in expert-id order: the order the sorted scatter visits them
    pos = torch.empty_like(r.order)
    pos[r.order] = torch.arange(n * k, device=dev)
    pos = torch.sort(pos.reshape(n, k), dim=1).values
    src = torch.clamp(slot, 0, e_loc * cap - 1)[pos]             # [T, k]
    if e_loc != e:
        y = _fold_split(ye, src, mine[pos].to(ye.dtype),
                        (r.sg * r.keep).to(ye.dtype)[pos], sh, t)
    else:
        yflat = sh.own_experts(ye).reshape(e_loc * cap, d)
        rows = yflat[src]                                         # [T, k, d]
        per_tok = rows * (r.sg * r.keep).to(rows.dtype)[pos][..., None]
        y = torch.zeros((n, d), dtype=per_tok.dtype, device=dev)
        for j in range(k):
            y = y + per_tok[:, j]
    y = sh.whole(y, (t, d))

    if cfg.num_shared:
        y = y + mlp_forward(p["shared"], xf)

    # ---- aux losses --------------------------------------------------------
    lse2 = torch.square(torch.logsumexp(logits, dim=-1))
    if sh.bdims:
        me = sh.row_sum(probs.sum(dim=0)) / t                    # mean prob
        z_loss = sh.row_sum(lse2.sum()) / t
    else:
        me, z_loss = probs.mean(dim=0), torch.mean(lse2)
    fe = r.counts.to(torch.float32) / (t * k)                     # routed frac
    load_balance = e * torch.sum(me * fe)
    kept = torch.clamp_max(r.counts, cap).sum()
    dropped = 1.0 - kept.to(torch.float32) / (t * k)
    aux = {"moe_load_balance": cfg.load_balance_coef * load_balance,
           "moe_z_loss": cfg.router_z_coef * z_loss,
           "moe_drop_fraction": dropped}
    aux = {key: sh.replicated(v) for key, v in aux.items()}
    return y.reshape(b, l, d), aux
