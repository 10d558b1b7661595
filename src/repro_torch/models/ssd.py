"""Mamba2 / SSD (state-space duality) mixer: chunked dual form + decode
(twin of ``repro.models.ssd``).

The SSD algorithm (Dao & Gu 2024) splits the sequence into chunks:
within a chunk the recurrence is evaluated in its quadratic
"attention-like" dual form (matmuls); across chunks a [B, H, N, P] state
is carried by a sequential loop. That inter-chunk state carry is a long,
decaying accumulation, the numerical structure the paper's Kahan
technique targets, so the carry supports compensated accumulation
(``kahan_state``): a (sum, carry) pair, both scaled by the chunk's decay,
advanced by ``core.kahan.neumaier_step``. The compensated chain is eager
PyTorch, one rounding per op: nothing contracts its multiplies and adds
into FMAs, which would change what the carry measures.

The reference computes all of this in plain JAX (no Pallas kernel), and
so does the port, in torch ops: the three-operand einsums are written as
a scaling and one batched product each, so no [B, Q, N, H, P]
intermediate is formed. The products ``in_proj`` / ``out_proj`` go
through ``common.dense`` (bf16 operands, f32 accumulation; on the card
one tensor-core GEMM).

Layout: x [B, L, H, P] (P = head dim), B/C [B, L, N] (ngroups = 1),
dt [B, L, H], A [H] (negative), state [B, H, N, P]. Caches (one layer):
``ssm`` [B, H, N, P] f32 and ``conv`` [B, W-1, conv_dim] bf16, the
pre-conv inputs of the last W-1 positions.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.core import kahan
from repro_torch.ecm import step_cost
from repro_torch.models import common
from repro_torch.models.common import ParamSpec


class SSMConfig(NamedTuple):
    d_inner: int
    state_dim: int               # N
    head_dim: int = 64           # P
    conv_width: int = 4
    chunk: int = 256
    kahan_state: bool = False

    @property
    def num_heads(self) -> int:
        return self.d_inner // self.head_dim

    @property
    def conv_dim(self) -> int:
        return self.d_inner + 2 * self.state_dim


def mamba2_schema(d_model: int, cfg: SSMConfig) -> dict:
    di, n, h = cfg.d_inner, cfg.state_dim, cfg.num_heads
    in_dim = 2 * di + 2 * n + h          # z, x, B, C, dt
    return {
        "in_proj": ParamSpec((d_model, in_dim), ("embed", "mlp"), init="fan_in"),
        "conv_w": ParamSpec((cfg.conv_width, cfg.conv_dim), (None, "mlp"),
                            init="fan_in"),
        "conv_b": ParamSpec((cfg.conv_dim,), ("mlp",), init="zeros"),
        "A_log": ParamSpec((h,), (None,), init="zeros"),     # A = -exp(A_log)
        "D": ParamSpec((h,), (None,), init="ones"),
        "dt_bias": ParamSpec((h,), (None,), init="zeros"),
        "norm": ParamSpec((di,), ("mlp",), init="ones"),
        "out_proj": ParamSpec((di, d_model), ("mlp", "embed"), init="fan_in"),
    }


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(1 + e^x) as logaddexp(x, 0)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def causal_conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                  history: torch.Tensor | None = None) -> torch.Tensor:
    """Depthwise causal conv. x: [B, L, C]; w: [W, C].

    ``history`` ([B, W-1, C] pre-conv inputs of the preceding positions)
    replaces the zero left-padding, so chunked prefill continues the conv
    exactly across chunk boundaries."""
    width, length = w.shape[0], x.shape[1]
    if history is None:
        xp = F.pad(x, (0, 0, width - 1, 0))
    else:
        xp = torch.cat([history.to(x.dtype), x], dim=1)
    # laid out as x: a DTensor's global shape would make a plain,
    # replicated buffer on every rank
    out = torch.zeros_like(x, dtype=torch.float32)
    for i in range(width):          # width is 4: unrolled taps
        out = out + xp[:, i: i + length].to(torch.float32) \
            * w[i].to(torch.float32)
    return F.silu(out + b.to(torch.float32)).to(x.dtype)


def _ssd_chunk_scan(x: torch.Tensor, dt: torch.Tensor,
                    a_log_step: torch.Tensor, bmat: torch.Tensor,
                    cmat: torch.Tensor, chunk: int, kahan_state: bool,
                    initial_state: torch.Tensor | None = None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD. x: [B,L,H,P]; dt, a_log_step: [B,L,H]; bmat/cmat:
    [B,L,N]. Returns (y [B,L,H,P] in x's dtype, final_state [B,H,N,P]
    f32)."""
    b, l_orig, h, p = x.shape
    n = bmat.shape[-1]
    # pad to a chunk multiple with identity steps: a = 0 (decay 1), x = 0
    # and dt = 0 (no state contribution), exact for the carried state
    pad = (-l_orig) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt, a_log_step = F.pad(dt, (0, 0, 0, pad)), \
            F.pad(a_log_step, (0, 0, 0, pad))
        bmat, cmat = F.pad(bmat, (0, 0, 0, pad)), F.pad(cmat, (0, 0, 0, pad))
    nc = (l_orig + pad) // chunk
    f32 = torch.float32
    xc = x.reshape(b, nc, chunk, h, p).to(f32)
    dtc = dt.reshape(b, nc, chunk, h)
    ac = a_log_step.reshape(b, nc, chunk, h)
    bc = bmat.reshape(b, nc, chunk, n).to(f32)
    cc = cmat.reshape(b, nc, chunk, n).to(f32)

    s = (torch.zeros((b, h, n, p), dtype=f32, device=x.device)
         if initial_state is None else initial_state.to(f32))
    carry = torch.zeros_like(s) if kahan_state else None
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=x.device))[None, :, :, None]
    ys = []
    for k in step_cost.trips(nc):
        x_k, dt_k, a_k, b_k, c_k = xc[:, k], dtc[:, k], ac[:, k], bc[:, k], \
            cc[:, k]
        cum = torch.cumsum(a_k, dim=1)                  # [B,Q,H]
        # inter-chunk: y_i += C_i . (exp(cum_i) * S_prev)
        y_inter = torch.einsum("bqn,bhnp->bqhp", c_k, s) \
            * torch.exp(cum)[..., None]
        # intra-chunk dual form; mask BEFORE exp (for i < j the exponent
        # is positive and overflows)
        seg = cum[:, :, None, :] - cum[:, None, :, :]   # [B,Q,Q,H]
        lmat = torch.exp(torch.where(mask, seg, -1e30)) * mask
        scores = torch.einsum("bin,bjn->bij", c_k, b_k)  # [B,Q,Q]
        att = scores[..., None] * lmat * dt_k[:, None, :, :]
        y_intra = torch.einsum("bijh,bjhp->bihp", att, x_k)
        # S = exp(sum a) S_prev + sum_j exp(cum_last - cum_j) dt_j B_j x_j
        total = cum[:, -1, :]                           # [B,H]
        decay_state = torch.exp(total[:, None, :] - cum) * dt_k
        s_local = torch.einsum("bqn,bqhp->bhnp", b_k,
                               x_k * decay_state[..., None])
        chunk_decay = torch.exp(total)[:, :, None, None]
        if kahan_state:
            s, carry = kahan.neumaier_step(s * chunk_decay,
                                           carry * chunk_decay, s_local)
        else:
            s = s * chunk_decay + s_local
        ys.append(y_inter + y_intra)
    ys = step_cost.fill(ys, nc)
    y = torch.stack(ys, dim=1).reshape(b, nc * chunk, h, p)[:, :l_orig]
    final_state = s + carry if kahan_state else s
    return y.to(x.dtype), final_state


def _mixer_in(p: dict, hidden: torch.Tensor, cfg: SSMConfig):
    """in_proj, then split into z, the pre-conv xbc and dt."""
    zxbcdt = common.dense(hidden, p["in_proj"])
    return torch.split(zxbcdt, [cfg.d_inner, cfg.conv_dim, cfg.num_heads],
                       dim=-1)


def _mixer_scan(p: dict, z, xbc, dt, cfg: SSMConfig,
                initial_state=None):
    """Conv output -> SSD scan -> gated norm -> out_proj."""
    b, l, _ = xbc.shape
    di, n, h = cfg.d_inner, cfg.state_dim, cfg.num_heads
    x, bmat, cmat = torch.split(xbc, [di, n, n], dim=-1)
    x = x.reshape(b, l, h, cfg.head_dim)
    from repro_torch.distributed.sharding import per_shard, shard_act
    x = shard_act(x, "act_batch", "act_seq", "act_heads", None)
    dt = _softplus(dt.to(torch.float32) + p["dt_bias"])        # [B,L,H]
    a = -torch.exp(p["A_log"].to(torch.float32))               # [H]
    # per (sequence, head): a DTensor split over those alone scans on
    # each rank's local tensors (B and C are shared by the heads)
    heads, rows, state_map = {0: 0, 2: 2}, {0: 0}, {0: 0, 2: 1}
    y, state = per_shard(
        lambda x, dt, da, bm, cm, s0: _ssd_chunk_scan(
            x, dt, da, bm, cm, min(cfg.chunk, l), cfg.kahan_state,
            initial_state=s0),
        (x, dt, dt * a, bmat, cmat, initial_state),
        (heads, heads, heads, rows, rows, state_map), (heads, state_map))
    y = y + x.to(torch.float32).to(y.dtype) * p["D"].to(y.dtype)[:, None]
    y = y.reshape(b, l, di)
    y = common.rms_norm(y * F.silu(z.to(torch.float32)).to(y.dtype),
                        p["norm"])
    return common.dense(y, p["out_proj"]), state


def mamba2_forward(p: dict, hidden: torch.Tensor, cfg: SSMConfig, *,
                   return_state: bool = False):
    """Full-sequence Mamba2 mixer. hidden: [B, L, d_model]."""
    z, xbc, dt = _mixer_in(p, hidden, cfg)
    out, state = _mixer_scan(
        p, z, causal_conv1d(xbc, p["conv_w"], p["conv_b"]), dt, cfg)
    if return_state:
        return out, {"ssm": state, "conv": _conv_tail(hidden, p, cfg)}
    return out


def mamba2_prefill_chunk(p: dict, hidden: torch.Tensor, cfg: SSMConfig,
                         cache: dict) -> tuple[torch.Tensor, dict]:
    """Chunked prefill: continue the mixer from a decode cache.

    hidden: [B, C, d_model]; cache: {ssm [B,H,N,P], conv [B,W-1,conv_dim]}.
    The conv continues from the cached pre-conv window and the SSD scan
    from the cached state, so processing a prompt chunk by chunk is
    exact. Returns (out, new cache in the cache's dtypes)."""
    z, xbc_pre, dt = _mixer_in(p, hidden, cfg)
    xbc = causal_conv1d(xbc_pre, p["conv_w"], p["conv_b"],
                        history=cache["conv"])
    out, state = _mixer_scan(p, z, xbc, dt, cfg,
                             initial_state=cache["ssm"])
    window = torch.cat([cache["conv"].to(xbc_pre.dtype), xbc_pre], dim=1)
    return out, {"ssm": state.to(cache["ssm"].dtype),
                 "conv": window[:, -(cfg.conv_width - 1):]
                 .to(cache["conv"].dtype)}


def _conv_tail(hidden: torch.Tensor, p: dict,
               cfg: SSMConfig) -> torch.Tensor:
    """Last (conv_width - 1) pre-conv xbc inputs, for the decode cache."""
    _, xbc, _ = _mixer_in(p, hidden[:, -(cfg.conv_width - 1):], cfg)
    return xbc


def mamba2_decode(p: dict, hidden: torch.Tensor, cfg: SSMConfig,
                  cache: dict) -> torch.Tensor:
    """Single-token step. hidden: [B, 1, d]; cache: {ssm [B,H,N,P] f32,
    conv [B, W-1, conv_dim]}, updated IN PLACE (the port's cache
    convention): the state is scaled by its decay and takes the rank-1
    input in two in-place passes, so a full-width step moves the state
    twice and reads it once more for C, instead of forming new tensors."""
    b = hidden.shape[0]
    di, n, h, hp = cfg.d_inner, cfg.state_dim, cfg.num_heads, cfg.head_dim
    f32 = torch.float32
    z, xbc_new, dt = _mixer_in(p, hidden, cfg)
    # conv over (cached W-1 inputs ++ new input)
    window = torch.cat([cache["conv"], xbc_new.to(cache["conv"].dtype)],
                       dim=1)                                 # [B,W,conv]
    conv_out = (window.to(f32) * p["conv_w"].to(f32)).sum(dim=1) \
        + p["conv_b"]
    xbc = F.silu(conv_out)[:, None, :].to(hidden.dtype)       # [B,1,conv]
    x, bmat, cmat = torch.split(xbc, [di, n, n], dim=-1)
    x = x.reshape(b, h, hp).to(f32)                           # [B,H,P]
    bvec, cvec = bmat[:, 0].to(f32), cmat[:, 0].to(f32)       # [B,N]
    dt = _softplus(dt[:, 0].to(f32) + p["dt_bias"])           # [B,H]
    a = -torch.exp(p["A_log"].to(f32))
    state = cache["ssm"]
    if state.dtype != f32:
        raise ValueError(f"the ssm cache must be f32, got {state.dtype}")
    state.mul_(torch.exp(dt * a)[:, :, None, None])
    # += B_n (dt x)_p per (slot, head): a rank-1 batched update in place
    state.view(b * h, n, hp).baddbmm_(
        bvec[:, None, :].expand(b, h, n).reshape(b * h, n, 1),
        (x * dt[..., None]).reshape(b * h, 1, hp))
    y = torch.matmul(cvec[:, None, None, :], state)[:, :, 0]  # [B,H,P]
    y = y + x * p["D"][:, None]
    y = y.reshape(b, 1, di).to(hidden.dtype)
    y = common.rms_norm(y * F.silu(z.to(f32)).to(y.dtype), p["norm"])
    cache["conv"].copy_(window[:, 1:])
    return common.dense(y, p["out_proj"])


def mamba2_cache_spec(batch: int, cfg: SSMConfig,
                      dtype=torch.float32) -> dict:
    """{leaf: (shape, dtype)} of one layer's recurrent state."""
    return {
        "ssm": ((batch, cfg.num_heads, cfg.state_dim, cfg.head_dim), dtype),
        "conv": ((batch, cfg.conv_width - 1, cfg.conv_dim), torch.bfloat16),
    }
