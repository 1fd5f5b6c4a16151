"""Mamba-2 (SSD, state-space duality) block, arXiv:2405.21060 (port of
``repro.models.ssm``).

Chunked SSD algorithm: an intra-chunk quadratic (attention-like) term
plus an inter-chunk linear state recurrence, here a Python loop over the
chunks (JAX scans them); decode is an O(1) per-token state update.  The
projections route through ``core.linear`` so SlideSparse covers them; the
scan itself is plain torch, as the JAX package keeps it outside Pallas.
Under tensor parallelism the SSD heads shard over the ranks
(``SSMSpec.shards``): d_inner and the heads are the local shard's, the
gated norm over d_inner all-reduces its sum of squares (``tp.rmsnorm``)
and ``wo`` is row-parallel; the input enters through ``tp.enter``, and
the replicated wB / wC, whose outputs feed this rank's heads only, sum
their weight gradients over the ranks (``tp.replicated``).
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.core import linear as sl
from repro_torch.core.linear import SparsityConfig
from repro_torch.sharding import tp


@dataclasses.dataclass(frozen=True)
class SSMSpec:
    d_model: int
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk: int = 256
    # tensor-parallel ranks the heads shard over: the spec then describes
    # the local shard (``transformer.ssm_spec`` fills it from the context)
    shards: int = 1

    @property
    def d_inner(self):
        return self.expand * self.d_model // self.shards

    @property
    def num_heads(self):
        return self.d_inner // self.head_dim


def init(gen: torch.Generator, spec: SSMSpec, dtype=torch.float32):
    """JAX's initialisation: per-head log-spaced A in [1, 16] and dt in
    [1e-3, 0.1], and ``wo`` zero, so a freshly initialised block is the
    identity on the residual stream (a random-weight model must draw
    ``wo`` itself to exercise the block)."""
    h, dev = spec.num_heads, gen.device
    a0 = torch.exp(torch.linspace(math.log(1.0), math.log(16.0), h,
                                  dtype=torch.float32, device=dev))
    dt0 = torch.exp(torch.linspace(math.log(1e-3), math.log(0.1), h,
                                   dtype=torch.float32, device=dev))
    return {
        "wx": sl.init(gen, spec.d_model, spec.d_inner, dtype),
        "wz": sl.init(gen, spec.d_model, spec.d_inner, dtype),
        "wB": sl.init(gen, spec.d_model, spec.d_state, dtype),
        "wC": sl.init(gen, spec.d_model, spec.d_state, dtype),
        "wdt": sl.init(gen, spec.d_model, spec.num_heads, dtype),
        "wo": {"w": torch.zeros((spec.d_model, spec.d_inner), dtype=dtype,
                                device=dev)},
        "conv_w": (torch.randn((spec.d_conv, spec.d_inner), generator=gen,
                               dtype=torch.float32, device=dev)
                   * 0.1).to(dtype),
        "A_log": torch.log(a0),
        "dt_bias": torch.log(torch.expm1(dt0)),  # softplus^-1(dt0)
        "D": torch.ones((h,), dtype=torch.float32, device=dev),
        "norm": {"g": torch.ones((spec.d_inner,), dtype=torch.float32,
                                 device=dev)},
    }


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """L[..., i, j] = sum_{j < k <= i} x[..., k]; -inf above the diagonal."""
    cs = torch.cumsum(x, -1)
    d = cs[..., :, None] - cs[..., None, :]
    ll = x.shape[-1]
    mask = torch.tril(torch.ones((ll, ll), dtype=torch.bool, device=x.device))
    return torch.where(mask, d, -math.inf)


def _causal_conv(x, w, state=None, valid_len=None):
    """Depthwise causal conv. x: [B, S, C]; w: [K, C].
    state: [B, K-1, C] trailing context (decode / chunked prefill) or None.
    valid_len: [B] count of real (non-pad) tokens, a device tensor: the
    carried state is the window ending at the last real token."""
    k, s = w.shape[0], x.shape[1]
    if state is None:
        xp = F.pad(x, (0, 0, k - 1, 0))
    else:
        xp = torch.cat([state.to(x.dtype), x], dim=1)
    out = xp[:, 0:s] * w[0]
    for i in range(1, k):
        out = out + xp[:, i:i + s] * w[i]
    if k <= 1:
        new_state = None
    elif valid_len is None:
        new_state = xp[:, -(k - 1):]
    else:
        # trailing k-1 entries ending at xp index (k-1) + valid_len - 1
        idx = valid_len.to(torch.int64)[:, None] + torch.arange(
            k - 1, device=x.device)
        new_state = torch.gather(
            xp, 1, idx[..., None].expand(-1, -1, xp.shape[-1]))
    return F.silu(out), new_state


def _ssd_chunked(x, a, b_mat, c_mat, chunk: int, h0=None):
    """Chunked SSD scan (Mamba-2 'ssd_minimal_discrete').

    x: [B, S, H, P] (already * dt); a: [B, S, H] log-decay (dt * A);
    b_mat/c_mat: [B, S, N] (single group, broadcast over heads).
    h0: optional [B, H, P, N] initial state (chunked-prefill continuation).
    Returns y [B, S, H, P] and the final state [B, H, P, N] (fp32)."""
    bsz, s, h, p = x.shape
    n = b_mat.shape[-1]
    pad = (-s) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        a = F.pad(a, (0, 0, 0, pad))
        b_mat = F.pad(b_mat, (0, 0, 0, pad))
        c_mat = F.pad(c_mat, (0, 0, 0, pad))
    nc = (s + pad) // chunk
    xc = x.reshape(bsz, nc, chunk, h, p)
    ac = a.reshape(bsz, nc, chunk, h).permute(0, 3, 1, 2)   # [B,H,C,Q]
    bc = b_mat.reshape(bsz, nc, chunk, n)
    cc = c_mat.reshape(bsz, nc, chunk, n)

    a_cum = torch.cumsum(ac, -1)                           # [B,H,C,Q]
    el = torch.exp(_segsum(ac))                            # [B,H,C,Q,Q]
    cb = torch.einsum("bcln,bcsn->bcls", cc, bc)
    y_diag = torch.einsum("bhcls,bcshp->bclhp", cb[:, None] * el, xc)

    decay_states = torch.exp(a_cum[..., -1:] - a_cum)      # [B,H,C,Q]
    states = torch.einsum("bcln,bhcl,bclhp->bchpn", bc, decay_states, xc)

    chunk_decay = torch.exp(a_cum[..., -1])                # [B,H,C]
    h_prev = (torch.zeros((bsz, h, p, n), dtype=torch.float32,
                          device=x.device) if h0 is None
              else h0.to(torch.float32))
    prevs = []
    for ci in range(nc):  # inter-chunk recurrence, sequential over chunks
        prevs.append(h_prev)
        h_prev = h_prev * chunk_decay[:, :, ci, None, None] \
            + states[:, ci].to(torch.float32)
    prev_states = torch.stack(prevs, 1)                    # [B,C,H,P,N]

    state_decay_out = torch.exp(a_cum)                     # [B,H,C,Q]
    y_off = torch.einsum("bcln,bchpn,bhcl->bclhp", cc,
                         prev_states.to(cc.dtype), state_decay_out)
    y = (y_diag + y_off).reshape(bsz, nc * chunk, h, p)
    return y[:, :s], h_prev


def apply(params, spec: SSMSpec, x: torch.Tensor, sp_cfg: SparsityConfig,
          cache=None, chunked: bool = False, valid_len=None):
    """x: [B, S, D]. cache: {'conv': [B,K-1,dI], 'ssd': [B,H,P,N]}.

    Three modes:
      cache None                -> prefill from zero state
      cache + chunked=True      -> chunked-prefill continuation from the
                                   cached state; ``valid_len`` [B] (a device
                                   tensor) masks right-padding: pad tokens
                                   get dt == 0, so they neither move the
                                   state nor enter the carried conv window
      cache + chunked=False     -> O(1) single-token decode (S == 1)
    Returns (out, new_cache); the caller stores the new cache."""
    x = tp.enter(x)
    bsz, s, _ = x.shape
    h, p = spec.num_heads, spec.head_dim

    xi = sl.apply(params["wx"], x, sp_cfg)
    z = sl.apply(params["wz"], x, sp_cfg)
    dt = F.softplus(sl.apply(params["wdt"], x, sp_cfg).to(torch.float32)
                    + params["dt_bias"])                   # [B,S,H]
    if valid_len is not None:
        valid = torch.arange(s, dtype=torch.int32, device=x.device)[None, :] \
            < valid_len[:, None]
        dt = dt * valid[..., None]
    a = -torch.exp(params["A_log"])                        # [H]

    conv_state = cache["conv"] if cache is not None else None
    xi, new_conv = _causal_conv(xi, params["conv_w"], conv_state,
                                valid_len=valid_len)
    b_mat = sl.apply(tp.replicated(params["wB"]), x, sp_cfg).to(
        torch.float32)
    c_mat = sl.apply(tp.replicated(params["wC"]), x, sp_cfg).to(
        torch.float32)

    xh = xi.reshape(bsz, s, h, p).to(torch.float32)
    if cache is None or chunked:
        h0 = None if cache is None else cache["ssd"]
        y, h_final = _ssd_chunked(xh * dt[..., None], dt * a, b_mat, c_mat,
                                  min(spec.chunk, s), h0=h0)
        new_cache = {"conv": new_conv, "ssd": h_final}
    else:
        # O(1) decode: h' = h * exp(dt A) + dt * (B outer x); y = C . h'
        dt1 = dt[:, 0]                                     # [B,H]
        da = torch.exp(dt1 * a)                            # [B,H]
        upd = (xh[:, 0] * dt1[..., None])[..., None] \
            * b_mat[:, 0, None, None, :]                   # [B,H,P,N]
        h_new = cache["ssd"] * da[..., None, None] + upd
        y = torch.einsum("bhpn,bn->bhp", h_new, c_mat[:, 0])[:, None]
        new_cache = {"conv": new_conv, "ssd": h_new}
    y = y + xh * params["D"][:, None]
    y = y.reshape(bsz, s, spec.d_inner).to(x.dtype)
    # gated RMSNorm (Mamba-2 norm_before_gate) bounds the SSD magnitude;
    # d_inner is the sharded axis, so the mean of squares is global
    g = tp.rmsnorm(params["norm"], y * F.silu(z))
    return sl.apply(params["wo"], g, sp_cfg, reduce_out=True), new_cache


def make_cache(spec: SSMSpec, batch: int, dtype=torch.float32, device=None):
    device = resolve_device(device)
    return {
        "conv": torch.zeros((batch, spec.d_conv - 1, spec.d_inner),
                            dtype=dtype, device=device),
        "ssd": torch.zeros((batch, spec.num_heads, spec.head_dim,
                            spec.d_state), dtype=torch.float32,
                           device=device),
    }
