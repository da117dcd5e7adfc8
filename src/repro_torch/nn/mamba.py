"""Mamba2 block (state-space duality / SSD), chunked.

Follows the minimal SSD formulation of Dao & Gu 2024 (arXiv:2405.21060),
as the JAX package's ``nn/mamba.py`` does: within chunks the recurrence
is computed as masked matmuls (the "dual" quadratic form); across chunks
a linear recurrence carries the (heads, head_dim, state) SSM state (the
JAX package's ``lax.scan`` over chunks is a loop here).

The input projections are separate z/x/B/C/dt matrices and the depthwise
conv has per-stream weights, as in the reference, so params carry across
by name.  In prefill the three streams' causal conv1d runs the
hand-written kernel (``ops.conv1d_causal``, the cuConv tap decomposition
in 1D); train mode runs the plain ``causal_conv1d``, which autograd
differentiates (the kernel has no backward); decode keeps the
reference's K-wide window sum over the cached tails.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.kernels.conv1d_tap import conv1d_tap_plain
from repro_torch.nn import layers as L

CHUNK = 256


def mamba_init(gen, cfg, dtype=L.DEFAULT_DTYPE):
    D = cfg.d_model
    d_in, H, N, G = cfg.d_inner, cfg.ssm_heads, cfg.ssm_state, cfg.ssm_groups
    GN = G * N
    dev = gen.device

    def conv(dim):
        return {"w": L.randn(gen, (cfg.d_conv, dim), 0.2, dtype),
                "b": torch.zeros((dim,), dtype=dtype, device=dev)}

    p = {"wz": L.dense_init(gen, D, d_in, dtype),
         "wx": L.dense_init(gen, D, d_in, dtype),
         "wB": L.dense_init(gen, D, GN, dtype),
         "wC": L.dense_init(gen, D, GN, dtype),
         "wdt": L.dense_init(gen, D, H, dtype)}
    p.update(conv_x=conv(d_in), conv_B=conv(GN), conv_C=conv(GN))
    p.update(
        A_log=torch.log(torch.linspace(1.0, 16.0, H, device=dev)),
        D=torch.ones((H,), device=dev),
        dt_bias=torch.zeros((H,), device=dev),
        norm=L.rmsnorm_init(d_in, dev),
        out_proj=L.dense_init(gen, d_in, D, dtype))
    return p


def causal_conv1d(x, w, b):
    """Tap-decomposed depthwise causal conv1d, plain PyTorch: the
    ``conv1d_tap`` kernel's plain version, which autograd differentiates.

    x: (B, L, C); w: (K, C).  y[l] = sum_k w[k] * x[l - K + 1 + k] + b,
    accumulated in fp32 over the K shifted views, then cast to x.dtype.
    """
    return conv1d_tap_plain(x, w, b)


def _conv_decode(window, w, b):
    """window: (B, K, C) raw stream values; returns conv output at last pos."""
    out = (window.float() * w.float()[None]).sum(1)
    return out + b.float()


def _segsum(dA):
    """Stable segment-sum: out[..., i, j] = sum_{j<k<=i} dA[..., k]."""
    T = dA.shape[-1]
    cs = torch.cumsum(dA, dim=-1)
    out = cs[..., :, None] - cs[..., None, :]
    mask = L.like(torch.tril(torch.ones((T, T), dtype=torch.bool,
                                        device=dA.device)), dA)
    return out.masked_fill(~mask, float("-inf"))


def ssd_chunked(x, dt, A, B, C, chunk=CHUNK):
    """SSD over chunks, group-aware: B/C keep their (g, n) group shape
    inside every einsum instead of being repeated h-fold.

    x: (b, l, h, p)  dt: (b, l, h)  A: (h,)  B, C: (b, l, g, n)
    Returns y: (b, l, h, p) fp32, final_state: (b, h, p, n) fp32.
    """
    b, l, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    if l % chunk:
        raise ValueError(f"seq {l} not divisible by chunk {chunk}")
    nc = l // chunk
    rep = h // g

    xr = x.reshape(b, nc, chunk, g, rep, p)
    dtr = dt.reshape(b, nc, chunk, g, rep)
    Bg = B.reshape(b, nc, chunk, g, n)
    Cg = C.reshape(b, nc, chunk, g, n)

    dA = dtr * A.reshape(g, rep)[None, None, None]     # (b,nc,T,g,rep)
    dA = dA.permute(0, 1, 3, 4, 2)                     # (b,nc,g,rep,T)
    dA_cum = torch.cumsum(dA, dim=-1)

    # 1) diagonal (intra-chunk) term; scores are per group (h-free)
    Ldec = torch.exp(_segsum(dA))                      # (b,nc,g,rep,T,T)
    scores = torch.einsum("bctgn,bcsgn->bcgts", Cg, Bg).float()
    gated = scores[:, :, :, None] * Ldec               # (b,nc,g,rep,T,T)
    xw = (xr * dtr[..., None]).float()                 # dt-weighted input
    y_diag = torch.einsum("bcgrts,bcsgrp->bctgrp", gated, xw)

    # 2) chunk-final states
    decay_to_end = torch.exp(dA_cum[..., -1:] - dA_cum)   # (b,nc,g,rep,T)
    states = torch.einsum("bctgn,bcgrt,bctgrp->bcgrpn",
                          Bg.float(), decay_to_end, xw)

    # 3) inter-chunk recurrence
    chunk_decay = torch.exp(dA_cum[..., -1])              # (b,nc,g,rep)
    carry = L.like(torch.zeros((b, g, rep, p, n), device=x.device), x)
    prev = []
    for c in range(nc):
        prev.append(carry)                                # state entering c
        carry = carry * chunk_decay[:, c, ..., None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)                # (b,nc,g,rep,p,n)

    # 4) off-diagonal contribution from the carried state
    state_decay = torch.exp(dA_cum)                       # (b,nc,g,rep,T)
    y_off = torch.einsum("bctgn,bcgrt,bcgrpn->bctgrp",
                         Cg.float(), state_decay, prev_states)

    y = (y_diag + y_off).reshape(b, l, h, p)
    return y, carry.reshape(b, h, p, n)


def ssd_decode_step(state, x, dt, A, B, C):
    """Single-token recurrence.  state: (b,h,p,n); x: (b,h,p); B,C: (b,g,n)."""
    h = x.shape[1]
    rep = h // B.shape[1]
    Bh = B.repeat_interleave(rep, dim=1).float()                  # (b,h,n)
    Ch = C.repeat_interleave(rep, dim=1).float()
    dA = torch.exp(dt * A[None, :])                               # (b,h)
    upd = torch.einsum("bhp,bhn->bhpn", (x * dt[..., None]).float(), Bh)
    new_state = state * dA[..., None, None] + upd
    y = torch.einsum("bhpn,bhn->bhp", new_state, Ch)
    return y, new_state


def _decode_local(cfg, dtype, x_raw, B_raw, C_raw, dt_raw, tx, tB, tC,
                  state, wx, bx, wB, bB, wC, bC, A, dt_bias, D_rep):
    """One decode step of the block's conv and recurrence: each stream's
    K-wide window over its cached tail and the new value, the conv and
    SiLU, then ``ssd_decode_step``.  Returns y (B, 1, d_inner) fp32 with
    the D skip, the three new tails and the new state."""
    Bsz = x_raw.shape[0]
    d_in, G, N, H = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
    P = cfg.ssm_head_dim
    wins = [torch.cat([t.to(raw.dtype), raw[:, :1]], dim=1)
            for t, raw in ((tx, x_raw), (tB, B_raw), (tC, C_raw))]
    x, Bc, Cc = (F.silu(_conv_decode(win, w, b)).to(dtype)
                 for win, (w, b) in zip(wins, ((wx, bx), (wB, bB),
                                               (wC, bC))))
    dt = F.softplus(dt_raw[:, 0].float() + dt_bias)
    y, new_state = ssd_decode_step(
        state.float(), x.reshape(Bsz, H, P), dt, A,
        Bc.reshape(Bsz, G, N), Cc.reshape(Bsz, G, N))
    y = y.reshape(Bsz, 1, d_in)
    y = y + x.reshape(Bsz, 1, d_in).float() * D_rep
    return (y,) + tuple(win[:, 1:] for win in wins) + (new_state,)


def mamba_fwd(p, cfg, u, cache=None, mode="train"):
    """u: (B, S, D).  Returns (out, cache).

    cache (prefill/decode): ((tail_x, tail_B, tail_C), ssm_state) with
    tails (B, d_conv-1, dim) holding raw pre-conv stream values; it is
    updated in place (the JAX package donates it instead).
    """
    Bsz, S, _ = u.shape
    d_in, G, N, H = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
    P = cfg.ssm_head_dim
    z = L.dense_fwd(p["wz"], u)
    x_raw = L.dense_fwd(p["wx"], u)
    B_raw = L.dense_fwd(p["wB"], u)
    C_raw = L.dense_fwd(p["wC"], u)
    dt_raw = L.dense_fwd(p["wdt"], u)
    D_rep = p["D"].repeat_interleave(P)[None, None, :]
    A = -torch.exp(p["A_log"])

    if mode in ("train", "prefill"):
        # y[l] = sum_k w[k] x[l-K+1+k] + b in fp32: prefill through the
        # kernel, train through the differentiable plain version (on a
        # mesh on each rank's batch rows, ``layers.shard_local``: DTensor
        # mis-places the gradient of its causal pad)
        conv = functools.partial(
            L.shard_local, ops.conv1d_causal if mode == "prefill"
            else causal_conv1d, whole=(1, 2))
        x, Bc, Cc = (F.silu(conv(raw, p[n]["w"], p[n]["b"]))
                     for raw, n in ((x_raw, "conv_x"), (B_raw, "conv_B"),
                                    (C_raw, "conv_C")))
        dt = F.softplus(dt_raw.float() + p["dt_bias"])
        chunk = min(cfg.ssm_chunk or CHUNK, max(16, S))
        pad = (-S) % chunk
        if pad:
            x, Bc, Cc, dt = (F.pad(t, (0, 0, 0, pad)) for t in (x, Bc, Cc, dt))
        # on a mesh the scan runs on each rank's batch rows, its channels
        # whole (``layers.shard_local``): DTensor has no rule for the
        # ``flip`` of its cumsum's backward, and its einsum breaks on a
        # channel-sharded SSD
        y, final_state = L.shard_local(
            functools.partial(ssd_chunked, chunk=chunk),
            x.reshape(Bsz, -1, H, P), dt, A,
            Bc.reshape(Bsz, -1, G, N), Cc.reshape(Bsz, -1, G, N),
            whole=(2,))
        y = y.reshape(Bsz, -1, d_in)[:, :S]
        y = y + x[:, :S].float() * D_rep
        if mode == "prefill":
            K1 = cfg.d_conv - 1
            (bx, bB, bC), bs = cache
            for buf, stream in ((bx, x_raw), (bB, B_raw), (bC, C_raw)):
                t = stream[:, max(0, S - K1):, :]
                if S < K1:
                    t = F.pad(t, (0, 0, K1 - S, 0))
                L.write(buf, t)
            L.write(bs, final_state)
    else:
        (tx, tB, tC), ssm_state = cache           # tails: (B, K-1, dim)
        # on a mesh on each rank's batch rows, the caches and the conv
        # taps whole (``layers.shard_local``): torch 2.11's DTensor finds
        # no rule for the recurrence on a state cut over 'data' (the KV
        # length's rule, long-context decode)
        y, *tails, new_ssm = L.shard_local(
            functools.partial(_decode_local, cfg, u.dtype), x_raw, B_raw,
            C_raw, dt_raw, tx, tB, tC, ssm_state, p["conv_x"]["w"],
            p["conv_x"]["b"], p["conv_B"]["w"], p["conv_B"]["b"],
            p["conv_C"]["w"], p["conv_C"]["b"], A, p["dt_bias"], D_rep,
            whole=tuple(range(8, 17)))
        for t, new in zip((tx, tB, tC), tails):
            L.write(t, new)
        L.write(ssm_state, new_ssm)

    y = y.to(u.dtype) * F.silu(z)
    y = L.rmsnorm_fwd(p["norm"], y, cfg.rms_norm_eps, cfg.norm_impl)
    return L.dense_fwd(p["out_proj"], y), cache
