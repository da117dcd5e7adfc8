"""Mixture-of-experts MLP (DeepSeek-style: shared + fine-grained routed).

The JAX package's ``nn/moe.py`` on PyTorch, with its semantics kept
exactly: an fp32 router, softmax then top-K, the gates renormalized by
``max(sum, 1e-9)``; tokens routed *within groups*, each expert taking
its top-capacity tokens by gate value (expert-choice capacity,
``C = G`` when dropless); the experts' SwiGLU as batched products over
the E experts; the gate weighting and the combine in fp32, then a cast
to ``x.dtype``; the shared experts' MLP added after.  The reference
computes all of it in plain ``jnp`` with no Pallas kernel, so the
library's batched products are its counterpart here.

Top-k is the reference's ``lax.top_k``: equal values come out lower
index first.  ``torch.topk`` promises no order among ties, and ties are
real here (a wave's empty slots are identical rows, so an expert's
top-C picks among equal gates), so ``top_k`` takes the head of a stable
descending sort.

Two choices are the port's own, both for the card:
  * every shape is static (no ``.item()``, ``nonzero()`` or boolean-mask
    indexing), so the prefill and decode CUDA graphs capture it;
  * the combine is a gather, not the reference's scatter-add: each
    expert's top-C tokens are distinct, so scattering the slot numbers
    into a (groups, E, G) position map is deterministic, and each token
    then gathers the weighted outputs of its K routed experts (a dropped
    slot reads 0) and sums them in fp32.  An expert's non-routed picks
    carry gate 0 and add exactly 0 in the reference, so the sum is the
    same; unlike ``index_add_`` on the card (fp32 atomics in no fixed
    order), two calls give the same bits.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.nn import layers as L


def moe_init(gen, cfg, dtype=L.DEFAULT_DTYPE):
    """Router in fp32 (whatever ``dtype``), expert banks (E, a, b) and the
    shared experts' MLP in ``dtype``."""
    E, D, Fd = cfg.num_experts, cfg.d_model, cfg.moe_d_ff

    def bank(a, b):
        return L.randn(gen, (E, a, b), 1.0 / np.sqrt(a), dtype)

    p = {"router": {"w": L.randn(gen, (D, E), 1.0 / np.sqrt(D),
                                 torch.float32)},
         "experts": {"wi": bank(D, Fd), "wg": bank(D, Fd), "wo": bank(Fd, D)}}
    if cfg.num_shared_experts:
        p["shared"] = L.mlp_init(gen, D, Fd * cfg.num_shared_experts, dtype)
    return p


def top_k(x, k: int):
    """The k largest along the last axis, descending, ties lower index
    first (``lax.top_k``'s order): values and indices."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def dispatch(p, cfg, xg, dropless=False):
    """The routing of grouped tokens xg (ng, G, D): the fp32 router's
    probs (ng, G, E), the routed experts eidx (ng, G, K), the dense gate
    matrix gate_te (ng, G, E) (the renormalized top-K gates, 0 where not
    routed), and each expert's top-C tokens by gate (expert-choice
    capacity, C = G when dropless): their gates vals and indices
    tok_idx, (ng, E, C)."""
    G, K, E = xg.shape[1], cfg.experts_per_token, cfg.num_experts
    logits = torch.matmul(xg.float(), p["router"]["w"].float())
    probs = torch.softmax(logits, dim=-1)
    gates, eidx = top_k(probs, K)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    gate_te = torch.zeros_like(probs).scatter(-1, eidx, gates)
    # the reference's Python arithmetic
    C = G if dropless else min(max(1, int(cfg.capacity_factor * G * K / E)),
                               G)
    vals, tok_idx = top_k(gate_te.transpose(1, 2), C)
    return probs, eidx, gate_te, vals, tok_idx


def _expert_tokens(x2, tok_idx, G):
    """Each expert's top-C tokens gathered from x2 (T, D): (E, ng*C, D)."""
    ng, E, C = tok_idx.shape
    rows = tok_idx + (torch.arange(ng, device=x2.device) * G)[:, None, None]
    ein = x2.index_select(0, rows.transpose(0, 1).reshape(-1))
    return ein.reshape(E, ng * C, x2.shape[-1])


def _combine(w, tok_idx, eidx):
    """Token g of group n reads slot pos[n, e, g] of each routed expert e
    of the gate-weighted outputs w (ng, E, C, D) and sums them in fp32:
    (ng, G, D)."""
    ng, E, C, D = w.shape
    G = eidx.shape[1]
    slots = torch.arange(C, device=w.device).expand(ng, E, C)
    pos = torch.full((ng, E, G), -1, dtype=torch.int64, device=w.device)
    pos.scatter_(-1, tok_idx, slots)
    slot = pos.gather(1, eidx.transpose(1, 2)).transpose(1, 2)  # (ng,G,K)
    flat = eidx * C + slot.clamp_min(0)                         # (ng,G,K)
    picked = w.reshape(ng, E * C, D).gather(
        1, flat.reshape(ng, -1, 1).expand(-1, -1, D))           # (ng,G*K,D)
    picked = picked.reshape(ng, G, -1, D)
    picked = torch.where((slot >= 0)[..., None], picked,
                         torch.zeros((), device=w.device))
    return picked.sum(2)


def _aux(probs, eidx, vals, gate_te):
    """Load-balance aux loss (Switch-style) and dropped-token fraction."""
    E = probs.shape[-1]
    me = probs.mean((0, 1))                                    # (E,)
    ce = torch.zeros_like(probs).scatter_(-1, eidx, 1.0).mean((0, 1))
    kept = (vals > 0).sum((1, 2)).float()                      # per group
    routed = (gate_te > 0).sum((1, 2)).float()
    return (E * torch.sum(me * ce),
            1.0 - (kept / routed.clamp_min(1.0)).mean())


def moe_fwd(p, cfg, x, dropless=False, n_groups=1):
    """x: (B, S, D) -> (B, S, D), plus the aux metrics dict
    (``load_balance_loss``, ``dropped_frac``, fp32 scalars).

    n_groups: routing groups (the reference sets the data-parallel
    degree); 1 when it does not divide the tokens.  dropless=True sets
    each expert's capacity to the whole group (decode).

    On a mesh (DTensor x) the routing, the token gather and the combine
    run on the whole tokens on every rank (``layers.shard_local`` with
    ``dims=()``): the stable sort over tokens, ``scatter``, ``gather``
    and ``index_select`` have no DTensor rule.  The expert products stay
    sharded (EP x FSDP).
    """
    B, S, D = x.shape
    T = B * S
    E = cfg.num_experts
    if T % n_groups != 0:
        n_groups = 1
    ng, G = n_groups, T // n_groups
    # (the reshapes into groups run on the whole local tokens: DTensor
    # mis-sizes the view of a batch-sharded (B, S, D) into groups)
    probs, eidx, gate_te, vals, tok_idx = L.shard_local(
        lambda xs, w: dispatch({"router": {"w": w}}, cfg,
                               xs.reshape(ng, G, D), dropless),
        x, p["router"]["w"], dims=())
    C = tok_idx.shape[-1]

    # gather each expert's tokens, (E, ng*C, D), and run the banks
    ein = L.shard_local(lambda xs, ti: _expert_tokens(xs.reshape(T, D), ti,
                                                      G),
                        x, tok_idx, dims=())
    ex = p["experts"]
    h = F.silu(torch.bmm(*L.promote(ein, ex["wi"])))
    h = h * torch.bmm(*L.promote(ein, ex["wg"]))
    eout = torch.bmm(*L.promote(h, ex["wo"]))              # (E, ng*C, D)
    w = eout.reshape(E, ng, C, D).transpose(0, 1).float() * vals[..., None]

    out = L.shard_local(lambda *a: _combine(*a).reshape(B, S, D), w,
                        tok_idx, eidx, dims=())
    out = out.to(x.dtype)

    if cfg.num_shared_experts:
        out = out + L.mlp_fwd(p["shared"], x)

    lb, dropped = L.shard_local(_aux, probs, eidx, vals, gate_te, dims=())
    return out, {"load_balance_loss": lb, "dropped_frac": dropped}
