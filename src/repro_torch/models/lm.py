"""Causal LM assembly: the JAX package's ``models/lm.py`` for every
assigned family (dense, MoE, MLA, SSM, hybrid, audio, VLM).

The layer stack follows the reference's *stack plan*: a list of
segments, each ``(repeats, kinds)`` where ``kinds`` is the repeating
period of (mixer, mlp) pairs.  The reference stacks each segment's
params along a leading repeats axis and ``lax.scan``s over it; here a
segment is a list of ``repeats`` period dicts ``{"pos{i}": layer}`` and
the forward is a loop.  In train mode with grad on, ``cfg.remat`` picks
what a layer keeps for its backward, as the reference's
``jax.checkpoint`` does: "full" recomputes the layer
(``torch.utils.checkpoint``), "dots" keeps the outputs of its matmuls
with no batch dims and recomputes the rest, "none" keeps everything.

Params are plain dicts of tensors on one device (``init_lm`` draws them
from a ``torch.Generator`` there; ``params_from_numpy`` carries the JAX
package's ``init_lm`` tree across and ``params_to_numpy`` carries the
port's back).  The cache is updated in place by prefill and decode.  The
MoE router stays fp32 whatever the params' dtype, as in the reference.
The losses (``cross_entropy``, ``cross_entropy_chunked``, ``train_loss``)
are the reference's: padded vocab slots masked with -1e30, mean over
tokens in fp32, plus 0.01 of the MoE load-balance loss.
"""
from __future__ import annotations

import functools
import types
from typing import Any, Dict, List, Tuple

import numpy as np
import torch
import torch.utils.checkpoint as tcheckpoint

from repro_torch.configs.base import ATTN, MOE, ModelConfig
from repro_torch.core.convspec import resolve_device
from repro_torch.nn import attention as A
from repro_torch.nn import layers as L
from repro_torch.nn import mamba as S
from repro_torch.nn import moe as M
from repro_torch.tree import map_tree

#: the leaves the reference keeps in fp32 whatever the params' dtype, by
#: the tail of their path (the MoE router's weight is named "w", like
#: every dense weight)
FP32_LEAVES = (("scale",), ("A_log",), ("D",), ("dt_bias",), ("router", "w"))


# ---------------------------------------------------------------------------
# Stack plan

def stack_plan(cfg: ModelConfig) -> List[Tuple[int, Tuple[Tuple[str, str], ...]]]:
    kinds = cfg.layer_kinds()
    n = cfg.num_layers
    if cfg.first_layer_dense:
        rest = kinds[1:]
        if any(k != rest[0] for k in rest):
            raise ValueError("unsupported irregular stack")
        return [(1, (kinds[0],)), (n - 1, (rest[0],))]
    p = cfg.pattern_period
    if p == 0:
        return [(1, (k,)) for k in kinds]          # fully unrolled
    period = kinds[:p]
    if kinds != period * (n // p):
        raise ValueError("layer kinds do not repeat their period")
    return [(n // p, period)]


def _layers(cfg):
    """(segment, repeat, pos name, mixer, mlp) of every layer, in order."""
    for si, (repeats, kinds) in enumerate(stack_plan(cfg)):
        for r in range(repeats):
            for i, (mixer, mlp) in enumerate(kinds):
                yield si, r, f"pos{i}", mixer, mlp


# ---------------------------------------------------------------------------
# Per-layer init / fwd

def _layer_init(gen, cfg, mixer, mlp, dtype):
    p: Dict[str, Any] = {"ln1": L.rmsnorm_init(cfg.d_model, gen.device)}
    if mixer == ATTN:
        p["attn"] = (A.mla_init(gen, cfg, dtype) if cfg.mla
                     else A.gqa_init(gen, cfg, dtype))
    else:
        p["ssm"] = S.mamba_init(gen, cfg, dtype)
    if mlp != "none":
        p["ln2"] = L.rmsnorm_init(cfg.d_model, gen.device)
        if mlp == MOE:
            p["moe"] = M.moe_init(gen, cfg, dtype)
        else:
            p["mlp"] = L.mlp_init(gen, cfg.d_model, cfg.d_ff, dtype)
    return p


def _layer_fwd(p, cfg, mixer, mlp, x, positions, cache, offset, mode,
               moe_groups=1):
    """Returns (x, cache, aux); aux is the MoE layer's statistics, empty
    for any other layer."""
    h = L.rmsnorm_fwd(p["ln1"], x, cfg.rms_norm_eps, cfg.norm_impl)
    aux = {}
    if mixer == ATTN:
        fwd = A.mla_fwd if cfg.mla else A.gqa_fwd
        out, cache = fwd(p["attn"], cfg, h, positions, cache, offset, mode)
    else:
        out, cache = S.mamba_fwd(p["ssm"], cfg, h, cache, mode)
    x = x + out
    if mlp != "none":
        h2 = L.rmsnorm_fwd(p["ln2"], x, cfg.rms_norm_eps, cfg.norm_impl)
        if mlp == MOE:
            mo, aux = M.moe_fwd(p["moe"], cfg, h2,
                                dropless=(mode == "decode"),
                                n_groups=moe_groups)
        else:
            mo = L.mlp_fwd(p["mlp"], h2)
        x = x + mo
    return x, cache, aux


# ---------------------------------------------------------------------------
# Model init

def init_lm(cfg: ModelConfig, seed: int = 0, device=None,
            dtype=L.DEFAULT_DTYPE, place=None) -> Dict[str, Any]:
    """Random params from ``seed`` on ``device`` (default: the card;
    ``"meta"`` gives the shapes and dtypes alone); dense weights in
    ``dtype``; norm scales, the SSM's A_log, D and dt_bias and the MoE
    router in fp32, as the reference.

    ``place(path, piece)``, where given, is called on each piece as soon
    as it is drawn (the embedding, each layer, the final norm, the head;
    ``path`` its keys in the tree) and what it returns takes the piece's
    place: a caller can shard a model that no device holds whole, one
    layer at a time, with the values drawn here."""
    dev = resolve_device(device)
    gen = (types.SimpleNamespace(device=dev) if dev.type == "meta"
           else torch.Generator(device=dev).manual_seed(seed))
    put = place or (lambda path, piece: piece)
    params: Dict[str, Any] = {}
    if cfg.input_mode == "tokens":
        params["embed"] = put(("embed",), L.embed_init(
            gen, cfg.padded_vocab, cfg.d_model, dtype))
    params["segments"] = [
        [{f"pos{i}": put(("segments", si, r, f"pos{i}"),
                         _layer_init(gen, cfg, mx, ml, dtype))
          for i, (mx, ml) in enumerate(kinds)} for r in range(repeats)]
        for si, (repeats, kinds) in enumerate(stack_plan(cfg))]
    params["final_norm"] = put(("final_norm",),
                               L.rmsnorm_init(cfg.d_model, dev))
    if not cfg.tie_embeddings:
        params["lm_head"] = put(("lm_head",), L.dense_init(
            gen, cfg.d_model, cfg.padded_vocab, dtype))
    return params


def params_from_numpy(tree, cfg: ModelConfig, device=None, dtype=None):
    """The JAX package's ``init_lm`` tree, as numpy arrays -> the port's
    params on ``device`` (default: the card).

    Each ``segments[si]["pos{i}"]`` leaf is unstacked along its leading
    repeats axis.  Leaves that ``FP32_LEAVES`` names stay fp32; the
    others take ``dtype`` (default bf16, the reference's: numpy has no
    bf16, so bf16 leaves arrive as float32, and the bf16 -> fp32 -> bf16
    round trip is exact).
    """
    dev = resolve_device(device)
    dtype = L.DEFAULT_DTYPE if dtype is None else dtype

    def conv(node, path=()):
        if isinstance(node, dict):
            return {k: conv(v, path + (k,)) for k, v in node.items()}
        fp32 = any(path[-len(tail):] == tail for tail in FP32_LEAVES)
        dt = torch.float32 if fp32 else dtype
        return torch.tensor(np.asarray(node, np.float32), device=dev).to(dt)

    def unstack(node, r):
        if isinstance(node, dict):
            return {k: unstack(v, r) for k, v in node.items()}
        return np.asarray(node)[r]

    out = {k: conv(v, (k,)) for k, v in tree.items() if k != "segments"}
    out["segments"] = [
        [conv(unstack(seg, r)) for r in range(repeats)]
        for seg, (repeats, _) in zip(tree["segments"], stack_plan(cfg))]
    return out


def params_to_numpy(params, cfg: ModelConfig):
    """The port's params -> the JAX package's ``init_lm`` tree as numpy,
    the inverse of ``params_from_numpy``: each segment's repeats stacked
    along a leading axis, every leaf float32 (bf16 converts exactly)."""
    def host(t):
        return t.detach().float().cpu().numpy()
    plan = stack_plan(cfg)
    if [len(seg) for seg in params["segments"]] != [r for r, _ in plan]:
        raise ValueError("the params' segments do not follow the stack "
                         "plan of this config")
    out = {k: map_tree(host, v) for k, v in params.items()
           if k != "segments"}
    out["segments"] = [
        map_tree(lambda *rows: np.stack([host(t) for t in rows]), *seg)
        for seg in params["segments"]]
    return out


# ---------------------------------------------------------------------------
# Cache

def _layer_cache_shapes(cfg, mixer, batch, max_len, kv_dtype):
    if mixer == ATTN:
        if cfg.mla:         # one latent: compressed kv and the roped key
            return ((batch, max_len, cfg.kv_lora_rank + cfg.qk_rope_dim),
                    kv_dtype)
        kv = ((batch, max_len, cfg.num_kv_heads, cfg.head_dim), kv_dtype)
        return (kv, kv)
    gn = cfg.ssm_groups * cfg.ssm_state
    return (
        (((batch, cfg.d_conv - 1, cfg.d_inner), kv_dtype),
         ((batch, cfg.d_conv - 1, gn), kv_dtype),
         ((batch, cfg.d_conv - 1, gn), kv_dtype)),
        ((batch, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state),
         torch.float32),
    )


def _is_leaf(s):
    return isinstance(s, tuple) and len(s) == 2 and isinstance(s[1],
                                                               torch.dtype)


def _map(fn, node):
    if _is_leaf(node):
        return fn(node)
    return tuple(_map(fn, n) for n in node)


def cache_shapes(cfg: ModelConfig, batch: int, max_len: int,
                 kv_dtype=torch.bfloat16):
    """Per segment, ``{"pos{i}": nested (shape, dtype) leaves}`` with the
    leading repeats axis of the reference's stacked cache."""
    return [{f"pos{i}": _map(lambda s: ((repeats,) + s[0], s[1]),
                             _layer_cache_shapes(cfg, mx, batch, max_len,
                                                 kv_dtype))
             for i, (mx, _) in enumerate(kinds)}
            for repeats, kinds in stack_plan(cfg)]


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               kv_dtype=torch.bfloat16, device=None):
    """Zeroed cache on ``device`` (default: the card), one entry per
    layer: ``cache[si][r]["pos{i}"]``."""
    dev = resolve_device(device)
    return [[{pos: _map(lambda s: torch.zeros(s[0][1:], dtype=s[1],
                                              device=dev), shapes)
              for pos, shapes in seg.items()} for _ in range(repeats)]
            for seg, (repeats, _) in zip(
                cache_shapes(cfg, batch, max_len, kv_dtype),
                stack_plan(cfg))]


# ---------------------------------------------------------------------------
# Forward

def _save_dots(ctx, op, *args, **kwargs):
    """remat="dots": keep the outputs of matmuls with no batch dims
    (``dots_with_no_batch_dims_saveable``), recompute the rest."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return tcheckpoint.CheckpointPolicy.MUST_SAVE
    return tcheckpoint.CheckpointPolicy.PREFER_RECOMPUTE


def _remat(cfg: ModelConfig, fn):
    """``fn`` under the activation checkpointing ``cfg.remat`` asks for."""
    if cfg.remat == "none":
        return fn
    if cfg.remat == "full":
        return functools.partial(tcheckpoint.checkpoint, fn,
                                 use_reentrant=False)
    if cfg.remat == "dots":
        return functools.partial(
            tcheckpoint.checkpoint, fn, use_reentrant=False,
            context_fn=functools.partial(
                tcheckpoint.create_selective_checkpoint_contexts,
                _save_dots))
    raise ValueError(f"unknown remat {cfg.remat!r}: none | full | dots")


def lm_forward(params, cfg: ModelConfig, batch: Dict[str, Any],
               cache=None, offset=0, mode="train", act_spec=None,
               moe_groups=1, skip_head=False):
    """Returns (logits, cache, aux); with ``skip_head`` the final-normed
    hidden states (B, S, D) in place of the logits.

    batch: {'tokens': (B,S) int} or {'embeds': (B,S,D)}; optional
    'positions' ((B,S) or (3,B,S) for M-RoPE), tensors on the params'
    device.  mode: "train" | "prefill" | "decode"; "train" runs no kernel,
    so autograd differentiates it, each layer under ``cfg.remat`` where
    grad is on.  act_spec: an activation sharding spec, None on one
    device (``layers.maybe_constrain``).  aux holds the reference's MoE
    statistics, ``load_balance_loss`` and ``dropped_frac``, each summed
    over the MoE layers (zero without any).
    """
    x, positions = stack_input(params, cfg, batch, offset, act_spec)
    remat = mode == "train" and torch.is_grad_enabled()

    aux = {"load_balance_loss": torch.zeros((), device=x.device),
           "dropped_frac": torch.zeros((), device=x.device)}
    for si, r, pos, mixer, mlp in _layers(cfg):
        c = cache[si][r][pos] if cache is not None else None

        def layer(x_, p_=params["segments"][si][r][pos], mixer=mixer,
                  mlp=mlp, c_=c):
            out = _layer_fwd(p_, cfg, mixer, mlp,
                             L.maybe_constrain(x_, act_spec), positions, c_,
                             offset, mode, moe_groups)
            return (L.maybe_constrain(out[0], act_spec),) + out[1:]
        x, _, layer_aux = (_remat(cfg, layer) if remat else layer)(x)
        for k, v in layer_aux.items():
            aux[k] = aux[k] + v

    return stack_output(params, cfg, x, skip_head), cache, aux


def stack_input(params, cfg: ModelConfig, batch: Dict[str, Any], offset=0,
                act_spec=None):
    """The layer stack's input of ``batch`` (``lm_forward``'s): the
    hidden states (B, S, D) and the positions, ``batch["positions"]``
    where it has them, else ``offset`` onwards.  Reads ``params["embed"]``
    for tokens, and only the head's dtype for embeddings."""
    if cfg.input_mode == "tokens":
        x = L.embed_fwd(params["embed"], batch["tokens"])
        B, Sq = batch["tokens"].shape
    else:
        # match the params' compute dtype (tests may cast params to fp32)
        pdt = (params["lm_head"]["w"].dtype if "lm_head" in params
               else L.DEFAULT_DTYPE)
        x = batch["embeds"].to(pdt)
        B, Sq = x.shape[0], x.shape[1]
    x = L.maybe_constrain(x, act_spec)
    positions = batch.get("positions")
    if positions is None:
        positions = L.like(L.make_positions(B, Sq, offset, x.device), x)
    return x, positions


def stack_output(params, cfg: ModelConfig, x, skip_head=False):
    """The final norm and the head over the stack's output (B, S, D):
    the logits (B, S, Vpad), or with ``skip_head`` the normed states.
    Reads ``params["final_norm"]`` and the head (``embed`` when tied)."""
    x = L.rmsnorm_fwd(params["final_norm"], x, cfg.rms_norm_eps,
                      cfg.norm_impl)
    if skip_head:
        return x
    if cfg.tie_embeddings:
        return torch.matmul(*L.promote(x, params["embed"]["embedding"].T))
    return L.dense_fwd(params["lm_head"], x)


# ---------------------------------------------------------------------------
# Losses

def _mask_padded(logits, vocab_size):
    """fp32 logits with the padded vocab slots at -1e30 (out of the
    partition function; they take no gradient)."""
    lf = logits.float()
    Vpad = lf.shape[-1]
    if Vpad > vocab_size:
        col = L.like(torch.arange(Vpad, device=lf.device) < vocab_size, lf)
        lf = lf.masked_fill(~col, -1e30)
    return lf


def _gold(logits, labels):
    """The label's logit at each position.  On a mesh each rank gathers
    its own positions with the vocab whole (``layers.shard_local``):
    DTensor's gather along a sharded dim returns a partial that the next
    index cannot take."""
    return L.shard_local(
        lambda lf, y: torch.gather(lf, -1, y[..., None].long())[..., 0],
        logits, labels, dims=(0, 1))


def cross_entropy(logits, labels, vocab_size):
    """Mean CE over tokens; logits (B,S,Vpad), labels (B,S) in [0, vocab)."""
    lf = _mask_padded(logits, vocab_size)
    logz = torch.logsumexp(lf, dim=-1)
    return (logz - _gold(lf, labels)).mean()


def _chunk_ce(xc, head_w, yc, vc, vocab_size):
    logits = _mask_padded(torch.matmul(*L.promote(xc, head_w)), vocab_size)
    logz = torch.logsumexp(logits, dim=-1)
    return torch.sum((logz - _gold(logits, yc)) * vc[None, :])


def cross_entropy_chunked(hidden, head_w, labels, vocab_size,
                          chunk=512, unroll=False):
    """Fused head+CE over sequence chunks: the (B,S,Vpad) fp32 logits are
    never held whole.  Each chunk's logits are made, reduced to
    (logz - gold) and dropped, and made again in backward
    (``torch.utils.checkpoint``); numerics those of ``cross_entropy``.
    ``unroll`` is the reference's scan-or-loop switch; both loop here.

    hidden: (B,S,D); head_w: (D, Vpad); labels: (B,S).
    """
    del unroll
    B, S, D = hidden.shape
    pad = (-S) % chunk
    if pad:
        hidden = torch.nn.functional.pad(hidden, (0, 0, 0, pad))
        labels = torch.nn.functional.pad(labels, (0, pad))
    nch = (S + pad) // chunk
    valid = (torch.arange(S + pad, device=hidden.device) < S).to(
        torch.float32).reshape(nch, chunk)
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(nch):
        sl = slice(i * chunk, (i + 1) * chunk)
        args = (hidden[:, sl], head_w, labels[:, sl], valid[i], vocab_size)
        total = total + (tcheckpoint.checkpoint(_chunk_ce, *args,
                                                use_reentrant=False)
                         if torch.is_grad_enabled() else _chunk_ce(*args))
    return total / (B * S)


def train_loss(params, cfg: ModelConfig, batch, act_spec=None,
               moe_groups=1):
    """(loss, {"ce_loss", "load_balance_loss", "dropped_frac"}), the
    reference's: ``ce_loss`` is the loss with the MoE term in it."""
    if cfg.ce_impl == "chunked":
        hidden, _, aux = lm_forward(params, cfg, batch, act_spec=act_spec,
                                    moe_groups=moe_groups, skip_head=True)
        head_w = (params["embed"]["embedding"].T if cfg.tie_embeddings
                  else params["lm_head"]["w"])
        loss = cross_entropy_chunked(
            hidden, head_w, batch["labels"], cfg.vocab_size,
            unroll=(cfg.attn_impl == "chunked_unrolled"))
    else:
        logits, _, aux = lm_forward(params, cfg, batch, act_spec=act_spec,
                                    moe_groups=moe_groups)
        loss = cross_entropy(logits, batch["labels"], cfg.vocab_size)
    if cfg.num_experts:
        loss = loss + 0.01 * aux["load_balance_loss"]
    return loss, {"ce_loss": loss, **aux}


def prefill(params, cfg: ModelConfig, batch, cache, act_spec=None,
            moe_groups=1):
    """Run the full prompt, writing into a preallocated decode cache."""
    logits, cache, _ = lm_forward(params, cfg, batch, cache=cache, offset=0,
                                  mode="prefill", act_spec=act_spec,
                                  moe_groups=moe_groups)
    return logits, cache


def decode_step(params, cfg: ModelConfig, batch, cache, offset,
                act_spec=None):
    """One token step against an existing cache.  ``offset``, the cache
    position of the step's first token, is taken as a 0-d int64 tensor
    on the batch's device (a Python int is made one), as the reference's
    jitted step traces it: positions, cache writes and the mask are
    computed from it on the device."""
    dev = next(iter(batch.values())).device
    offset = torch.as_tensor(offset, dtype=torch.int64, device=dev)
    logits, cache, _ = lm_forward(params, cfg, batch, cache=cache,
                                  offset=offset, mode="decode",
                                  act_spec=act_spec)
    return logits, cache
