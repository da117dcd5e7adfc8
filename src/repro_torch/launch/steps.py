"""Step functions (train / prefill / decode) and their input specs: the
JAX package's ``launch/steps.py``.

Specs are tensors on the "meta" device (shapes and dtypes, no memory).
The train step runs eagerly: autograd through ``lm.train_loss`` (train
mode runs no hand-written kernel, as the reference's train mode reaches
no Pallas kernel), gradient accumulation over micro-batches summed in
fp32, optional int8 + error-feedback compression, then AdamW.

On a mesh the state and the batch are DTensors (``dist/sharding.py``)
and the same step runs on them: each gradient is brought back to its
param's placements as soon as the backward makes it (a hook on the
param, so no rank holds the model's gradients partial or whole at
once), the accumulation and AdamW run on the local shards,
and the metrics come back as plain replicated values.  Micro-batch ``i``
holds rows ``[i*b, (i+1)*b)`` of the *global* batch, as the reference's
reshape does, not each rank's ``i``-th local slice: the MoE aux losses
and the fp32 sums depend on which rows a micro-batch holds.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.dist.sharding import local_shard, place_like, whole
from repro_torch.models import lm
from repro_torch.optim import adamw_init, adamw_update, cosine_schedule
from repro_torch.tree import leaves, unflatten

META = torch.device("meta")


# ---------------------------------------------------------------------------
# input specs (meta tensors: shapes and dtypes, nothing allocated)

def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    B = shape.global_batch
    S = shape.seq_len if shape.kind != "decode" else 1
    batch: Dict[str, Any] = {}
    if cfg.input_mode == "tokens":
        batch["tokens"] = torch.empty((B, S), dtype=torch.int32, device=META)
    else:
        # modality frontend stub: precomputed frame/patch embeddings
        batch["embeds"] = torch.empty((B, S, cfg.d_model),
                                      dtype=torch.bfloat16, device=META)
    if cfg.mrope_sections:
        batch["positions"] = torch.empty((3, B, S), dtype=torch.int32,
                                         device=META)
    if shape.kind == "train":
        batch["labels"] = torch.empty((B, S), dtype=torch.int32, device=META)
    return batch


def state_specs(cfg: ModelConfig, key=None) -> Dict[str, Any]:
    """The train state (params + opt + step) as meta tensors."""
    del key
    params = lm.init_lm(cfg, device=META)
    return {"params": params, "opt": adamw_init(params),
            "step": torch.zeros((), dtype=torch.int32, device=META)}


# ---------------------------------------------------------------------------
# steps

def _split_batch(batch, accum):
    """The reference's micro-batches: rows [i*b, (i+1)*b) of the batch
    axis, which is dim 1 of (3, B, S) M-RoPE positions.  A DTensor's
    rows are those of the global batch, placed as the batch was."""
    def rows(k, v, i):
        b = v.shape[1 if k == "positions" and v.dim() == 3 else 0] // accum
        if k == "positions" and v.dim() == 3:
            return v[:, i * b:(i + 1) * b]
        return v[i * b:(i + 1) * b]

    out = [{} for _ in range(accum)]
    for k, v in batch.items():
        w = whole(v)
        for i in range(accum):
            out[i][k] = place_like(rows(k, w, i), v)
    return out



def _placed_as(p: DTensor):
    """A gradient hook: a DTensor's gradient may come back partial or
    otherwise placed, and is brought to its param's placements as soon
    as the backward makes it, so the gradients of a whole model are never
    all held whole (or partial) at once."""
    def hook(g):
        if isinstance(g, DTensor) and g.placements != p.placements:
            return g.redistribute(p.device_mesh, p.placements)
        return g
    return hook


def make_train_step(cfg: ModelConfig, peak_lr=3e-4, total_steps=10_000,
                    act_spec=None, moe_groups=1, grad_compression=False,
                    donate=False):
    """grad_compression: int8 + error feedback applied to the gradient
    before the optimizer (the EF residual rides in state['ef']).
    donate: update the state's tensors in place (the reference's jit
    donates the state); the state passed in is then consumed.
    """
    accum = max(1, cfg.grad_accum)

    def loss_and_grads(params, micro):
        req = [p.detach().requires_grad_(True) for p in leaves(params)]
        for r in req:
            if isinstance(r, DTensor):
                r.register_hook(_placed_as(r))
        with torch.enable_grad():
            loss, _ = lm.train_loss(unflatten(params, req), cfg, micro,
                                    act_spec=act_spec, moe_groups=moe_groups)
            grads = torch.autograd.grad(loss, req, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(req, grads)]
        return whole(loss.detach()), grads

    def train_step(state, batch):
        params = state["params"]
        if accum > 1:
            gsum, lsum = None, None
            for micro in _split_batch(batch, accum):
                loss, grads = loss_and_grads(params, micro)
                if gsum is None:
                    gsum = [g.to(torch.float32, copy=True) for g in grads]
                    lsum = loss
                else:
                    torch._foreach_add_([local_shard(g) for g in gsum],
                                        [local_shard(g) for g in grads])
                    lsum = lsum + loss
                del grads
            torch._foreach_div_([local_shard(g) for g in gsum], accum)
            grads, loss = gsum, lsum / accum
        else:
            loss, grads = loss_and_grads(params, batch)
        grads = unflatten(params, grads)
        lr = cosine_schedule(state["step"], peak_lr=peak_lr,
                             total_steps=total_steps)
        extra = {}
        if grad_compression:
            from repro_torch.dist import compress as C
            grads, new_ef = C.tree_quantize_with_feedback(grads, state["ef"])
            extra["ef"] = new_ef
        new_params, new_opt, om = adamw_update(
            params, grads, state["opt"], state["step"], lr, donate=donate)
        del grads
        new_state = {"params": new_params, "opt": new_opt,
                     "step": state["step"] + 1, **extra}
        return new_state, {"loss": loss, "lr": lr, **om}

    return train_step


def make_prefill_step(cfg: ModelConfig, max_len: int, act_spec=None,
                      moe_groups=1):
    def prefill_step(params, batch, cache):
        with torch.no_grad():
            logits, new_cache = lm.prefill(params, cfg, batch, cache,
                                           act_spec=act_spec,
                                           moe_groups=moe_groups)
        # serving returns only the last-position logits (next-token dist)
        return logits[:, -1, :], new_cache
    return prefill_step


def make_decode_step(cfg: ModelConfig, act_spec=None):
    def decode_step(params, batch, cache, offset):
        with torch.no_grad():
            logits, new_cache = lm.decode_step(params, cfg, batch, cache,
                                               offset, act_spec=act_spec)
        return logits[:, -1, :], new_cache
    return decode_step
