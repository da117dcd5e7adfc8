"""LM configuration system: the port's own copy of the JAX package's.

Every assigned architecture is a ``ModelConfig`` registered under its id.
Reduced "smoke" variants (same family, tiny dims) are derived via
:func:`smoke_variant` and used by the CPU tests; ``qwen2-1.5b``,
``mamba2-1.3b``, ``deepseek-v2-lite-16b`` and ``deepseek-moe-16b``
are served at full size on the card.  The fields and
properties are the reference's, so ``num_params`` and ``layer_kinds``
agree with it for every arch; the execution knobs that only shape the
XLA program (``scan_layers``, ``attn_score_dtype``, ``shard_heads``) are
kept as data and not read by the port.  ``remat`` (activation
checkpointing of a layer in train mode) and ``ce_impl`` (the loss's
cross entropy, whole or chunked) are read by training, as in the
reference.  ``attn_impl`` is read where the reference reads it: "exact"
keeps the plain attention (train mode, MLA) off ``chunked_attention``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

# ---------------------------------------------------------------------------
# Layer kinds used to describe hybrid stacking patterns.
ATTN = "attn"   # self-attention (GQA / MHA / MLA)
SSM = "ssm"     # Mamba2 SSD block
DENSE = "dense" # dense MLP
MOE = "moe"     # routed mixture-of-experts MLP


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128

    # --- attention flavour -------------------------------------------------
    qkv_bias: bool = False          # qwen2 family
    qk_norm: bool = False           # qwen3
    rope_theta: float = 1_000_000.0
    mrope_sections: Tuple[int, ...] = ()   # qwen2-vl M-RoPE (t, h, w) dims
    # MLA (deepseek-v2)
    mla: bool = False
    kv_lora_rank: int = 0
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128

    # --- MoE ----------------------------------------------------------------
    num_experts: int = 0            # routed experts
    num_shared_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0               # per-expert FFN width
    moe_every: int = 1              # a MoE MLP every k layers (others dense)
    first_layer_dense: bool = False # deepseek-moe: layer 0 keeps dense MLP
    capacity_factor: float = 1.25

    # --- SSM (Mamba2 / SSD) -------------------------------------------------
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_groups: int = 1
    d_conv: int = 4

    # --- hybrid stacking ----------------------------------------------------
    # Repeating pattern of layer kinds.  () means uniform (ATTN or SSM based
    # on family).  jamba: 8-layer period, attention at index 4, MoE every 2.
    layer_pattern: Tuple[str, ...] = ()

    # --- input modality -----------------------------------------------------
    # "tokens": int32 token ids.  "embeddings": the modality frontend is a
    # stub and the model consumes precomputed frame/patch embeddings.
    input_mode: str = "tokens"
    tie_embeddings: bool = False

    # --- norm ---------------------------------------------------------------
    rms_norm_eps: float = 1e-5

    # --- training-time knobs (overridable per run) ---------------------------
    grad_accum: int = 1             # microbatch accumulation steps
    remat: str = "full"             # "none" | "full" (recompute layer interior)

    # --- execution-structure knobs (cost probes / perf experiments) ----------
    scan_layers: bool = True        # lax.scan over layers (False: unrolled)
    attn_impl: str = "auto"         # "auto" | "chunked_unrolled" | "exact"
    ce_impl: str = "simple"         # "simple" | "chunked" (§Perf lever: the
                                    # simple path materializes f32 logits)
    attn_score_dtype: str = "f32"   # "f32" | "bf16" (§Perf: halves the
                                    # chunked-attention score/prob HBM traffic)
    shard_heads: str = "none"       # "none" | "head_dim": pin q/k/v
                                    # (B,S,H,hd) sharding (hd over 'model');
                                    # rescues archs with heads % TP != 0
    ssm_chunk: int = 256            # SSD chunk length (§Perf: diag-block
                                    # traffic scales linearly with it)
    norm_impl: str = "f32"          # "f32" | "stat_f32": keep the variance
                                    # reduction in f32 but normalize in bf16
                                    # (§Perf: kills (B,S,D)-sized f32 traffic)
    rope_impl: str = "f32"          # "f32" | "bf16": rotate in bf16

    # -------------------------------------------------------------------
    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def conv_dim(self) -> int:
        # mamba2: conv runs over x (d_inner) plus B and C streams
        return self.d_inner + 2 * self.ssm_groups * self.ssm_state

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up so TP sharding divides evenly (multiple of 256)."""
        return ((self.vocab_size + 255) // 256) * 256

    def layer_kinds(self) -> Tuple[Tuple[str, str], ...]:
        """Full per-layer (mixer_kind, mlp_kind) schedule of the stack."""
        out = []
        for i in range(self.num_layers):
            if self.layer_pattern:
                mixer = self.layer_pattern[i % len(self.layer_pattern)]
            else:
                mixer = SSM if self.family == "ssm" else ATTN
            if self.num_experts > 0 and (i % self.moe_every == self.moe_every - 1
                                         or self.moe_every == 1):
                mlp = MOE
            else:
                mlp = DENSE
            if self.first_layer_dense and i == 0:
                mlp = DENSE
            if self.family == "ssm":
                mlp = "none"        # mamba2 blocks have no separate MLP
            out.append((mixer, mlp))
        return tuple(out)

    @property
    def uniform_stack(self) -> bool:
        """True when every layer is identical -> scan over all layers."""
        kinds = self.layer_kinds()
        return all(k == kinds[0] for k in kinds)

    @property
    def pattern_period(self) -> int:
        """Length of the repeating layer pattern (scan unit)."""
        if self.uniform_stack:
            return 1
        # honour both the mixer pattern and the moe_every cadence
        period = len(self.layer_pattern) if self.layer_pattern else 1
        if self.num_experts > 0 and self.moe_every > 1:
            import math
            period = math.lcm(period, self.moe_every)
        # first_layer_dense breaks periodicity; fall back to unrolled
        if self.first_layer_dense:
            return 0
        if self.num_layers % period != 0:
            return 0                # 0 => no clean period, unroll
        return period

    def num_params(self) -> int:
        """Analytic parameter count (for 6ND model-flops accounting)."""
        p = 0
        V, D = self.padded_vocab, self.d_model
        if self.input_mode == "tokens":
            p += V * D                                 # embed
        if not self.tie_embeddings:
            p += D * V                                 # lm head
        p += D                                         # final norm
        for mixer, mlp in self.layer_kinds():
            p += D if mlp == "none" else 2 * D         # pre-norms
            if mixer == ATTN:
                if self.mla:
                    qk_dim = self.qk_nope_dim + self.qk_rope_dim
                    p += D * self.num_heads * qk_dim                   # wq
                    p += D * (self.kv_lora_rank + self.qk_rope_dim)    # w_dkv
                    p += self.kv_lora_rank * self.num_heads * (
                        self.qk_nope_dim + self.v_head_dim)            # w_ukv
                    p += self.num_heads * self.v_head_dim * D          # wo
                else:
                    p += D * self.q_dim + 2 * D * self.kv_dim
                    p += self.q_dim * D
                    if self.qkv_bias:
                        p += self.q_dim + 2 * self.kv_dim
            elif mixer == SSM:
                d_in, conv = self.d_inner, self.conv_dim
                p += D * (2 * d_in + 2 * self.ssm_groups * self.ssm_state
                          + self.ssm_heads)            # z/x/B/C/dt projs
                p += self.d_conv * conv + conv         # conv1d w + bias
                p += 3 * self.ssm_heads                # A_log, D, dt_bias
                p += d_in                              # gated norm
                p += d_in * D                          # out_proj
            if mlp == DENSE:
                p += 3 * D * self.d_ff
            elif mlp == MOE:
                p += D * self.num_experts              # router
                p += self.num_experts * 3 * D * self.moe_d_ff
                p += self.num_shared_experts * 3 * D * self.moe_d_ff
        return p

    def num_active_params(self) -> int:
        """Params touched per token (MoE: routed top-k + shared only)."""
        if self.num_experts == 0:
            return self.num_params()
        p = self.num_params()
        for mixer, mlp in self.layer_kinds():
            if mlp == MOE:
                inactive = self.num_experts - self.experts_per_token
                p -= inactive * 3 * self.d_model * self.moe_d_ff
        return p


# ---------------------------------------------------------------------------
# Input shape cells (the assigned shape set for the LM family).

@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k":    ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k":  ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k":   ShapeConfig("long_500k", 524_288, 1, "decode"),
}


# ---------------------------------------------------------------------------
# Registry

_REGISTRY: Dict[str, Callable[[], ModelConfig]] = {}


def _load_archs() -> None:
    """Import the registrations (``configs/archs.py``) on first use."""
    from repro_torch.configs import archs  # noqa: F401


def register(name: str):
    def deco(fn: Callable[[], ModelConfig]):
        _REGISTRY[name] = fn
        return fn
    return deco


def get_config(name: str) -> ModelConfig:
    _load_archs()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]()


def list_archs():
    _load_archs()
    return sorted(_REGISTRY)


def smoke_variant(cfg: ModelConfig) -> ModelConfig:
    """A tiny same-family config that runs a real step on CPU."""
    n_layers = max(2, len(cfg.layer_pattern)) if cfg.layer_pattern else 2
    if cfg.num_experts > 0 and cfg.moe_every > 1:
        import math
        n_layers = math.lcm(n_layers, cfg.moe_every)
    if cfg.first_layer_dense:
        n_layers = max(n_layers, 2)
    kw = dict(
        name=cfg.name + "-smoke",
        num_layers=n_layers,
        d_model=64,
        num_heads=4,
        num_kv_heads=min(cfg.num_kv_heads, 2) if cfg.num_kv_heads else 0,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
    )
    if cfg.num_experts:
        kw.update(num_experts=4, experts_per_token=min(2, cfg.experts_per_token),
                  moe_d_ff=32)
    if cfg.mla:
        kw.update(kv_lora_rank=32, qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16)
    if cfg.ssm_state:
        kw.update(ssm_state=16, ssm_head_dim=16)
    if cfg.mrope_sections:
        kw.update(mrope_sections=(4, 2, 2))
    return dataclasses.replace(cfg, **kw)
