"""The 10 assigned architectures (exact public configs; see brackets),
registered as in the JAX package."""
from __future__ import annotations

from repro_torch.configs.base import ATTN, SSM, ModelConfig, register


@register("qwen2-72b")
def qwen2_72b():
    # [arXiv:2407.10671; hf] GQA kv=8, QKV bias
    return ModelConfig(
        name="qwen2-72b", family="dense", num_layers=80, d_model=8192,
        num_heads=64, num_kv_heads=8, head_dim=128, d_ff=29568,
        vocab_size=152064, qkv_bias=True, rope_theta=1e6, grad_accum=16)


@register("mistral-large-123b")
def mistral_large_123b():
    # [hf:mistralai/Mistral-Large-Instruct-2407; unverified]
    return ModelConfig(
        name="mistral-large-123b", family="dense", num_layers=88,
        d_model=12288, num_heads=96, num_kv_heads=8, head_dim=128,
        d_ff=28672, vocab_size=32768, rope_theta=1e6, grad_accum=16)


@register("qwen2-1.5b")
def qwen2_1_5b():
    # [arXiv:2407.10671; hf] GQA kv=2, QKV bias
    return ModelConfig(
        name="qwen2-1.5b", family="dense", num_layers=28, d_model=1536,
        num_heads=12, num_kv_heads=2, head_dim=128, d_ff=8960,
        vocab_size=151936, qkv_bias=True, rope_theta=1e6,
        tie_embeddings=True, grad_accum=4)


@register("qwen3-14b")
def qwen3_14b():
    # [hf:Qwen/Qwen3-8B; hf] qk_norm, GQA kv=8
    return ModelConfig(
        name="qwen3-14b", family="dense", num_layers=40, d_model=5120,
        num_heads=40, num_kv_heads=8, head_dim=128, d_ff=17408,
        vocab_size=151936, qk_norm=True, rope_theta=1e6, grad_accum=8)


@register("jamba-v0.1-52b")
def jamba_52b():
    # [arXiv:2403.19887; hf] Mamba+attn 1:7 interleave, MoE 16e top-2
    # 8-layer period with attention at index 4; MoE every 2nd layer.
    pattern = (SSM, SSM, SSM, SSM, ATTN, SSM, SSM, SSM)
    return ModelConfig(
        name="jamba-v0.1-52b", family="hybrid", num_layers=32, d_model=4096,
        num_heads=32, num_kv_heads=8, head_dim=128, d_ff=14336,
        vocab_size=65536, layer_pattern=pattern,
        num_experts=16, experts_per_token=2, moe_d_ff=14336, moe_every=2,
        ssm_state=16, ssm_expand=2, ssm_head_dim=64, ssm_groups=1,
        d_conv=4, rope_theta=1e6, grad_accum=8)


@register("musicgen-large")
def musicgen_large():
    # [arXiv:2306.05284; hf] decoder-only over EnCodec tokens (frontend stub)
    return ModelConfig(
        name="musicgen-large", family="audio", num_layers=48, d_model=2048,
        num_heads=32, num_kv_heads=32, head_dim=64, d_ff=8192,
        vocab_size=2048, input_mode="embeddings", rope_theta=1e4,
        grad_accum=4)


@register("deepseek-v2-lite-16b")
def deepseek_v2_lite():
    # [arXiv:2405.04434; hf] MLA kv_lora=512, 2 shared + 64 routed top-6
    return ModelConfig(
        name="deepseek-v2-lite-16b", family="moe", num_layers=27,
        d_model=2048, num_heads=16, num_kv_heads=16, head_dim=128,
        d_ff=10944, vocab_size=102400,
        mla=True, kv_lora_rank=512, qk_nope_dim=128, qk_rope_dim=64,
        v_head_dim=128,
        num_experts=64, num_shared_experts=2, experts_per_token=6,
        moe_d_ff=1408, moe_every=1, first_layer_dense=True,
        rope_theta=1e4, grad_accum=4)


@register("deepseek-moe-16b")
def deepseek_moe_16b():
    # [arXiv:2401.06066; hf] 2 shared + 64 routed top-6, fine-grained
    return ModelConfig(
        name="deepseek-moe-16b", family="moe", num_layers=28, d_model=2048,
        num_heads=16, num_kv_heads=16, head_dim=128, d_ff=10944,
        vocab_size=102400,
        num_experts=64, num_shared_experts=2, experts_per_token=6,
        moe_d_ff=1408, moe_every=1, first_layer_dense=True,
        rope_theta=1e4, grad_accum=4)


@register("qwen2-vl-2b")
def qwen2_vl_2b():
    # [arXiv:2409.12191; hf] M-RoPE (t,h,w) sections; patch frontend stub
    return ModelConfig(
        name="qwen2-vl-2b", family="vlm", num_layers=28, d_model=1536,
        num_heads=12, num_kv_heads=2, head_dim=128, d_ff=8960,
        vocab_size=151936, qkv_bias=True, input_mode="embeddings",
        mrope_sections=(16, 24, 24), rope_theta=1e6, grad_accum=4)


@register("mamba2-1.3b")
def mamba2_1_3b():
    # [arXiv:2405.21060; unverified] SSD, attn-free, ssm_state=128
    return ModelConfig(
        name="mamba2-1.3b", family="ssm", num_layers=48, d_model=2048,
        num_heads=0, num_kv_heads=0, head_dim=0, d_ff=0,
        vocab_size=50280, ssm_state=128, ssm_expand=2, ssm_head_dim=64,
        ssm_groups=1, d_conv=4, tie_embeddings=True, grad_accum=4)
