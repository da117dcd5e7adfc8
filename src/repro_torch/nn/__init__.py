"""LM layers: dense, norms, rotary embeddings, GQA and MLA attention,
mixture of experts, Mamba2."""
from repro_torch.nn import layers, attention, moe, mamba  # noqa: F401
