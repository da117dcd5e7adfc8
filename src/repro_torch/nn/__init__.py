"""LM layers: dense, norms, rotary embeddings, GQA attention, Mamba2."""
