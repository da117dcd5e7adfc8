"""Plain PyTorch references: no kernel, cache or batching of the
program, and no import of it."""
