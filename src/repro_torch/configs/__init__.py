"""Configurations: the paper's conv tables, the serving deployments and
the LM architectures."""
