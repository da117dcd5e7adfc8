"""Configurations: the paper's conv tables and the serving deployments."""
