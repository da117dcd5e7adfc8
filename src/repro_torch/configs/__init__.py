"""Configurations: the paper's conv tables, the serving deployments and
the LM architectures."""
from repro_torch.configs import base  # noqa: F401
from repro_torch.configs.base import (  # noqa: F401
    SHAPES, get_config, list_archs, smoke_variant)

_LOADED = False


def load_all():
    """Import every registration module (the LM archs, the paper's conv
    tables)."""
    global _LOADED
    if _LOADED:
        return
    from repro_torch.configs import archs, cnn_paper  # noqa: F401
    _LOADED = True
