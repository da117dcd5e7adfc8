"""Persisted JSON plan stores under ``$REPRO_CACHE_DIR/torch/``.

One small concern, shared by the measured-autotune cache
(``autotune.json``) and the graph-level plan cache (``graphplans.json``):
a string-keyed JSON map that survives across processes, merges with
concurrent writers instead of clobbering them, and degrades to
in-memory-only on a read-only filesystem.  The port keeps its entries
in a ``torch/`` namespace beside the JAX package's, with ``"cuda"`` as
the backend in its keys.  ``REPRO_CACHE_DIR`` is read at every use, so
tests and deployments can move the store at run time.
"""
from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Any, Dict, Optional


def cache_dir() -> Path:
    base = os.environ.get("REPRO_CACHE_DIR",
                          os.path.join(os.path.expanduser("~"), ".cache",
                                       "repro"))
    return Path(base) / "torch"


class JsonCache:
    """A ``{str: json-value}`` map persisted to ``cache_dir()/<name>``."""

    def __init__(self, filename: str):
        self.filename = filename
        self._mem: Dict[str, Any] = {}
        self._loaded_from: Optional[Path] = None   # path _mem mirrors

    def path(self) -> Path:
        return cache_dir() / self.filename

    def _ensure_loaded(self) -> None:
        path = self.path()
        if path == self._loaded_from:
            return
        self._loaded_from = path
        self._mem = {}
        try:
            self._mem.update(json.loads(path.read_text()))
        except (OSError, ValueError):
            pass                        # no/corrupt cache: start empty

    def get(self, key: str, default: Any = None) -> Any:
        self._ensure_loaded()
        return self._mem.get(key, default)

    def put(self, key: str, value: Any) -> None:
        self._ensure_loaded()
        self._mem[key] = value
        self._persist()

    def clear(self) -> None:
        """Drop the in-memory mirror (tests); the JSON file is untouched."""
        self._loaded_from = None

    def _persist(self) -> None:
        path = self.path()
        try:
            path.parent.mkdir(parents=True, exist_ok=True)
            # merge what concurrent processes persisted since our load, so
            # a stale snapshot never clobbers their entries
            try:
                merged = json.loads(path.read_text())
            except (OSError, ValueError):
                merged = {}
            merged.update(self._mem)
            self._mem.update(merged)
            tmp = path.with_suffix(f".{os.getpid()}.tmp")
            tmp.write_text(json.dumps(merged, indent=0, sort_keys=True))
            os.replace(tmp, path)       # atomic: readers never see torn files
        except OSError:
            pass                        # read-only FS: stay in-memory only
