"""Shared kernel-geometry helper: the tile clamp + pad arithmetic."""
from typing import Sequence, Tuple


def clamp_tiles(dims: Sequence[int], tiles: Sequence[int]
                ) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """Clamp tile sizes to their dims and derive the pad-to-multiple.

    Returns ``(clamped, pads)`` where ``clamped[i] = min(tiles[i],
    dims[i])`` and ``pads[i] = (-dims[i]) % clamped[i]`` — so
    ``(dims[i] + pads[i]) // clamped[i]`` is the grid size along that
    axis.  Non-positive tile sizes are a caller bug and raise.
    """
    if len(dims) != len(tiles):
        raise ValueError(f"{len(dims)} dims but {len(tiles)} tile sizes")
    clamped, pads = [], []
    for d, t in zip(dims, tiles):
        t = int(t)
        if t < 1:
            raise ValueError(f"tile sizes must be >= 1; got {tiles}")
        t = min(t, int(d))
        clamped.append(t)
        pads.append((-int(d)) % t)
    return tuple(clamped), tuple(pads)
