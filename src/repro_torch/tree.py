"""Walking the port's param and train-state trees.

A tree is nested dicts, lists and tuples of tensors.  The reference
keeps each LM segment as one period dict whose arrays are stacked along
a leading repeats axis; the port keeps a segment as a list of period
dicts, one per repeat (``models/lm.py``).  So a list whose items are all
lists is a list of segments, each a list of structurally equal repeats,
and a leaf inside one stands for row ``r`` of the reference's stacked
array.  ``walk`` names every leaf by the reference's path (dict keys in
sorted order, as ``jax.tree`` flattens them; a segment by its index, the
repeat left out) and its repeat, so the optimizer can apply the
reference's shape rules and the checkpoint can write its layout.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator, Optional, Tuple

Path = Tuple[Any, ...]


def _is_segments(node) -> bool:
    return (isinstance(node, list) and len(node) > 0
            and all(isinstance(s, list) for s in node))


def walk(tree, path: Path = (), rep: Optional[int] = None
         ) -> Iterator[Tuple[Path, Optional[int], Any]]:
    """``(path, repeat, leaf)`` of every leaf, in a fixed order: the
    path is the reference's (no repeat index), the repeat the row of its
    stacked array (None outside a segment list)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from walk(tree[k], path + (k,), rep)
    elif _is_segments(tree):
        for si, seg in enumerate(tree):
            for r, node in enumerate(seg):
                yield from walk(node, path + (si,), r)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from walk(v, path + (i,), rep)
    else:
        yield path, rep, tree


def leaves(tree) -> list:
    return [leaf for _, _, leaf in walk(tree)]


def fill(like, fn: Callable, path: Path = (), rep: Optional[int] = None):
    """A tree shaped like ``like`` whose leaves are
    ``fn(path, repeat, leaf)``, visited in ``walk``'s order."""
    if isinstance(like, dict):
        return {k: fill(like[k], fn, path + (k,), rep) for k in sorted(like)}
    if _is_segments(like):
        return [[fill(node, fn, path + (si,), r) for r, node in enumerate(seg)]
                for si, seg in enumerate(like)]
    if isinstance(like, (list, tuple)):
        return type(like)(fill(v, fn, path + (i,), rep)
                          for i, v in enumerate(like))
    return fn(path, rep, like)


def unflatten(like, new_leaves):
    """``like``'s structure over ``new_leaves`` (in ``walk``'s order)."""
    it = iter(new_leaves)
    out = fill(like, lambda *_: next(it))
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def map_tree(fn: Callable, *trees):
    """``fn`` over the leaves of trees of one structure."""
    t = trees[0]
    if isinstance(t, dict):
        return {k: map_tree(fn, *(x[k] for x in trees)) for k in t}
    if isinstance(t, (list, tuple)):
        return type(t)(map_tree(fn, *z) for z in zip(*trees))
    return fn(*trees)


def key(path: Path) -> str:
    """The reference's flattened key of a path, ``"a/b/0/c"``."""
    return "/".join(str(p) for p in path)

