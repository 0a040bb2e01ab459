"""Flatten and rebuild nested-dict state in ``jax.tree_util``'s order.

The port's state is nested dicts of tensors. Leaf order decides the tier
buffers' row offsets and the byte-weighted leaf draw of
``MemoryDomain.inject``, so it must be the reference's: dict keys sorted,
depth first. Anything that is not a dict is a leaf.

A treedef is ``None`` for a leaf and a tuple of ``(key, treedef)`` pairs,
in sorted key order, for a dict; it is hashable and compares by structure.

The recursions are module-level functions, not closures: a recursive
closure is a reference cycle, and one that holds the leaf list keeps every
leaf (on the card, gigabytes of struck or corrected copies) alive until
the cycle collector happens to run.
"""
from __future__ import annotations

from typing import Any, List, Optional, Tuple

Path = Tuple[str, ...]
Treedef = Optional[tuple]


def _walk(node, path: Path, flat: List[Tuple[Path, Any]]) -> Treedef:
    if isinstance(node, dict):
        return tuple((k, _walk(node[k], path + (k,), flat))
                     for k in sorted(node))
    flat.append((path, node))
    return None


def flatten_with_path(tree) -> Tuple[List[Tuple[Path, Any]], Treedef]:
    """``([(key_path, leaf), ...], treedef)`` with keys sorted."""
    flat: List[Tuple[Path, Any]] = []
    treedef = _walk(tree, (), flat)
    return flat, treedef


def leaves(tree) -> List[Any]:
    return [leaf for _, leaf in flatten_with_path(tree)[0]]


def structure(tree) -> Treedef:
    return flatten_with_path(tree)[1]


def map_leaves(fn, tree):
    """``tree`` with ``fn`` applied to every leaf; dicts keep their key
    order."""
    if isinstance(tree, dict):
        return {k: map_leaves(fn, v) for k, v in tree.items()}
    return fn(tree)


def map_with_path(fn, tree, path: Path = ()):
    """``tree`` with ``fn(key_path, leaf)`` applied to every leaf, as
    ``jax.tree_util.tree_map_with_path`` does; dicts keep their key
    order."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def _build(td: Treedef, it):
    if td is None:
        return next(it)
    return {k: _build(sub, it) for k, sub in td}


def unflatten(treedef: Treedef, leaves_: List[Any]):
    """Rebuild the nested dicts of ``treedef`` from leaves in order."""
    it = iter(leaves_)
    out = _build(treedef, it)
    if next(it, it) is not it:
        raise ValueError("more leaves than the treedef holds")
    return out
