"""Nested containers of tensors ("trees"), walked in the JAX package's order.

A tree is a dict, list or tuple whose leaves are tensors (or anything else
that is not one of the three). Dict keys are visited in sorted order and
sequences in index order, as ``jax.tree_util`` does, so a leaf's position
and its key path (``[0]/layers/wq``: dict keys, and ``[i]`` for sequence
indices, joined by ``/``) are the reference's: the optimizer sums the leaves
in the reference's order and checkpoints carry across key for key.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator

SEP = "/"


def _is_node(x) -> bool:
    return isinstance(x, (dict, list, tuple))


def _children(x) -> Iterator[tuple[str, Any]]:
    if isinstance(x, dict):
        for k in sorted(x):
            yield str(k), x[k]
    else:
        for i, v in enumerate(x):
            yield f"[{i}]", v


def tree_leaves_with_path(tree, is_leaf: Callable | None = None) -> list[tuple[str, Any]]:
    """``(key path, leaf)`` for every leaf, in the reference's order."""
    out = []

    def walk(x, path):
        if (is_leaf is not None and is_leaf(x)) or not _is_node(x):
            out.append((SEP.join(path), x))
            return
        for name, child in _children(x):
            walk(child, path + [name])

    walk(tree, [])
    return out


def tree_leaves(tree, is_leaf: Callable | None = None) -> list:
    return [leaf for _, leaf in tree_leaves_with_path(tree, is_leaf)]


def tree_map(fn: Callable, tree, *rest, is_leaf: Callable | None = None):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure); the result has ``tree``'s."""
    if (is_leaf is not None and is_leaf(tree)) or not _is_node(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest), is_leaf=is_leaf)
                for k in tree}
    mapped = [tree_map(fn, v, *(r[i] for r in rest), is_leaf=is_leaf)
              for i, v in enumerate(tree)]
    return type(tree)(mapped)


def map_with_path(fn: Callable, tree, is_leaf: Callable | None = None, _path=()):
    """``fn(key_path, leaf)`` over the leaves; the result has ``tree``'s
    structure."""
    if (is_leaf is not None and is_leaf(tree)) or not _is_node(tree):
        return fn(SEP.join(_path), tree)
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, is_leaf, _path + (str(k),)) for k, v in tree.items()}
    return type(tree)(map_with_path(fn, v, is_leaf, _path + (f"[{i}]",))
                      for i, v in enumerate(tree))
