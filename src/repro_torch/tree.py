"""Nested-dict parameter trees.

Parameters are plain nested ``dict``s of tensors (a list may sit inside, as
in the per-sublayer KV caches). Dict leaves are visited in sorted key order,
the order ``jax.tree_util`` flattens dicts in, list items in order, and a
leaf's path prints exactly as ``jax.tree_util.keystr`` prints it
(``['base']['fusion_w0']``, ``['__per_sub__'][0]['k']``), so
``GroupLayout`` keys and group ids agree with the reference leaf for leaf.
"""
from __future__ import annotations

from collections.abc import Callable, Iterator
from typing import Any


def path_str(keys: tuple[str | int, ...]) -> str:
    return "".join(f"[{k}]" if isinstance(k, int) else f"['{k}']"
                   for k in keys)


def _walk(tree: Any, keys: tuple) -> Iterator[tuple[tuple, Any]]:
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], keys + (k,))
    elif isinstance(tree, list):
        for i, item in enumerate(tree):
            yield from _walk(item, keys + (i,))
    else:
        yield keys, tree


def leaves_with_path(tree: Any) -> list[tuple[str, Any]]:
    """[(path string, leaf)] in sorted key order."""
    return [(path_str(k), leaf) for k, leaf in _walk(tree, ())]


def leaves(tree: Any) -> list[Any]:
    return [leaf for _, leaf in _walk(tree, ())]


def map_with_path(fn: Callable[..., Any], tree: Any, *rest: Any,
                  _keys: tuple[str, ...] = ()) -> Any:
    """fn(path string, leaf, *matching leaves of ``rest``) over the tree;
    the result has the same nesting, with keys in sorted order."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, tree[k], *(r[k] for r in rest),
                                 _keys=_keys + (k,))
                for k in sorted(tree)}
    if isinstance(tree, list):
        return [map_with_path(fn, item, *(r[i] for r in rest),
                              _keys=_keys + (i,))
                for i, item in enumerate(tree)]
    return fn(path_str(_keys), tree, *rest)


def tree_map(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:
    return map_with_path(lambda _, *xs: fn(*xs), tree, *rest)
