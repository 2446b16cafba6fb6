"""Nested dicts of tensors, walked as JAX walks a pytree of dicts: keys in
sorted order, each leaf's path written as ``jax.tree_util.keystr`` writes
it (``['layers']['attn']['wq']``), so a checkpoint's keys are JAX's own."""

from __future__ import annotations

from typing import Any, Callable, Iterator


def paths(tree: Any, prefix: str = "") -> Iterator[tuple[str, Any]]:
    """(keystr path, leaf) of every leaf, in JAX's flattening order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from paths(tree[k], f"{prefix}[{k!r}]")
    else:
        yield prefix, tree


def leaves(tree: Any) -> list:
    return [leaf for _, leaf in paths(tree)]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` of the leaves of ``tree`` and of the trees in ``rest`` (the
    same nesting), in ``tree``'s nesting."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def rebuild(tree: Any, flat: list) -> Any:
    """``tree``'s nesting with the leaves of ``flat``, given in
    ``paths(tree)`` order."""
    it = iter(flat)
    out = _rebuild(tree, it)
    if next(it, None) is not None:
        raise ValueError("rebuild: more leaves than the tree holds")
    return out


def _rebuild(tree: Any, it: Iterator) -> Any:
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], it) for k in sorted(tree)}
    return next(it)
