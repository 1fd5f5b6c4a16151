"""Parameter trees: nested dicts, lists and tuples (named tuples too) of
tensors, the port's stand-in for ``jax.tree_util``.

Leaves are visited as JAX visits them: a dict's keys in sorted order, a
sequence's items in order; ``None`` is an empty subtree (an fp32
``OptState`` holds ``None`` for its int8 scales).
"""
from __future__ import annotations


def leaves(tree) -> list:
    """The tree's leaves in visiting order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for c in tree for x in leaves(c)]
    return [tree]


def paths(tree, prefix=()) -> list[tuple]:
    """Each leaf's path (dict keys and sequence indices), in ``leaves``
    order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in paths(tree[k], prefix + (k,))]
    if isinstance(tree, (list, tuple)):
        return [p for i, c in enumerate(tree) for p in paths(c, prefix + (i,))]
    return [prefix]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of each
    tree in ``rest`` (of the same structure); ``None`` maps to ``None``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, *xs) for xs in zip(tree, *rest)]
        if isinstance(tree, list):
            return out
        return type(tree)(*out) if hasattr(tree, "_fields") else tuple(out)
    return fn(tree, *rest)


def unflatten(like, values):
    """A tree shaped like ``like`` holding ``values`` (in ``leaves`` order)."""
    it = iter(values)
    out = _rebuild(like, it)
    if next(it, None) is not None:
        raise ValueError("more values than leaves")
    return out


def _rebuild(node, it):
    if node is None:
        return None
    if isinstance(node, dict):
        return {k: _rebuild(node[k], it) for k in sorted(node)}
    if isinstance(node, (list, tuple)):
        out = [_rebuild(c, it) for c in node]
        if isinstance(node, list):
            return out
        return type(node)(*out) if hasattr(node, "_fields") else tuple(out)
    try:
        return next(it)
    except StopIteration:
        raise ValueError("fewer values than leaves") from None


def describe(tree) -> str:
    """The structure with each leaf as ``*`` (a checkpoint manifest's
    record of the tree it holds)."""
    if tree is None:
        return "None"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {describe(tree[k])}"
                               for k in sorted(tree)) + "}"
    if isinstance(tree, (list, tuple)):
        inner = ", ".join(describe(c) for c in tree)
        name = type(tree).__name__ if hasattr(tree, "_fields") else ""
        return f"{name}({inner})" if isinstance(tree, tuple) else f"[{inner}]"
    return "*"
