"""Trees of tensors: nested dicts, lists and tuples, ``None`` an empty
subtree.  Leaves are visited in the order ``jax.tree`` visits the same
tree (dict keys sorted), so the optimizer, the checkpoint and the trainer
pair leaves of one tree with leaves of another as the reference does."""
from __future__ import annotations

__all__ = ["tree_leaves", "tree_map", "tree_unflatten"]


def tree_leaves(tree) -> list:
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
        return tuple(out) if isinstance(tree, tuple) else out
    return fn(tree, *rest)


def tree_unflatten(like, leaves):
    """``like``'s structure with ``leaves`` (in ``tree_leaves`` order) at
    its leaves."""
    it = iter(leaves)

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            built = {k: build(t[k]) for k in sorted(t)}
            return {k: built[k] for k in t}
        if isinstance(t, (list, tuple)):
            out = [build(v) for v in t]
            return tuple(out) if isinstance(t, tuple) else out
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out
