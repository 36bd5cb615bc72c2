"""Parameter trees (nested dicts, tuples and lists of tensors) flattened
in ``jax.tree_util``'s leaf order: dict keys sorted, sequences in order.

The order matters beyond this package: a flat parameter row carried across
from the JAX package (``models.flatten.ParamFlattener``) lays its leaves
out in that order, so an ``MLPAgent`` layer ``{"w", "b"}`` is ``b`` then
``w`` in the row.
"""

from __future__ import annotations


def tree_flatten(tree):
    """``(leaves, treedef)``: the leaves in JAX's order and a hashable
    description of the structure (None for a leaf)."""
    if isinstance(tree, dict):
        keys = tuple(sorted(tree))
        parts = [tree_flatten(tree[k]) for k in keys]
        return ([leaf for ls, _ in parts for leaf in ls],
                ("dict", keys, tuple(d for _, d in parts)))
    if isinstance(tree, (tuple, list)):
        parts = [tree_flatten(x) for x in tree]
        return ([leaf for ls, _ in parts for leaf in ls],
                (type(tree).__name__, None, tuple(d for _, d in parts)))
    return [tree], None


def tree_leaves(tree):
    """The leaves of ``tree`` in JAX's order."""
    return tree_flatten(tree)[0]


def tree_unflatten(treedef, leaves):
    """Rebuild the structure ``treedef`` describes from ``leaves``."""
    it = iter(leaves)

    def build(d):
        if d is None:
            return next(it)
        kind, keys, children = d
        built = [build(c) for c in children]
        if kind == "dict":
            return dict(zip(keys, built))
        return tuple(built) if kind == "tuple" else list(built)
    return build(treedef)


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``, trees of the same structure), in a tree of that structure."""
    leaves, treedef = tree_flatten(tree)
    others = [tree_leaves(r) for r in rest]
    return tree_unflatten(treedef, [fn(*xs) for xs in zip(leaves, *others)])


def tree_paths(tree, prefix=""):
    """``(path, leaf)`` pairs in leaf order, the path the keys and indices
    from the root joined by "/" — the names the JAX package's checkpoints
    give leaves (``groups/0/b0/ffn/w_up``)."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from tree_paths(tree[key], f"{prefix}{key}/")
    elif isinstance(tree, (tuple, list)):
        for i, sub in enumerate(tree):
            yield from tree_paths(sub, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree
