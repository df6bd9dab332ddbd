"""Nested dicts of tensors (parameter, gradient and optimizer trees): the
few tree operations the port needs in place of ``jax.tree``."""
from __future__ import annotations


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest``; returns a tree of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def flatten(tree, prefix=()):
    """``(path, leaf)`` pairs in sorted key order, so trees of one
    structure flatten in the same order however they were built."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from flatten(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def leaves(tree):
    return [x for _, x in flatten(tree)]


def unflatten(pairs):
    """The tree of ``(path, leaf)`` pairs."""
    out: dict = {}
    for path, x in pairs:
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = x
    return out


def add_into(acc, g):
    """``acc += g`` leaf by leaf, in place; returns ``acc``."""
    for a, b in zip(leaves(acc), leaves(g)):
        a.add_(b)
    return acc
