"""Nested dictionaries of tensors (the port's counterpart of the reference's
pytrees of parameters and optimizer state)."""
from __future__ import annotations


def tree_map(fn, *trees):
    """``fn`` over the leaves of nested dictionaries with the same keys; a
    leaf is anything that is not a dictionary."""
    return {k: tree_map(fn, *(t[k] for t in trees))
            if isinstance(v, dict) else fn(*(t[k] for t in trees))
            for k, v in trees[0].items()}


def unzip(tree, n: int) -> tuple:
    """A tree of n-tuples as n trees."""
    return tuple(tree_map(lambda t, i=i: t[i], tree) for i in range(n))


def leaves(tree) -> list:
    """The leaves in sorted-key order: the order ``jax.tree_util`` flattens
    dictionaries in, so both packages agree on leaf i of a state."""
    out = []
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            out.extend(leaves(tree[k]))
        else:
            out.append(tree[k])
    return out


def unflatten(template, flat) -> dict:
    """``template``'s structure with its leaves replaced, in ``leaves``
    order, by the items of ``flat``."""
    it = iter(flat)

    def build(t):
        return {k: build(t[k]) if isinstance(t[k], dict) else next(it)
                for k in sorted(t)}

    out = build(template)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template holds")
    return out
