"""Pytrees of tensors in JAX's leaf order.

The optimizer's moment tuples and the checkpoint's ``leaf_i`` numbering are
aligned with ``jax.tree.leaves(params)`` in the reference, so the port walks
its trees in the same order: dict keys sorted, lists, tuples and NamedTuple
fields in order, ``None`` and empty containers holding no leaf, anything
else a leaf.  The port's parameter dicts keep their insertion order, which
is not sorted, so a plain walk would misalign every moment with its
parameter.  :func:`unflatten` rebuilds dicts in their original key order.
"""
from __future__ import annotations

__all__ = ["TreeDef", "flatten", "leaves", "unflatten", "map", "paths",
           "map_with_path"]

_LEAF = object()  # a leaf's place in a TreeDef's skeleton


class TreeDef:
    """The structure of a tree with its leaves taken out."""

    def __init__(self, skeleton, num_leaves: int):
        self.skeleton = skeleton
        self.num_leaves = num_leaves

    def __str__(self) -> str:
        return f"PyTreeDef({_describe(self.skeleton)})"


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def _flatten(node, is_leaf, out: list):
    if is_leaf is not None and is_leaf(node):
        out.append(node)
        return _LEAF
    if node is None:
        return None
    if isinstance(node, dict):
        done = {k: _flatten(node[k], is_leaf, out) for k in sorted(node)}
        return {k: done[k] for k in node}
    if _is_namedtuple(node):
        return type(node)(*(_flatten(c, is_leaf, out) for c in node))
    if isinstance(node, (list, tuple)):
        return type(node)(_flatten(c, is_leaf, out) for c in node)
    out.append(node)
    return _LEAF


def flatten(tree, is_leaf=None) -> tuple[list, TreeDef]:
    """``(leaves, treedef)``; ``is_leaf(node)`` true stops the walk there."""
    out: list = []
    skeleton = _flatten(tree, is_leaf, out)
    return out, TreeDef(skeleton, len(out))


def leaves(tree, is_leaf=None) -> list:
    return flatten(tree, is_leaf)[0]


def _build(node, it):
    if node is _LEAF:
        return next(it)
    if node is None:
        return None
    if isinstance(node, dict):
        done = {k: _build(node[k], it) for k in sorted(node)}
        return {k: done[k] for k in node}
    if _is_namedtuple(node):
        return type(node)(*(_build(c, it) for c in node))
    return type(node)(_build(c, it) for c in node)


def unflatten(treedef: TreeDef, leaves_) -> object:
    leaves_ = list(leaves_)
    if len(leaves_) != treedef.num_leaves:
        raise ValueError(f"{len(leaves_)} leaves for a tree of "
                         f"{treedef.num_leaves}")
    return _build(treedef.skeleton, iter(leaves_))


def map(fn, tree, *rest, is_leaf=None):  # noqa: A001 - jax.tree.map's name
    """``fn`` over the leaves of ``tree`` and the same-shaped ``rest``."""
    ls, treedef = flatten(tree, is_leaf)
    others = [leaves(r, is_leaf) for r in rest]
    return unflatten(treedef, [fn(*xs) for xs in zip(ls, *others)])


def paths(tree) -> list[str]:
    """Each leaf's path (``/key/index/...``), in leaf order."""
    def walk(node, prefix):
        if node is None:
            return
        if isinstance(node, dict):
            for k in sorted(node):
                yield from walk(node[k], f"{prefix}/{k}")
        elif isinstance(node, (list, tuple)):
            for i, c in enumerate(node):
                yield from walk(c, f"{prefix}/{i}")
        else:
            yield prefix

    return list(walk(tree, ""))


def map_with_path(fn, tree, *rest, is_leaf=None):
    """``fn(path, leaf, *rest_leaves)`` over the leaves in leaf order, with
    ``path`` '/'-joined without a leading slash (``stages/0/attn/wq``), as
    the reference's ``jax.tree_util.tree_map_with_path`` names them."""
    ps: list[str] = []

    def walk(node, prefix):
        if is_leaf is not None and is_leaf(node):
            ps.append(prefix)
        elif node is None:
            return
        elif isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], f"{prefix}/{k}" if prefix else str(k))
        elif isinstance(node, (list, tuple)):
            for i, c in enumerate(node):
                walk(c, f"{prefix}/{i}" if prefix else str(i))
        else:
            ps.append(prefix)

    walk(tree, "")
    ls, treedef = flatten(tree, is_leaf)
    others = [leaves(r, is_leaf) for r in rest]
    return unflatten(treedef, [fn(p, *xs) for p, *xs in
                               zip(ps, ls, *others)])


def _describe(node) -> str:
    if node is _LEAF:
        return "*"
    if node is None:
        return "None"
    if isinstance(node, dict):
        return "{" + ", ".join(f"{k!r}: {_describe(node[k])}"
                               for k in sorted(node)) + "}"
    inner = ", ".join(_describe(c) for c in node)
    if _is_namedtuple(node):
        return f"{type(node).__name__}({inner})"
    return f"[{inner}]" if isinstance(node, list) else f"({inner})"
