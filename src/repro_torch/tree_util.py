"""Flattening of the port's state trees: dicts, lists, tuples and named
tuples (``HeadParams``, ``OptState``, ``LMHeadState``, ``Tree``,
``TrainState``, ...) down to their leaves, and back.

A leaf is anything else: a tensor, a numpy array, a Python number, a
string. ``None`` is a node with no leaves, so a tree that holds ``None``
(an unused optimizer slot, a generator without a tree) keeps its shape
through a round trip. Dict keys are visited in sorted order, as the JAX
package's ``jax.tree`` visits them.
"""
from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple

# A spec is (kind, meta, children): kind in {"leaf", "none", "dict", "list",
# "tuple", "named"}; meta the sorted keys or the named tuple's type.
Spec = Tuple[str, Any, tuple]


def _children(tree, is_leaf):
    if is_leaf is not None and is_leaf(tree):
        return "leaf", None, ()
    if tree is None:
        return "none", None, ()
    if isinstance(tree, dict):
        keys = sorted(tree)
        return "dict", tuple(keys), tuple(tree[k] for k in keys)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return "named", type(tree), tuple(tree)
    if isinstance(tree, (list, tuple)):
        return ("list" if isinstance(tree, list) else "tuple"), None, tuple(tree)
    return "leaf", None, ()


def _names(kind, meta, n):
    if kind == "dict":
        return [str(k) for k in meta]
    if kind == "named":
        return list(meta._fields)
    return [str(i) for i in range(n)]


def _walk(node, path, is_leaf, pairs) -> Spec:
    kind, meta, kids = _children(node, is_leaf)
    if kind == "leaf":
        pairs.append((path, node))
        return ("leaf", None, ())
    names = _names(kind, meta, len(kids))
    return (kind, meta, tuple(_walk(k, path + (n,), is_leaf, pairs)
                              for k, n in zip(kids, names)))


def flatten_with_paths(tree, is_leaf: Optional[Callable[[Any], bool]] = None
                       ) -> Tuple[List[Tuple[Tuple[str, ...], Any]], Spec]:
    """((path, leaf) pairs, spec): a path names the dict keys, the named
    tuples' fields and the list indices down to its leaf. ``is_leaf``
    makes a node (``None``, a state box) one leaf.

    The walks here are module functions, not nested closures: a closure
    that calls itself is a reference cycle, which would keep the leaves it
    saw (gathered weights, gradients) alive until the cyclic collector
    runs."""
    pairs: List[Tuple[Tuple[str, ...], Any]] = []
    spec = _walk(tree, (), is_leaf, pairs)
    return pairs, spec


def flatten(tree, is_leaf: Optional[Callable[[Any], bool]] = None
            ) -> Tuple[List[Any], Spec]:
    """(leaves, spec) of ``tree``; :func:`unflatten` inverts it."""
    pairs, spec = flatten_with_paths(tree, is_leaf)
    return [leaf for _, leaf in pairs], spec


def _build(s: Spec, it) -> Any:
    kind, meta, kids = s
    if kind == "leaf":
        return next(it)
    if kind == "none":
        return None
    vals = [_build(k, it) for k in kids]
    if kind == "dict":
        return dict(zip(meta, vals))
    if kind == "named":
        return meta(*vals)
    return vals if kind == "list" else tuple(vals)


def unflatten(spec: Spec, leaves) -> Any:
    it = iter(leaves)
    out = _build(spec, it)
    rest = list(it)
    if rest:
        raise ValueError(f"unflatten: {len(rest)} leaves left over")
    return out


def leaves(tree) -> List[Any]:
    return flatten(tree)[0]


def tree_map(fn: Callable[[Any], Any], tree) -> Any:
    """``fn`` applied to every leaf, the structure kept."""
    flat, spec = flatten(tree)
    return unflatten(spec, [fn(x) for x in flat])


def spec_str(spec: Spec) -> str:
    """A printable form of a spec, for checkpoint manifests."""
    kind, meta, kids = spec
    if kind == "leaf":
        return "*"
    if kind == "none":
        return "None"
    inner = ", ".join(spec_str(k) for k in kids)
    if kind == "dict":
        return "{" + ", ".join(f"{k!r}: {spec_str(c)}" for k, c in zip(meta, kids)) + "}"
    if kind == "named":
        return f"{meta.__name__}({inner})"
    return f"[{inner}]" if kind == "list" else f"({inner})"
