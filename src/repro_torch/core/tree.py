"""State trees: flatten and rebuild nested containers of tensors.

The port's counterpart of the ``jax.tree_util`` calls the merge layer and
training make, with the same leaf order, so a state tree flattens here as
it does in the reference:

* a dict flattens its values in sorted-key order;
* a list, a tuple and a NamedTuple flatten their items in order;
* an object with ``tree_flatten()`` / ``tree_unflatten(aux, children)``
  (``txn.store.Table``) flattens its children as it says;
* ``None`` is an empty subtree;
* anything else (a tensor, a numpy array, a number) is a leaf.

``is_leaf`` stops the walk early: a node it accepts is one leaf (the
merge layer passes the lattice types, so a whole lattice is one group).
"""

from __future__ import annotations

from typing import Any, Callable

_LEAF = object()
_NONE = object()


def flatten(tree: Any, is_leaf: Callable[[Any], bool] | None = None
            ) -> tuple[list, Any]:
    """``(leaves, treedef)``: the leaves in the reference's order, and the
    structure :func:`unflatten` rebuilds from them."""
    leaves: list = []
    return leaves, _walk(tree, leaves, is_leaf)


# The walks are module functions, not closures: a recursive closure is a
# reference cycle that would keep its leaves (tensors) alive until the
# garbage collector runs.
def _walk(x, leaves: list, is_leaf):
    if is_leaf is not None and is_leaf(x):
        leaves.append(x)
        return _LEAF
    if x is None:
        return _NONE
    if isinstance(x, dict):
        keys = tuple(sorted(x))
        return (dict, keys, tuple(_walk(x[k], leaves, is_leaf)
                                  for k in keys))
    if isinstance(x, (list, tuple)):
        return (type(x), None, tuple(_walk(v, leaves, is_leaf) for v in x))
    if hasattr(x, "tree_flatten") and hasattr(x, "tree_unflatten"):
        children, aux = x.tree_flatten()
        return (type(x), aux, tuple(_walk(c, leaves, is_leaf)
                                    for c in children))
    leaves.append(x)
    return _LEAF


def unflatten(treedef: Any, leaves) -> Any:
    """The tree of ``treedef`` with ``leaves`` in place of its leaves."""
    return _build(treedef, iter(leaves))


def _build(d, it):
    if d is _LEAF:
        return next(it)
    if d is _NONE:
        return None
    kind, aux, children = d
    vals = [_build(c, it) for c in children]
    if kind is dict:
        return dict(zip(aux, vals))
    if hasattr(kind, "_fields"):
        return kind(*vals)
    if kind in (list, tuple):
        return kind(vals)
    return kind.tree_unflatten(aux, vals)


def flatten_up_to(treedef: Any, tree: Any) -> list:
    """The subtrees of ``tree`` at the leaf positions of ``treedef`` (the
    reference's ``treedef.flatten_up_to``); raises where the structures
    differ."""
    out: list = []
    _walk_up_to(treedef, tree, out)
    return out


def _walk_up_to(d, x, out: list) -> None:
    if d is _LEAF:
        out.append(x)
        return
    if d is _NONE:
        return
    kind, aux, children = d
    if kind is dict:
        xs = [x[k] for k in aux]
    elif issubclass(kind, (list, tuple)):
        xs = list(x)
    else:
        xs = list(x.tree_flatten()[0])
    if len(xs) != len(children):
        raise ValueError(f"tree structure mismatch at {kind.__name__}: "
                         f"{len(children)} vs {len(xs)} children")
    for c, v in zip(children, xs):
        _walk_up_to(c, v, out)


def leaves(tree: Any) -> list:
    """The leaves of ``tree``, in the reference's order."""
    return flatten(tree)[0]


def map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``tree`` with ``fn(leaf, *matching leaves of rest)`` in place of
    each leaf (the reference's ``jax.tree.map``)."""
    leaves_, treedef = flatten(tree)
    others = [flatten_up_to(treedef, t) for t in rest]
    return unflatten(treedef, [fn(*xs) for xs in zip(leaves_, *others)])
