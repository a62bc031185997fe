"""Minimal pytree helpers with JAX's flattening order.

Record pytrees are nested tuples, lists, dicts and named tuples whose
leaves are tensors.  The reference flattens them with ``jax.tree``: dict
entries in *sorted key* order, ``None`` as an empty subtree.  The port
must visit leaves in exactly that order (segment-reduce groups leaves,
``describe()`` and ``unify`` name them), so it keeps its own flattener
instead of ``torch.utils._pytree``, which keeps dict insertion order.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator, List, Tuple

#: A treedef is a hashable nested tuple: ``("leaf",)``, ``("none",)``, or
#: ``(kind, meta, child_defs)`` for containers.
TreeDef = Tuple


def _is_namedtuple(x: Any) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(node: Any):
    """``(kind, meta, [(key_str, child), ...])`` for a container node, or
    None for a leaf."""
    if node is None:
        return ("none", None, [])
    if _is_namedtuple(node):
        return ("namedtuple", type(node),
                [(f".{f}", getattr(node, f)) for f in node._fields])
    if isinstance(node, tuple):
        return ("tuple", len(node), [(f"[{i}]", c) for i, c in enumerate(node)])
    if isinstance(node, list):
        return ("list", len(node), [(f"[{i}]", c) for i, c in enumerate(node)])
    if isinstance(node, dict):
        keys = sorted(node)
        return ("dict", tuple(keys), [(f"[{k!r}]", node[k]) for k in keys])
    return None


def _walk(node: Any, path: str, out: List[Tuple[str, Any]]) -> TreeDef:
    ch = _children(node)
    if ch is None:
        out.append((path, node))
        return ("leaf",)
    kind, meta, items = ch
    if kind == "none":
        return ("none",)
    return (kind, meta, tuple(_walk(c, path + k, out) for k, c in items))


def flatten_with_path(tree: Any) -> Tuple[List[Tuple[str, Any]], TreeDef]:
    """Leaves with their ``jax.tree_util.keystr``-style paths, plus the
    treedef.  The walk is a module function, not a closure calling
    itself: such a closure is a reference cycle that would keep every
    leaf (a whole dataset's tensors) alive until the cyclic collector
    runs."""
    out: List[Tuple[str, Any]] = []
    treedef = _walk(tree, "", out)
    return out, treedef


def flatten(tree: Any) -> Tuple[List[Any], TreeDef]:
    pairs, treedef = flatten_with_path(tree)
    return [leaf for _, leaf in pairs], treedef


def leaves(tree: Any) -> List[Any]:
    return flatten(tree)[0]


def _build(td: TreeDef, it: Iterator[Any]) -> Any:
    kind = td[0]
    if kind == "leaf":
        return next(it)
    if kind == "none":
        return None
    _, meta, kids = td
    built = [_build(k, it) for k in kids]
    if kind == "tuple":
        return tuple(built)
    if kind == "list":
        return built
    if kind == "namedtuple":
        return meta(*built)
    return dict(zip(meta, built))


def unflatten(treedef: TreeDef, leaves_: List[Any]) -> Any:
    it = iter(leaves_)
    out = _build(treedef, it)
    rest = list(it)
    if rest:
        raise ValueError(f"{len(rest)} leaves left over after unflatten")
    return out


def tree_map(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:
    """``jax.tree.map``: apply ``fn`` leafwise over same-structure trees."""
    leaves_, treedef = flatten(tree)
    others = []
    for r in rest:
        r_leaves, r_def = flatten(r)
        if r_def != treedef:
            raise ValueError("tree_map: pytrees differ in structure")
        others.append(r_leaves)
    return unflatten(treedef, [fn(*xs) for xs in zip(leaves_, *others)])
