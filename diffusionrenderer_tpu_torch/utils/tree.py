"""Parameter trees: nested dicts, lists and tuples of tensors (the port's
counterpart of jax.tree_util for the few walks it needs)."""

from __future__ import annotations

from typing import Any, Callable, Dict, List


def leaves(tree: Any) -> List[Any]:
    """The leaves, depth first, in insertion order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def tree_map(fn: Callable, tree: Any) -> Any:
    """fn over the leaves, keeping the structure (named tuples included); a
    None stays None (a block another pipeline stage holds)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        mapped = [tree_map(fn, v) for v in tree]
        return type(tree)(*mapped) if hasattr(tree, "_fields") else type(tree)(mapped)
    return fn(tree)


def flatten(tree: Any, prefix: str = "") -> Dict[str, Any]:
    """{'/'-joined path: leaf}, in the order of `leaves`."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out: Dict[str, Any] = {}
    for k, v in items:
        out.update(flatten(v, f"{prefix}/{k}" if prefix else str(k)))
    return out
