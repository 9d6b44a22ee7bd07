"""Trees of tensors in the order the reference's ``jax.tree`` walks them.

A tree is nested dicts, lists and tuples with tensors (or numpy arrays, or
numbers) at the leaves; ``None`` is an empty subtree, as in JAX. Dict keys
are visited sorted and sequences by index, so a path's key (``a/b/0``) and
the order of the leaves are the reference's: ``global_norm`` sums its
leaves in the same order and a checkpoint lists them in the same order.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator, List, Tuple

Path = Tuple[Any, ...]


def flatten_with_paths(tree: Any, prefix: Path = ()
                       ) -> Iterator[Tuple[Path, Any]]:
    """(path, leaf) pairs in the reference's order."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from flatten_with_paths(tree[k], prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from flatten_with_paths(v, prefix + (i,))
    else:
        yield prefix, tree


def leaves(tree: Any) -> List[Any]:
    return [leaf for _, leaf in flatten_with_paths(tree)]


def path_key(path: Path) -> str:
    """The reference checkpoint's key of a path: its parts joined by '/'."""
    return "/".join(str(p) for p in path)


def tree_map(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:
    """``fn`` applied to the leaves of ``tree`` and the matching leaves of
    each tree in ``rest`` (same structure), keeping ``tree``'s structure."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def map_with_paths(fn: Callable[[Path, Any], Any], tree: Any,
                   prefix: Path = ()) -> Any:
    """``fn(path, leaf)`` at every leaf, keeping the tree's structure."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: map_with_paths(fn, v, prefix + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_paths(fn, v, prefix + (i,))
                          for i, v in enumerate(tree))
    return fn(prefix, tree)


def unflatten_like(template: Any, flat: List[Any]) -> Any:
    """A tree of ``template``'s structure whose leaves are ``flat``, taken
    in the reference's order."""
    by_path = dict(zip((p for p, _ in flatten_with_paths(template)), flat))
    return map_with_paths(lambda p, _: by_path[p], template)


def at(tree: Any, path: Path) -> Any:
    """The subtree of ``tree`` at ``path`` (a path of
    :func:`flatten_with_paths`)."""
    for k in path:
        tree = tree[k]
    return tree
