"""Trees of tensors: flatten, unflatten, map and leaf paths.

A tree is a dict, list, tuple or NamedTuple of trees, ``None``, or a
leaf (anything else).  Leaf order and path strings follow JAX's pytree
rules, so a checkpoint's ``manifest.json`` names the same leaves in both
packages:

* dict keys are visited in sorted order;
* ``None`` and empty containers hold no leaves;
* a path joins its parts with ``/``: a dict key as ``str(key)``, a list
  or tuple position as its index, a NamedTuple field as ``.name``.

For a BNN ``TrainState`` that gives ``.params/0/w``,
``.params/2/gamma``, ``.opt/.step``, ``.opt/.inner/m/0/w``, ``.step``.

Also here: the host-array conversions the tree users share
(:func:`to_numpy`, :func:`from_numpy`), which carry bfloat16 as its raw
16-bit pattern (NumPy has no bfloat16).
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

__all__ = [
    "TreeDef", "flatten", "unflatten", "leaves", "paths", "tree_map",
    "tree_map_with_path", "to_numpy", "from_numpy",
]


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(x) -> list:
    """[(path part, child)] of a container, in leaf order."""
    if isinstance(x, dict):
        return [(str(k), x[k]) for k in sorted(x)]
    if _is_namedtuple(x):
        return [(f".{f}", getattr(x, f)) for f in x._fields]
    return [(str(i), c) for i, c in enumerate(x)]


def _is_node(x) -> bool:
    return x is None or isinstance(x, (dict, list, tuple))


class TreeDef:
    """The structure of a tree without its leaves."""

    __slots__ = ("_skeleton", "num_leaves")

    def __init__(self, skeleton, num_leaves: int):
        self._skeleton = skeleton
        self.num_leaves = num_leaves

    def __eq__(self, other) -> bool:
        return (isinstance(other, TreeDef)
                and _same_structure(self._skeleton, other._skeleton))

    def __repr__(self) -> str:
        return f"TreeDef({self._skeleton!r})"


class _Leaf:
    __slots__ = ()

    def __repr__(self) -> str:
        return "*"


_LEAF = _Leaf()


def _same_structure(a, b) -> bool:
    if a is _LEAF or b is _LEAF:
        return a is b
    if a is None or b is None:
        return a is b
    if type(a) is not type(b):
        return False
    ca, cb = _children(a), _children(b)
    return (len(ca) == len(cb)
            and all(ka == kb and _same_structure(va, vb)
                    for (ka, va), (kb, vb) in zip(ca, cb)))


def _rebuild(node, children: list):
    if isinstance(node, dict):
        return {k: c for k, c in zip(sorted(node), children)}
    if _is_namedtuple(node):
        return type(node)(*children)
    return type(node)(children)


def _flatten(x, path: tuple, out: list, out_paths: list):
    if x is None:
        return None
    if not _is_node(x):
        out.append(x)
        out_paths.append(path)
        return _LEAF
    kids = [_flatten(c, path + (part,), out, out_paths)
            for part, c in _children(x)]
    return _rebuild(x, kids)


def flatten(tree: Any) -> tuple:
    """(leaves in JAX's order, TreeDef)."""
    out: list = []
    skeleton = _flatten(tree, (), out, [])
    return out, TreeDef(skeleton, len(out))


def leaves(tree: Any) -> list:
    return flatten(tree)[0]


def paths(tree: Any) -> list:
    """Each leaf's path string, e.g. ``.opt/.inner/m/0/w``."""
    out_paths: list = []
    _flatten(tree, (), [], out_paths)
    return ["/".join(p) for p in out_paths]


def unflatten(treedef: TreeDef, new_leaves) -> Any:
    """The tree of `treedef`'s structure holding `new_leaves` in order."""
    it = iter(new_leaves)

    def build(node):
        if node is _LEAF:
            return next(it)
        if node is None:
            return None
        return _rebuild(node, [build(c) for _, c in _children(node)])

    out = build(treedef._skeleton)
    if next(it, _LEAF) is not _LEAF:
        raise ValueError(f"more leaves than the {treedef.num_leaves} "
                         "the structure holds")
    return out


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """`fn` over the leaves of `tree` and of each tree in `rest`, which
    must have the same structure."""
    flat, tdef = flatten(tree)
    others = []
    for r in rest:
        fr, tr = flatten(r)
        if tr != tdef:
            raise ValueError(f"tree structures differ: {tdef} vs {tr}")
        others.append(fr)
    return unflatten(tdef, [fn(*xs) for xs in zip(flat, *others)])


def tree_map_with_path(fn: Callable, tree: Any) -> Any:
    """`fn(path, leaf)` over the leaves of `tree`, ``path`` the tuple of
    the leaf's path parts (``("blocks", "attn", "wq")``; the parts that
    :func:`paths` joins with ``/``), as
    ``jax.tree_util.tree_map_with_path`` passes its key path."""
    out: list = []
    out_paths: list = []
    skeleton = _flatten(tree, (), out, out_paths)
    tdef = TreeDef(skeleton, len(out))
    return unflatten(tdef, [fn(p, x) for p, x in zip(out_paths, out)])


def to_numpy(x) -> np.ndarray:
    """A host copy of a tensor (blocking: ``.cpu()``) or an array as
    NumPy.  bfloat16 becomes its raw 2-byte pattern (dtype ``V2``), the
    form NumPy gives the JAX package's bfloat16 in an ``.npz``."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view("V2")
        return t.numpy()
    return np.asarray(x)


def from_numpy(arr: np.ndarray, device, dtype_name: str | None = None
               ) -> torch.Tensor:
    """A NumPy array (or a JAX array through ``np.asarray``) as a tensor
    on `device`.  ``dtype_name`` ``"bfloat16"`` (or an array whose dtype
    is named so) reads the 2-byte pattern back as bfloat16."""
    arr = np.asarray(arr)
    name = dtype_name or str(arr.dtype)
    if name == "bfloat16":
        bits = np.array(arr, order="C").view(np.int16)
        return torch.from_numpy(bits).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(arr, order="C")).to(device)
