"""Compensated-summation primitives (the paper's core algorithm, §4.2).

Twin of ``repro.core.kahan``: the same branch-free f32 operation
sequences, written as separate PyTorch ops so every add rounds on its
own (PyTorch never reassociates or contracts elementwise ops), which
keeps them bitwise equal to the reference.

Trees (``KahanState`` and ``tree_*``) are the port's parameter trees:
nested dicts and lists of tensors, walked in order.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

Tensor = torch.Tensor
Tree = Any


def twosum(a: Tensor, b: Tensor) -> tuple[Tensor, Tensor]:
    """Knuth TwoSum: (s, e) with s = fl(a + b) and s + e == a + b."""
    s = a + b
    a_prime = s - b
    b_prime = s - a_prime
    da = a - a_prime
    db = b - b_prime
    return s, da + db


def kahan_step(s: Tensor, c: Tensor, x: Tensor) -> tuple[Tensor, Tensor]:
    """One classic Kahan update (``c`` holds the negative compensation)."""
    y = x - c
    t = s + y
    c_new = (t - s) - y
    return t, c_new


def neumaier_step(s: Tensor, c: Tensor, x: Tensor) -> tuple[Tensor, Tensor]:
    """Kahan–Babuška–Neumaier update; the represented value is s + c."""
    t, e = twosum(s, x)
    return t, c + e


def combine(s1: Tensor, c1: Tensor, s2: Tensor, c2: Tensor
            ) -> tuple[Tensor, Tensor]:
    """Merge two Neumaier partials (s1 + c1) and (s2 + c2)."""
    s, e = twosum(s1, s2)
    return s, c1 + c2 + e


def value(s: Tensor, c: Tensor) -> Tensor:
    return s + c


class KahanState(NamedTuple):
    """A compensated accumulator over a tree: ``sum`` and ``carry`` have
    the same structure and the represented value is ``sum + carry``
    leafwise. Functional, like the reference: ``add`` and ``merge``
    return new trees (``kernels.ops.kahan_accumulate`` is the in-place
    kernel form of ``add`` for one leaf)."""

    sum: Tree
    carry: Tree

    @staticmethod
    def zeros_like(tree: Tree) -> "KahanState":
        return KahanState(sum=tree_map(torch.zeros_like, tree),
                          carry=tree_map(torch.zeros_like, tree))

    def add(self, update: Tree) -> "KahanState":
        return KahanState(*tree_kahan_add(self.sum, self.carry, update))

    def merge(self, other: "KahanState") -> "KahanState":
        return KahanState(*tree_kahan_combine(self.sum, self.carry,
                                              other.sum, other.carry))

    def value(self) -> Tree:
        return tree_map(torch.add, self.sum, self.carry)


def tree_map(fn, tree: Tree, *rest: Tree) -> Tree:
    """``fn`` leafwise over trees of one structure (dicts, lists, tuples
    and ``NamedTuple`` states; ``None`` holds no leaf, as in JAX)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v, *(r[i] for r in rest))
                            for i, v in enumerate(tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree: Tree) -> list:
    """The leaves of a tree, in ``tree_map``'s order."""
    out = []
    tree_map(out.append, tree)
    return out


def tree_unflatten(like: Tree, leaves) -> Tree:
    """A tree shaped like ``like`` whose leaves are ``leaves`` in
    ``tree_leaves``'s order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


def _unzip(like: Tree, pairs: Tree) -> tuple[Tree, Tree]:
    """A tree of (a, b) leaves, shaped like ``like`` -> (a tree, b tree)."""
    return (tree_map(lambda _, p: p[0], like, pairs),
            tree_map(lambda _, p: p[1], like, pairs))


def tree_kahan_add(sum_tree: Tree, carry_tree: Tree, update_tree: Tree
                   ) -> tuple[Tree, Tree]:
    """Leafwise Neumaier update of a tree accumulator."""
    return _unzip(sum_tree, tree_map(neumaier_step, sum_tree, carry_tree,
                                     update_tree))


def tree_kahan_combine(s1: Tree, c1: Tree, s2: Tree, c2: Tree
                       ) -> tuple[Tree, Tree]:
    """Leafwise merge of two tree accumulators."""
    return _unzip(s1, tree_map(combine, s1, c1, s2, c2))


def kahan_sum(x: Tensor, axis: int = -1, *, variant: str = "neumaier"
              ) -> Tensor:
    """Compensated sum along ``axis`` in sequential order (the scan form)."""
    step = neumaier_step if variant == "neumaier" else kahan_step
    x = torch.movedim(x, axis, 0)
    s = torch.zeros(x.shape[1:], dtype=x.dtype, device=x.device)
    c = torch.zeros_like(s)
    for xi in x:
        s, c = step(s, c, xi)
    return s + c if variant == "neumaier" else s


def kahan_dot(a: Tensor, b: Tensor, *, variant: str = "neumaier") -> Tensor:
    """Compensated scalar product, scan form."""
    return kahan_sum(a * b, axis=0, variant=variant)


def naive_sum(x: Tensor, axis: int = -1) -> Tensor:
    """The paper's baseline: straightforward accumulation."""
    return torch.sum(x, dim=axis)


def naive_dot(a: Tensor, b: Tensor) -> Tensor:
    """The paper's baseline scalar product."""
    return torch.sum(a * b)
