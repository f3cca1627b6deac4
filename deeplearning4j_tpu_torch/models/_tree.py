"""Nested dict/list parameter trees — the port's counterpart of JAX
pytrees, shared by the models (GPT, BERT) and the zoo.

Leaves are visited in ``jax.tree.leaves`` order (dict keys sorted, lists in
order), so a flat buffer written by the JAX package lines up leaf by leaf,
and a JAX tree converted with ``jax.tree.map(np.asarray, tree)`` comes
across with :func:`params_from_numpy`.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Optional, Tuple, Union

import numpy as np
import torch

from deeplearning4j_tpu_torch.environment import resolve_device


def leaf_paths(tree, prefix=()) -> Iterator[Tuple[tuple, Any]]:
    """(path, leaf) in ``jax.tree.leaves`` order: dict keys sorted, lists
    in order."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from leaf_paths(tree[key], prefix + (key,))
    elif isinstance(tree, list):
        for i, sub in enumerate(tree):
            yield from leaf_paths(sub, prefix + (i,))
    else:
        yield prefix, tree


def map_tree(fn, tree):
    """``fn`` applied to every leaf; the structure kept."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_tree(fn, v) for v in tree]
    return fn(tree)


def rebuild(template, by_path: Dict[tuple, Any], prefix=()):
    """The structure of ``template`` with the leaf at each path taken from
    ``by_path``."""
    if isinstance(template, dict):
        return {k: rebuild(v, by_path, prefix + (k,))
                for k, v in template.items()}
    if isinstance(template, list):
        return [rebuild(v, by_path, prefix + (i,))
                for i, v in enumerate(template)]
    return by_path[prefix]


def params_from_numpy(tree, device: Union[str, torch.device, None] = None,
                      dtype: Optional[torch.dtype] = None) -> Dict[str, Any]:
    """A JAX tree as numpy arrays (``jax.tree.map(np.asarray, tree)``) as a
    tree of tensors on ``device``: copies, never aliases of the arrays.
    bfloat16 arrays (ml_dtypes) become bfloat16 tensors; ``dtype``, when
    given, casts every leaf. Tensor leaves (a tree of the port's own) are
    copied to ``device`` as they are."""
    dev = resolve_device(device)

    def conv(a):
        if isinstance(a, torch.Tensor):
            return a.detach().to(device=dev, dtype=dtype or a.dtype,
                                 copy=True)
        a = np.asarray(a)
        want = dtype
        if a.dtype.name == "bfloat16":  # ml_dtypes: numpy has no bfloat16
            a, want = a.astype(np.float32), dtype or torch.bfloat16
        t = torch.from_numpy(np.array(a, copy=True))  # own, writable
        return t.to(device=dev, dtype=want or t.dtype)

    return map_tree(conv, tree)
