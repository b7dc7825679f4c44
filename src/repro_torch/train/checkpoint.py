"""Flat checkpoint trees (the port of ``state_to_tree`` and
``tree_from_flat`` of ``repro.train.checkpoint``, without jax): a
nested dict/list tree of arrays <-> a flat ``{path: numpy}`` dict whose
paths are the "/"-joined keys and indices the JAX package writes."""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.layout import canonical_paths


@dataclass(frozen=True)
class LeafSpec:
    """Shape and dtype of one leaf of a template tree."""
    shape: tuple
    dtype: np.dtype


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu()
        if leaf.dtype == torch.bfloat16:
            raise TypeError("bfloat16 tensors have no numpy dtype")
        return leaf.numpy()
    return np.asarray(leaf)


def state_to_tree(state) -> dict:
    """Tree of arrays or tensors -> flat {path: numpy} (host snapshot)."""
    return {p: _host(leaf) for p, leaf in canonical_paths(state)}


def tree_from_flat(template, flat: dict):
    """Rebuild the nested structure of `template` (leaves with
    ``shape``/``dtype``) from {path: array}, casting each leaf to the
    template's dtype and shape."""
    def build(node, prefix):
        if isinstance(node, dict):
            return {k: build(v, prefix + [str(k)]) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(build(v, prefix + [str(i)])
                              for i, v in enumerate(node))
        arr = flat["/".join(prefix)]
        return np.asarray(arr, dtype=node.dtype).reshape(node.shape)

    return build(template, [])
