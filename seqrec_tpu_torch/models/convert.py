"""JAX parameters -> the port's `state_dict`, and `.npz` files of them.

The JAX model's parameters are a flax tree, here as nested dicts of numpy
arrays:

    {'params': {'item_embedding': [rows, D],
                'output_embedding': [rows, H],   # untied tables only
                'output_bias': [rows],           # full_softmax only
                'user_embedding': [users+1, D],  # use_user_embedding only
                'tower': {'gru0_wx': [D, 3H], 'gru0_wh': [H, 3H],
                          'gru0_bx': [3H], 'gru0_bh': [3H], ...}}}

The port keeps the flax names and layouts, so a leaf at path `a/b/c` becomes
`state_dict['a.b.c']` unchanged. A `.npz` file holds the same leaves under
their `/`-joined paths (`params/tower/gru0_wx`).

`random_params` draws such a tree with numpy from a seed, with the flax
initializers' distributions (normal(1/sqrt(D)) tables, Glorot-uniform w_x,
orthogonal w_h, zero biases), for runs that need weights without a trained
checkpoint.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    flat = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            flat.update(_flatten(v, path))
        else:
            flat[path] = np.asarray(v)
    return flat


def _unflatten(flat: Mapping[str, np.ndarray]) -> Dict:
    tree: Dict = {}
    for path, v in flat.items():
        node = tree
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def flax_to_state_dict(tree: Mapping) -> Dict[str, torch.Tensor]:
    """A flax parameter tree (with or without the top 'params' level) as the
    port's state_dict."""
    params = tree["params"] if "params" in tree else tree
    return {path.replace("/", "."): torch.from_numpy(np.array(v))
            for path, v in _flatten(params).items()}


def save_npz(path: str, tree: Mapping) -> None:
    """Write a flax tree's leaves under their '/'-joined paths."""
    np.savez(path, **_flatten(tree))


def load_npz(path: str) -> Dict:
    """Read a file written by `save_npz` back into a nested tree."""
    with np.load(path) as f:
        return _unflatten({k: f[k] for k in f.files})


def _orthogonal(rng: np.random.Generator, shape) -> np.ndarray:
    """flax.linen.initializers.orthogonal(column_axis=-1) for a 2-D shape."""
    n_rows, n_cols = shape
    a = rng.normal(size=(n_cols, n_rows) if n_rows < n_cols else (n_rows, n_cols))
    q, r = np.linalg.qr(a)
    q = q * np.sign(np.diag(r))
    return q.T if n_rows < n_cols else q


def random_params(model, seed: int) -> Dict:
    """A flax-layout tree for `model` (a SeqRecModel), drawn with numpy from
    `seed` with the flax initializers' distributions, in f32."""
    rng = np.random.default_rng(seed)
    params: Dict = {}
    tower: Dict = {}
    for name, p in model.named_parameters():
        shape = tuple(p.shape)
        leaf = name.split(".")[-1]
        if leaf.endswith("_embedding"):
            a = rng.normal(scale=1.0 / np.sqrt(shape[1]), size=shape)
        elif leaf.endswith("_wx"):
            limit = np.sqrt(6.0 / (shape[0] + shape[1]))
            a = rng.uniform(-limit, limit, size=shape)
        elif leaf.endswith("_wh"):
            a = _orthogonal(rng, shape)
        else:  # gru biases and output_bias
            a = np.zeros(shape)
        (tower if name.startswith("tower.") else params)[leaf] = a.astype(np.float32)
    if tower:
        params["tower"] = tower
    return {"params": params}
