"""Checkpoints in the JAX package's flat-npz format, read with numpy only,
and JAX parameter trees and train states carried over to the port;
counterpart of honerf_tpu.train.checkpoints.

Files are `ckpt_{iter:06d}.npz` whose keys are '/'-joined tree paths
(`sdf/layers/0/v`); numeric path parts are list indices.
"""

from __future__ import annotations

import re
from typing import Any, Dict

import numpy as np
import torch

from honerf_torch.utils.device import resolve_device


def _unflatten(flat: Dict[str, np.ndarray]) -> Any:
    root: Dict[str, Any] = {}
    for key, val in flat.items():
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val

    def listify(node):
        if not isinstance(node, dict):
            return node
        keys = list(node.keys())
        if keys and all(re.fullmatch(r"\d+", k) for k in keys):
            return [listify(node[str(i)]) for i in range(len(keys))]
        return {k: listify(v) for k, v in node.items()}

    return listify(root)


def load_checkpoint(path: str) -> Dict[str, Any]:
    """The saved tree, with numpy leaves."""
    with np.load(path, allow_pickle=False) as z:
        flat = {k: z[k] for k in z.files}
    return _unflatten(flat)


def params_from_jax(tree: Any, device=None) -> Any:
    """The JAX package's parameter tree (numpy-convertible leaves) -> the
    port's tree of float32 tensors (same keys and nesting), on the card
    unless the caller passes device="cpu"."""
    device = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [conv(v) for v in node]
        arr = np.asarray(node)
        dtype = np.float32 if arr.dtype.kind == "f" else arr.dtype
        return torch.from_numpy(np.array(arr, dtype=dtype)).to(device)

    return conv(tree)


def _pairs(a, b):
    """Corresponding tensor leaves of two trees of one structure, walked
    by key (key order may differ between the trees)."""
    if isinstance(a, dict):
        return [pair for k in a for pair in _pairs(a[k], b[k])]
    if isinstance(a, (list, tuple)):
        return [pair for x, y in zip(a, b) for pair in _pairs(x, y)]
    return [(a, b)]


def train_state_from_jax(state: Any, tcfg, device=None) -> Dict[str, Any]:
    """A JAX train state {'params', 'opt_state', 'step'} (optax Adam with a
    learning-rate schedule) -> the port's {'params', 'opt', 'step'}: the
    params, and Adam's mu / nu / count as the optimizer's exp_avg /
    exp_avg_sq / step, so the next step continues the same run."""
    from honerf_torch.train.offline import init_train_state

    params = params_from_jax(state["params"], device)
    out = init_train_state(params, tcfg)
    adam = state["opt_state"][0]
    count = float(np.asarray(adam.count))
    mu, nu = params_from_jax(adam.mu, device), params_from_jax(adam.nu, device)
    for (p, m), (_p, v) in zip(_pairs(params, mu), _pairs(params, nu)):
        out["opt"].state[p] = {"step": torch.tensor(count, dtype=torch.float32),
                               "exp_avg": m, "exp_avg_sq": v}
    out["step"] = int(np.asarray(state["step"]))
    return out
