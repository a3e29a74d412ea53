"""Checkpoints in the JAX package's flat-npz format, with numpy only; JAX
parameter trees and train states carried over to the port and back; the
`.pth` zoo converter.  Counterpart of honerf_tpu.train.checkpoints.

Files are `ckpt_{iter:06d}.npz` under `<exp>/checkpoints/`, resumed by
lexicographic-latest, whose keys are '/'-joined tree paths
(`params/sdf/layers/0/v`); numeric path parts are list indices.  A train
state is stored as the JAX runner stores its own, {params, opt_state,
step, iter_step}, with optax's Adam-with-schedule state flattened by
position: opt_state/0/0 the Adam count, opt_state/0/1 and /0/2 the trees
of mu and nu, opt_state/1/0 the schedule's count.  So either runner
resumes from the other's checkpoints.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, Optional

import numpy as np
import torch

from honerf_torch.utils.device import resolve_device


def _map_tree(fn, tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_tree(fn, v) for v in tree]
    return fn(tree)


def _flatten(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    elif isinstance(tree, torch.Tensor):
        out[prefix[:-1]] = tree.detach().cpu().numpy()
    else:
        out[prefix[:-1]] = np.asarray(tree)
    return out


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


def save_checkpoint(path: str, tree: Dict[str, Any]) -> None:
    """Write the tree (tensor or numpy leaves) as flat npz, atomically:
    to a temporary file beside it, then renamed over the target."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    flat = _flatten(tree)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **flat)
    os.replace(tmp, path)


def load_checkpoint(path: str) -> Dict[str, Any]:
    """The saved tree, with numpy leaves."""
    with np.load(path, allow_pickle=False) as z:
        flat = {k: z[k] for k in z.files}
    return _unflatten(flat)


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    """The lexicographically latest `ckpt_*.npz` of a directory, or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    names = sorted(n for n in os.listdir(ckpt_dir)
                   if n.endswith(".npz") and n.startswith("ckpt_"))
    return os.path.join(ckpt_dir, names[-1]) if names else None


def params_from_jax(tree: Any, device=None) -> Any:
    """The JAX package's parameter tree (numpy-convertible leaves) -> the
    port's tree of float32 tensors (same keys and nesting), on the card
    unless the caller passes device="cpu"."""
    device = resolve_device(device)

    def conv(leaf):
        arr = np.asarray(leaf)
        dtype = np.float32 if arr.dtype.kind == "f" else arr.dtype
        return torch.from_numpy(np.array(arr, dtype=dtype)).to(device)

    return _map_tree(conv, tree)


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
    learning-rate schedule), live or as load_checkpoint reads it -> the
    port's {'params', 'opt', 'step'}: the params, and Adam's mu / nu /
    count as the optimizer's exp_avg / exp_avg_sq / step, so the next step
    continues the same run."""
    from honerf_torch.train.offline import init_train_state

    params = params_from_jax(state["params"], device)
    out = init_train_state(params, tcfg)
    count, mu, nu = state["opt_state"][0][:3]  # ScaleByAdamState(count, mu, nu)
    count = float(np.asarray(count))
    mu, nu = params_from_jax(mu, device), params_from_jax(nu, device)
    for (p, m), (_p, v) in zip(_pairs(params, mu), _pairs(params, nu)):
        out["opt"].state[p] = {"step": torch.tensor(count, dtype=torch.float32),
                               "exp_avg": m, "exp_avg_sq": v}
    out["step"] = int(np.asarray(state["step"]))
    return out


def train_state_to_jax(state: Dict[str, Any]) -> Dict[str, Any]:
    """The port's {'params', 'opt', 'step'} -> the JAX runner's tree
    {'params', 'opt_state', 'step'} with numpy leaves; an optimizer that
    has not stepped has zero moments and count 0, as optax.adam's init."""
    opt_state = state["opt"].state
    to_np = lambda t: t.detach().cpu().numpy()  # noqa: E731

    def moment(key):
        return _map_tree(lambda p: to_np(opt_state[p][key]) if p in opt_state
                         else np.zeros(tuple(p.shape), np.float32), state["params"])

    counts = [float(st["step"]) for st in opt_state.values()]
    count = np.int32(counts[0] if counts else 0)
    step = np.int32(state["step"])
    return {"params": _map_tree(to_np, state["params"]),
            "opt_state": ((count, moment("exp_avg"), moment("exp_avg_sq")), (step,)),
            "step": step}


# ---------------------------------------------------------------------------
# .pth (reference torch checkpoints) -> the parameter tree
# ---------------------------------------------------------------------------

def convert_torch_state_dict(state: Dict[str, Any]) -> Dict[str, Any]:
    """A reference network state_dict (linN.weight_v / weight_g / bias, or
    plain linN.weight) -> {'layers': [{v, g, b} ...]} with numpy leaves;
    `se3_refine` and `variance` come along under their own keys."""
    def np_(t):
        return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)

    layer_ids = sorted({int(m.group(1)) for k in state for m in [re.match(r"lin(\d+)\.", k)]
                        if m})
    layers = []
    for l in layer_ids:
        pre = f"lin{l}."
        if pre + "weight_v" in state:
            layers.append({"v": np_(state[pre + "weight_v"]),
                           "g": np_(state[pre + "weight_g"]).reshape(-1),
                           "b": np_(state[pre + "bias"])})
        else:
            layers.append({"w": np_(state[pre + "weight"]), "b": np_(state[pre + "bias"])})
    out: Dict[str, Any] = {"layers": layers}
    for key in ("se3_refine", "variance"):
        if key in state:
            out[key] = np_(state[key])
    return out


def load_torch_checkpoint(path: str) -> Dict[str, Any]:
    """A reference `ckpt_XXXXXX.pth` -> {'iter_step', 'sdf', 'color',
    'variance' (and 'se3_refine')} in the parameter tree's layout, numpy
    leaves (params_from_jax makes them tensors)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    out: Dict[str, Any] = {"iter_step": int(ckpt.get("iter_step", 0))}
    sdf_tree = convert_torch_state_dict(ckpt["sdf_network_fine"])
    out["sdf"] = {"layers": sdf_tree["layers"]}
    if "se3_refine" in sdf_tree:
        out["se3_refine"] = sdf_tree["se3_refine"]
    out["color"] = {"layers": convert_torch_state_dict(ckpt["color_network_fine"])["layers"]}
    out["variance"] = {"variance": ckpt["variance_network_fine"]["variance"].numpy()}
    return out
