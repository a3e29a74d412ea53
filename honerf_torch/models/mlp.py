"""Linear layers with explicit (v, g, b) weight norm; counterpart of
honerf_tpu.models.mlp.

Parameters are plain dicts of tensors, the same tree as the JAX package's
pytrees, so a JAX checkpoint maps onto them key for key.  w = g v / |v|_row
is torch.nn.utils.weight_norm(dim=0) written out.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch

Params = Dict[str, torch.Tensor]


def init_linear(
    generator: Optional[torch.Generator],
    d_in: int,
    d_out: int,
    weight_norm: bool = True,
    w_init: Optional[torch.Tensor] = None,
    b_init: Optional[torch.Tensor] = None,
    device: torch.device = torch.device("cpu"),
) -> Params:
    """A layer's parameters; w_init (d_out, d_in) overrides the
    torch.nn.Linear fan-in uniform init."""
    if w_init is None:
        bound = 1.0 / math.sqrt(d_in)
        w_init = (torch.rand((d_out, d_in), generator=generator) * 2 - 1) * bound
        if b_init is None:
            b_init = (torch.rand((d_out,), generator=generator) * 2 - 1) * bound
    if b_init is None:
        b_init = torch.zeros((d_out,))
    w_init, b_init = w_init.to(device), b_init.to(device)
    if weight_norm:
        return {"v": w_init, "g": torch.linalg.norm(w_init, dim=1), "b": b_init}
    return {"w": w_init, "b": b_init}


def linear_weight(p: Params) -> torch.Tensor:
    """The effective (d_out, d_in) weight."""
    if "v" in p:
        v = p["v"]
        return p["g"][:, None] * v / torch.linalg.norm(v, dim=1, keepdim=True)
    return p["w"]


def apply_linear(p: Params, x: torch.Tensor) -> torch.Tensor:
    return x @ linear_weight(p).T + p["b"]


def softplus_beta(x: torch.Tensor, beta: float = 100.0) -> torch.Tensor:
    """Softplus(beta) as logaddexp(beta x, 0)/beta: no threshold switch,
    the same numerics as the JAX package."""
    return torch.logaddexp(beta * x, torch.zeros_like(x)) / beta


def geometric_init_weights(
    generator: Optional[torch.Generator],
    dims: Sequence[int],
    skip_in: Tuple[int, ...],
    bias: float,
    inside_outside: bool,
    skip_style: str,
) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """IDR/NeuS geometric init, with the reference's quirk of treating the
    first 3 input channels as raw xyz.  widen_input: in = dims[l] + dims[0]
    at a skip layer; shrink_output: out = dims[l+1] - dims[0] before it."""
    n_layers = len(dims)
    out = []
    for l in range(n_layers - 1):
        if skip_style == "widen_input":
            in_dim = dims[l] + dims[0] if l in skip_in else dims[l]
            out_dim = dims[l + 1]
        else:
            in_dim = dims[l]
            out_dim = dims[l + 1] - dims[0] if (l + 1) in skip_in else dims[l + 1]
        normal = lambda shape: torch.randn(shape, generator=generator)  # noqa: E731
        if l == n_layers - 2:
            mean = math.sqrt(math.pi) / math.sqrt(in_dim)
            if inside_outside:
                mean = -mean
            w = mean + 0.0001 * normal((out_dim, in_dim))
            b = torch.full((out_dim,), bias if inside_outside else -bias)
        elif l == 0:
            w = torch.zeros((out_dim, in_dim))
            w[:, :3] = math.sqrt(2.0) / math.sqrt(out_dim) * normal((out_dim, 3))
            b = torch.zeros((out_dim,))
        elif l in skip_in:
            w = math.sqrt(2.0) / math.sqrt(out_dim) * normal((out_dim, in_dim))
            w[:, -(dims[0] - 3):] = 0.0
            b = torch.zeros((out_dim,))
        else:
            w = math.sqrt(2.0) / math.sqrt(out_dim) * normal((out_dim, in_dim))
            b = torch.zeros((out_dim,))
        out.append((w, b))
    return out
