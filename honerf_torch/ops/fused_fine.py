"""Trunk statements shared by the fused hand kernels; counterpart of the
block bodies of honerf_tpu.ops.fused_fine (`_kernel_fwd_body`,
`_trunk_bwd_block`).  Its own Pallas kernels (K5/K6) are not ported yet;
the fine pass (ops.fused_fine_full, K2 forward and K3 backward) runs
these statements as its plain version.

Trunk (9 weight-normed linear layers L0..L8, softplus beta=100 after
L0..L7, widened-input skip at l=4 scaled 1/sqrt2):

  forward:  in_l = concat(a_l, e)/sqrt2 at the skip else a_l;
            z_l = in_l @ W_l + b_l;  a_{l+1} = softplus(z_l)  (l < 8)
  u-chain:  u = d z_8[:, 0] / d e, downward l = 8..0:
            m_l = t_l @ W_l^T, t_8 = onehot(sdf column);
            c_l = m_l (skip: m_4[:, :H]/sqrt2, and m_4[:, H:]/sqrt2 adds
            into u);  t_{l-1} = c_l * s_{l-1},  s_l = sigmoid(beta z_l);
            u += c_0
  backward (cotangents dout on z_8, du on u): the u-chain transposed
            upward (dc_l = dt * s_{l-1}, ds_{l-1} = dt * c_l,
            dt = dm_l @ W_l, dW_l += dm_l^T t_l), then the forward
            transposed downward with the second-order term
            dz_l = da * s_l + ds_l * beta s_l (1 - s_l),
            dW_l += in_l^T dz_l, db_l = sum dz_l, din = dz_l @ W_l^T.

Padded layout (shared by the plain versions and the CUDA kernels): every
width is rounded up to PAD, a multiple of the CUDA GEMM's K step, with
zero weight rows and columns; the skip layer's rows are [hidden (Hp) | embedding (Ep)].
bf16 mode rounds every matmul operand to bf16 and accumulates in f32.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Tuple

import torch

PAD = 64
BETA = 100.0
INV_SQRT2 = 1.0 / math.sqrt(2.0)
# bf16(1/sqrt2): the skip scale a bf16 concat is multiplied by
INV_SQRT2_BF16 = 0.70703125


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


class TrunkMeta(NamedTuple):
    """Static trunk architecture.  dtype: 'bf16' (fast mode) or 'f32'."""

    emb_width: int          # E (unpadded), e.g. 1386
    d_hidden: int           # 256
    n_layers: int           # linear layers, e.g. 9
    skip: int               # skip layer index, e.g. 4
    d_out: int              # 257 (1 for the sdf-only ladder)
    dtype: str = "bf16"

    @property
    def Hp(self) -> int:
        return _round_up(self.d_hidden, PAD)

    @property
    def Ep(self) -> int:
        return _round_up(self.emb_width, PAD)

    @property
    def Op(self) -> int:
        return _round_up(self.d_out, PAD)


def _dims(meta: TrunkMeta) -> Tuple[Tuple[int, int], ...]:
    """(in, out) per layer, unpadded."""
    out = []
    for l in range(meta.n_layers):
        d_in = meta.emb_width if l == 0 else meta.d_hidden
        if l == meta.skip:
            d_in = meta.d_hidden + meta.emb_width
        d_out = meta.d_out if l == meta.n_layers - 1 else meta.d_hidden
        out.append((d_in, d_out))
    return tuple(out)


def _cast(meta: TrunkMeta) -> torch.dtype:
    return torch.bfloat16 if meta.dtype == "bf16" else torch.float32


def _pad_weights(ws, bs, meta: TrunkMeta):
    """(in, out) f32 weights -> zero-padded (in_pad, out_pad) weights in
    the trunk dtype and (out_pad,) f32 biases; skip rows [Hp | Ep]."""
    H, E = meta.d_hidden, meta.emb_width
    Hp, Ep = meta.Hp, meta.Ep
    wps, bps = [], []
    for l, ((d_in, d_out), w, b) in enumerate(zip(_dims(meta), ws, bs)):
        w = w[:, :d_out]
        op = _round_up(d_out, PAD)
        if l == meta.skip:
            wp = w.new_zeros((Hp + Ep, op))
            wp[:H, :d_out] = w[:H]
            wp[Hp:Hp + E, :d_out] = w[H:]
        else:
            wp = w.new_zeros((_round_up(d_in, PAD), op))
            wp[:d_in, :d_out] = w
        bp = b.new_zeros((op,))
        bp[:d_out] = b[:d_out]
        wps.append(wp.to(_cast(meta)).contiguous())
        bps.append(bp.float().contiguous())
    return tuple(wps), tuple(bps)


def _rnd(meta: TrunkMeta, x: torch.Tensor) -> torch.Tensor:
    """Round a matmul operand to the trunk dtype (kept in f32 storage)."""
    return x.to(torch.bfloat16).float() if meta.dtype == "bf16" else x.float()


def _mm(meta: TrunkMeta, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(B, in) @ (in, out), operands rounded to the trunk dtype, f32 sums."""
    return _rnd(meta, x) @ w.float()


def _mm_t(meta: TrunkMeta, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(B, out) @ (in, out)^T."""
    return _rnd(meta, x) @ w.float().T


def _mm_tn(meta: TrunkMeta, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(B, in)^T @ (B, out) -> (in, out): contract the point axis."""
    return _rnd(meta, x).T @ _rnd(meta, y)


def _softplus_beta(z: torch.Tensor) -> torch.Tensor:
    return torch.logaddexp(BETA * z, torch.zeros_like(z)) / BETA


def _skip_concat(meta: TrunkMeta, a: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    if meta.dtype == "bf16":
        return _rnd(meta, torch.cat([a, e], dim=-1) * INV_SQRT2_BF16)
    return torch.cat([a, e], dim=-1) * INV_SQRT2


def _kernel_fwd_body(meta: TrunkMeta, e: torch.Tensor, ws, bs, residuals: bool = False):
    """Forward + u-chain on one block: e (B, Ep) already in the trunk
    dtype's values.  Returns (z_last (B, Op), u (B, Ep), ss), and with
    `residuals` also the backward's (ins, ts, cs): each layer's input,
    the u-chain's t_l and c_l."""
    n, Hp = meta.n_layers, meta.Hp
    a = e
    ss: List[torch.Tensor] = []
    ins: List[torch.Tensor] = []
    z_last = None
    for l in range(n):
        x = _skip_concat(meta, a, e) if l == meta.skip else a
        ins.append(x)
        z = _mm(meta, x, ws[l]) + bs[l]
        if l < n - 1:
            ss.append(torch.sigmoid(BETA * z))
            a = _rnd(meta, _softplus_beta(z))
        else:
            z_last = z
    t = torch.zeros_like(z_last)
    t[:, 0] = 1.0
    ts: List[torch.Tensor] = [None] * n
    cs: List[torch.Tensor] = [None] * n
    ts[n - 1] = t
    u = None
    for l in range(n - 1, -1, -1):
        m = _mm_t(meta, ts[l], ws[l])
        if l == meta.skip:
            c = m[:, :Hp] * INV_SQRT2
            u = m[:, Hp:] * INV_SQRT2
        else:
            c = m
        cs[l] = c
        if l > 0:
            ts[l - 1] = c * ss[l - 1]
        else:
            u = u + c
    if residuals:
        return z_last, u, ss, ins, ts, cs
    return z_last, u, ss


def _trunk_bwd_block(meta: TrunkMeta, dout: torch.Tensor, du: torch.Tensor, ws, fwd,
                     want_dw: bool = True):
    """Transposed trunk statements for one block at cotangents dout
    (B, Op) on z_last and du (B, Ep) on u, given the forward's
    (ss, ins, ts, cs).  Returns (de (B, Ep), dws, dbs); want_dw=False
    (frozen nets) skips every dW = X^T dY product and the db sums and
    returns (de, None, None)."""
    n, Hp = meta.n_layers, meta.Hp
    ss, ins, ts, cs = fwd
    dws: List[torch.Tensor] = [None] * n
    dbs: List[torch.Tensor] = [None] * n
    ds: List[torch.Tensor] = [None] * (n - 1)
    # transpose of the u-chain, upward; the last dt would land on the
    # constant one-hot t_{n-1} and is not formed
    dt = None
    for l in range(n):
        if l > 0:
            dc = dt * ss[l - 1]
            ds[l - 1] = dt * cs[l]
        else:
            dc = du
        dm = torch.cat([dc * INV_SQRT2, du * INV_SQRT2], dim=-1) if l == meta.skip else dc
        if l < n - 1:
            dt = _mm(meta, dm, ws[l])
        if want_dw:
            dws[l] = _mm_tn(meta, dm, ts[l])    # m = t W^T: dW += dm^T t
    # transpose of the forward, downward
    dz = dout
    de = None
    din = None
    for l in range(n - 1, -1, -1):
        if l < n - 1:
            if l + 1 == meta.skip:
                da = din[:, :Hp] * INV_SQRT2
                de = din[:, Hp:] * INV_SQRT2
            else:
                da = din
            sig = ss[l]
            dz = da * sig + ds[l] * (BETA * sig * (1.0 - sig))
        if want_dw:
            dws[l] = dws[l] + _mm_tn(meta, ins[l], dz)
            dbs[l] = dz.sum(0)
        din = _mm_t(meta, dz, ws[l])
    de = din if de is None else de + din
    if not want_dw:
        return de, None, None
    return de, dws, dbs
