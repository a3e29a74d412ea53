"""Color-fused hand fine pass, forward and backward; counterpart of
honerf_tpu.ops.fused_fine_full (`hand_fine_color`, whose Pallas kernels
are `_fwd_call` -> `_fine_fwd_block` and `_bwd_call` -> `_fine_bwd_block`).

Forward, per point:
  embedding stages -> e (1386 channels, channel-major)
  trunk forward -> z (sdf + 256 features);  u-chain u = d sdf / d e
  embedding REVERSE chain with cotangent u -> g = d sdf / d p
  grad-PE (L=4) -> 5-layer relu color net + sigmoid on [e | feat | g | PE(g)]
and returns (sdf (N,), g (N, 3), color (N, 3)).

Backward at cotangents (dsdf, dg, dcolor), with the forward recomputed:
  color net transposed -> the e, feature and grad-PE cotangents;
  grad-PE transposed into dg;  the reverse chain transposed at dg -> du
  (the cotangent of u) and the second-order stage adjoints;  the trunk
  backward at (dout = [dsdf | dfeat], du) -> de and every dW/db;  the
  embedding forward transposed -> dq, hence dp = dq rotT^T,
  drotT = dg^T f_q + p^T dq, doff = sum dq.

Kernel layout of the color input (kernel rows, zero weight rows on pads):
[e (Ep) | feat (Fp) | grad-PE 8-wide blocks [g | sin_l | cos_l] (Gp)];
`color_row_map` maps it onto the reference color-input rows.

Entry points:
  * `hand_fine_color(pts, rotT, off, cut, ws, bs, cws, cbs, meta)`: the
    differentiable op (torch.autograd.Function) on the unpadded (in, out)
    weights; it packs them in its forward and recomputes the forward in its
    backward.  Weights that need no gradient launch no dW work.
  * `hand_fine_color_fwd(pts, rotT, off, cut, pack)` and
    `hand_fine_color_bwd(...)`: the forward and the backward on a FinePack
    made once per parameter snapshot (the eval render, the tests).
One flag selects the mode: `FineMeta.with_color` of the meta (and so of
the pack).  False is JAX's `hand_fine_full`: no color net (cws = cbs =
()), outputs (out (N, d_out), g (N, 3), e (N, E)), e the embedding rounded
to the trunk dtype, and cotangents on all three.  The same kernels run
without their color launches; the cotangents on e and on the features
enter where the color net's input cotangent entered.
On CUDA tensors the forward launches csrc/fused_fine_full.cu (K2) and the
backward csrc/fused_fine_bwd.cu (K3): every mode, with or without the
color net and weight gradients, on a bf16 or an f32 trunk
(`FineMeta.dtype`; the confs' trunks are f32 as written); the color net
runs as two launches, its forward and its transpose: csrc/color_fused.cu
in bf16 (`color_fwd`, `color_bwd`), csrc/color_fused_f32.cu in f32
(`color_fwd_f32`, `color_bwd_f32`); on CPU tensors both run their plain
versions (`hand_fine_color_plain`, `hand_fine_color_plain_bwd`) in either
dtype.

What bounds the kernels on an H100 and how their design answers that:
the notes at the top of the two .cu files; their times: PERF.md.
"""

from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Tuple

import numpy as np
import torch

from honerf_torch.models.embedding import CUTOFF_TAU
from honerf_torch.ops import _build
from honerf_torch.ops import fused_fine as FT
from honerf_torch.ops import fused_hand as FH
from honerf_torch.ops import perpoint_layout as PL
from honerf_torch.ops.fused_fine import (_WS_FLOATS, PAD, _colsum, _round_up, _tn,  # noqa: F401
                                         chunk_size)

# points per pass of the CUDA forward: the per-point scratch is ~23 KB
# (e, sigmoid rows, u, activations), so a chunk holds ~1.5 GB
CHUNK = 65536
# points per pass of the CUDA backward: it keeps every activation, t and
# c row of the forward besides the cotangents, ~77 KB/pt (~5 GB a chunk)
BWD_CHUNK = 65536
# the f32 mode's passes take at most half as many points (chunk_size)

KERNEL = _build.Kernel(
    "hand_fine_color_fwd", "honerf_torch/ops/csrc/fused_fine_full.cu",
    "honerf_tpu/ops/fused_fine_full.py:1556")
KERNEL_BWD = _build.Kernel(
    "hand_fine_color_bwd", "honerf_torch/ops/csrc/fused_fine_bwd.cu",
    "honerf_tpu/ops/fused_fine_full.py:1650")
# K3's reverse-chain transpose (du, dg_total and the top cotangent), inside
# its pallas_call's body (_fine_bwd_block)
BWDREV = _build.Kernel(
    "fine_bwd_rev_kernel", "honerf_torch/ops/csrc/fused_fine_bwd.cu",
    "honerf_tpu/ops/fused_fine_full.py:1650")
# K3's pose sums drotT / doff (drotT_blk / doff_blk inside its pallas_call's
# body, summed over its grid)
POSE = _build.Kernel(
    "pose_sum_kernel", "honerf_torch/ops/csrc/fused_fine_bwd.cu",
    "honerf_tpu/ops/fused_fine_full.py:1650")
# The color net in two launches (csrc/color_fused.cu in bf16,
# csrc/color_fused_f32.cu in f32): the mode of `_color_fwd_block` inside
# K2's pallas_call (and K3's recompute), and of `_color_bwd_block` inside
# K3's
COLOR_FWD = _build.Kernel(
    "color_fwd_kernel", "honerf_torch/ops/csrc/color_fused.cu",
    "honerf_tpu/ops/fused_fine_full.py:1556")
COLOR_BWD = _build.Kernel(
    "color_bwd_kernel", "honerf_torch/ops/csrc/color_fused.cu",
    "honerf_tpu/ops/fused_fine_full.py:1650")
COLOR_FWD_F32 = _build.Kernel(
    "color_fwd_f32_kernel", "honerf_torch/ops/csrc/color_fused_f32.cu",
    "honerf_tpu/ops/fused_fine_full.py:1556")
COLOR_BWD_F32 = _build.Kernel(
    "color_bwd_f32_kernel", "honerf_torch/ops/csrc/color_fused_f32.cu",
    "honerf_tpu/ops/fused_fine_full.py:1650")
# the color transpose's seed dz = s (1 - s) dcolor, inside K3's
# pallas_call's body: the split launches' only (_color_bwd_split), which no
# main path runs
COLOR_DZ = _build.Kernel(
    "color_dz_kernel", "honerf_torch/ops/csrc/fused_fine_bwd.cu",
    "honerf_tpu/ops/fused_fine_full.py:1650")


class FineMeta(NamedTuple):
    """Static architecture of the fused fine pass.  with_color: the color
    net is part of the op; False: JAX's hand_fine_full, whose c_* fields
    are not read."""

    v_multires: int         # 10
    r_multires: int         # 7
    d_hidden: int           # 256
    n_layers: int           # 9 linear layers
    skip: int               # 4
    d_out: int              # 257
    dtype: str = "bf16"     # 'bf16' / 'f32' (the fitting stage's trunks)
    c_hidden: int = 256
    c_layers: int = 5       # linear layers of the color net
    grad_L: int = 4         # grad-PE frequencies
    with_color: bool = True

    @property
    def emb_width(self) -> int:
        return 21 * (1 + 2 * self.v_multires) + 63 * (1 + 2 * self.r_multires)

    @property
    def trunk_meta(self) -> FT.TrunkMeta:
        return FT.TrunkMeta(emb_width=self.emb_width, d_hidden=self.d_hidden,
                            n_layers=self.n_layers, skip=self.skip, d_out=self.d_out,
                            dtype=self.dtype)

    @property
    def gpe_blocks(self) -> int:
        return 1 + 2 * self.grad_L

    @property
    def Fp(self) -> int:
        return _round_up(self.d_out - 1, PAD)

    @property
    def Gp(self) -> int:
        return _round_up(8 * self.gpe_blocks, PAD)

    @property
    def color_in(self) -> int:
        """Kernel width of the color input [e | feat | grad-PE]."""
        return self.trunk_meta.Ep + self.Fp + self.Gp

    @property
    def color_dims(self) -> Tuple[Tuple[int, int], ...]:
        """(in, out) per color layer, kernel layout, unpadded outputs."""
        dims = []
        d_in = self.color_in
        for l in range(self.c_layers):
            d_o = 3 if l == self.c_layers - 1 else self.c_hidden
            dims.append((d_in, d_o))
            d_in = _round_up(d_o, PAD)
        return tuple(dims)


class FinePack(NamedTuple):
    """Padded weights of one parameter snapshot.  wts / cwts are the
    transposed trunk / color weights the CUDA u-chain and backward read
    (None on the CPU)."""

    ws: Tuple[torch.Tensor, ...]
    bs: Tuple[torch.Tensor, ...]
    cws: Tuple[torch.Tensor, ...]
    cbs: Tuple[torch.Tensor, ...]
    wts: object
    cwts: object
    meta: FineMeta


class FineGrads(NamedTuple):
    """The backward's outputs in kernel layout: dp (N, 3), drotT (8, 128),
    doff (1, 128), and f32 dW/db of the padded trunk and color layers
    (None when no weight gradient was asked; dcws / dcbs None without
    the color net)."""

    dp: torch.Tensor
    drotT: torch.Tensor
    doff: torch.Tensor
    dws: object
    dbs: object
    dcws: object
    dcbs: object


def color_row_map(meta: FineMeta) -> np.ndarray:
    """Kernel color-input rows -> reference color-input rows (after the
    channel-major e gather), -1 for zero rows.  The reference input is
    [e (E) | feat (F) | g (3) | PE(g): per channel sin f0..fL-1, cos ..]."""
    E, F, L = meta.emb_width, meta.d_out - 1, meta.grad_L
    Ep = meta.trunk_meta.Ep
    rows = list(range(E)) + [-1] * (Ep - E)
    rows += list(range(E, E + F)) + [-1] * (meta.Fp - F)
    gbase = E + F
    for blk in range(meta.gpe_blocks):
        for ch in range(8):
            if ch >= 3:
                rows.append(-1)
            elif blk == 0:
                rows.append(gbase + ch)
            else:
                t = 0 if blk - 1 < L else 1
                l = (blk - 1) % L
                rows.append(gbase + 3 + ch * 2 * L + t * L + l)
    rows += [-1] * (meta.Gp - 8 * meta.gpe_blocks)
    return np.asarray(rows)


def _pad_color_weights(cws, cbs, meta: FineMeta):
    """Color weights in kernel layout: layer 0 rows by color_row_map, all
    widths padded to PAD, trunk dtype weights, f32 biases."""
    cast = FT._cast(meta.trunk_meta)
    rows = torch.as_tensor(color_row_map(meta), device=cws[0].device)
    w0 = cws[0]
    w0_ext = torch.cat([w0, w0.new_zeros((1, w0.shape[1]))], dim=0)
    first = w0_ext[torch.where(rows < 0, w0.shape[0], rows)]
    wps, bps = [], []
    for l, ((d_in, d_out), w, b) in enumerate(zip(meta.color_dims, cws, cbs)):
        if l == 0:
            w = first
        op = _round_up(d_out, PAD)
        wp = w.new_zeros((d_in, op))
        wp[:w.shape[0], :d_out] = w
        bp = b.new_zeros((op,))
        bp[:d_out] = b
        wps.append(wp.to(cast).contiguous())
        bps.append(bp.float().contiguous())
    return tuple(wps), tuple(bps)


def pack_fine_weights(ws, bs, cws, cbs, meta: FineMeta) -> FinePack:
    """(in, out) f32 trunk and color weights (channel-major e columns) ->
    FinePack for hand_fine_color_fwd / _bwd; without meta.with_color the
    color weights are not read (pass ())."""
    tm = meta.trunk_meta
    assert 0 < tm.skip < tm.n_layers - 1
    with torch.no_grad():
        wps, bps = FT._pad_weights(ws, bs, tm)
        cwps, cbps = _pad_color_weights(cws, cbs, meta) if meta.with_color else ((), ())
        on_card = wps[0].device.type == "cuda"
        wts = tuple(w.T.contiguous() for w in wps) if on_card else None
        cwts = tuple(w.T.contiguous() for w in cwps) if on_card else None
    return FinePack(wps, bps, cwps, cbps, wts, cwts, meta)


# ---------------------------------------------------------------------------
# Plain PyTorch version (the kernels' statements)
# ---------------------------------------------------------------------------

def _S(x: torch.Tensor) -> torch.Tensor:
    """(B, 63) -> (B, 21): sum each bone's three channels."""
    return x.reshape(x.shape[0], 21, 3).sum(-1)


def _ST(x: torch.Tensor) -> torch.Tensor:
    """(B, 21) -> (B, 63): repeat each bone's value on its channels."""
    return torch.repeat_interleave(x, 3, dim=-1)


def _emb_fwd_block(p, rotT, off, cut, meta: FineMeta):
    """Embedding stages; PE values stay f32 (only e is cast, by the
    trunk), e is the (B, E) channel-major embedding."""
    st = FH._emb_stages(p, rotT, off, cut)
    pe = {}
    for name, x, L in (("v", st["v"], meta.v_multires), ("r", st["rr"], meta.r_multires)):
        s, c = torch.sin(x), torch.cos(x)
        ss, cc = [], []
        for l in range(L):
            if l:
                s, c = 2.0 * s * c, (c - s) * (c + s)
            ss.append(s)
            cc.append(c)
        pe["s" + name], pe["c" + name] = ss, cc
    h, h3 = st["h"], st["h3"]
    pieces = [st["v"] * h] + [s * h for s in pe["sv"]] + [c * h for c in pe["cv"]]
    pieces += [st["rr"] * h3] + [s * h3 for s in pe["sr"]] + [c * h3 for c in pe["cr"]]
    st.update(pe, e=torch.cat(pieces, dim=-1))
    return st


def _split_u(u, meta: FineMeta):
    """Per-piece views of a (B, E) embedding cotangent."""
    vL, rL = meta.v_multires, meta.r_multires
    widths = [21] * (1 + 2 * vL) + [63] * (1 + 2 * rL)
    out, pos = [], 0
    for w in widths:
        out.append(u[:, pos:pos + w])
        pos += w
    return (out[0], out[1:1 + vL], out[1 + vL:1 + 2 * vL], out[1 + 2 * vL],
            out[2 + 2 * vL:2 + 2 * vL + rL], out[2 + 2 * vL + rL:])


def _rev_tail(st, rotT, phi_v, a_v, b_h, phi_r, c_rr, d_h3):
    """R5-R12 of the reverse chain -> (g (B, 3), the chain values its
    transpose reads)."""
    b_h = b_h + _S(d_h3)                                    # R5
    f_q = c_rr * st["w3"]                                   # R6
    m_vrep = -0.5 * c_rr * st["q"] * st["w3"] ** 3          # R7
    n_v2p = _S(m_vrep)                                      # R8
    a_v = a_v - CUTOFF_TAU * st["sc"] * (1.0 - st["sc"]) * b_h  # R9
    n_v2p = n_v2p + 0.5 * a_v / st["v"]                     # R10
    f_q = f_q + 2.0 * st["q"] * _ST(n_v2p)                  # R11
    g = f_q @ rotT[:3, :63].T                               # R12
    return g, dict(phi_v=phi_v, a_v=a_v, b_h=b_h, phi_r=phi_r, c_rr=c_rr, f_q=f_q,
                   n_v2p=n_v2p)


def _emb_rev_block(st, rotT, u, meta: FineMeta):
    """Reverse chain: cotangent u on e -> (g = (d e / d p)^T u (B, 3),
    chain values)."""
    vL, rL = meta.v_multires, meta.r_multires
    u_vh, u_sv, u_cv, u_rh, u_sr, u_cr = _split_u(u, meta)
    sv, cv, sr, cr = st["sv"], st["cv"], st["sr"], st["cr"]
    phi_v = u_vh + sum((2.0 ** l) * (cv[l] * u_sv[l] - sv[l] * u_cv[l]) for l in range(vL))
    a_v = st["h"] * phi_v
    b_h = st["v"] * u_vh + sum(sv[l] * u_sv[l] + cv[l] * u_cv[l] for l in range(vL))
    phi_r = u_rh + sum((2.0 ** l) * (cr[l] * u_sr[l] - sr[l] * u_cr[l]) for l in range(rL))
    c_rr = st["h3"] * phi_r
    d_h3 = st["rr"] * u_rh + sum(sr[l] * u_sr[l] + cr[l] * u_cr[l] for l in range(rL))
    return _rev_tail(st, rotT, phi_v, a_v, b_h, phi_r, c_rr, d_h3)


def _gpe_block(meta: FineMeta, g3):
    """Kernel-layout grad(+PE) section (B, Gp): 8-wide blocks
    [g | sin(2^l g)_l | cos(2^l g)_l] of g padded to 8 channels."""
    g8 = torch.nn.functional.pad(g3, (0, 5))
    pieces = [g8] + [torch.sin(g8 * 2.0 ** l) for l in range(meta.grad_L)]
    pieces += [torch.cos(g8 * 2.0 ** l) for l in range(meta.grad_L)]
    x = torch.cat(pieces, dim=-1)
    return torch.nn.functional.pad(x, (0, meta.Gp - x.shape[1]))


def _gpe_transpose(meta: FineMeta, g3, dgpe):
    """Transpose of _gpe_block: cotangent on the (B, Gp) section -> on g."""
    L = meta.grad_L
    dg = dgpe[:, :3]
    for l in range(L):
        f = 2.0 ** l
        ds = dgpe[:, (1 + l) * 8:(1 + l) * 8 + 3]
        dc = dgpe[:, (1 + L + l) * 8:(1 + L + l) * 8 + 3]
        dg = dg + f * (torch.cos(g3 * f) * ds - torch.sin(g3 * f) * dc)
    return dg


def _color_fwd_block(meta: FineMeta, x, cws, cbs, residuals: bool = False):
    """Color MLP on the kernel-layout input -> color (B, 3) [, each
    layer's pre-activation and (rounded) input]."""
    tm = meta.trunk_meta
    a = FT._rnd(tm, x)
    zs, acts = [], [a]
    for l in range(meta.c_layers):
        z = FT._mm(tm, a, cws[l]) + cbs[l]
        zs.append(z)
        if l < meta.c_layers - 1:
            a = FT._rnd(tm, torch.relu(z))
            acts.append(a)
    color = torch.sigmoid(z[:, :3])
    return (color, zs, acts) if residuals else color


def _color_transpose(meta: FineMeta, dz, masks, cws):
    """The color MLP transposed from the last layer's cotangent dz (B,
    out_pad) -> (dx, [dz_0 .. dz_{n-1}]): da = dz cW_l^T, masked by
    masks[l - 1] (the relu of layer l's input) for l > 0."""
    tm = meta.trunk_meta
    dzs: List[torch.Tensor] = [None] * meta.c_layers
    for l in range(meta.c_layers - 1, -1, -1):
        dzs[l] = dz
        da = FT._mm_t(tm, dz, cws[l])
        if l > 0:
            dz = torch.where(masks[l - 1], da, torch.zeros_like(da))
    return da, dzs


def _color_bwd_block(meta: FineMeta, color, acts, cws, dcolor, want_dw: bool):
    """Transpose of the color MLP at cotangent dcolor (B, 3) in JAX's
    res_stash form: the forward's sigmoid `color` (B, 3) read back, the
    relu masks from its kept activations acts = [x, a_1 .. a_{n-1}] (a_l >
    0; x, the rounded input, is read only for dW) -> (dx, dcws, dcbs, [dz_0
    .. dz_{n-1}]); want_dw=False skips the weight gradients."""
    tm = meta.trunk_meta
    n = meta.c_layers
    pad = cws[-1].shape[1] - 3
    s = torch.nn.functional.pad(color, (0, pad))
    dz = s * (1.0 - s) * torch.nn.functional.pad(dcolor, (0, pad))
    dx, dzs = _color_transpose(meta, dz, [a > 0.0 for a in acts[1:n]], cws)
    if not want_dw:
        return dx, [None] * n, [None] * n, dzs
    return (dx, [FT._mm_tn(tm, acts[l], dzs[l]) for l in range(n)],
            [dzs[l].sum(0) for l in range(n)], dzs)


def _transpose_head(st, ch, rotT, t3):
    """T12-T5 of the reverse-chain transpose at cotangent t3 (B, 3) on g:
    the family cotangents (ca on a_v, cb on b_h, cc on c_rr, cd on d_h3),
    the direct stage adjoints (dq, dv, dsc, dw3) and drotT's
    g = f_q rotT^T term (3, 63)."""
    v, q, sc, w3 = st["v"], st["q"], st["sc"], st["w3"]
    cf = t3 @ rotT[:3, :63]                              # T12
    drotT = t3.T @ ch["f_q"]
    cn = _S(2.0 * q * cf)                                # T11
    dq = 2.0 * _ST(ch["n_v2p"]) * cf
    ca = 0.5 * cn / v                                    # T10
    dv = -0.5 * ch["a_v"] / (v * v) * cn
    cb = -CUTOFF_TAU * sc * (1.0 - sc) * ca              # T9
    dsc = -CUTOFF_TAU * (1.0 - 2.0 * sc) * ch["b_h"] * ca
    cm = _ST(cn)                                         # T8
    cc = -0.5 * q * w3 ** 3 * cm                         # T7
    dq = dq - 0.5 * ch["c_rr"] * w3 ** 3 * cm
    dw3 = -1.5 * ch["c_rr"] * q * w3 ** 2 * cm
    cc = cc + w3 * cf                                    # T6
    dw3 = dw3 + ch["c_rr"] * cf
    cd = _ST(cb)                                         # T5
    return dict(drotT=drotT, dq=dq, dv=dv, dsc=dsc, dw3=dw3, ca=ca, cb=cb, cc=cc, cd=cd)


def _emb_rev_transpose_block(st, ch, rotT, u, t3, meta: FineMeta):
    """Transpose of the reverse chain w.r.t. (u, stages, rotT) at
    cotangent t3 on g -> (du (B, E), stage adjoints, drotT term)."""
    vL, rL = meta.v_multires, meta.r_multires
    sv, cv, sr, cr = st["sv"], st["cv"], st["sr"], st["cr"]
    h, v, rr, h3 = st["h"], st["v"], st["rr"], st["h3"]
    u_vh, u_sv, u_cv, u_rh, u_sr, u_cr = _split_u(u, meta)
    hd = _transpose_head(st, ch, rotT, t3)
    ca, cb, cc, cd = hd["ca"], hd["cb"], hd["cc"], hd["cd"]
    # T4: d = rr u_rh + sum(sr u_sr + cr u_cr)
    cu_rh = rr * cd
    drr = u_rh * cd
    dsr = [u_sr[l] * cd for l in range(rL)]
    dcr = [u_cr[l] * cd for l in range(rL)]
    cu_sr = [sr[l] * cd for l in range(rL)]
    cu_cr = [cr[l] * cd for l in range(rL)]
    # T3: c = h3 phi_r
    dh3 = ch["phi_r"] * cc
    hc = h3 * cc
    cu_rh = cu_rh + hc
    for l in range(rL):
        f = 2.0 ** l
        cu_sr[l] = cu_sr[l] + f * cr[l] * hc
        cu_cr[l] = cu_cr[l] - f * sr[l] * hc
        dcr[l] = dcr[l] + f * u_sr[l] * hc
        dsr[l] = dsr[l] - f * u_cr[l] * hc
    # T2: b = v u_vh + sum(sv u_sv + cv u_cv)
    cu_vh = v * cb
    dv = hd["dv"] + u_vh * cb
    dsv = [u_sv[l] * cb for l in range(vL)]
    dcv = [u_cv[l] * cb for l in range(vL)]
    cu_sv = [sv[l] * cb for l in range(vL)]
    cu_cv = [cv[l] * cb for l in range(vL)]
    # T1: a = h phi_v
    dh = ch["phi_v"] * ca
    hca = h * ca
    cu_vh = cu_vh + hca
    for l in range(vL):
        f = 2.0 ** l
        cu_sv[l] = cu_sv[l] + f * cv[l] * hca
        cu_cv[l] = cu_cv[l] - f * sv[l] * hca
        dcv[l] = dcv[l] + f * u_sv[l] * hca
        dsv[l] = dsv[l] - f * u_cv[l] * hca
    du = torch.cat([cu_vh] + cu_sv + cu_cv + [cu_rh] + cu_sr + cu_cr, dim=-1)
    adj = dict(dq=hd["dq"], dv=dv, dsc=hd["dsc"], dw3=hd["dw3"], drr=drr, dh=dh, dh3=dh3,
               dsv=dsv, dcv=dcv, dsr=dsr, dcr=dcr)
    return du, adj, hd["drotT"]


def _emb_fwd_transpose_block(st, de, adj, meta: FineMeta):
    """Transpose of the embedding forward at cotangent de (B, E), merged
    with the reverse-chain transpose's stage adjoints -> dq (B, 63)."""
    vL, rL = meta.v_multires, meta.r_multires
    sv, cv, sr, cr = st["sv"], st["cv"], st["sr"], st["cr"]
    h, v, rr, h3 = st["h"], st["v"], st["rr"], st["h3"]
    e_vh, e_sv, e_cv, e_rh, e_sr, e_cr = _split_u(de, meta)
    # e pieces: X * gate (gate h for the v family, h3 for the r family)
    dv = adj["dv"] + h * e_vh
    dh = adj["dh"] + v * e_vh
    dsv = [adj["dsv"][l] + h * e_sv[l] for l in range(vL)]
    dcv = [adj["dcv"][l] + h * e_cv[l] for l in range(vL)]
    dh = dh + sum(sv[l] * e_sv[l] + cv[l] * e_cv[l] for l in range(vL))
    drr = adj["drr"] + h3 * e_rh
    dh3 = adj["dh3"] + rr * e_rh
    dsr = [adj["dsr"][l] + h3 * e_sr[l] for l in range(rL)]
    dcr = [adj["dcr"][l] + h3 * e_cr[l] for l in range(rL)]
    dh3 = dh3 + sum(sr[l] * e_sr[l] + cr[l] * e_cr[l] for l in range(rL))
    # PE transposes: d sin(2^l x)/dx = 2^l cos(2^l x), d cos/dx = -2^l sin
    for l in range(vL):
        dv = dv + (2.0 ** l) * (cv[l] * dsv[l] - sv[l] * dcv[l])
    for l in range(rL):
        drr = drr + (2.0 ** l) * (cr[l] * dsr[l] - sr[l] * dcr[l])
    # stage tail
    q, sc, w3 = st["q"], st["sc"], st["w3"]
    dh = dh + _S(dh3)                                    # h3 = repeat(h)
    dq = adj["dq"] + w3 * drr                            # rr = q w3
    dw3 = adj["dw3"] + q * drr
    dv2p = _S(-0.5 * w3 ** 3 * dw3)                      # w3 = rsqrt(v2p + eps)
    dsc = adj["dsc"] - dh                                # h = 1 - sc
    dv = dv + CUTOFF_TAU * sc * (1.0 - sc) * dsc         # sc = sigmoid(tau (v - cut))
    dv2p = dv2p + 0.5 * dv / v                           # v = sqrt(v2p)
    return dq + 2.0 * q * _ST(dv2p)                      # v2p = sum q^2 + eps


def _fine_fwd_block(meta: FineMeta, p, rotT, off, cut, pack: FinePack, residuals: bool = False,
                    g_color=None):
    """One block of the fused forward -> (sdf (B,), g (B, 3), color (B, 3)),
    or without meta.with_color (out (B, d_out), g (B, 3), e (B, E)) [,
    what the backward reads].  g_color (B, 3): the g the color net's
    grad-PE input is formed from, in place of the block's own (None)."""
    tm = meta.trunk_meta
    E = meta.emb_width
    st = _emb_fwd_block(p, rotT, off, cut, meta)
    e_pad = FT._e_block(tm, st["e"])
    out, u_pad, ss, ins, ts, cs = FT._kernel_fwd_body(tm, e_pad, pack.ws, pack.bs,
                                                       residuals=True)
    u = u_pad[:, :E]
    g, chain = _emb_rev_block(st, rotT, u, meta)
    if not meta.with_color:
        res = (st, u, chain, (ss, ins, ts, cs), None, None)
        outs = (out[:, :meta.d_out], g, e_pad[:, :E])
        return outs + (res,) if residuals else outs
    feat = torch.nn.functional.pad(out[:, 1:meta.d_out], (0, meta.Fp - (meta.d_out - 1)))
    x = torch.cat([e_pad, feat, _gpe_block(meta, g if g_color is None else g_color)], dim=-1)
    color, zs, acts = _color_fwd_block(meta, x, pack.cws, pack.cbs, residuals=True)
    if residuals:
        return out[:, 0], g, color, (st, u, chain, (ss, ins, ts, cs), zs, acts)
    return out[:, 0], g, color


def _fine_bwd_block(meta: FineMeta, p, rotT, off, cut, pack: FinePack, cts, want_dw: bool,
                    g_color=None):
    """One block of the backward (forward recomputed) at the cotangents
    `cts` on the forward's outputs ((dsdf, dg, dcolor), or without
    meta.with_color (dout, dg, de)) -> (dp (B, 3), drotT (3, 63), doff
    (63,), dws, dbs, dcws, dcbs); g_color as _fine_fwd_block's."""
    tm = meta.trunk_meta
    E, Ep, F = meta.emb_width, tm.Ep, meta.d_out - 1
    _o, g, color, (st, u, chain, trunk_fwd, _zs, acts) = _fine_fwd_block(
        meta, p, rotT, off, cut, pack, residuals=True, g_color=g_color)
    if meta.with_color:
        dsdf, dg, dcolor = cts
        # 0. color transpose -> cotangents on e, the features and the grad-PE
        dx, dcws, dcbs, _ = _color_bwd_block(meta, color, acts, pack.cws, dcolor, want_dw)
        de_ext = dx[:, :E]
        dg = dg + _gpe_transpose(meta, g if g_color is None else g_color, dx[:, Ep + meta.Fp:])
        dout = dx.new_zeros((p.shape[0], tm.Op))
        dout[:, 0] = dsdf
        dout[:, 1:1 + F] = dx[:, Ep:Ep + F]
    else:
        dout, dg, de_ext = cts
        dout = torch.nn.functional.pad(dout, (0, tm.Op - meta.d_out))
        dcws = dcbs = None
    # 1. transpose of the reverse chain at cotangent dg
    du, adj, drotT = _emb_rev_transpose_block(st, chain, rotT, u, dg, meta)
    # 2. trunk backward at (dout, du)
    de_trunk, dws, dbs = FT._trunk_bwd_block(
        tm, dout, torch.nn.functional.pad(du, (0, Ep - E)), pack.ws, trunk_fwd, want_dw)
    # 3. embedding-forward transpose
    dq = _emb_fwd_transpose_block(st, de_trunk[:, :E] + de_ext, adj, meta)
    # 4. point and pose adjoints
    dp = dq @ rotT[:3, :63].T
    return dp, drotT + p.T @ dq, dq.sum(0), dws, dbs, dcws, dcbs


def fine_bwd_rev_plain(pts, rotT, off, cut, meta: FineMeta, packed, dsdf, dg, dx, dtype):
    """fine_bwd_rev_kernel's function in plain PyTorch on the B rows given:
    dgt = dg + the grad-PE transpose of dx's grad-PE columns at g =
    packed[:, 1:4] (B, 3); du = the reverse chain transposed at dgt (the
    du of _emb_rev_transpose_block, which reads neither u nor the chain),
    zero-padded to Ep; the top cotangent dz = [dsdf | dx[:, Ep:Ep + F] |
    0] (B, Op).  Returns (dtype(du), dtype(du / sqrt2), dgt, dz,
    dtype(dz))."""
    tm = meta.trunk_meta
    E, Ep, Op, F = meta.emb_width, tm.Ep, tm.Op, meta.d_out - 1
    B = pts.shape[0]
    f32 = torch.float32
    st = _emb_fwd_block(pts, rotT, off, cut, meta)
    dgt = dg[:, :3] + _gpe_transpose(meta, packed[:, 1:4], dx[:, Ep + meta.Fp:])
    u0 = torch.zeros((B, E), device=pts.device, dtype=f32)
    _g, chain = _emb_rev_block(st, rotT, u0, meta)
    du, _adj, _drotT = _emb_rev_transpose_block(st, chain, rotT, u0, dgt, meta)
    du = torch.nn.functional.pad(du, (0, Ep - E))
    dz = torch.zeros((B, Op), device=pts.device, dtype=f32)
    dz[:, 0] = dsdf.reshape(-1)[:B]
    dz[:, 1:1 + F] = dx[:, Ep:Ep + F]
    return du.to(dtype), (du * FT.INV_SQRT2).to(dtype), dgt, dz, dz.to(dtype)


def fine_bwd_rev(blib, pts, m: int, rotT, off, cut, meta: FineMeta, packed, dsdf, dg, dx, du_b,
                 du_s, dgt, dzf, dzb, stream) -> None:
    """K3's reverse-chain transpose on the first m points (csrc/fused_fine_bwd.cu:
    fine_bwd_rev_kernel): du_b[:m, :Ep] = T(du), du_s[:m, :Ep] = T(du /
    sqrt2), dgt[:m, :3] = dg_total, dzf[:m, :Op] / dzb[:m, :Op] = the top
    cotangent in f32 / T (T: du_b's type, bf16 or f32).  On CPU outputs it
    writes fine_bwd_rev_plain's rows and launches nothing."""
    tm = meta.trunk_meta
    Ep, Op = tm.Ep, tm.Op
    if du_b.device.type == "cpu":
        outs = fine_bwd_rev_plain(pts[:m], rotT, off, cut, meta, packed[:m], dsdf.reshape(-1)[:m],
                                  dg[:m], dx[:m], du_b.dtype)
        du_b[:m, :Ep], du_s[:m, :Ep], dgt[:m, :3] = outs[0], outs[1], outs[2]
        dzf[:m, :Op], dzb[:m, :Op] = outs[3], outs[4]
        return
    T = du_b.dtype
    if (du_s.dtype != T or dzb.dtype != T or dzf.dtype != torch.float32
            or any(x.stride(1) != 1 for x in (du_b, du_s, dzf, dzb, dx))
            or du_s.stride(0) != du_b.stride(0) or dzb.stride(0) != dzf.stride(0)
            or dgt.stride(0) != 4 or m > min(x.shape[0] for x in (du_b, du_s, dzf, dzb, dx))):
        raise ValueError("the reverse-chain transpose takes du_b, du_s (one type, one stride), "
                         "f32 dzf beside dzb of that type, contiguous columns, a (C, 4) dgt "
                         "and m rows of each")
    PL.check_bwr_operands(
        {"du_b": du_b.data_ptr(), "du_s": du_s.data_ptr(), "dzf": dzf.data_ptr(),
         "dzb": dzb.data_ptr()}, du_b.stride(0), dzf.stride(0), du_b.element_size(),
        meta.v_multires, meta.r_multires, Ep, Op, meta.grad_L)
    fn = blib.honerf_fine_bwd_rev_f32 if T == torch.float32 else blib.honerf_fine_bwd_rev
    BWDREV.launches += 1
    _build.check(fn(
        pts.data_ptr(), m, rotT.data_ptr(), off.data_ptr(), cut.data_ptr(),
        meta.v_multires, meta.r_multires, packed.data_ptr(), dsdf.data_ptr(),
        dg.data_ptr(), dx.data_ptr(), dx.stride(0), Ep, meta.d_out - 1, meta.Fp, meta.grad_L,
        du_b.data_ptr(), du_s.data_ptr(), du_b.stride(0), dgt.data_ptr(),
        dzf.data_ptr(), dzb.data_ptr(), dzf.stride(0), Op, stream), "honerf_fine_bwd_rev")


def _pose_block_sums(X, n: int, split: int) -> torch.Tensor:
    """(ceil(n / split), PS_COLS): block s's sum over the rows [s split,
    min(n, (s + 1) split)) of X in pose_sum_kernel's order, as elementwise
    f32 adds: accumulator k of row lane l adds the rows s split +
    PS_ROW_STEP i + PS_LANES k + l for i = 0, 1, ...; a lane's sum ((a0 +
    a1) + (a2 + a3)) + ((a4 + a5) + (a6 + a7)); the block's t0 + t1 + t2 +
    t3 over the lanes.  The padding rows it adds are +0, which leaves an
    f32 sum's bits as they are (no sum here is -0)."""
    f32, dev = torch.float32, X.device
    S, steps = -(-n // split), -(-split // PL.PS_ROW_STEP)
    j = torch.arange(steps * PL.PS_ROW_STEP, device=dev)
    rows = torch.arange(S, device=dev)[:, None] * split + j
    live = (j < split) & (rows < n)
    xp = torch.where(live[..., None], X[rows.clamp(max=n - 1), :PL.PS_COLS].to(f32),
                     torch.zeros((), device=dev, dtype=f32))
    xp = xp.reshape(S, steps, PL.PS_ACC, PL.PS_LANES, PL.PS_COLS)
    a = torch.zeros((S, PL.PS_ACC, PL.PS_LANES, PL.PS_COLS), device=dev, dtype=f32)
    for i in range(steps):
        a = a + xp[:, i]
    t = ((a[:, 0] + a[:, 1]) + (a[:, 2] + a[:, 3])) + ((a[:, 4] + a[:, 5]) + (a[:, 6] + a[:, 7]))
    part = t[:, 0]
    for lane in range(1, PL.PS_LANES):
        part = part + t[:, lane]
    return part


def pose_sum_ordered_plain(P, m: int, out=None, acc: int = 0, sms=None) -> torch.Tensor:
    """out[:256] (+)= the column sums of the pose rows P[:m, :256] in
    pose_sum_kernel's order (csrc/fused_fine_bwd.cu; the split is
    perpoint_layout.pose_split's at `sms` SMs, P's device's by default):
    each block's partial over its rows (_pose_block_sums), then the S
    partials in the same order as one block's rows, partial s in the place
    of row s.  Returns out (new when None)."""
    f32 = torch.float32
    if out is None:
        out = torch.zeros((PL.PS_COLS,), device=P.device, dtype=f32)
    if m <= 0:   # the kernel launches nothing
        return out
    lay = PL.pose_split(m, PL.sm_count(P.device) if sms is None else sms)
    part = _pose_block_sums(P, m, lay["split"])
    tot = _pose_block_sums(part, lay["S"], lay["S"])[0]
    out[:PL.PS_COLS] = out[:PL.PS_COLS] + tot if acc else tot
    return out


def pose_sum(blib, P, m: int, out, acc: int, ws, stream) -> None:
    """out[:256] (+)= the column sums of the pose rows P[:m] (f32, (C, 256)
    rows; csrc/fused_fine_bwd.cu: pose_sum_kernel, one launch, a fixed
    order; ws: the f32 scratch of its partial rows).  On a CPU P it runs
    pose_sum_ordered_plain and launches nothing."""
    if (P.dtype != torch.float32 or P.dim() != 2 or P.shape[1] != PL.PS_COLS
            or P.stride() != (PL.PS_COLS, 1) or not 0 <= m <= P.shape[0]
            or out.device != P.device or out.dtype != torch.float32 or out.dim() != 1
            or out.shape[0] < PL.PS_COLS or out.stride(0) != 1):
        raise ValueError(f"the pose sum takes dense f32 rows of {PL.PS_COLS} columns, m of "
                         f"them, and an f32 out of {PL.PS_COLS} on P's device (P "
                         f"{tuple(P.shape)} {P.dtype} strides {P.stride()}, m {m}, out "
                         f"{tuple(out.shape)} {out.dtype} {out.device})")
    if P.device.type == "cpu":
        pose_sum_ordered_plain(P, m, out, acc)
        return
    if P.data_ptr() % 16 or ws.data_ptr() % 16 or ws.dtype != torch.float32:
        raise ValueError(f"the pose sum reads P and its f32 partials as float4: 16-byte-aligned "
                         f"P and ws (P {P.data_ptr():#x}, ws {ws.data_ptr():#x} {ws.dtype})")
    lay = PL.pose_split(m, PL.sm_count(P.device))
    if lay["S"] * PL.PS_COLS > ws.numel():
        raise ValueError(f"pose-sum scratch too small: {lay['S'] * PL.PS_COLS} > "
                         f"{ws.numel()} floats")
    POSE.launches += 1
    _build.check(blib.honerf_pose_sum(P.data_ptr(), m, lay["split"], ws.data_ptr(),
                                      out.data_ptr(), acc, stream), "honerf_pose_sum")


def hand_fine_color_plain(pts, rotT, off, cut, pack: FinePack, block: int = 4096):
    """The forward kernel's statements in plain PyTorch, in blocks of
    points (with or without the color net, as the pack's meta says)."""
    outs = [_fine_fwd_block(pack.meta, pts[s:s + block], rotT, off, cut, pack)
            for s in range(0, pts.shape[0], block)]
    return tuple(torch.cat(parts, dim=0) for parts in zip(*outs))


def _zero_pose_grads(pts):
    return (pts.new_zeros((8, FH._LANE)), pts.new_zeros((1, FH._LANE)))


def _plain_bwd(pts, rotT, off, cut, pack: FinePack, cts, want_dw: bool,
               block: int, g_color=None) -> FineGrads:
    """The backward kernel's statements in plain PyTorch, in blocks of
    points, at the per-point cotangents `cts` (_fine_bwd_block's); dW/db
    in f32, summed over the blocks."""
    meta = pack.meta
    drotT, doff = _zero_pose_grads(pts)
    dp = pts.new_zeros((pts.shape[0], 3))
    z = lambda ts: [torch.zeros(t.shape, device=pts.device) for t in ts]  # noqa: E731
    sums = [z(pack.ws), z(pack.bs), z(pack.cws), z(pack.cbs)] if want_dw else None
    for s in range(0, pts.shape[0], block):
        sl = slice(s, s + block)
        dp[sl], dr, do, *dwb = _fine_bwd_block(
            meta, pts[sl], rotT, off, cut, pack, [c[sl] for c in cts], want_dw,
            None if g_color is None else g_color[sl])
        drotT[:3, :63] += dr
        doff[0, :63] += do
        if want_dw:
            for acc, part in zip(sums, dwb):
                for a, b in zip(acc, part or ()):
                    a += b
    if not want_dw:
        return FineGrads(dp, drotT, doff, None, None, None, None)
    if not meta.with_color:
        return FineGrads(dp, drotT, doff, tuple(sums[0]), tuple(sums[1]), None, None)
    return FineGrads(dp, drotT, doff, *[tuple(x) for x in sums])


def hand_fine_color_plain_bwd(pts, rotT, off, cut, pack: FinePack, ct0, dg, ct2,
                              want_dw: bool = True, block: int = 4096,
                              g_color=None) -> FineGrads:
    """K3's statements in plain PyTorch at the cotangents on the forward's
    outputs (hand_fine_color_bwd's).  g_color (N, 3), with the color net:
    the g its grad-PE input is formed from, in place of the plain
    forward's own.  The input holds sin / cos(2^l g), so it carries a
    rounding of g at 2^l |g| (|g| reaches hundreds on a random field):
    holding the kernel against this version at the kernel's own g
    compares the backward's arithmetic, not that conditioning."""
    return _plain_bwd(pts, rotT, off, cut, pack, (ct0, dg, ct2), want_dw, block, g_color)


def color_relu_margin(pts, rotT, off, cut, pack: FinePack, g_color=None,
                      block: int = 4096) -> torch.Tensor:
    """(N,) per point: the least |z| / max |z| over the units of each relu
    layer of the color net (the plain forward's pre-activations; g_color
    as hand_fine_color_plain_bwd's).  Where it is ~1e-6, two f32 sums in
    another order can put z on either side of the kink, and the
    backward's mask with it."""
    meta = pack.meta
    out = []
    for s in range(0, pts.shape[0], block):
        *_, res = _fine_fwd_block(meta, pts[s:s + block], rotT, off, cut, pack, residuals=True,
                                  g_color=None if g_color is None else g_color[s:s + block])
        zs = [z[:, :meta.c_hidden].abs() for z in res[4][:-1]]
        rel = [z.min(1).values / z.max(1).values.clamp_min(1e-30) for z in zs]
        out.append(torch.stack(rel, 1).min(1).values)
    return torch.cat(out)


# Where a color relu's pre-activation lies within RELU_MARGIN of its
# layer's scale of zero, two f32 sums in another order can flip its mask
# (~0.1% of a step's points on a random field).
RELU_MARGIN = 1e-6


def shared_g_cotangents(pts, rotT, off, cut, pack: FinePack, ct0, dg, dcolor):
    """How K3 with the color net is held against its plain version: (g,
    (ct0, dg, dcolor with zero at the points within RELU_MARGIN of a color
    relu's kink), how many points those are), g the forward's own
    (hand_fine_color_fwd on the card: the kernel's), for the plain
    backward's g_color."""
    g = hand_fine_color_fwd(pts, rotT, off, cut, pack)[1]
    keep = color_relu_margin(pts, rotT, off, cut, pack, g_color=g) >= RELU_MARGIN
    return g, (ct0, dg, dcolor * keep[:, None]), int((~keep).sum())


# ---------------------------------------------------------------------------
# CUDA path
# ---------------------------------------------------------------------------

_P, _I = ctypes.c_void_p, ctypes.c_int
EPI_MASK = 7


def _lib():
    lib = FH._lib("fused_fine_full")
    if not getattr(lib, "_honerf_fine_typed", False):
        FT.type_trunk_lib(lib)
        for fn in (lib.honerf_fine_rev, lib.honerf_fine_rev_f32):
            fn.argtypes = [_P, _I, _P, _P, _P, _I, _I, _P, _I, _P, _I, _I, _P, _I, _I, _I, _P,
                           _P]
            fn.restype = _I
        lib._honerf_fine_typed = True
    return lib


def _bwd_lib():
    lib = FH._lib("fused_fine_bwd")
    if not getattr(lib, "_honerf_bwd_typed", False):
        FT.type_trunk_lib(lib)
        for fn in (lib.honerf_color_dz, lib.honerf_color_dz_f32):
            fn.argtypes = [_P, _P, _I, _P, _P, _I, _I, _P]
            fn.restype = _I
        for fn in (lib.honerf_fine_bwd_rev, lib.honerf_fine_bwd_rev_f32):
            fn.argtypes = [
                _P, _I, _P, _P, _P, _I, _I,      # pts, M, rotT, off, cut, vL, rL
                _P, _P, _P, _P, _I,              # packed, dsdf, dg, dx, ldx
                _I, _I, _I, _I,                  # Ep, F, Fp, L
                _P, _P, _I, _P, _P, _P, _I, _I,  # du_b, du_s, lddu, dgt, dzf, dzb, lddz, Op
                _P]
            fn.restype = _I
        lib.honerf_pose_sum.argtypes = [_P, _I, _I, _P, _P, _I, _P]
        lib.honerf_pose_sum.restype = _I
        lib.honerf_fine_bwd_emb.argtypes = [
            _P, _I, _P, _P, _P, _I, _I,      # pts, M, rotT, off, cut, vL, rL
            _P, _I, _P, _P, _I, _P, _I,      # u, ldu, dgt, de, ldde, dx, ldx
            _P, _P, _P]                      # dp, pose rows, stream
        lib.honerf_fine_bwd_emb.restype = _I
        lib._honerf_bwd_typed = True
    return lib


def _cf32lib():
    """The library of csrc/color_fused_f32.cu (the f32 color net's two
    kernels)."""
    lib = _build.load("color_fused_f32")
    if not getattr(lib, "_honerf_cf32_typed", False):
        lib.honerf_color_fwd_f32.argtypes = [
            _P, _I, _I, _P, _I, _I, _I, _I,  # e, lde, Ep, cx2, ldx, X, M, n_layers
            _P, _P, _P, _P,                  # wsplit, rows, cols, bs
            _P, _I, _P, _I, _P]              # color, ldcolor, acts, ldact, stream
        lib.honerf_color_bwd_f32.argtypes = [
            _I, _I, _P, _P, _P,              # M, n_layers, wsplit, in_cols, out_cols
            _P, _I, _P, _I, _P, _I,          # s, lds, dcolor, lddc, acts, ldact
            _P, _I, _P, _I, _P]              # dx, lddx, dz, lddz, stream
        lib.honerf_color_fwd_f32.restype = lib.honerf_color_bwd_f32.restype = _I
        lib._honerf_cf32_typed = True
    return lib


def _cf16lib():
    """The library of csrc/color_fused.cu (the bf16 color net's two
    kernels)."""
    lib = _build.load("color_fused")
    if not getattr(lib, "_honerf_cf16_typed", False):
        lib.honerf_color_fwd.argtypes = [
            _P, _I, _I, _P, _I, _I, _I, _I,  # e, lde, Ep, cx2, ldx, X, M, n_layers
            _P, _P, _P, _P,                  # ws, rows, cols, bs
            _P, _I, _P, _I, _P]              # color, ldcolor, acts, ldact, stream
        lib.honerf_color_bwd.argtypes = [
            _I, _I, _P, _P, _P,              # M, n_layers, wts, in_cols, out_cols
            _P, _I, _P, _I, _P, _I,          # s, lds, dcolor, lddc, acts, ldact
            _P, _I, _P, _P, _I, _I, _P]      # dx, lddx, dzf, dzb, lddz, lddzb, stream
        lib.honerf_color_fwd.restype = lib.honerf_color_bwd.restype = _I
        lib._honerf_cf16_typed = True
    return lib


def _check_color(meta: FineMeta, cws, dtype: str) -> None:
    want = torch.float32 if dtype == "f32" else torch.bfloat16
    if meta.dtype != dtype or not meta.with_color or any(w.dtype != want for w in cws):
        raise ValueError(f"the fused color kernels take a {dtype} pack with the color net")


def _check_packed(packed, m: int) -> None:
    if (packed.dtype != torch.float32 or packed.dim() != 2 or packed.shape[1] != 8
            or packed.stride(1) != 1 or packed.shape[0] < m):
        raise ValueError("packed: f32 rows of 8 contiguous columns, at least m of them")


def color_fwd_plain(e, cx2, m: int, cws, cbs, meta: FineMeta):
    """color_fwd_kernel's (bf16) or color_fwd_f32_kernel's (f32) function in
    plain PyTorch (_color_fwd_block in the meta's dtype: the operands
    rounded to it, f32 sums) on the first m rows of [e[:, :Ep] | cx2[:, :Fp
    + Gp]]: (color (m, 3) f32, the relu rows [relu(z_l) for l < n - 1] (m,
    H) in the meta's dtype)."""
    x = torch.cat([e[:m, :meta.trunk_meta.Ep], cx2[:m, :meta.Fp + meta.Gp]], 1)
    color, _zs, acts = _color_fwd_block(meta, x, cws, cbs, residuals=True)
    return color, [a.to(FT._cast(meta.trunk_meta)) for a in acts[1:]]


def color_fwd(e, cx2, m: int, cws, cbs, meta: FineMeta, packed, cacts=None, stream=None) -> None:
    """The bf16 color net's forward on m points (one launch:
    csrc/color_fused.cu's color_fwd_kernel): packed[:m, 4:7] (f32, rows of
    8) = the sigmoid of the last layer on [e[:, :Ep] | cx2] (bf16) and,
    with cacts (K3's recompute: the planes of one bf16 tensor),
    cacts[l][:m] = bf16(relu(z_l)) for l < n - 1.  On a CPU e it writes
    color_fwd_plain's rows and launches nothing."""
    _check_color(meta, cws, "bf16")
    _check_packed(packed, m)
    n, bf16 = meta.c_layers, torch.bfloat16
    if e.device.type == "cpu":
        color, acts = color_fwd_plain(e, cx2, m, cws, cbs, meta)
        packed[:m, 4:7] = color
        for dst, a in zip(cacts or (), acts):
            dst[:m] = a
        return
    Ep, X = meta.trunk_meta.Ep, meta.Fp + meta.Gp
    lde = FT._check_rows("e", [e], bf16, m, Ep)
    ldx = FT._check_rows("cx2", [cx2], bf16, m, X)
    ldact = (FT._check_rows("cacts", list(cacts[:n - 1]), bf16, m, cws[0].shape[1])
             if cacts is not None else 0)
    COLOR_FWD.launches += 1
    _build.check(_cf16lib().honerf_color_fwd(
        e.data_ptr(), lde, Ep, cx2.data_ptr(), ldx, X, m, n, FT._ptrs(cws),
        FT._ints([w.shape[0] for w in cws]), FT._ints([w.shape[1] for w in cws]), FT._ptrs(cbs),
        packed[:, 4:].data_ptr(), packed.stride(0),
        None if cacts is None else FT._ptrs(cacts[:n - 1]), ldact, stream), "honerf_color_fwd")


def color_fwd_f32(e, cx2, m: int, cws, cbs, meta: FineMeta, packed, cacts=None,
                  stream=None) -> None:
    """The f32 color net's forward on m points (one launch:
    csrc/color_fused_f32.cu's color_fwd_f32_kernel): packed[:m, 4:7] (f32,
    rows of 8) = the sigmoid of the last layer on [e[:, :Ep] | cx2] (f32)
    and, with cacts (K3's recompute: the planes of one f32 tensor),
    cacts[l][:m] = relu(z_l) for l < n - 1.  On a CPU e it writes
    color_fwd_plain's rows and launches nothing."""
    _check_color(meta, cws, "f32")
    _check_packed(packed, m)
    n, f32 = meta.c_layers, torch.float32
    if e.device.type == "cpu":
        color, acts = color_fwd_plain(e, cx2, m, cws, cbs, meta)
        packed[:m, 4:7] = color
        for dst, a in zip(cacts or (), acts):
            dst[:m] = a
        return
    Ep, X = meta.trunk_meta.Ep, meta.Fp + meta.Gp
    lde = FT._check_rows("e", [e], f32, m, Ep)
    ldx = FT._check_rows("cx2", [cx2], f32, m, X)
    ldact = (FT._check_rows("cacts", list(cacts[:n - 1]), f32, m, cws[0].shape[1])
             if cacts is not None else 0)
    COLOR_FWD_F32.launches += 1
    _build.check(_cf32lib().honerf_color_fwd_f32(
        e.data_ptr(), lde, Ep, cx2.data_ptr(), ldx, X, m, n,
        FT._ptrs([FT.tf32_operands(w, True) for w in cws]), FT._ints([w.shape[0] for w in cws]),
        FT._ints([w.shape[1] for w in cws]), FT._ptrs(cbs), packed[:, 4:].data_ptr(),
        packed.stride(0), None if cacts is None else FT._ptrs(cacts[:n - 1]), ldact, stream),
        "honerf_color_fwd_f32")


def color_bwd_plain(m: int, cws, meta: FineMeta, packed, dcolor, cacts):
    """color_bwd_kernel's (bf16) or color_bwd_f32_kernel's (f32) function
    in plain PyTorch on the first m points: dz = s (1 - s) dcolor on the
    last layer's columns (s = packed[:, 4:7], the forward's sigmoid), then
    _color_transpose with the masks cacts[l] > 0 (JAX's res_stash form of
    _color_bwd_block; each dz rounded to the meta's dtype before its
    product) -> (dx (m, color_in), [dz_0 .. dz_{n-1}], f32)."""
    acts = [None] + [a[:m] for a in cacts[:meta.c_layers - 1]]
    dx, _, _, dzs = _color_bwd_block(meta, packed[:m, 4:7], acts, cws, dcolor[:m], False)
    return dx, dzs


def color_bwd(m: int, cws, cwts, meta: FineMeta, packed, dcolor, cacts, dx, cdz=None, cdzb=None,
              stream=None) -> None:
    """The bf16 color net's transpose on m points (one launch:
    csrc/color_fused.cu's color_bwd_kernel): dx[:m, :color_in] (f32) and,
    with cdz and cdzb (weight gradients asked: the planes of one f32 and of
    one bf16 tensor), layer l's dz into cdz[l][:m, :out_l] and bf16(dz)
    into cdzb[l], from the forward's sigmoid packed[:, 4:7], dcolor (>= m,
    3) f32 and the kept relu rows cacts[l] (bf16, l < n - 1); cwts = the
    pack's transposed weights (W_l^T).  On a CPU dx it writes
    color_bwd_plain's rows and launches nothing."""
    _check_color(meta, cws, "bf16")
    _check_packed(packed, m)
    n, f32, bf16 = meta.c_layers, torch.float32, torch.bfloat16
    if (cdz is None) != (cdzb is None):
        raise ValueError("the dz rows come in both types or not at all")
    if dx.device.type == "cpu":
        d, dzs = color_bwd_plain(m, cws, meta, packed, dcolor, cacts)
        dx[:m, :meta.color_in] = d
        for dst, dstb, z in zip(cdz or (), cdzb or (), dzs):
            dst[:m, :z.shape[1]] = z
            dstb[:m, :z.shape[1]] = z
        return
    H = cws[0].shape[1]
    if (dcolor.dtype != f32 or dcolor.dim() != 2 or dcolor.shape[1] != 3
            or dcolor.stride(1) != 1 or dcolor.shape[0] < m):
        raise ValueError("dcolor: f32 rows of 3 contiguous columns, at least m of them")
    if cwts is None or [tuple(w.shape) for w in cwts] != [tuple(w.shape[::-1]) for w in cws]:
        raise ValueError("cwts: the transposed color weights of a pack made on the card")
    ldact = FT._check_rows("cacts", list(cacts[:n - 1]), bf16, m, H)
    lddx = FT._check_rows("dx", [dx], f32, m, meta.color_in)
    lddz = lddzb = 0
    if cdz is not None:
        lddz = FT._check_rows("cdz", list(cdz[:n]), f32, m, H)
        lddzb = FT._check_rows("cdzb", list(cdzb[:n]), bf16, m, H)
    COLOR_BWD.launches += 1
    _build.check(_cf16lib().honerf_color_bwd(
        m, n, FT._ptrs(cwts), FT._ints([w.shape[0] for w in cws]),
        FT._ints([w.shape[1] for w in cws]), packed[:, 4:].data_ptr(), packed.stride(0),
        dcolor.data_ptr(), dcolor.stride(0), FT._ptrs(cacts[:n - 1]), ldact, dx.data_ptr(), lddx,
        None if cdz is None else FT._ptrs(cdz[:n]), None if cdzb is None else FT._ptrs(cdzb[:n]),
        lddz, lddzb, stream), "honerf_color_bwd")


def color_bwd_f32(m: int, cws, meta: FineMeta, packed, dcolor, cacts, dx, cdz=None,
                  stream=None) -> None:
    """The f32 color net's transpose on m points (one launch:
    csrc/color_fused_f32.cu's color_bwd_f32_kernel): dx[:m, :color_in]
    (f32) and, with cdz (weight gradients asked: the planes of one f32
    tensor), cdz[l][:m, :out_l] = dz_l for every layer, from the forward's
    sigmoid packed[:, 4:7], dcolor (>= m, 3) f32 and the kept relu rows
    cacts[l] (l < n - 1).  On a CPU dx it writes color_bwd_plain's rows
    and launches nothing."""
    _check_color(meta, cws, "f32")
    _check_packed(packed, m)
    n, f32 = meta.c_layers, torch.float32
    if dx.device.type == "cpu":
        d, dzs = color_bwd_plain(m, cws, meta, packed, dcolor, cacts)
        dx[:m, :meta.color_in] = d
        for dst, z in zip(cdz or (), dzs):
            dst[:m, :z.shape[1]] = z
        return
    H = cws[0].shape[1]
    if (dcolor.dtype != f32 or dcolor.dim() != 2 or dcolor.shape[1] != 3
            or dcolor.stride(1) != 1 or dcolor.shape[0] < m):
        raise ValueError("dcolor: f32 rows of 3 contiguous columns, at least m of them")
    ldact = FT._check_rows("cacts", list(cacts[:n - 1]), f32, m, H)
    lddx = FT._check_rows("dx", [dx], f32, m, meta.color_in)
    lddz = (FT._check_rows("cdz", list(cdz[:n]), f32, m, max(H, cws[-1].shape[1]))
            if cdz is not None else 0)
    COLOR_BWD_F32.launches += 1
    _build.check(_cf32lib().honerf_color_bwd_f32(
        m, n, FT._ptrs([FT.tf32_operands(w, False) for w in cws]),
        FT._ints([w.shape[0] for w in cws]), FT._ints([w.shape[1] for w in cws]),
        packed[:, 4:].data_ptr(), packed.stride(0), dcolor.data_ptr(), dcolor.stride(0),
        FT._ptrs(cacts[:n - 1]), ldact, dx.data_ptr(), lddx,
        None if cdz is None else FT._ptrs(cdz[:n]), lddz, stream), "honerf_color_bwd_f32")


def _fwd_chunk(lib, pts, m, rotT, off, cut, pack: FinePack, buf, packed, stream, keep=False,
               z=None):
    """K2's launches on one chunk of m points: e, the trunk activations
    and sigmoid rows, the u-chain, [sdf | g] into packed, the color net
    (without meta.with_color: none, and the trunk's last layer goes to z
    when given).  keep=True (the backward's recompute) keeps every
    activation, t row and c row in its own buffer instead of two
    alternating ones."""
    meta, tm = pack.meta, pack.meta.trunk_meta
    e, u, cx2 = buf["e"], buf["u"], buf.get("cx2")
    z = buf["z"] if z is None else z
    FH.embed(lib, pts, m, rotT, off, cut, meta.v_multires, meta.r_multires, e, stream)
    FT.cuda_trunk_forward(lib, e, m, pack.ws, pack.bs, pack.wts, tm, buf, stream, keep=keep,
                          z=z, u=u)
    # reverse chain -> [sdf | g] into packed, [feat | grad-PE] into cx2
    rev = lib.honerf_fine_rev_f32 if meta.dtype == "f32" else lib.honerf_fine_rev
    _build.check(rev(
        pts.data_ptr(), m, rotT.data_ptr(), off.data_ptr(), cut.data_ptr(),
        meta.v_multires, meta.r_multires, u.data_ptr(), u.stride(0),
        z.data_ptr(), z.stride(0), meta.d_out - 1, FH._ptr(cx2), FH._ld(cx2),
        meta.Fp, meta.grad_L, packed.data_ptr(), stream), "honerf_fine_rev")
    if not meta.with_color:
        return
    # color net on [e | feat | grad-PE]: one launch in either dtype
    fwd = color_fwd_f32 if meta.dtype == "f32" else color_fwd
    fwd(e, cx2, m, pack.cws, pack.cbs, meta, packed, buf["cacts"] if keep else None, stream)


def _color_fwd_gemms(lib, e, cx2, m, pack: FinePack, cacts, packed, keep, stream):
    """The color net as one GEMM a layer (gemm_kernel, or gemm_f32_kernel
    on f32 operands): relu layers into cacts (keep: one row a layer, else
    two alternating ones), the sigmoid into packed[:, 4:7]."""
    meta, tm = pack.meta, pack.meta.trunk_meta
    cHp = pack.cws[0].shape[1]
    a = None
    for l in range(meta.c_layers):
        w = pack.cws[l]
        A1, K1, A2, K2 = (e, tm.Ep, cx2, cx2.shape[1]) if l == 0 else (a, cHp, None, 0)
        if l < meta.c_layers - 1:
            nxt = cacts[l] if keep else cacts[l % 2]
            FH.gemm(lib, A1, K1, A2, K2, w, w.shape[1], pack.cbs[l], m, FH.EPI_RELU,
                    nxt, nxt.stride(0), stream=stream)
            a = nxt
        else:
            FH.gemm(lib, A1, K1, A2, K2, w, w.shape[1], pack.cbs[l], m, FH.EPI_SIGMOID,
                    packed[:, 4:], 8, n_store=3, stream=stream)


def _color_fwd_split(lib, e, cx2, m, pack: FinePack, packed, stream, cacts=None) -> None:
    """color_fwd's / color_fwd_f32's outputs as the split launches they
    replaced: one gemm_kernel (bf16) or gemm_f32_kernel (f32) a layer
    (cacts None: two alternating rows of their own).  No main path calls
    it: chip_smoke.py holds the fused forward against it at the same
    calls."""
    keep = cacts is not None
    if not keep:
        cacts = [torch.empty((e.shape[0], pack.cws[0].shape[1]), device=e.device,
                             dtype=pack.cws[0].dtype) for _ in range(2)]
    _color_fwd_gemms(lib, e, cx2, m, pack, cacts, packed, keep, stream)


def _fwd_buffers(pack: FinePack, C: int, dev, keep: bool):
    """K2's scratch for C points: the operand rows (e, the color input's
    second part, the color activations) in the trunk dtype, z and u in
    f32.  The color net keeps its activations on chip: its rows only with
    keep (K3's masks and dW)."""
    meta, tm = pack.meta, pack.meta.trunk_meta
    op, f32 = FT._cast(tm), torch.float32
    buf = FT.trunk_buffers(tm, C, dev, keep)
    buf.update(e=torch.empty((C, tm.Ep), device=dev, dtype=op),
               z=torch.empty((C, tm.Op), device=dev, dtype=f32),
               u=torch.empty((C, tm.Ep), device=dev, dtype=f32))
    if meta.with_color:
        cHp = pack.cws[0].shape[1]
        buf.update(cx2=torch.empty((C, meta.Fp + meta.Gp), device=dev, dtype=op),
                   cacts=FT.planes(meta.c_layers - 1 if keep else 0, C, cHp, dev, op))
    return buf


def _hand_fine_cuda(pts, rotT, off, cut, pack: FinePack):
    """K2: (sdf, g, color), or without meta.with_color (out, g, e)."""
    meta = pack.meta
    lib = _lib()
    dev = pts.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    N = pts.shape[0]
    packed = torch.empty((N, 8), device=dev, dtype=torch.float32)
    if not meta.with_color:
        out = torch.empty((N, meta.d_out), device=dev, dtype=torch.float32)
        e_out = torch.empty((N, meta.emb_width), device=dev, dtype=torch.float32)
    if N:
        C = chunk_size(N, meta.dtype, CHUNK)
        buf = _fwd_buffers(pack, C, dev, keep=False)
        KERNEL.launches += 1
    for s in range(0, N, C if N else 1):
        m = min(C, N - s)
        if meta.with_color:
            _fwd_chunk(lib, pts[s:], m, rotT, off, cut, pack, buf, packed[s:], stream)
        else:
            _fwd_chunk(lib, pts[s:], m, rotT, off, cut, pack, buf, packed[s:], stream,
                       z=out[s:])
            FT.copy_cols(lib, buf["e"], m, meta.emb_width, e_out[s:], stream)
    if not meta.with_color:
        return out, packed[:, 1:4], e_out
    return packed[:, 0], packed[:, 1:4], packed[:, 4:7]


def _hand_fine_bwd_cuda(pts, rotT, off, cut, pack: FinePack, cts, want_dw: bool) -> FineGrads:
    """K3 at the cotangents `cts`: (dsdf, dg, dcolor), or without
    meta.with_color (dout, dg, de)."""
    meta, tm = pack.meta, pack.meta.trunk_meta
    n, Hp, Ep, Op, E = tm.n_layers, tm.Hp, tm.Ep, tm.Op, tm.emb_width
    cn, F = meta.c_layers, meta.d_out - 1
    color = meta.with_color
    lib, blib = _lib(), _bwd_lib()
    dev = pts.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    f32 = torch.float32
    N = pts.shape[0]
    dp = torch.empty((N, 3), device=dev, dtype=f32)
    pose = torch.zeros((256,), device=dev, dtype=f32)
    # the weight gradients' sums, only where they are asked for
    zeros = lambda ts: tuple(torch.zeros(t.shape, device=dev, dtype=f32)  # noqa: E731
                             for t in ts) if want_dw else None
    dws, dbs, dcws, dcbs = zeros(pack.ws), zeros(pack.bs), zeros(pack.cws), zeros(pack.cbs)
    dg = cts[1]
    C = chunk_size(N, meta.dtype, BWD_CHUNK)
    if C:
        buf = _fwd_buffers(pack, C, dev, keep=True)
        packed = torch.empty((C, 8), device=dev, dtype=f32)
        width = max(pack.cws[0].shape[1], Hp, Op) if color else max(Hp, Op)
        bw = FT.trunk_bwd_buffers(pack.ws, tm, C, dev, width, want_dw)
        dzf, dzb = bw["dzf"], bw["dzb"]
        # with dW: one f32 dz row a color layer, which the pass's dW launch
        # reads (bf16: the column sums; the bf16 rows cdzb, the TN GEMMs)
        cdz = cdzb = None
        if color and want_dw:
            cdz = FT.planes(cn, C, pack.cws[0].shape[1], dev, f32)
            if meta.dtype == "bf16":
                cdzb = FT.planes(cn, C, pack.cws[0].shape[1], dev, torch.bfloat16)
        dgt = torch.empty((C, 4), device=dev, dtype=f32)
        pose_rows = torch.empty((C, 256), device=dev, dtype=f32)
        ws = torch.empty((FT._WS_FLOATS,), device=dev, dtype=f32)
        if color:
            dx = torch.empty((C, meta.color_in), device=dev, dtype=f32)
        else:
            # the color input's cotangent rows, [de | 0 | dfeat | 0 | 0]: only
            # the e and feature columns are written per chunk
            dx = torch.zeros((C, meta.color_in), device=dev, dtype=f32)
            dsdf_c = torch.empty((C, 1), device=dev, dtype=f32)
        KERNEL_BWD.launches += 1
    for s in range(0, N, C or 1):
        m = min(C, N - s)
        acc = int(s > 0)
        _fwd_chunk(lib, pts[s:], m, rotT, off, cut, pack, buf, packed, stream, keep=True)
        e = buf["e"]
        if color:
            dsdf = cts[0][s:]
            _color_bwd_cuda(blib, m, pack, buf, packed, cts[2][s:], dx, dcws, dcbs, acc, ws,
                            stream, cdz, cdzb)
        else:
            # the cotangents on e and on the features where the color net's
            # input cotangent goes, dsdf beside them
            dout, de_ext = cts[0][s:], cts[2][s:]
            FT.copy_cols(blib, de_ext, m, E, dx, stream)
            FT.copy_cols(blib, dout[:, 1:], m, F, dx[:, Ep:], stream)
            FT.copy_cols(blib, dout, m, 1, dsdf_c, stream)
            dsdf = dsdf_c
        # reverse-chain transpose at dg (+ the grad-PE term) -> du, and the
        # trunk's top cotangent [dsdf | dfeat]
        fine_bwd_rev(blib, pts[s:], m, rotT, off, cut, meta, packed, dsdf, dg[s:], dx,
                     bw["du_b"], bw["du_s"], dgt, dzf[0], dzb[0], stream)
        crows = (FT.dw_color_rows(buf["cx2"], buf["cacts"], cdz, dcws, dcbs)
                 if cdz is not None and meta.dtype == "f32" else None)
        FT.cuda_trunk_backward(blib, m, e, pack.ws, pack.wts, tm, buf, bw, dws, dbs, want_dw,
                               acc, ws, stream, crows)
        # embedding-forward transpose -> dp and the per-point pose rows
        _build.check(blib.honerf_fine_bwd_emb(
            pts[s:].data_ptr(), m, rotT.data_ptr(), off.data_ptr(), cut.data_ptr(),
            meta.v_multires, meta.r_multires, buf["u"].data_ptr(), buf["u"].stride(0),
            dgt.data_ptr(), bw["de"].data_ptr(), bw["de"].stride(0), dx.data_ptr(), dx.stride(0),
            dp[s:].data_ptr(), pose_rows.data_ptr(), stream), "honerf_fine_bwd_emb")
        pose_sum(blib, pose_rows, m, pose, acc, ws, stream)
    drotT, doff = _zero_pose_grads(pts)
    drotT[:3, :63] = pose[:192].reshape(3, 64)[:, :63]
    doff[0, :63] = pose[192:255]
    if not want_dw:
        return FineGrads(dp, drotT, doff, None, None, None, None)
    if not color:
        return FineGrads(dp, drotT, doff, dws, dbs, None, None)
    return FineGrads(dp, drotT, doff, dws, dbs, dcws, dcbs)


def _color_bwd_cuda(blib, m, pack: FinePack, buf, packed, dcolor, dx, dcws, dcbs, acc, ws,
                    stream, cdz=None, cdzb=None):
    """K3's color launches: dz = s (1 - s) dcolor, then per layer, top
    down, da = dz cW^T masked by the relu; the color input's cotangent
    into dx: one launch in either dtype.  With dW (cdz given) layer l's dz
    into cdz[l]: f32, for the pass's one dW launch (fused_fine.trunk_dw);
    bf16, also bf16(dz) into cdzb[l], then each layer's dcW = a^T dz
    (gemm_tn_kernel) and dcb = sum dz (colsum_partial_kernel), top down."""
    meta = pack.meta
    if meta.dtype == "f32":
        color_bwd_f32(m, pack.cws, meta, packed, dcolor, buf["cacts"], dx, cdz, stream)
        return
    color_bwd(m, pack.cws, pack.cwts, meta, packed, dcolor, buf["cacts"], dx, cdz, cdzb, stream)
    if cdz is None:
        return
    Ep, e, cx2 = meta.trunk_meta.Ep, buf["e"], buf["cx2"]
    for l in range(meta.c_layers - 1, -1, -1):
        width = pack.cws[l].shape[1]
        if l == 0:
            _tn(blib, e, Ep, Ep, cdzb[0], width, m, dcws[0], acc, ws, stream)
            _tn(blib, cx2, cx2.stride(0), cx2.shape[1], cdzb[0], width, m, dcws[0][Ep:], acc,
                ws, stream)
        else:
            a = buf["cacts"][l - 1]
            _tn(blib, a, a.stride(0), a.shape[1], cdzb[l], width, m, dcws[l], acc, ws, stream)
        _colsum(blib, cdz[l], width, m, dcbs[l], acc, ws, stream)


def _color_bwd_split(blib, m, pack: FinePack, buf, packed, dcolor, dx, cdz, stream,
                     cdzb=None) -> None:
    """color_bwd's / color_bwd_f32's outputs (dx, every dz row into the
    planes cdz, and in bf16 bf16(dz) into cdzb) as the split launches they
    replaced: color_dz_kernel, then one gemm_kernel (bf16) or
    gemm_f32_kernel (f32) a layer.  No main path calls it: chip_smoke.py
    holds the fused transpose against it at the same calls."""
    if (cdzb is None) != (pack.meta.dtype == "f32"):
        raise ValueError("the bf16 split launches write the dz rows in both types, f32's in one")
    _color_bwd_gemms(blib, m, pack, buf, packed, dcolor, dx, cdz, cdzb, stream)


def _color_bwd_gemms(blib, m, pack: FinePack, buf, packed, dcolor, dx, cdz, cdzb, stream):
    """The color transpose as color_dz_kernel and one GEMM a layer
    (gemm_kernel, or gemm_f32_kernel on f32 operands): layer l's dz into
    cdz[l] (f32) and cdzb[l] (the operand type; f32: cdz itself)."""
    meta = pack.meta
    dzf = [cdz[l] for l in range(meta.c_layers - 1, -1, -1)]
    dzb = dzf if cdzb is None else [cdzb[l] for l in range(meta.c_layers - 1, -1, -1)]
    color_dz = blib.honerf_color_dz_f32 if meta.dtype == "f32" else blib.honerf_color_dz
    if dzf[0].stride(0) != dzb[0].stride(0):
        raise ValueError("color_dz_kernel writes both dz rows with one row stride")
    COLOR_DZ.launches += 1
    _build.check(color_dz(packed.data_ptr(), dcolor.data_ptr(), m, dzf[0].data_ptr(),
                          dzb[0].data_ptr(), dzf[0].stride(0), pack.cws[-1].shape[1], stream),
                 "honerf_color_dz")
    for cur, l in enumerate(range(meta.c_layers - 1, -1, -1)):
        width = pack.cws[l].shape[1]
        wt = pack.cwts[l]                   # (out_pad, in_pad)
        if l > 0:
            FH.gemm(blib, dzb[cur], width, None, 0, wt, wt.shape[1], None, m, EPI_MASK,
                    dzb[cur + 1], dzb[cur + 1].stride(0), Cf=dzf[cur + 1],
                    Act=buf["cacts"][l - 1], stream=stream)
        else:
            FH.gemm(blib, dzb[cur], width, None, 0, wt, wt.shape[1], None, m, FH.EPI_F32,
                    dx, dx.stride(0), n_store=dx.shape[1], stream=stream)


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def _check_cuda_pack(pack: FinePack):
    """Raise on a pack the kernels do not take: one made off the card, or
    of another dtype than bf16 and f32."""
    if pack.meta.dtype not in ("bf16", "f32") or pack.wts is None:
        raise ValueError("the CUDA fine pass takes a bf16 or f32 pack made on the card")


def hand_fine_color_fwd(pts, rotT, off, cut, pack: FinePack):
    """(N, 3) points -> (sdf (N,), g (N, 3), color (N, 3)), or without
    pack.meta.with_color (out (N, d_out), g (N, 3), e (N, E)), on a
    FinePack.  CUDA tensors launch the forward kernel (bf16 or f32); CPU
    tensors run the plain version.  No gradient flows through it."""
    FH.check_operands(pts, rotT, off, cut, (), pack.bs + pack.cbs)
    with torch.no_grad():
        if pts.device.type == "cuda":
            _check_cuda_pack(pack)
            FH.check_operands(pts, rotT, off, cut, pack.ws + pack.cws + pack.wts,
                              pack.bs + pack.cbs, FT._cast(pack.meta.trunk_meta))
            return _hand_fine_cuda(pts, rotT, off, cut, pack)
        if pts.device.type != "cpu":
            raise ValueError(f"unsupported device {pts.device}")
        return hand_fine_color_plain(pts, rotT, off, cut, pack)


def hand_fine_color_bwd(pts, rotT, off, cut, pack: FinePack, ct0, dg, ct2,
                        want_dw: bool = True) -> FineGrads:
    """The backward at the cotangents on the forward's outputs, in kernel
    layout: (ct0, dg, ct2) = (dsdf (N,), dg (N, 3), dcolor (N, 3)), or
    without pack.meta.with_color (dout (N, d_out), dg (N, 3), de (N, E)),
    dcws / dcbs then None.  CUDA tensors launch the backward kernel (bf16
    or f32, with or without want_dw); CPU tensors run the plain version."""
    N, meta = pts.shape[0], pack.meta
    if meta.with_color:
        cts, shapes = (ct0.reshape(N), dg, ct2), ((N,), (N, 3), (N, 3))
    else:
        cts, shapes = (ct0, dg, ct2), ((N, meta.d_out), (N, 3), (N, meta.emb_width))
    FH.check_operands(pts, rotT, off, cut, (), pack.bs + pack.cbs)
    cts = [t.float().contiguous() for t in cts]
    for t, shape in zip(cts, shapes):
        if tuple(t.shape) != shape or t.device != pts.device:
            raise ValueError(f"cotangent must be {shape} on {pts.device}")
    with torch.no_grad():
        if pts.device.type == "cuda":
            _check_cuda_pack(pack)
            FH.check_operands(pts, rotT, off, cut,
                              pack.ws + pack.cws + pack.wts + pack.cwts, pack.bs + pack.cbs,
                              FT._cast(pack.meta.trunk_meta))
            return _hand_fine_bwd_cuda(pts, rotT, off, cut, pack, cts, want_dw)
        if pts.device.type != "cpu":
            raise ValueError(f"unsupported device {pts.device}")
        return hand_fine_color_plain_bwd(pts, rotT, off, cut, pack, *cts, want_dw)


def _unpad_grads(grads: FineGrads, meta: FineMeta, w_shapes, cw_shapes):
    """Kernel-layout dW/db -> gradients of the unpadded (in, out) inputs:
    the skip layer's [Hp | Ep] rows joined, color layer 0's rows scattered
    back to the reference rows."""
    dws, dbs = FT.unpad_trunk_grads(grads.dws, grads.dbs, meta.trunk_meta, w_shapes)
    if grads.dcws is None:
        return dws, dbs, [], []
    rows = torch.as_tensor(color_row_map(meta), device=grads.dp.device)
    live = rows >= 0
    dcws, dcbs = [], []
    for l, (dw, db, (d_in, d_out)) in enumerate(zip(grads.dcws, grads.dcbs, cw_shapes)):
        if l == 0:
            full = dw.new_zeros((d_in, dw.shape[1]))
            full[rows[live]] = dw[live]
            dw = full
        dcws.append(dw[:d_in, :d_out])
        dcbs.append(db[:d_out])
    return dws, dbs, dcws, dcbs


class _HandFine(torch.autograd.Function):
    """The fine pass as one differentiable op: JAX's hand_fine_color
    (meta.with_color) or hand_fine_full (not) custom VJP.  The
    forward packs the weights (no grad) and keeps no activations; the
    backward recomputes the forward."""

    @staticmethod
    def forward(ctx, meta, pts, rotT, off, cut, *weights):
        n = meta.n_layers
        cn = meta.c_layers if meta.with_color else 0
        ws, bs = weights[:n], weights[n:2 * n]
        cws, cbs = weights[2 * n:2 * n + cn], weights[2 * n + cn:]
        pack = pack_fine_weights([w.detach() for w in ws], [b.detach() for b in bs],
                                 [w.detach() for w in cws], [b.detach() for b in cbs], meta)
        outs = hand_fine_color_fwd(pts.detach(), rotT.detach(), off.detach(), cut, pack)
        ctx.save_for_backward(pts, rotT, off, cut)
        ctx.pack = pack
        ctx.shapes = ([tuple(w.shape) for w in ws], [tuple(w.shape) for w in cws])
        return outs

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, *cts):
        pts, rotT, off, cut = ctx.saved_tensors
        pack = ctx.pack
        meta = pack.meta
        need = ctx.needs_input_grad
        want_dw = any(need[5:])
        grads = hand_fine_color_bwd(pts, rotT, off, cut, pack, *cts, want_dw)
        ctx.pack = None
        head = (None, grads.dp if need[1] else None, grads.drotT if need[2] else None,
                grads.doff if need[3] else None, None)
        n_w = len(need) - 5
        if not want_dw:
            return head + (None,) * n_w
        dws, dbs, dcws, dcbs = _unpad_grads(grads, meta, *ctx.shapes)
        wgrads = tuple(dws) + tuple(dbs) + tuple(dcws) + tuple(dcbs)
        return head + tuple(g if nd else None for g, nd in zip(wgrads, need[5:]))


def hand_fine_color(pts, rotT, off, cut, ws, bs, cws, cbs, meta: FineMeta):
    """(N, 3) points -> (sdf (N,), g (N, 3), color (N, 3)), differentiable
    in pts, rotT, off and the (in, out) trunk and color weights and biases
    (color layer 0 in the reference row order).  Without meta.with_color
    it is JAX's hand_fine_full: cws = cbs = (), and it returns (out (N,
    d_out), g (N, 3), e (N, E)), e the embedding rounded to the trunk
    dtype.  CUDA tensors launch the kernels (bf16 or f32 trunk), CPU
    tensors run the plain versions."""
    return _HandFine.apply(meta, pts, rotT, off, cut, *ws, *bs, *cws, *cbs)

