"""Color-fused hand fine pass, forward; counterpart of the forward half of
honerf_tpu.ops.fused_fine_full (`hand_fine_color`, whose Pallas kernel is
`_fwd_call`/`_make_fwd_kernel` -> `_fine_fwd_block`).

Per point:
  embedding stages -> e (1386 channels, channel-major)
  trunk forward -> z (sdf + 256 features);  u-chain u = d sdf / d e
  embedding REVERSE chain with cotangent u -> g = d sdf / d p
  grad-PE (L=4) -> 5-layer relu color net + sigmoid on [e | feat | g | PE(g)]
and returns (sdf (N,), g (N, 3), color (N, 3)).

Kernel layout of the color input (kernel rows, zero weight rows on pads):
[e (Ep) | feat (Fp) | grad-PE 8-wide blocks [g | sin_l | cos_l] (Gp)];
`color_row_map` maps it onto the reference color-input rows.

On CUDA, `hand_fine_color` launches csrc/fused_fine_full.cu (bf16 trunk
only); on the CPU it runs `hand_fine_color_plain`.  Forward only: the
backward kernel comes with the training slice.

What bounds the kernel on an H100 and how its design answers that: the
note at the top of csrc/fused_fine_full.cu; its times: PERF.md.
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
from honerf_torch.ops.fused_fine import PAD, _round_up

# points per pass of the CUDA path: the per-point scratch is ~23 KB
# (e, sigmoid rows, u, activations), so a chunk holds ~1.5 GB
CHUNK = 65536

KERNEL = _build.Kernel(
    "hand_fine_color_fwd", "honerf_torch/ops/csrc/fused_fine_full.cu",
    "honerf_tpu/ops/fused_fine_full.py:1556")


class FineMeta(NamedTuple):
    """Static architecture of the fused fine pass (with the color net)."""

    v_multires: int         # 10
    r_multires: int         # 7
    d_hidden: int           # 256
    n_layers: int           # 9 linear layers
    skip: int               # 4
    d_out: int              # 257
    dtype: str = "bf16"     # 'bf16' fast / 'f32' validation (CPU only)
    c_hidden: int = 256
    c_layers: int = 5       # linear layers of the color net
    grad_L: int = 4         # grad-PE frequencies

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
    def color_dims(self) -> Tuple[Tuple[int, int], ...]:
        """(in, out) per color layer, kernel layout, unpadded outputs."""
        dims = []
        d_in = self.trunk_meta.Ep + self.Fp + self.Gp
        for l in range(self.c_layers):
            d_o = 3 if l == self.c_layers - 1 else self.c_hidden
            dims.append((d_in, d_o))
            d_in = _round_up(d_o, PAD)
        return tuple(dims)


class FinePack(NamedTuple):
    """Padded weights of one parameter snapshot.  wts are the transposed
    trunk weights the CUDA u-chain reads (None on the CPU)."""

    ws: Tuple[torch.Tensor, ...]
    bs: Tuple[torch.Tensor, ...]
    cws: Tuple[torch.Tensor, ...]
    cbs: Tuple[torch.Tensor, ...]
    wts: object
    meta: FineMeta


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
    FinePack for hand_fine_color."""
    tm = meta.trunk_meta
    assert 0 < tm.skip < tm.n_layers - 1
    with torch.no_grad():
        wps, bps = FT._pad_weights(ws, bs, tm)
        cwps, cbps = _pad_color_weights(cws, cbs, meta)
        wts = (tuple(w.T.contiguous() for w in wps)
               if wps[0].device.type == "cuda" else None)
    return FinePack(wps, bps, cwps, cbps, wts, meta)


# ---------------------------------------------------------------------------
# Plain PyTorch version (the kernel's statements)
# ---------------------------------------------------------------------------

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
    """R5-R12 of the reverse chain -> g (B, 3)."""
    B = st["v"].shape[0]
    b_h = b_h + d_h3.reshape(B, 21, 3).sum(-1)
    f_q = c_rr * st["w3"]
    m_vrep = -0.5 * c_rr * st["q"] * st["w3"] ** 3
    n_v2p = m_vrep.reshape(B, 21, 3).sum(-1)
    a_v = a_v - CUTOFF_TAU * st["sc"] * (1.0 - st["sc"]) * b_h
    n_v2p = n_v2p + 0.5 * a_v / st["v"]
    f_q = f_q + 2.0 * st["q"] * torch.repeat_interleave(n_v2p, 3, dim=-1)
    return f_q @ rotT[:3, :63].T


def _emb_rev_block(st, rotT, u, meta: FineMeta):
    """Reverse chain: cotangent u on e -> g = (d e / d p)^T u  (B, 3)."""
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


def _color_fwd_block(meta: FineMeta, x, cws, cbs):
    """Color MLP on the kernel-layout input -> color (B, 3)."""
    tm = meta.trunk_meta
    a = FT._rnd(tm, x)
    for l in range(meta.c_layers):
        z = FT._mm(tm, a, cws[l]) + cbs[l]
        if l < meta.c_layers - 1:
            a = FT._rnd(tm, torch.relu(z))
    return torch.sigmoid(z[:, :3])


def _fine_fwd_block(meta: FineMeta, p, rotT, off, cut, pack: FinePack):
    """One block of the fused forward -> (sdf (B,), g (B, 3), color (B, 3))."""
    tm = meta.trunk_meta
    E = meta.emb_width
    st = _emb_fwd_block(p, rotT, off, cut, meta)
    e_pad = FT._rnd(tm, torch.nn.functional.pad(st["e"], (0, tm.Ep - E)))
    out, u_pad, _ = FT._kernel_fwd_body(tm, e_pad, pack.ws, pack.bs)
    g = _emb_rev_block(st, rotT, u_pad[:, :E], meta)
    feat = torch.nn.functional.pad(out[:, 1:meta.d_out], (0, meta.Fp - (meta.d_out - 1)))
    x = torch.cat([e_pad, feat, _gpe_block(meta, g)], dim=-1)
    color = _color_fwd_block(meta, x, pack.cws, pack.cbs)
    return out[:, 0], g, color


def hand_fine_color_plain(pts, rotT, off, cut, pack: FinePack, block: int = 4096):
    """The kernel's statements in plain PyTorch, in blocks of points."""
    outs = [_fine_fwd_block(pack.meta, pts[s:s + block], rotT, off, cut, pack)
            for s in range(0, pts.shape[0], block)]
    return tuple(torch.cat(parts, dim=0) for parts in zip(*outs))


# ---------------------------------------------------------------------------
# CUDA path
# ---------------------------------------------------------------------------

def _lib():
    lib = FH._lib("fused_fine_full")
    if not getattr(lib, "_honerf_fine_typed", False):
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.honerf_uchain_seed.argtypes = [P, I, P, I, I, P, I, P]
        lib.honerf_uchain_seed.restype = I
        lib.honerf_fine_rev.argtypes = [P, I, P, P, P, I, I, P, I, P, I, I, P, I, I, I, P, P]
        lib.honerf_fine_rev.restype = I
        lib._honerf_fine_typed = True
    return lib


def _hand_fine_color_cuda(pts, rotT, off, cut, pack: FinePack):
    meta, tm = pack.meta, pack.meta.trunk_meta
    n, Hp, Ep, Op = tm.n_layers, tm.Hp, tm.Ep, tm.Op
    lib = _lib()
    dev = pts.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    N = pts.shape[0]
    packed = torch.empty((N, 8), device=dev, dtype=torch.float32)
    if N == 0:
        return packed[:, 0], packed[:, 1:4], packed[:, 4:7]
    C = min(N, CHUNK)
    bf16, f32 = torch.bfloat16, torch.float32
    e = torch.empty((C, Ep), device=dev, dtype=bf16)
    acts = [torch.empty((C, Hp), device=dev, dtype=bf16) for _ in range(2)]
    ss = torch.empty((n - 1, C, Hp), device=dev, dtype=f32)
    z = torch.empty((C, Op), device=dev, dtype=f32)
    u = torch.empty((C, Ep), device=dev, dtype=f32)
    cx2 = torch.empty((C, meta.Fp + meta.Gp), device=dev, dtype=bf16)
    cHp = pack.cws[0].shape[1]
    cacts = [torch.empty((C, cHp), device=dev, dtype=bf16) for _ in range(2)]
    gemm = FH.gemm
    KERNEL.launches += 1
    for s in range(0, N, C):
        m = min(C, N - s)
        FH.embed(lib, pts[s:], m, rotT, off, cut, meta.v_multires, meta.r_multires, e, stream)
        # trunk forward: a_{l+1} = softplus(z_l), ss[l] = sigmoid(beta z_l)
        a = None
        for l in range(n):
            if l == 0:
                A1, K1, A2, K2, scale = e, Ep, None, 0, 0.0
            elif l == tm.skip:
                A1, K1, A2, K2, scale = a, Hp, e, Ep, FT.INV_SQRT2_BF16
            else:
                A1, K1, A2, K2, scale = a, Hp, None, 0, 0.0
            w = pack.ws[l]
            if l < n - 1:
                nxt = acts[l % 2]
                gemm(lib, A1, K1, A2, K2, w, w.shape[1], pack.bs[l], m, FH.EPI_SOFTPLUS,
                     nxt, nxt.stride(0), a_scale=scale, S=ss[l], stream=stream)
                a = nxt
            else:
                gemm(lib, A1, K1, A2, K2, w, Op, pack.bs[l], m, FH.EPI_F32, z, Op,
                     n_store=Op, a_scale=scale, stream=stream)
        # u-chain: t_{n-2} = W_{n-1}[:, 0] * s_{n-2}, then m_l = t_l W_l^T
        t = acts[0]
        FH._build.check(lib.honerf_uchain_seed(
            pack.ws[n - 1].data_ptr(), pack.ws[n - 1].stride(0), ss[n - 2].data_ptr(),
            Hp, m, t.data_ptr(), t.stride(0), stream), "honerf_uchain_seed")
        for l in range(n - 2, -1, -1):
            wt = pack.wts[l]                       # (out_pad, in_pad) = (Hp, in_pad)
            if l == 0:
                gemm(lib, t, Hp, None, 0, wt, wt.shape[1], None, m, FH.EPI_UCHAIN, None, 0,
                     U=u, split=0, u_acc=1, stream=stream)
                break
            nxt = acts[1] if t is acts[0] else acts[0]
            if l == tm.skip:
                gemm(lib, t, Hp, None, 0, wt, wt.shape[1], None, m, FH.EPI_UCHAIN, nxt,
                     nxt.stride(0), S=ss[l - 1], U=u, split=Hp, hscale=FT.INV_SQRT2,
                     escale=FT.INV_SQRT2, stream=stream)
            else:
                gemm(lib, t, Hp, None, 0, wt, wt.shape[1], None, m, FH.EPI_UCHAIN, nxt,
                     nxt.stride(0), S=ss[l - 1], split=wt.shape[1], stream=stream)
            t = nxt
        # reverse chain -> [sdf | g] into packed, [feat | grad-PE] into cx2
        FH._build.check(lib.honerf_fine_rev(
            pts[s:].data_ptr(), m, rotT.data_ptr(), off.data_ptr(), cut.data_ptr(),
            meta.v_multires, meta.r_multires, u.data_ptr(), u.stride(0),
            z.data_ptr(), z.stride(0), meta.d_out - 1, cx2.data_ptr(), cx2.stride(0),
            meta.Fp, meta.grad_L, packed[s:].data_ptr(), stream), "honerf_fine_rev")
        # color net on [e | feat | grad-PE]
        a = None
        for l in range(meta.c_layers):
            w = pack.cws[l]
            A1, K1, A2, K2 = (e, Ep, cx2, cx2.shape[1]) if l == 0 else (a, cHp, None, 0)
            if l < meta.c_layers - 1:
                nxt = cacts[l % 2]
                gemm(lib, A1, K1, A2, K2, w, w.shape[1], pack.cbs[l], m, FH.EPI_RELU,
                     nxt, nxt.stride(0), stream=stream)
                a = nxt
            else:
                gemm(lib, A1, K1, A2, K2, w, w.shape[1], pack.cbs[l], m, FH.EPI_SIGMOID,
                     packed[s:, 4:], 8, n_store=3, stream=stream)
    return packed[:, 0], packed[:, 1:4], packed[:, 4:7]


def hand_fine_color(pts, rotT, off, cut, pack: FinePack):
    """(N, 3) points -> (sdf (N,), g (N, 3), color (N, 3)).  CUDA tensors
    launch the kernel (bf16 trunk only); CPU tensors run the plain
    version.  Forward only: raises if a gradient is asked of it."""
    ws = pack.ws + pack.cws
    FH.check_operands(pts, rotT, off, cut, (), pack.bs + pack.cbs)
    if torch.is_grad_enabled() and (pts.requires_grad or any(w.requires_grad for w in ws)):
        raise NotImplementedError(
            "hand_fine_color is forward-only: its backward kernel is not ported yet")
    with torch.no_grad():
        if pts.device.type == "cuda":
            if pack.meta.dtype != "bf16" or pack.wts is None:
                raise ValueError("the CUDA fine pass takes a bf16 pack made on the card")
            FH.check_operands(pts, rotT, off, cut, ws + pack.wts, pack.bs + pack.cbs)
            return _hand_fine_color_cuda(pts, rotT, off, cut, pack)
        if pts.device.type != "cpu":
            raise ValueError(f"unsupported device {pts.device}")
        return hand_fine_color_plain(pts, rotT, off, cut, pack)
