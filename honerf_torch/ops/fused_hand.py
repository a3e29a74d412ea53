"""Forward-only pose-conditioned hand SDF for the up-sample ladder;
counterpart of honerf_tpu.ops.fused_hand (FusedHandSDF, whose Pallas
kernel is `_run_kernel`/`_make_kernel`).

Per point: q_j = R_j p + T_j - tpose_j for 21 bones, v = |q|, r = q/v,
cutoff gate h = 1 - sigmoid(200 (v - cut)), gated PE of v (L=10) and r
(L=7) by the double-angle recurrence, the 1386-channel channel-major
embedding e, the 9-layer softplus trunk with the widened skip at 4, and
the sdf column only.  bf16 matmul operands, f32 accumulation.

On a CUDA tensor `fused_hand_sdf` launches the hand-written kernels of
csrc/fused_hand.cu; on a CPU tensor it runs `fused_hand_sdf_plain`, which
repeats the same statements with the same bf16 rounding points.

What bounds the kernel on an H100 and how its design answers that: the
note at the top of csrc/fused_hand.cu; its times: PERF.md.
"""

from __future__ import annotations

import ctypes
from typing import Any, Dict, List, NamedTuple, Tuple

import torch

from honerf_torch.models.embedding import BONE_CUTOFFS, CUTOFF_TAU
from honerf_torch.models.fields import SDFConfig, _flat_sdf_layers
from honerf_torch.models.mlp import linear_weight
from honerf_torch.ops import _build
from honerf_torch.ops.fused_fine import (
    INV_SQRT2_BF16,
    TrunkMeta,
    _mm,
    _pad_weights,
    _rnd,
    _skip_concat,
    _softplus_beta,
)

_LANE = 128
# points per pass of the CUDA path: bounds the (chunk, 1408) bf16
# embedding scratch to ~370 MB
CHUNK = 131072

KERNEL = _build.Kernel(
    "fused_hand_sdf", "honerf_torch/ops/csrc/fused_hand.cu",
    "honerf_tpu/ops/fused_hand.py:400")


class HandKernelMeta(NamedTuple):
    trunk: TrunkMeta      # d_out = 1: the sdf column only
    v_multires: int
    r_multires: int


def pack_hand_sdf_weights(params: Dict[str, Any], cfg: SDFConfig):
    """Padded bf16 (in, out) weights with channel-major embedding columns
    and f32 biases; the last layer keeps only the sdf column."""
    assert cfg.kind == "hand" and len(cfg.skip_in) == 1
    layers = _flat_sdf_layers(params, cfg)
    ws = [linear_weight(l).T for l in layers]
    bs = [l["b"] for l in layers]
    meta = HandKernelMeta(
        trunk=TrunkMeta(emb_width=cfg.input_width, d_hidden=cfg.d_hidden,
                        n_layers=len(cfg.dims) - 1, skip=cfg.skip_in[0],
                        d_out=1, dtype="bf16"),
        v_multires=cfg.v_multires, r_multires=cfg.r_multires,
    )
    assert 0 < meta.trunk.skip < meta.trunk.n_layers - 1
    ws, bs = _pad_weights(ws, bs, meta.trunk)
    return ws, bs, meta


def pack_hand_pose(bt_inv: torch.Tensor, t_pose_21: torch.Tensor):
    """(21,4,4) inverse bone transforms + (21,3) T-pose -> f32
    rotT (8,128) [rows 0-2: R_j^T concatenated], off (1,128), cut (1,128)."""
    rot = bt_inv[:, :3, :3].float()
    trans = (bt_inv[:, :3, 3] - t_pose_21).float()
    dev = bt_inv.device
    rotT = torch.zeros((8, _LANE), device=dev)
    rotT[:3, :63] = rot.permute(2, 0, 1).reshape(3, 63)  # rotT[a, 3j+c] = R_j[c, a]
    off = torch.zeros((1, _LANE), device=dev)
    off[0, :63] = trans.reshape(63)
    cut = torch.zeros((1, _LANE), device=dev)
    cut[0, :21] = torch.as_tensor(BONE_CUTOFFS, device=dev)
    return rotT, off, cut


def _emb_stages(pts: torch.Tensor, rotT, off, cut) -> Dict[str, torch.Tensor]:
    """q (B,63), v2p/v/sc/h (B,21), w3/rr/h3 (B,63) of the embedding."""
    B = pts.shape[0]
    q = pts.float() @ rotT[:3, :63] + off[0, :63]
    v2p = (q * q).reshape(B, 21, 3).sum(-1) + 1e-24
    v = torch.sqrt(v2p)
    sc = torch.sigmoid(CUTOFF_TAU * (v - cut[0, :21]))
    h = 1.0 - sc
    w3 = torch.rsqrt(torch.repeat_interleave(v2p, 3, dim=-1) + 1e-24)
    rr = q * w3
    h3 = torch.repeat_interleave(h, 3, dim=-1)
    return dict(q=q, v2p=v2p, v=v, sc=sc, h=h, w3=w3, rr=rr, h3=h3)


def _pe_pieces(x: torch.Tensor, gate: torch.Tensor, L: int):
    """Gated bf16 [sin(2^l x) g]_l, [cos(2^l x) g]_l by the double-angle
    recurrence: sin/cos(2^l x) = (2 s c, (c - s)(c + s))."""
    s, c = torch.sin(x), torch.cos(x)
    sins, coss = [], []
    for l in range(L):
        if l:
            s, c = 2.0 * s * c, (c - s) * (c + s)
        sins.append((s * gate).to(torch.bfloat16).float())
        coss.append((c * gate).to(torch.bfloat16).float())
    return sins, coss


def fused_hand_sdf_plain(pts, rotT, off, cut, ws, bs, meta: HandKernelMeta) -> torch.Tensor:
    """The kernel's statements in plain PyTorch: (N, 3) -> (N,) sdf."""
    tm = meta.trunk
    st = _emb_stages(pts, rotT, off, cut)
    bf = lambda t: t.to(torch.bfloat16).float()  # noqa: E731
    sv, cv = _pe_pieces(st["v"], st["h"], meta.v_multires)
    sr, cr = _pe_pieces(st["rr"], st["h3"], meta.r_multires)
    e = torch.cat([bf(st["v"] * st["h"])] + sv + cv + [bf(st["rr"] * st["h3"])] + sr + cr,
                  dim=-1)
    e = torch.nn.functional.pad(e, (0, tm.Ep - tm.emb_width))
    x = e
    for l in range(tm.n_layers):
        if l == tm.skip:
            x = _skip_concat(tm, x, e)
        y = _mm(tm, x, ws[l]) + bs[l]
        if l < tm.n_layers - 1:
            y = _softplus_beta(y)
            y[:, tm.d_hidden:] = 0.0
            x = _rnd(tm, y)
    return y[:, 0]


# ---------------------------------------------------------------------------
# CUDA path
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
EPI_F32, EPI_SOFTPLUS, EPI_RELU, EPI_SIGMOID, EPI_UCHAIN = range(5)


def _lib(name: str):
    lib = _build.load(name)
    if not getattr(lib, "_honerf_typed", False):
        lib.honerf_hand_embed.argtypes = [_P, _I, _P, _P, _P, _I, _I, _P, _I, _P]
        lib.honerf_hand_embed.restype = _I
        lib.honerf_gemm.argtypes = [
            _P, _I, _I, _P, _I, _I, _F,      # A1, lda1, K1, A2, lda2, K2, a_scale
            _P, _I, _I, _P, _I,              # B, ldb, N, bias, M
            _I, _P, _I, _I,                  # mode, C, ldc, n_store
            _P, _I, _P, _I, _I, _F, _F, _I,  # S, lds, U, ldu, split, hscale, escale, u_acc
            _P]                              # stream
        lib.honerf_gemm.restype = _I
        lib._honerf_typed = True
    return lib


def _ptr(t) -> int:
    return 0 if t is None else t.data_ptr()


def gemm(lib, A1, K1, A2, K2, B, N, bias, M, mode, C, ldc, n_store=0, a_scale=0.0,
         S=None, U=None, split=0, hscale=1.0, escale=1.0, u_acc=0, stream=None):
    """One launch of the shared bf16 GEMM + epilogue (see csrc/common.cuh).
    A = concat(A1[:, :K1], A2[:, :K2]) optionally rounded through
    bf16(x * a_scale); B (K1+K2, N) row-major."""
    rc = lib.honerf_gemm(
        _ptr(A1), A1.stride(0), K1, _ptr(A2), 0 if A2 is None else A2.stride(0), K2,
        a_scale, _ptr(B), B.stride(0), N, _ptr(bias), M,
        mode, _ptr(C), ldc, n_store,
        _ptr(S), 0 if S is None else S.stride(0), _ptr(U), 0 if U is None else U.stride(0),
        split, hscale, escale, u_acc, stream)
    _build.check(rc, "honerf_gemm")


def embed(lib, pts, m, rotT, off, cut, vL, rL, e, stream):
    rc = lib.honerf_hand_embed(pts.data_ptr(), m, rotT.data_ptr(), off.data_ptr(),
                               cut.data_ptr(), vL, rL, e.data_ptr(), e.stride(0), stream)
    _build.check(rc, "honerf_hand_embed")


def check_operands(pts, rotT, off, cut, ws, bs) -> None:
    """Raise on anything the kernels do not take."""
    dev = pts.device
    if pts.dim() != 2 or pts.shape[1] != 3 or pts.dtype != torch.float32:
        raise ValueError(f"pts must be (N, 3) float32, got {tuple(pts.shape)} {pts.dtype}")
    for name, t, shape in (("rotT", rotT, (8, _LANE)), ("off", off, (1, _LANE)),
                           ("cut", cut, (1, _LANE))):
        if tuple(t.shape) != shape or t.dtype != torch.float32:
            raise ValueError(f"{name} must be {shape} float32")
    for t in (pts, rotT, off, cut, *ws, *bs):
        if t.device != dev:
            raise ValueError("all operands must be on one device")
        if not t.is_contiguous():
            raise ValueError("operands must be contiguous")
    for w in ws:
        if w.dtype != torch.bfloat16 or w.shape[0] % 32 or w.shape[1] % 64:
            raise ValueError("weights must be bf16 with rows % 32 == 0, cols % 64 == 0")
    for b in bs:
        if b.dtype != torch.float32:
            raise ValueError("biases must be float32")


def _fused_hand_sdf_cuda(pts, rotT, off, cut, ws, bs, meta: HandKernelMeta) -> torch.Tensor:
    tm = meta.trunk
    lib = _lib("fused_hand")
    stream = torch.cuda.current_stream(pts.device).cuda_stream
    N = pts.shape[0]
    out = torch.empty((N,), device=pts.device, dtype=torch.float32)
    if N == 0:
        return out
    C = min(N, CHUNK)
    e = torch.empty((C, tm.Ep), device=pts.device, dtype=torch.bfloat16)
    acts = [torch.empty((C, tm.Hp), device=pts.device, dtype=torch.bfloat16) for _ in range(2)]
    KERNEL.launches += 1
    for s in range(0, N, C):
        m = min(C, N - s)
        embed(lib, pts[s:], m, rotT, off, cut, meta.v_multires, meta.r_multires, e, stream)
        a = None
        for l in range(tm.n_layers):
            if l == 0:
                A1, K1, A2, K2, scale = e, tm.Ep, None, 0, 0.0
            elif l == tm.skip:
                A1, K1, A2, K2, scale = a, tm.Hp, e, tm.Ep, INV_SQRT2_BF16
            else:
                A1, K1, A2, K2, scale = a, tm.Hp, None, 0, 0.0
            if l < tm.n_layers - 1:
                nxt = acts[l % 2]
                gemm(lib, A1, K1, A2, K2, ws[l], ws[l].shape[1], bs[l], m, EPI_SOFTPLUS,
                     nxt, nxt.stride(0), a_scale=scale, stream=stream)
                a = nxt
            else:
                gemm(lib, A1, K1, A2, K2, ws[l], ws[l].shape[1], bs[l], m, EPI_F32,
                     out[s:], 1, n_store=1, a_scale=scale, stream=stream)
    return out


def fused_hand_sdf(pts, rotT, off, cut, ws, bs, meta: HandKernelMeta) -> torch.Tensor:
    """(N, 3) f32 -> (N,) sdf.  CUDA tensors launch the kernel; CPU
    tensors run the plain version.  No gradient flows through it."""
    check_operands(pts, rotT, off, cut, ws, bs)
    with torch.no_grad():
        if pts.device.type == "cuda":
            return _fused_hand_sdf_cuda(pts, rotT, off, cut, ws, bs, meta)
        if pts.device.type != "cpu":
            raise ValueError(f"unsupported device {pts.device}")
        return fused_hand_sdf_plain(pts, rotT, off, cut, ws, bs, meta)


class FusedHandSDF:
    """(N, 3) -> (N,) hand SDF for one parameter snapshot; the pose is
    packed per call:
        fused = FusedHandSDF(params['sdf'], cfg)
        sdf = fused(pts, bt_inv, t_pose_21)
    """

    def __init__(self, sdf_params: Dict[str, Any], cfg: SDFConfig):
        with torch.no_grad():
            self.ws, self.bs, self.meta = pack_hand_sdf_weights(sdf_params, cfg)

    def __call__(self, pts: torch.Tensor, bt_inv: torch.Tensor,
                 t_pose_21: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            rotT, off, cut = pack_hand_pose(bt_inv, t_pose_21)
        return fused_hand_sdf(pts.contiguous(), rotT, off, cut, self.ws, self.bs, self.meta)
