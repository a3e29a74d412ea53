"""Forward-only pose-conditioned hand SDF for the up-sample ladder;
counterpart of honerf_tpu.ops.fused_hand (FusedHandSDF, whose Pallas
kernel is `_run_kernel`/`_make_kernel`).

Per point: q_j = R_j p + T_j - tpose_j for 21 bones, v = |q|, r = q/v,
cutoff gate h = 1 - sigmoid(200 (v - cut)), gated PE of v (L=10) and r
(L=7) by the double-angle recurrence, the 1386-channel channel-major
embedding e, the 9-layer softplus trunk with the widened skip at 4, and
the sdf column only.  bf16 matmul operands, f32 accumulation.

On a CUDA tensor `fused_hand_sdf` launches two hand-written kernels a
chunk of points: hand_embed_kernel (csrc/common.cuh) and the whole trunk,
hand_trunk_fwd_kernel (csrc/trunk_fused.cu, fused_fine.trunk_fwd); on a
CPU tensor it runs `fused_hand_sdf_plain`, which repeats the same
statements with the same bf16 rounding points.

What bounds the kernels on an H100 and how their design answers that: the
notes at the top of csrc/fused_hand.cu and csrc/trunk_fused.cu; their
times: PERF.md.
"""

from __future__ import annotations

import ctypes
from typing import Any, Dict, List, NamedTuple, Tuple

import torch

from honerf_torch.models.embedding import BONE_CUTOFFS, CUTOFF_TAU
from honerf_torch.models.fields import SDFConfig, _flat_sdf_layers
from honerf_torch.models.mlp import linear_weight
from honerf_torch.ops import _build
from honerf_torch.ops import perpoint_layout as PL
from honerf_torch.ops import fused_fine as FT
from honerf_torch.ops.fused_fine import (
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
# The bf16 GEMMs (wgmma on a TMA ring, csrc/wgmma.cuh), launched by every
# bf16 kernel: each layer's product of K1, K2, K3, K4, K5 and K6 (the bf16
# matmuls of K1's pallas_call; also K2's, K3's, K4's at
# honerf_tpu/ops/fused_sdf.py:205, K5's and K6's), and dW of K3 and K6.
GEMM = _build.Kernel("gemm_kernel", "honerf_torch/ops/csrc/common.cuh",
                     "honerf_tpu/ops/fused_hand.py:400")
GEMM_TN = _build.Kernel("gemm_tn_kernel", "honerf_torch/ops/csrc/trunk.cuh",
                        "honerf_tpu/ops/fused_fine_full.py:1650")
# The f32 trunk mode's GEMMs, launched by K2, K3, K5 and K6 in f32: the
# f32 matmuls of K2's pallas_call (the NN product; also K3's, K5's at
# honerf_tpu/ops/fused_fine.py:452 and K6's at :488) and of K3's (dW; also
# K6's).
GEMM_F32 = _build.Kernel("gemm_f32_kernel", "honerf_torch/ops/csrc/common.cuh",
                         "honerf_tpu/ops/fused_fine_full.py:1556")
GEMM_TN_F32 = _build.Kernel("gemm_tn_f32_kernel", "honerf_torch/ops/csrc/trunk.cuh",
                            "honerf_tpu/ops/fused_fine_full.py:1650")
# The hand embedding e (bf16 or f32), launched by K1's chunk loop and by
# K2/K3's forward: K1's `embed` inside its pallas_call (also the embedding
# of K2's and K3's).
EMBED = _build.Kernel("hand_embed_kernel", "honerf_torch/ops/csrc/common.cuh",
                      "honerf_tpu/ops/fused_hand.py:273")


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
    """Gated f32 [sin(2^l x) g]_l, [cos(2^l x) g]_l by the double-angle
    recurrence: sin/cos(2^l x) = (2 s c, (c - s)(c + s))."""
    s, c = torch.sin(x), torch.cos(x)
    sins, coss = [], []
    for l in range(L):
        if l:
            s, c = 2.0 * s * c, (c - s) * (c + s)
        sins.append(s * gate)
        coss.append(c * gate)
    return sins, coss


def embed_plain(pts, rotT, off, cut, vL: int, rL: int, lde: int, dtype=torch.bfloat16):
    """hand_embed_kernel's function in plain PyTorch: e (N, lde) of dtype,
    the channel-major embedding with the kernel's recurrence, each value
    rounded once to dtype, zero-padded to lde columns."""
    st = _emb_stages(pts, rotT, off, cut)
    sv, cv = _pe_pieces(st["v"], st["h"], vL)
    sr, cr = _pe_pieces(st["rr"], st["h3"], rL)
    e = torch.cat([st["v"] * st["h"]] + sv + cv + [st["rr"] * st["h3"]] + sr + cr, dim=-1)
    return torch.nn.functional.pad(e, (0, lde - e.shape[1])).to(dtype)


def fused_hand_sdf_plain(pts, rotT, off, cut, ws, bs, meta: HandKernelMeta) -> torch.Tensor:
    """The kernel's statements in plain PyTorch: (N, 3) -> (N,) sdf."""
    tm = meta.trunk
    e = embed_plain(pts, rotT, off, cut, meta.v_multires, meta.r_multires, tm.Ep).float()
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
# The f32 GEMMs' arithmetic (csrc/common.cuh: split-precision 3xTF32)
# ---------------------------------------------------------------------------
# A model for the tests (tests/test_torch_tf32_split.py); nothing on the
# main path calls it: on the CPU the plain versions multiply in f32.

def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """f32 -> the nearest TF32 value (10 mantissa bits, ties away from
    zero; the kernels' cvt.rna), as f32 with the low 13 bits clear."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split_tf32(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (f32) = big + small + ~2^-22 |x|: big = tf32(x), small =
    tf32(x - big)."""
    big = tf32_round(x)
    return big, tf32_round(x.float() - big)


def matmul_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the f32 GEMMs form it: the three TF32 products small.big,
    big.small and big.big, summed in f64 (each TF32 product is exact in
    f64; the kernels sum in f32)."""
    ab, as_ = (t.double() for t in split_tf32(a))
    bb, bs = (t.double() for t in split_tf32(b))
    return as_ @ bb + ab @ bs + ab @ bb


def matmul_1xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One TF32 product, summed in f64: what a TF32 GEMM would form."""
    return tf32_round(a).double() @ tf32_round(b).double()


# ---------------------------------------------------------------------------
# CUDA path
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
EPI_F32, EPI_SOFTPLUS, EPI_RELU, EPI_SIGMOID, EPI_UCHAIN = range(5)


_GEMM_ARGS = [
    _P, _I, _I, _P, _I, _I, _F,      # A1, lda1, K1, A2, lda2, K2, a_scale
    _P, _I, _I, _P, _I,              # B, ldb, N, bias, M
    _I, _P, _I, _I,                  # mode, C, ldc, n_store
    _P, _I, _P, _I, _I, _F, _F, _I,  # S, lds, U, ldu, split, hscale, escale, u_acc
    _P, _I, _P, _I, _P, _I, _P, _I,  # Cf, ldcf, DS, ldds, CS, ldcs, Act, ldact
    _P]                              # stream


def _lib(name: str):
    lib = _build.load(name)
    if not getattr(lib, "_honerf_typed", False):
        for fn in ("honerf_hand_embed", "honerf_hand_embed_f32"):
            getattr(lib, fn).argtypes = [_P, _I, _P, _P, _P, _I, _I, _P, _I, _P]
            getattr(lib, fn).restype = _I
        for fn in ("honerf_gemm", "honerf_gemm_f32"):
            getattr(lib, fn).argtypes = _GEMM_ARGS
            getattr(lib, fn).restype = _I
        lib._honerf_typed = True
    return lib


def _ptr(t) -> int:
    return 0 if t is None else t.data_ptr()


def _ld(t) -> int:
    return 0 if t is None else t.stride(0)


def _f32(t) -> bool:
    """True for an f32 operand (the f32 trunk mode's kernel variants),
    False for bf16."""
    if t.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"kernel operands are bf16 or f32, got {t.dtype}")
    return t.dtype == torch.float32


def check_tma_operand(ptr: int, ld: int, what: str) -> None:
    """Raise on a bf16 GEMM operand that TMA cannot read (csrc/wgmma.cuh;
    the C entry points refuse it too): a base `ptr` not 16-byte aligned or
    rows `ld` elements apart that are not a multiple of 16 bytes apart."""
    if ptr % 16 or ld % 8:
        raise ValueError(f"{what}: the bf16 GEMMs take a 16-byte-aligned base and a row "
                         f"stride of a multiple of 16 bytes (base {ptr:#x}, stride {ld})")


def gemm(lib, A1, K1, A2, K2, B, N, bias, M, mode, C, ldc, n_store=0, a_scale=0.0,
         S=None, U=None, split=0, hscale=1.0, escale=1.0, u_acc=0, Cf=None, DS=None,
         CS=None, cs_ld=None, Act=None, stream=None):
    """One launch of the shared GEMM + epilogue (see csrc/common.cuh): the
    bf16 tensor-core kernel, or on f32 operands the f32 one.
    A = concat(A1[:, :K1], A2[:, :K2]) optionally scaled through
    T(x * a_scale); B (K1+K2, N) row-major, of A's type.  Cf/DS/CS/Act are
    the backward epilogues' extra rows (CS may be one row for every point:
    cs_ld=0)."""
    f32 = _f32(A1)
    if _f32(B) != f32 or (A2 is not None and _f32(A2) != f32):
        raise ValueError("the GEMM's operands must share one type")
    fn = lib.honerf_gemm_f32 if f32 else lib.honerf_gemm
    pa1, pa2, pb = _ptr(A1), _ptr(A2), _ptr(B)
    lda1, lda2, ldb = A1.stride(0), _ld(A2), B.stride(0)
    if f32:
        GEMM_F32.launches += 1
    else:
        check_tma_operand(pa1, lda1, "A1")
        check_tma_operand(pa2, lda2, "A2")
        check_tma_operand(pb, ldb, "B")
        GEMM.launches += 1
    rc = fn(
        pa1, lda1, K1, pa2, lda2, K2,
        a_scale, pb, ldb, N, _ptr(bias), M,
        mode, _ptr(C), ldc, n_store,
        _ptr(S), _ld(S), _ptr(U), _ld(U), split, hscale, escale, u_acc,
        _ptr(Cf), _ld(Cf), _ptr(DS), _ld(DS), _ptr(CS), _ld(CS) if cs_ld is None else cs_ld,
        _ptr(Act), _ld(Act), stream)
    _build.check(rc, "honerf_gemm_f32" if f32 else "honerf_gemm")


def embed(lib, pts, m, rotT, off, cut, vL, rL, e, stream):
    """The hand embedding of the first m points of pts into e[:m] (bf16, or
    f32 for an f32 e; csrc/common.cuh: hand_embed_kernel).  On a CPU e it
    writes embed_plain's rows and launches nothing."""
    if e.device.type == "cpu":
        e[:m] = embed_plain(pts[:m], rotT, off, cut, vL, rL, e.shape[1], e.dtype)
        return
    if e.stride(1) != 1 or m > min(e.shape[0], pts.shape[0]):
        raise ValueError(f"e must hold m = {m} rows of contiguous columns, pts m points")
    PL.check_emb_operand(e.data_ptr(), e.stride(0), e.element_size(), vL, rL)
    fn = lib.honerf_hand_embed_f32 if _f32(e) else lib.honerf_hand_embed
    EMBED.launches += 1
    rc = fn(pts.data_ptr(), m, rotT.data_ptr(), off.data_ptr(), cut.data_ptr(), vL, rL,
            e.data_ptr(), e.stride(0), stream)
    _build.check(rc, "honerf_hand_embed")


def check_operands(pts, rotT, off, cut, ws, bs, w_dtype=torch.bfloat16) -> None:
    """Raise on anything the kernels do not take; weights of w_dtype (bf16,
    or f32 for the f32 trunk mode)."""
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
        if w.dtype != w_dtype or w.shape[0] % 32 or w.shape[1] % 64:
            raise ValueError(f"weights must be {w_dtype} with rows % 32 == 0, cols % 64 == 0")
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
    KERNEL.launches += 1
    for s in range(0, N, C):
        # two launches a chunk: the embedding, then the whole trunk on chip
        m = min(C, N - s)
        embed(lib, pts[s:], m, rotT, off, cut, meta.v_multires, meta.r_multires, e, stream)
        FT.trunk_fwd(e, m, ws, bs, tm, sdf=out[s:], stream=stream)
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
