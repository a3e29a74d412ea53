"""Forward-only object SDF for mesh extraction; counterpart of
honerf_tpu.ops.fused_sdf (FusedObjSDF, whose Pallas kernel is
`_run_kernel`/`_make_kernel`).

Per point: the embedding e = [x, y, z, sin(2^k x), cos(2^k x) (k < L),
the same for y and z] in f32, the 9-layer softplus (beta = 100) trunk
with the shrink-output skip, x = concat(a[:, :d_prev], e) / sqrt2, and
the sdf column times 1/scale.  Every matmul operand is bf16 of an f32
value with f32 sums, the biases f32; at the skip both halves are rounded
once, bf16(f32 value * f32(1/sqrt2)), as in the JAX kernel.

On a CUDA tensor `fused_obj_sdf` launches the hand-written kernels of
csrc/fused_sdf.cu; on a CPU tensor it runs `fused_obj_sdf_plain`, which
states the same rounding points.  What bounds the kernel on an H100 and
how its design answers that: the note at the top of csrc/fused_sdf.cu;
its times: PERF.md.
"""

from __future__ import annotations

import ctypes
from typing import Any, Dict, NamedTuple, Tuple

import torch

from honerf_torch.models.embedding import positional_encoding
from honerf_torch.models.fields import SDFConfig
from honerf_torch.models.mlp import linear_weight
from honerf_torch.ops import _build
from honerf_torch.ops import fused_hand as FH
from honerf_torch.ops.fused_fine import INV_SQRT2, PAD, _round_up, _softplus_beta

# points per pass of the CUDA path: the two (CHUNK, 256) bf16 activation
# buffers (33.5 MB) stay inside the H100's 50 MB L2
CHUNK = 32768
EPI_SP_SCALE, EPI_F32_SCALE = 8, 9

KERNEL = _build.Kernel(
    "fused_obj_sdf", "honerf_torch/ops/csrc/fused_sdf.cu",
    "honerf_tpu/ops/fused_sdf.py:205")


class ObjKernelMeta(NamedTuple):
    emb_width: int                # E = 3 + 6 L
    skips: Tuple[int, ...]        # layers whose input is concat(a, e) / sqrt2
    out_widths: Tuple[int, ...]   # unpadded output width of each layer (last: 1)
    multires: int                 # L
    scale: float

    @property
    def Ep(self) -> int:
        return _round_up(self.emb_width, PAD)

    @property
    def n_layers(self) -> int:
        return len(self.out_widths)


def pack_obj_sdf_weights(params: Dict[str, Any], cfg: SDFConfig):
    """bf16 (in, out) weights zero-padded to multiples of PAD, f32 biases,
    the last layer's sdf column only; a skip layer's rows are [activation
    block | embedding block], each padded on its own."""
    assert cfg.kind == "obj", "the object SDF kernel takes the object net"
    E = cfg.input_width
    Ep = _round_up(E, PAD)
    layers = params["layers"]
    n = len(layers)
    skips = tuple(cfg.skip_in)
    assert all(0 < s < n - 1 for s in skips)
    ws, bs, outs = [], [], []
    for l, layer in enumerate(layers):
        w = linear_weight(layer).T
        b = layer["b"]
        if l == n - 1:
            w, b = w[:, :1], b[:1]
        d_in, d_out = w.shape
        op = _round_up(d_out, PAD)
        if l in skips:
            d_prev = d_in - E
            assert d_prev == outs[-1], "skip input must be the previous output and e"
            ap = _round_up(d_prev, PAD)
            wp = w.new_zeros((ap + Ep, op))
            wp[:d_prev, :d_out] = w[:d_prev]
            wp[ap:ap + E, :d_out] = w[d_prev:]
        else:
            assert d_in == (E if l == 0 else outs[-1])
            wp = w.new_zeros((_round_up(d_in, PAD), op))
            wp[:d_in, :d_out] = w
        bp = b.new_zeros((op,))
        bp[:d_out] = b
        ws.append(wp.to(torch.bfloat16).contiguous())
        bs.append(bp.float().contiguous())
        outs.append(d_out)
    meta = ObjKernelMeta(emb_width=E, skips=skips, out_widths=tuple(outs),
                         multires=cfg.v_multires, scale=float(cfg.scale))
    return tuple(ws), tuple(bs), meta


def _bf(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


def fused_obj_sdf_plain(pts, ws, bs, meta: ObjKernelMeta) -> torch.Tensor:
    """The kernel's statements in plain PyTorch: (N, 3) -> (N,) sdf."""
    e = torch.cat([pts.float(), positional_encoding(pts.float(), meta.multires)], dim=-1)
    e = torch.nn.functional.pad(e, (0, meta.Ep - meta.emb_width))
    es = _bf(e * INV_SQRT2)
    a = _bf(e)
    for l in range(meta.n_layers):
        x = torch.cat([a, es], dim=-1) if l in meta.skips else a
        y = x @ ws[l].float() + bs[l]
        if l < meta.n_layers - 1:
            sp = _softplus_beta(y)
            sp[:, meta.out_widths[l]:] = 0.0  # softplus(0) != 0 on the padding
            a = _bf(sp * INV_SQRT2) if l + 1 in meta.skips else _bf(sp)
    return y[:, 0] * (1.0 / meta.scale)


# ---------------------------------------------------------------------------
# CUDA path
# ---------------------------------------------------------------------------

def _lib():
    lib = FH._lib("fused_sdf")
    if not getattr(lib, "_honerf_obj_typed", False):
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.honerf_obj_embed.argtypes = [P, I, I, ctypes.c_float, P, P, I, P]
        lib.honerf_obj_embed.restype = I
        lib._honerf_obj_typed = True
    return lib


def check_operands(pts, ws, bs, meta: ObjKernelMeta) -> None:
    """Raise on anything the kernels do not take."""
    if pts.dim() != 2 or pts.shape[1] != 3 or pts.dtype != torch.float32:
        raise ValueError(f"pts must be (N, 3) float32, got {tuple(pts.shape)} {pts.dtype}")
    if len(ws) != meta.n_layers or len(bs) != meta.n_layers:
        raise ValueError("one weight and one bias per layer")
    for t in (pts, *ws, *bs):
        if t.device != pts.device:
            raise ValueError("all operands must be on one device")
        if not t.is_contiguous():
            raise ValueError("operands must be contiguous")
    rows = meta.Ep
    for l, (w, b) in enumerate(zip(ws, bs)):
        if w.dtype != torch.bfloat16 or w.dim() != 2 or w.shape[0] % PAD or w.shape[1] % PAD:
            raise ValueError(f"weights must be bf16 with rows and cols % {PAD} == 0")
        if b.dtype != torch.float32 or tuple(b.shape) != (w.shape[1],):
            raise ValueError("biases must be float32, one per weight column")
        want = rows + meta.Ep if l in meta.skips else rows
        if w.shape[0] != want:
            raise ValueError(f"layer {l}: {w.shape[0]} weight rows, its input has {want}")
        rows = w.shape[1]


def _fused_obj_sdf_cuda(pts, ws, bs, meta: ObjKernelMeta) -> torch.Tensor:
    lib = _lib()
    dev = pts.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    N, Ep, n = pts.shape[0], meta.Ep, meta.n_layers
    out = torch.empty((N,), device=dev, dtype=torch.float32)
    if N == 0:
        return out
    C = min(N, CHUNK)
    e = torch.empty((C, Ep), device=dev, dtype=torch.bfloat16)
    es = torch.empty((C, Ep), device=dev, dtype=torch.bfloat16)
    width = max(w.shape[1] for w in ws[:-1])
    acts = [torch.empty((C, width), device=dev, dtype=torch.bfloat16) for _ in range(2)]
    KERNEL.launches += 1
    for s in range(0, N, C):
        m = min(C, N - s)
        _build.check(lib.honerf_obj_embed(pts[s:].data_ptr(), m, meta.multires, INV_SQRT2,
                                          e.data_ptr(), es.data_ptr(), Ep, stream),
                     "honerf_obj_embed")
        a = e
        for l in range(n):
            K1 = ws[l].shape[0] - (Ep if l in meta.skips else 0)
            A2, K2 = (es, Ep) if l in meta.skips else (None, 0)
            if l < n - 1:
                nxt = acts[l % 2]
                mode = EPI_SP_SCALE if l + 1 in meta.skips else FH.EPI_SOFTPLUS
                FH.gemm(lib, a, K1, A2, K2, ws[l], ws[l].shape[1], bs[l], m, mode, nxt,
                        nxt.stride(0), hscale=INV_SQRT2, stream=stream)
                a = nxt
            else:
                FH.gemm(lib, a, K1, A2, K2, ws[l], ws[l].shape[1], bs[l], m, EPI_F32_SCALE,
                        out[s:], 1, n_store=1, hscale=1.0 / meta.scale, stream=stream)
    return out


def fused_obj_sdf(pts, ws, bs, meta: ObjKernelMeta) -> torch.Tensor:
    """(N, 3) f32 -> (N,) sdf.  CUDA tensors launch the kernel; CPU
    tensors run the plain version.  No gradient flows through it."""
    check_operands(pts, ws, bs, meta)
    with torch.no_grad():
        if pts.device.type == "cuda":
            return _fused_obj_sdf_cuda(pts, ws, bs, meta)
        if pts.device.type != "cpu":
            raise ValueError(f"unsupported device {pts.device}")
        return fused_obj_sdf_plain(pts, ws, bs, meta)


class FusedObjSDF:
    """(N, 3) -> (N,) object SDF for one parameter snapshot:
        fused = FusedObjSDF(params['sdf'], cfg)
        sdf = fused(pts)
    """

    def __init__(self, sdf_params: Dict[str, Any], cfg: SDFConfig):
        with torch.no_grad():
            self.ws, self.bs, self.meta = pack_obj_sdf_weights(sdf_params, cfg)

    def __call__(self, pts: torch.Tensor) -> torch.Tensor:
        return fused_obj_sdf(pts.contiguous(), self.ws, self.bs, self.meta)
