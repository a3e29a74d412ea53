"""Forward-only object SDF for mesh extraction; counterpart of
honerf_tpu.ops.fused_sdf (FusedObjSDF, whose Pallas kernel is
`_run_kernel`/`_make_kernel`).

Per point: the embedding e = [x, y, z, sin(2^k x), cos(2^k x) (k < L),
the same for y and z] in f32, the 9-layer softplus (beta = 100) trunk
with the shrink-output skip, x = concat(a[:, :d_prev], e) / sqrt2, and
the sdf column times 1/scale.  Every matmul operand is bf16 of an f32
value with f32 sums, the biases f32; at the skip both halves are rounded
once, bf16(f32 value * f32(1/sqrt2)), as in the JAX kernel.

On a CUDA tensor `fused_obj_sdf` launches the hand-written kernel of
csrc/fused_sdf.cu (obj_sdf_fused_kernel: the PE and all the layers in one
launch, the activations in shared memory); on a CPU tensor it runs
`fused_obj_sdf_plain`, which states the same rounding points.  What
bounds the kernel on an H100 and how its design answers that: the note at
the top of csrc/fused_sdf.cu (its layout arithmetic: ops/wgmma_layout.py,
the K4_* names); its times: PERF.md.
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
from honerf_torch.ops import wgmma_layout as WL
from honerf_torch.ops.fused_fine import INV_SQRT2, PAD, _round_up, _softplus_beta

KERNEL = _build.Kernel(
    "obj_sdf_fused_kernel", "honerf_torch/ops/csrc/fused_sdf.cu",
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
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.honerf_obj_sdf.argtypes = [P, I, I, F, F, I, P, P, P, P, P, P, P, P]
        lib.honerf_obj_sdf.restype = I
        lib._honerf_obj_typed = True
    return lib


def check_operands(pts, ws, bs, meta: ObjKernelMeta) -> None:
    """Raise on anything the kernel does not take."""
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


def check_fused_shape(ws, meta: ObjKernelMeta) -> None:
    """Raise where the one-launch kernel's tiles do not hold the net: a PE
    wider than WL.K4_EP columns (or none), a layer wider than WL.K4_WIDTH,
    a last layer of other than 64 columns (the sdf column padded; it runs
    on m64n64k16), more than WL.K4_MAX_LAYERS layers, a skip at layer 0."""
    if (meta.Ep != WL.K4_EP or not 1 <= meta.multires <= (WL.K4_EP - 3) // 6
            or meta.n_layers > WL.K4_MAX_LAYERS
            or any(w.shape[1] > WL.K4_WIDTH for w in ws) or ws[-1].shape[1] != 64
            or 0 in meta.skips):
        raise ValueError(f"the fused object SDF kernel takes a PE of at most {WL.K4_EP} "
                         f"columns, layers of at most {WL.K4_WIDTH} columns, at most "
                         f"{WL.K4_MAX_LAYERS} layers and no skip at layer 0 (Ep {meta.Ep}, "
                         f"L {meta.multires}, widths {[w.shape[1] for w in ws]}, skips "
                         f"{meta.skips})")


def _fused_obj_sdf_cuda(pts, ws, bs, meta: ObjKernelMeta) -> torch.Tensor:
    check_fused_shape(ws, meta)
    lib = _lib()
    dev = pts.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    N, n = pts.shape[0], meta.n_layers
    out = torch.empty((N,), device=dev, dtype=torch.float32)
    if N == 0:
        return out
    ptrs = lambda ts: (ctypes.c_void_p * n)(*[t.data_ptr() for t in ts])  # noqa: E731
    ints = lambda xs: (ctypes.c_int * n)(*xs)  # noqa: E731
    KERNEL.launches += 1
    _build.check(lib.honerf_obj_sdf(
        pts.data_ptr(), N, meta.multires, INV_SQRT2, 1.0 / meta.scale, n, ptrs(ws),
        ints([w.shape[0] for w in ws]), ints([w.shape[1] for w in ws]), ints(meta.out_widths),
        ints([int(l in meta.skips) for l in range(n)]), ptrs(bs), out.data_ptr(), stream),
        "honerf_obj_sdf")
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
