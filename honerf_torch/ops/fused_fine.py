"""The hand trunk + u-chain from a given embedding, forward and its
second-order VJP; counterpart of honerf_tpu.ops.fused_fine
(`hand_trunk_sdf_u`, whose Pallas kernels are `_fwd_call` -> K5 and
`_bwd_call` -> K6), and the trunk statements and launch sequences that
the fine pass (ops.fused_fine_full, K2 and K3) shares with it.

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

`trunk_sdf_u_ref` / `trunk_sdf_u_bwd_ref` state these on the unpadded
(in, out) weights: the spec the tests hold against the JAX package.

Padded layout (shared by the plain versions and the CUDA kernels): every
width is rounded up to PAD, a multiple of the CUDA GEMM's K step, with
zero weight rows and columns; the skip layer's rows are [hidden (Hp) | embedding (Ep)].
bf16 mode rounds every matmul operand to bf16 and accumulates in f32.

Entry points:
  * `hand_trunk_sdf_u(e, ws, bs, meta)`: e (N, E) -> (out (N, d_out),
    u (N, E)), differentiable (torch.autograd.Function) in e and the
    unpadded (in, out) weights; it packs them in its forward, and its
    backward recomputes the forward.  Weights that need no gradient
    launch no dW work.
  * `hand_trunk_sdf_u_fwd(e, pack)`: the forward on a TrunkPack made once
    per parameter snapshot (the eval render).
On CUDA tensors the forward launches csrc/fused_trunk.cu (K5) and the
backward K6 from the same source, with a bf16 or an f32 trunk
(`TrunkMeta.dtype`); the trunk's forward and u-chain are two launches
(`trunk_fwd`, `trunk_uchain`: every layer of a tile of points on chip) of
csrc/trunk_fused.cu for a bf16 trunk and of csrc/trunk_fused_f32.cu (3xTF32
on wgmma) for an f32 one; the backward's two chains are two launches too
(`trunk_ut`, `trunk_dz`: csrc/trunk_bwd.cu for a bf16 trunk,
csrc/trunk_bwd_f32.cu for an f32 one).  On CPU
tensors both run their plain versions (`hand_trunk_sdf_u_plain`,
`hand_trunk_sdf_u_plain_bwd`, on the block bodies `_kernel_fwd_body`, that
is `trunk_fwd_plain` then `trunk_uchain_plain`, and `_trunk_bwd_block`, on
`trunk_ut_plain` and `trunk_dz_plain`).

What bounds the kernels on an H100 and how their design answers that: the
note at the top of csrc/fused_trunk.cu; their times: PERF.md.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import List, NamedTuple, Tuple

import torch

from honerf_torch.ops import _build
from honerf_torch.ops import perpoint_layout as PL
from honerf_torch.ops import wgmma_layout as WL

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


def trunk_fwd_plain(e, m: int, ws, bs, meta: TrunkMeta, last: bool = True):
    """hand_trunk_fwd_kernel's function in plain PyTorch on e[:m] (Ep
    columns, already in the trunk dtype's values): (acts, ss, z) with
    acts[l] = T(softplus(z_l)) and ss[l] = sigmoid(beta z_l) (f32, l < n - 1)
    and z the last layer's (m, Op) f32 sums with bias (None without
    `last`).  T rounds to the trunk dtype; the skip's input is
    T(concat(a, e) * skip scale), as the kernel forms it."""
    n = meta.n_layers
    x0 = e[:m].float()
    a = x0
    acts: List[torch.Tensor] = []
    ss: List[torch.Tensor] = []
    z = None
    for l in range(n if last else n - 1):
        x = _skip_concat(meta, a, x0) if l == meta.skip else a
        y = _mm(meta, x, ws[l]) + bs[l]
        if l < n - 1:
            ss.append(torch.sigmoid(BETA * y))
            a = _rnd(meta, _softplus_beta(y))
            acts.append(a)
        else:
            z = y
    return acts, ss, z


def trunk_uchain_plain(ss, ws, meta: TrunkMeta, with_u: bool = True):
    """hand_uchain_kernel's function in plain PyTorch from the forward's
    sigmoid rows: (u (B, Ep), ts, cs), u = d z[:, 0] / d e (None without
    `with_u`), t_l (l < n; t_{n-1} the one-hot sdf column) and c_l (l >= 1
    without u, else every l) of m_l = t_l W_l^T, c_l = m_l (the skip:
    m[:, :Hp] / sqrt2, its m[:, Hp:] / sqrt2 into u), t_{l-1} = c_l s_{l-1},
    u += c_0.  Each product rounds its operand to the trunk dtype."""
    n, Hp = meta.n_layers, meta.Hp
    t = ss[0].new_zeros((ss[0].shape[0], meta.Op))
    t[:, 0] = 1.0
    ts: List[torch.Tensor] = [None] * n
    cs: List[torch.Tensor] = [None] * n
    ts[n - 1] = t
    u = None
    for l in range(n - 1, -1 if with_u else 0, -1):
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
    return (u if with_u else None), ts, cs


def _kernel_fwd_body(meta: TrunkMeta, e: torch.Tensor, ws, bs, residuals: bool = False):
    """Forward + u-chain on one block: e (B, Ep) already in the trunk
    dtype's values (trunk_fwd_plain, then trunk_uchain_plain).  Returns
    (z_last (B, Op), u (B, Ep), ss), and with `residuals` also the
    backward's (ins, ts, cs): each layer's input, the u-chain's t_l and
    c_l."""
    acts, ss, z_last = trunk_fwd_plain(e, e.shape[0], ws, bs, meta)
    u, ts, cs = trunk_uchain_plain(ss, ws, meta)
    if residuals:
        ins = [e.float() if l == 0 else (_skip_concat(meta, acts[l - 1], e.float())
                                         if l == meta.skip else acts[l - 1])
               for l in range(meta.n_layers)]
        return z_last, u, ss, ins, ts, cs
    return z_last, u, ss


def trunk_ut_plain(du_b, du_s, m: int, ws, ss, cs, meta: TrunkMeta, keep: bool = False):
    """hand_trunk_ut_f32_kernel's function in plain PyTorch, the u-chain
    transposed upward on m points from du_b = du and du_s = du / sqrt2
    (Ep columns): (ds, dms) with dt_l = dm_l W_l, ds[l] = dt_l c_{l+1} and
    dm_{l+1} = (dt_l s_l) (/ sqrt2 into the skip) for l < n - 1, where
    dm_0 = du_b and the skip's product reads [dm_skip | du_s].  cs[l]: the
    u-chain's c rows of the m points (1 <= l < n; cs[n - 1] may be the one
    row every point shares).  dms (with `keep`, else None): [None, dm_1, ..., dm_{n-1}], the
    rows the weight gradients read.  Each product rounds its operand to
    the trunk dtype."""
    n, skip = meta.n_layers, meta.skip
    ds: List[torch.Tensor] = [None] * (n - 1)
    dms: List[torch.Tensor] = [None] * n
    dm = du_b[:m].float()
    for l in range(n - 1):
        x = torch.cat([dm, du_s[:m].float()], dim=-1) if l == skip else dm
        dt = _mm(meta, x, ws[l])
        ds[l] = dt * cs[l + 1]
        dm = dt * ss[l][:m]
        if l + 1 == skip:
            dm = dm * INV_SQRT2
        dms[l + 1] = dm
    return ds, (dms if keep else None)


def trunk_dz_plain(top, m: int, ws, ss, ds, meta: TrunkMeta, keep: bool = False):
    """hand_trunk_dz_f32_kernel's function in plain PyTorch, the forward
    transposed downward on m points from the top cotangent dz_{n-1} =
    top[:m] (Op columns): (de (m, Ep), dzs) with din_l = dz_l W_l^T and
    dz_{l-1} = da s_{l-1} + ds_{l-1} (beta s (1 - s)), da = din_l (the skip:
    din[:, :Hp] / sqrt2, and de = din[:, Hp:] / sqrt2), then de += din_0.
    dzs (with `keep`, else None): [dz_0, ..., dz_{n-1}], the rows the
    weight gradients read (dz_{n-1} the top's).  Each product rounds its
    operand to the trunk dtype."""
    n, Hp = meta.n_layers, meta.Hp
    dzs: List[torch.Tensor] = [None] * n
    dz = dzs[n - 1] = top[:m].float()
    de = None
    for l in range(n - 1, 0, -1):
        din = _mm_t(meta, dz, ws[l])
        if l == meta.skip:
            da = din[:, :Hp] * INV_SQRT2
            de = din[:, Hp:] * INV_SQRT2
        else:
            da = din
        sig = ss[l - 1][:m]
        dz = dzs[l - 1] = da * sig + ds[l - 1][:m] * (BETA * sig * (1.0 - sig))
    de = de + _mm_t(meta, dz, ws[0])
    return de, (dzs if keep else None)


def _trunk_bwd_block(meta: TrunkMeta, dout: torch.Tensor, du: torch.Tensor, ws, fwd,
                     want_dw: bool = True):
    """Transposed trunk statements for one block at cotangents dout
    (B, Op) on z_last and du (B, Ep) on u, given the forward's
    (ss, ins, ts, cs): the two chains (trunk_ut_plain, trunk_dz_plain),
    then dW_l = dm_l^T t_l + in_l^T dz_l and db_l = sum dz_l.  Returns
    (de (B, Ep), dws, dbs); want_dw=False (frozen nets) skips every
    dW = X^T dY product and the db sums and returns (de, None, None)."""
    n, B = meta.n_layers, du.shape[0]
    ss, ins, ts, cs = fwd
    du_s = du * INV_SQRT2
    ds, dms = trunk_ut_plain(du, du_s, B, ws, ss, cs, meta, keep=want_dw)
    de, dzs = trunk_dz_plain(dout, B, ws, ss, ds, meta, keep=want_dw)
    if not want_dw:
        return de, None, None
    dws: List[torch.Tensor] = [None] * n
    dbs: List[torch.Tensor] = [None] * n
    for l in range(n):
        # m = t W^T: dW += dm^T t (the skip's dm is [dm_skip | du_s])
        dm = du if l == 0 else (torch.cat([dms[l], du_s], dim=-1) if l == meta.skip
                                else dms[l])
        dws[l] = _mm_tn(meta, dm, ts[l]) + _mm_tn(meta, ins[l], dzs[l])
        dbs[l] = dzs[l].sum(0)
    return de, dws, dbs


# ---------------------------------------------------------------------------
# The spec on unpadded (in, out) weights (honerf_tpu.ops.fused_fine's
# trunk_sdf_u_ref / trunk_sdf_u_bwd_ref)
# ---------------------------------------------------------------------------

def _trunk_forward_ref(e, ws, bs, meta: TrunkMeta):
    """(zs, ss, ins, out) of the trunk on (N, E) e; s_l = sigmoid(beta z_l)."""
    zs, ss, ins = [], [], []
    a = _rnd(meta, e)
    e_in = a
    for l in range(meta.n_layers):
        x = _skip_concat(meta, a, e_in) if l == meta.skip else a
        ins.append(x)
        z = _mm(meta, x, ws[l]) + bs[l]
        zs.append(z)
        if l < meta.n_layers - 1:
            ss.append(torch.sigmoid(BETA * z))
            a = _rnd(meta, _softplus_beta(z))
    return zs, ss, ins, zs[-1]


def _u_chain_ref(ws, ss, meta: TrunkMeta):
    """(u, ts, cs): d out[:, 0] / d e and the chain's t_l and c_l."""
    H, n = meta.d_hidden, meta.n_layers
    t = ss[0].new_zeros((ss[0].shape[0], meta.d_out))
    t[:, 0] = 1.0
    ts: List[torch.Tensor] = [None] * n
    cs: List[torch.Tensor] = [None] * n
    ts[n - 1] = t
    u = None
    for l in range(n - 1, -1, -1):
        m = _mm_t(meta, ts[l], ws[l])
        if l == meta.skip:
            c = m[:, :H] * INV_SQRT2
            u = m[:, H:] * INV_SQRT2
        else:
            c = m
        cs[l] = c
        if l > 0:
            ts[l - 1] = c * ss[l - 1]
        else:
            u = u + c
    return u, ts, cs


def trunk_sdf_u_ref(e, ws, bs, meta: TrunkMeta):
    """(N, E) -> (out (N, d_out), u (N, E) = d out[:, 0] / d e)."""
    _, ss, _, out = _trunk_forward_ref(e, ws, bs, meta)
    u, _, _ = _u_chain_ref(ws, ss, meta)
    return out, u


def trunk_sdf_u_bwd_ref(e, ws, bs, meta: TrunkMeta, dout, du):
    """The hand-transposed VJP of trunk_sdf_u_ref at cotangents dout
    (N, d_out) and du (N, E): (de, dws, dbs).  Its products are f32, as
    in the JAX package's spec; the kernels round their operands to the
    trunk dtype (`_trunk_bwd_block`)."""
    H, n = meta.d_hidden, meta.n_layers
    _, ss, ins, _ = _trunk_forward_ref(e, ws, bs, meta)
    _, ts, cs = _u_chain_ref(ws, ss, meta)
    dws = [torch.zeros_like(w, dtype=torch.float32) for w in ws]
    dbs = [torch.zeros_like(b, dtype=torch.float32) for b in bs]
    ds = [torch.zeros_like(s) for s in ss]
    # transpose of the u-chain, upward
    dt = None
    for l in range(n):
        if l > 0:
            dc = dt * ss[l - 1]
            ds[l - 1] = ds[l - 1] + dt * cs[l]
        else:
            dc = du
        dm = torch.cat([dc * INV_SQRT2, du * INV_SQRT2], dim=-1) if l == meta.skip else dc
        dt = dm @ ws[l].float()
        dws[l] = dws[l] + dm.T @ ts[l]   # m = t W^T: dW += dm^T t
    # transpose of the forward, downward
    dz = dout
    de = torch.zeros_like(e, dtype=torch.float32)
    din = None
    for l in range(n - 1, -1, -1):
        if l < n - 1:
            if l + 1 == meta.skip:
                da = din[:, :H] * INV_SQRT2
                de = de + din[:, H:] * INV_SQRT2
            else:
                da = din
            dz = da * ss[l] + ds[l] * BETA * ss[l] * (1.0 - ss[l])
        dws[l] = dws[l] + ins[l].T @ dz
        dbs[l] = dbs[l] + dz.sum(0)
        din = dz @ ws[l].float().T
    return de + din, dws, dbs


# ---------------------------------------------------------------------------
# Packed weights and the plain versions of K5 / K6
# ---------------------------------------------------------------------------

class TrunkPack(NamedTuple):
    """Padded weights of one parameter snapshot (`_pad_weights`); wts are
    the transposed weights the CUDA u-chain and backward read (None on the
    CPU)."""

    ws: Tuple[torch.Tensor, ...]
    bs: Tuple[torch.Tensor, ...]
    wts: object
    meta: TrunkMeta


def pack_trunk_weights(ws, bs, meta: TrunkMeta) -> TrunkPack:
    """(in, out) f32 trunk weights (channel-major e columns) -> TrunkPack."""
    assert 0 < meta.skip < meta.n_layers - 1
    with torch.no_grad():
        wps, bps = _pad_weights(ws, bs, meta)
        wts = tuple(w.T.contiguous() for w in wps) if wps[0].device.type == "cuda" else None
    return TrunkPack(wps, bps, wts, meta)


def unpad_trunk_grads(dws, dbs, meta: TrunkMeta, w_shapes):
    """Padded dW/db -> gradients of the unpadded (in, out) weights: the
    skip layer's [Hp | Ep] rows joined."""
    H, E, Hp = meta.d_hidden, meta.emb_width, meta.Hp
    out_w, out_b = [], []
    for l, (dw, db, (d_in, d_out)) in enumerate(zip(dws, dbs, w_shapes)):
        if l == meta.skip:
            dw = torch.cat([dw[:H], dw[Hp:Hp + E]], dim=0)
        out_w.append(dw[:d_in, :d_out])
        out_b.append(db[:d_out])
    return out_w, out_b


def _e_block(meta: TrunkMeta, e: torch.Tensor) -> torch.Tensor:
    """(B, E) f32 -> the padded (B, Ep) GEMM operand in the trunk dtype's values."""
    return _rnd(meta, torch.nn.functional.pad(e, (0, meta.Ep - meta.emb_width)))


def hand_trunk_sdf_u_plain(e, pack: TrunkPack, block: int = 4096):
    """K5's statements in plain PyTorch, in blocks of points."""
    tm = pack.meta
    out = e.new_empty((e.shape[0], tm.d_out))
    u = e.new_empty(e.shape)
    for s in range(0, e.shape[0], block):
        z, ub, _ = _kernel_fwd_body(tm, _e_block(tm, e[s:s + block]), pack.ws, pack.bs)
        out[s:s + block] = z[:, :tm.d_out]
        u[s:s + block] = ub[:, :tm.emb_width]
    return out, u


def hand_trunk_sdf_u_plain_bwd(e, pack: TrunkPack, dout, du, want_dw: bool = True,
                               block: int = 4096):
    """K6's statements in plain PyTorch, in blocks of points: (de (N, E),
    padded f32 dws, dbs summed over the blocks; None, None without
    want_dw)."""
    tm = pack.meta
    E = tm.emb_width
    de = e.new_empty(e.shape)
    dws = [torch.zeros(w.shape, device=e.device) for w in pack.ws] if want_dw else None
    dbs = [torch.zeros(b.shape, device=e.device) for b in pack.bs] if want_dw else None
    for s in range(0, e.shape[0], block):
        sl = slice(s, s + block)
        _, _, ss, ins, ts, cs = _kernel_fwd_body(tm, _e_block(tm, e[sl]), pack.ws, pack.bs,
                                                 residuals=True)
        dout_p = torch.nn.functional.pad(dout[sl], (0, tm.Op - tm.d_out))
        du_p = torch.nn.functional.pad(du[sl], (0, tm.Ep - E))
        d_e, dw, db = _trunk_bwd_block(tm, dout_p, du_p, pack.ws, (ss, ins, ts, cs), want_dw)
        de[sl] = d_e[:, :E]
        if want_dw:
            for acc, x in zip(dws + dbs, dw + db):
                acc += x
    return de, (tuple(dws) if want_dw else None), (tuple(dbs) if want_dw else None)


# ---------------------------------------------------------------------------
# CUDA path: the trunk's launch sequences, shared with ops.fused_fine_full
# ---------------------------------------------------------------------------

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
EPI_UT, EPI_DZ = 5, 6
# points per pass of K5 / K6: the per-point scratch is ~18 KB forward,
# ~60 KB backward (every activation, sigmoid, t and c row kept)
CHUNK = 65536
BWD_CHUNK = 65536


def chunk_size(n: int, dtype: str, limit: int) -> int:
    """Points per pass for n points: `limit` in bf16; in f32, whose operand
    rows take twice the bytes, at most limit / 2 (so the scratch stays
    within the bf16 chunk's bytes), the passes balanced (rows a multiple
    of the GEMM tile)."""
    if dtype == "bf16" or n <= limit // 2:
        return min(n, limit)
    passes = -(-n // (limit // 2))
    return min(n, _round_up(-(-n // passes), 128))

# dW = X^T dY and column sums run split over the points, each partial in
# f32 scratch, then summed in a fixed order (two runs give the same bits):
# in f32 enough (tile, split) blocks for ~2 waves of 132 SMs; in bf16 about
# one work unit per SM of gemm_tn_kernel's persistent blocks
# (wgmma_layout.tn_split)
_TN_BLOCKS = 264
_TN_BLOCKS_BF16 = 132
_TN_TILE = 128
# the f32 scratch of those partials (floats): ~17 MB at the widest call
_WS_FLOATS = 8 << 20

KERNEL_FWD = _build.Kernel(
    "hand_trunk_sdf_u_fwd", "honerf_torch/ops/csrc/fused_trunk.cu",
    "honerf_tpu/ops/fused_fine.py:452")
KERNEL_BWD = _build.Kernel(
    "hand_trunk_sdf_u_bwd", "honerf_torch/ops/csrc/fused_trunk.cu",
    "honerf_tpu/ops/fused_fine.py:488")
# db of K3 and K6 (bf16 and f32): the column sums inside their
# pallas_calls' bodies (also K6's at honerf_tpu/ops/fused_fine.py:488).
COLSUM = _build.Kernel("colsum_partial_kernel", "honerf_torch/ops/csrc/trunk.cuh",
                       "honerf_tpu/ops/fused_fine_full.py:1650")
# the u-chain's first step, inside the bodies of K5 (honerf_tpu/ops/fused_fine.py:452)
# and of K2, K3, K6
UCHAIN = _build.Kernel("uchain_seed_kernel", "honerf_torch/ops/csrc/trunk.cuh",
                       "honerf_tpu/ops/fused_fine.py:452")
# the padded-row copy: the columns the bodies of K2 / K3 no-color
# (honerf_tpu/ops/fused_fine_full.py:1556, :1650) and K5 / K6 write
# themselves
COPY = _build.Kernel("copy_cols_kernel", "honerf_torch/ops/csrc/trunk.cuh",
                     "honerf_tpu/ops/fused_fine_full.py:1556")
# K5 / K6's operand, the pack of e (jnp.pad(e, ...).astype(_cast(meta)),
# honerf_tpu/ops/fused_fine.py:527 and :550, before the pallas_calls)
PACK = _build.Kernel("trunk_pack_e_kernel", "honerf_torch/ops/csrc/fused_trunk.cu",
                     "honerf_tpu/ops/fused_fine.py:452")
# The bf16 trunk in two launches (csrc/trunk_fused.cu): its forward, K1's
# whole body (the pallas_call at honerf_tpu/ops/fused_hand.py:400) and the
# forward half of `_kernel_fwd_body` inside K5's (honerf_tpu/ops/fused_fine.py:452)
# and K2's (honerf_tpu/ops/fused_fine_full.py:1556); its u-chain, the
# other half, inside K5's and K2's, and the recompute of K3 and K6.
TRUNK_FWD = _build.Kernel("hand_trunk_fwd_kernel", "honerf_torch/ops/csrc/trunk_fused.cu",
                          "honerf_tpu/ops/fused_hand.py:400")
TRUNK_UCHAIN = _build.Kernel("hand_uchain_kernel", "honerf_torch/ops/csrc/trunk_fused.cu",
                             "honerf_tpu/ops/fused_fine.py:452")
# The f32 trunk in two launches (csrc/trunk_fused_f32.cu): the f32 mode of
# `_kernel_fwd_body` (honerf_tpu/ops/fused_fine.py:275-323), the forward
# inside K2's pallas_call with FineMeta(dtype='f32')
# (honerf_tpu/ops/fused_fine_full.py:1556) and K5's, the u-chain inside
# K5's (honerf_tpu/ops/fused_fine.py:452) and K2's; both in the recompute of
# K3 and K6.
TRUNK_FWD_F32 = _build.Kernel("hand_trunk_fwd_f32_kernel",
                              "honerf_torch/ops/csrc/trunk_fused_f32.cu",
                              "honerf_tpu/ops/fused_fine_full.py:1556")
TRUNK_UCHAIN_F32 = _build.Kernel("hand_uchain_f32_kernel",
                                 "honerf_torch/ops/csrc/trunk_fused_f32.cu",
                                 "honerf_tpu/ops/fused_fine.py:452")
# The f32 trunk's backward in two launches (csrc/trunk_bwd_f32.cu): the f32
# mode of `_trunk_bwd_block`'s two chains (honerf_tpu/ops/fused_fine.py:
# 342-401), inside K6's pallas_call (:488) and K3's with
# FineMeta(dtype='f32') (honerf_tpu/ops/fused_fine_full.py:1650); each
# kernel runs in both.
TRUNK_UT_F32 = _build.Kernel("hand_trunk_ut_f32_kernel",
                             "honerf_torch/ops/csrc/trunk_bwd_f32.cu",
                             "honerf_tpu/ops/fused_fine.py:488")
TRUNK_DZ_F32 = _build.Kernel("hand_trunk_dz_f32_kernel",
                             "honerf_torch/ops/csrc/trunk_bwd_f32.cu",
                             "honerf_tpu/ops/fused_fine_full.py:1650")
# The bf16 trunk's backward in two launches (csrc/trunk_bwd.cu): the bf16
# mode of the same two chains, inside K6's pallas_call and K3's with
# FineMeta(dtype='bf16'); each kernel runs in both.
TRUNK_UT = _build.Kernel("hand_trunk_ut_kernel", "honerf_torch/ops/csrc/trunk_bwd.cu",
                         "honerf_tpu/ops/fused_fine.py:488")
TRUNK_DZ = _build.Kernel("hand_trunk_dz_kernel", "honerf_torch/ops/csrc/trunk_bwd.cu",
                         "honerf_tpu/ops/fused_fine_full.py:1650")
# An f32 pass's weight gradients in one launch (csrc/trunk_dw_f32.cu): the
# f32 mode of `_trunk_bwd_block`'s dW / db (honerf_tpu/ops/fused_fine.py:
# 379-381, 397-399) inside K6's pallas_call (:488) and K3's, with K3's
# color dW (`_color_bwd_block`, honerf_tpu/ops/fused_fine_full.py:902-904).
TRUNK_DW_F32 = _build.Kernel("trunk_dw_f32_kernel", "honerf_torch/ops/csrc/trunk_dw_f32.cu",
                             "honerf_tpu/ops/fused_fine.py:488")


def type_trunk_lib(lib) -> None:
    """argtypes of the entry points of csrc/trunk.cuh, which every fine-pass
    library carries."""
    lib.honerf_uchain_seed_f32.argtypes = [_P, _I, _P, _I, _I, _P, _I, _P]
    lib.honerf_gemm_tn.argtypes = [_P, _I, _I, _F, _P, _I, _I, _I, _I, _P, _P, _I, _I, _P]
    lib.honerf_gemm_tn_f32.argtypes = lib.honerf_gemm_tn.argtypes
    lib.honerf_colsum.argtypes = [_P, _I, _I, _I, _I, _P, _P, _I, _P]
    lib.honerf_copy_cols.argtypes = [_P, _I, _I, _I, _P, _I, _P]
    lib.honerf_copy_cols_bf16.argtypes = [_P, _I, _I, _I, _P, _I, _P]
    for fn in ("uchain_seed_f32", "gemm_tn", "gemm_tn_f32", "colsum",
               "copy_cols", "copy_cols_bf16"):
        getattr(lib, "honerf_" + fn).restype = _I


def _lib():
    from honerf_torch.ops import fused_hand as FH

    lib = FH._lib("fused_trunk")
    if not getattr(lib, "_honerf_trunk_typed", False):
        type_trunk_lib(lib)
        for fn in (lib.honerf_trunk_pack_e, lib.honerf_trunk_pack_e_f32):
            fn.argtypes = [_P, _I, _I, _I, _P, _I, _I, _P]
            fn.restype = _I
        for fn in (lib.honerf_trunk_bwd_seed, lib.honerf_trunk_bwd_seed_f32):
            fn.argtypes = [_P, _I, _I, _P, _I, _I, _I, _P, _P, _I, _I, _P, _P, _I, _I, _P]
            fn.restype = _I
        lib._honerf_trunk_typed = True
    return lib


def uchain_seed_plain(w, s, m: int, dtype) -> torch.Tensor:
    """uchain_seed_kernel's function in plain PyTorch: t (m, width) =
    dtype(w[:width, 0] * s[:m, :width]), one f32 product rounded once."""
    width = s.shape[1]
    return (s[:m].float() * w[:width, 0].float()).to(dtype)


def uchain_seed(lib, w, s, m: int, t, stream) -> None:
    """t[:m, :width] = T(w[:width, 0] * s[:m, :width]), width = s's columns
    (T: t's type; csrc/trunk.cuh: uchain_seed_kernel, the f32 trunk's seed:
    the bf16 trunk seeds in hand_uchain_kernel).  On a CPU t it writes
    uchain_seed_plain's rows and launches nothing."""
    width = s.shape[1]
    if t.device.type == "cpu":
        t[:m, :width] = uchain_seed_plain(w, s, m, t.dtype)
        return
    if (s.dtype != torch.float32 or s.stride(1) != 1 or s.stride(0) != width
            or t.stride(1) != 1 or t.dtype != torch.float32 or w.dtype != t.dtype
            or m > min(s.shape[0], t.shape[0])):
        raise ValueError("the u-chain seed (the f32 trunk's) takes dense f32 s rows, "
                         "contiguous f32 t columns of w's type and m rows of each")
    PL.check_us_operands(s.data_ptr(), t.data_ptr(), width, t.stride(0))
    UCHAIN.launches += 1
    _build.check(lib.honerf_uchain_seed_f32(w.data_ptr(), w.stride(0), s.data_ptr(), width, m,
                                            t.data_ptr(), t.stride(0), stream),
                 "honerf_uchain_seed_f32")


def copy_cols_plain(src, m: int, width: int) -> torch.Tensor:
    """copy_cols_kernel's function in plain PyTorch: f32(src[:m, :width])."""
    return src[:m, :width].float()


def copy_cols(lib, src, m: int, width: int, dst, stream) -> None:
    """dst[:m, :width] = f32(src[:m, :width]) (f32 or bf16 source, f32
    dst; csrc/trunk.cuh: copy_cols_kernel, the same bits).  On CPU
    tensors it writes copy_cols_plain's rows and launches nothing."""
    if (src.device != dst.device or src.device.type not in ("cpu", "cuda")
            or src.dtype not in (torch.float32, torch.bfloat16) or dst.dtype != torch.float32
            or src.dim() != 2 or dst.dim() != 2 or src.stride(1) != 1 or dst.stride(1) != 1
            or not 0 <= m <= min(src.shape[0], dst.shape[0])
            or not 0 <= width <= min(src.shape[1], dst.shape[1])):
        raise ValueError(f"copy_cols takes 2-D f32 or bf16 src and f32 dst on one device, "
                         f"contiguous columns and m rows, width columns of each (src "
                         f"{tuple(src.shape)} {src.dtype} {src.device}, dst {tuple(dst.shape)} "
                         f"{dst.dtype} {dst.device}, m {m}, width {width})")
    if src.device.type == "cpu":
        dst[:m, :width] = copy_cols_plain(src, m, width)
        return
    fn = lib.honerf_copy_cols_bf16 if src.dtype == torch.bfloat16 else lib.honerf_copy_cols
    COPY.launches += 1
    _build.check(fn(src.data_ptr(), src.stride(0), m, width, dst.data_ptr(), dst.stride(0),
                    stream), "honerf_copy_cols")


def trunk_pack_e_plain(e, m: int, Ep: int, dtype) -> torch.Tensor:
    """trunk_pack_e_kernel's function in plain PyTorch: e[:m] (f32) zero-
    padded to Ep columns and rounded once to dtype."""
    return torch.nn.functional.pad(e[:m].float(), (0, Ep - e.shape[1])).to(dtype)


def trunk_pack_e(lib, e, m: int, eb, stream) -> None:
    """eb[:m, :Ep] = T(e[:m]) zero-padded from E = e's to Ep = eb's columns
    (T: eb's type, bf16 or f32; csrc/fused_trunk.cu: trunk_pack_e_kernel,
    one rounding an element).  On CPU tensors it writes
    trunk_pack_e_plain's rows and launches nothing."""
    if (e.device != eb.device or e.device.type not in ("cpu", "cuda") or e.dim() != 2
            or eb.dim() != 2 or e.dtype != torch.float32
            or eb.dtype not in (torch.float32, torch.bfloat16) or e.stride(1) != 1
            or eb.stride(1) != 1 or not 0 <= m <= min(e.shape[0], eb.shape[0])
            or eb.shape[1] < e.shape[1]):
        raise ValueError(f"the pack of e takes 2-D f32 e and bf16 or f32 eb on one device, "
                         f"contiguous columns, m rows of each and eb at least as wide as e (e "
                         f"{tuple(e.shape)} {e.dtype} {e.device}, eb {tuple(eb.shape)} "
                         f"{eb.dtype} {eb.device}, m {m})")
    E, Ep = e.shape[1], eb.shape[1]
    if e.device.type == "cpu":
        eb[:m] = trunk_pack_e_plain(e, m, Ep, eb.dtype)
        return
    PL.check_pack_operands(eb.data_ptr(), eb.stride(0), eb.element_size(), e.stride(0), E, Ep,
                           e.data_ptr())
    fn = lib.honerf_trunk_pack_e_f32 if eb.dtype == torch.float32 else lib.honerf_trunk_pack_e
    PACK.launches += 1
    _build.check(fn(e.data_ptr(), e.stride(0), m, E, eb.data_ptr(), eb.stride(0), Ep, stream),
                 "honerf_trunk_pack_e")


def _tn(lib, X, ldx, K, Y, N, m, out, acc, ws, stream, x_scale=0.0):
    """out[:K, :N] (+)= X[:m, :K]^T Y[:m, :N] in f32, split over points:
    the bf16 tensor-core TN GEMM, or on f32 operands the f32 one."""
    from honerf_torch.ops import fused_hand as FH

    f32 = X.dtype == torch.float32
    if (Y.dtype == torch.float32) != f32:
        raise ValueError("the TN GEMM's operands must share one type")
    if f32:
        tiles = -(-K // _TN_TILE) * -(-N // _TN_TILE)
        splits = max(1, min(-(-_TN_BLOCKS // tiles), -(-m // 256)))
        split = _round_up(-(-m // splits), 32)
        need = -(-m // split) * _round_up(K, _TN_TILE) * _round_up(N, _TN_TILE)
    else:
        FH.check_tma_operand(X.data_ptr(), ldx, "X")
        FH.check_tma_operand(Y.data_ptr(), Y.stride(0), "Y")
        split = WL.tn_split(K, N, m, _TN_BLOCKS_BF16)
        need = WL.tn_workspace(K, N, m, split)
    if need > ws.numel():
        raise ValueError(f"dW scratch too small: {need} > {ws.numel()} floats")
    fn = lib.honerf_gemm_tn_f32 if f32 else lib.honerf_gemm_tn
    if f32:
        FH.GEMM_TN_F32.launches += 1
    else:
        FH.GEMM_TN.launches += 1
    _build.check(fn(
        X.data_ptr(), ldx, K, x_scale, Y.data_ptr(), Y.stride(0), N, m, split,
        ws.data_ptr(), out.data_ptr(), out.stride(0), acc, stream),
        "honerf_gemm_tn_f32" if f32 else "honerf_gemm_tn")


def colsum_ordered_plain(Z, N: int, m: int, out=None, acc: int = 0) -> torch.Tensor:
    """out[:N] (+)= sum over the m rows of Z[:m, :N] in f32, in
    colsum_partial_kernel's order (csrc/trunk.cuh; the split is
    perpoint_layout.colsum_split's), as elementwise f32 adds on Z's device:
    block s's accumulator k of warp w adds rows s split + 32 i + 8 k + w
    for i = 0, 1, ...; a thread's sum (a0 + a1) + (a2 + a3); a block's
    partial t0 + t1 + ... + t7; warp w of the last block adds the partials
    s = w, w + 8, ...; the total q0 + q1 + ... + q7.  The padding rows and
    partials it adds are +0, which leaves an f32 sum's bits as they are
    (no sum here is -0).  Returns out (new when None)."""
    f32 = torch.float32
    if out is None:
        out = torch.zeros((N,), device=Z.device, dtype=f32)
    if m <= 0 or N == 0:   # the kernel launches nothing
        return out
    lay = PL.colsum_split(m, N)
    split, S = lay["split"], lay["S"]
    zp = torch.zeros((S * split, N), device=Z.device, dtype=f32)
    zp[:m] = Z[:m, :N]
    zp = zp.reshape(S, split // PL.CS_ROW_STEP, PL.CS_ACC, PL.CS_WARPS, N)
    a = torch.zeros((S, PL.CS_ACC, PL.CS_WARPS, N), device=Z.device, dtype=f32)
    for i in range(zp.shape[1]):
        a = a + zp[:, i]
    t = (a[:, 0] + a[:, 1]) + (a[:, 2] + a[:, 3])            # (S, warps, N)
    part = t[:, 0]
    for w in range(1, PL.CS_WARPS):
        part = part + t[:, w]                                 # (S, N)
    S8 = -(-S // PL.CS_WARPS) * PL.CS_WARPS
    pp = torch.zeros((S8, N), device=Z.device, dtype=f32)
    pp[:S] = part
    pp = pp.reshape(S8 // PL.CS_WARPS, PL.CS_WARPS, N)
    q = torch.zeros((PL.CS_WARPS, N), device=Z.device, dtype=f32)
    for i in range(pp.shape[0]):
        q = q + pp[i]
    tot = q[0]
    for w in range(1, PL.CS_WARPS):
        tot = tot + q[w]
    out[:N] = out[:N] + tot if acc else tot
    return out


def _colsum(lib, Z, N, m, out, acc, ws, stream):
    """out[:N] (+)= sum over the m rows of Z[:, :N] (f32, a fixed order:
    csrc/trunk.cuh's colsum_partial_kernel).  On a CPU Z it runs
    colsum_ordered_plain and launches nothing."""
    if Z.device.type == "cpu":
        colsum_ordered_plain(Z, N, m, out, acc)
        return
    if Z.dtype != torch.float32 or Z.data_ptr() % 16 or Z.stride(0) % 4 or Z.stride(1) != 1:
        raise ValueError("the column sum reads f32 rows as float4: a 16-byte-aligned base "
                         f"and a row stride of a multiple of 4 (base {Z.data_ptr():#x}, "
                         f"strides {Z.stride()})")
    lay = PL.colsum_split(m, N)
    if lay["S"] * N > ws.numel():
        raise ValueError(f"column-sum scratch too small: {lay['S'] * N} > {ws.numel()} floats")
    COLSUM.launches += 1
    _build.check(lib.honerf_colsum(Z.data_ptr(), Z.stride(0), N, m, lay["split"],
                                   ws.data_ptr(), out.data_ptr(), acc, stream),
                 "honerf_colsum")


def _tlib():
    """The library of csrc/trunk_fused.cu (the two fused trunk kernels)."""
    lib = _build.load("trunk_fused")
    if not getattr(lib, "_honerf_tf_typed", False):
        L = ctypes.c_longlong
        lib.honerf_trunk_fwd.argtypes = [
            _P, _I, _I, _I, _I, _I, _I,      # e, lde, M, Ep, Hp, n_layers, skip
            _P, _P, _P, _P, _F,              # ws, rows, cols, bs, skip_scale
            _P, L, _I, _P, _I,               # ss, ss_layer, lds, acts, ldact
            _P, _I, _I, _P, _P]              # z, ldz, n_store, sdf, stream
        lib.honerf_trunk_uchain.argtypes = [
            _I, _I, _I, _I, _I, _P, _P,      # M, Ep, Hp, n_layers, skip, wts, in_cols
            _P, _I, _P, L, _I, _F, _F,       # w_last, ldw, ss, ss_layer, lds, hscale, escale
            _P, _I, _P, _I, _P, _I, _P]      # u, ldu, ts, ldt, cs, ldc, stream
        lib.honerf_rcp12_check.argtypes = [_P, _P]
        lib.honerf_trunk_fwd.restype = lib.honerf_trunk_uchain.restype = _I
        lib.honerf_rcp12_check.restype = _I
        lib._honerf_tf_typed = True
    return lib


def _t32lib():
    """The library of csrc/trunk_fused_f32.cu (the f32 trunk's two kernels)."""
    lib = _build.load("trunk_fused_f32")
    if not getattr(lib, "_honerf_t32_typed", False):
        L = ctypes.c_longlong
        lib.honerf_trunk_fwd_f32.argtypes = [
            _P, _I, _I, _I, _I, _I, _I,      # e, lde, M, Ep, Hp, n_layers, skip
            _P, _P, _P, _P, _F,              # wsplit, rows, cols, bs, skip_scale
            _P, L, _I, _P, _I,               # ss, ss_layer, lds, acts, ldact
            _P, _I, _I, _P]                  # z, ldz, n_store, stream
        lib.honerf_trunk_uchain_f32.argtypes = [
            _I, _I, _I, _I, _I, _P, _P,      # M, Ep, Hp, n_layers, skip, wsplit, in_cols
            _P, _I, _P, L, _I, _F, _F,       # w_last, ldw, ss, ss_layer, lds, hscale, escale
            _P, _I, _P, _I, _P, _I, _P]      # u, ldu, ts, ldt, cs, ldc, stream
        lib.honerf_trunk_fwd_f32.restype = lib.honerf_trunk_uchain_f32.restype = _I
        lib._honerf_t32_typed = True
    return lib


def _tb32lib():
    """The library of csrc/trunk_bwd_f32.cu (the f32 trunk backward's two
    kernels)."""
    lib = _build.load("trunk_bwd_f32")
    if not getattr(lib, "_honerf_tb32_typed", False):
        L = ctypes.c_longlong
        lib.honerf_trunk_ut_f32.argtypes = [
            _I, _I, _I, _I, _I, _P, _P,      # M, Ep, Hp, n_layers, skip, wsplit, in_cols
            _P, _P, _I, _P, L, _I,           # du_b, du_s, lddu, ss, ss_layer, lds
            _P, _I, _P,                      # cs, ldc, c_last
            _P, L, _I, _P, _I, _F, _P]       # ds, ds_layer, ldds, dm, lddm, hscale, stream
        lib.honerf_trunk_dz_f32.argtypes = [
            _I, _I, _I, _I, _I, _I,          # M, Ep, Hp, Op, n_layers, skip
            _P, _P, _P, _P, _I,              # wsplit, in_cols, out_cols, top, ldtop
            _P, L, _I, _P, L, _I,            # ss, ss_layer, lds, ds, ds_layer, ldds
            _P, _I, _P, _I, _F, _F, _P]      # de, ldde, dz, lddz, hscale, escale, stream
        lib.honerf_trunk_ut_f32.restype = lib.honerf_trunk_dz_f32.restype = _I
        lib._honerf_tb32_typed = True
    return lib


def _tb16lib():
    """The library of csrc/trunk_bwd.cu (the bf16 trunk backward's two
    kernels)."""
    lib = _build.load("trunk_bwd")
    if not getattr(lib, "_honerf_tb16_typed", False):
        L = ctypes.c_longlong
        lib.honerf_trunk_ut.argtypes = [
            _I, _I, _I, _I, _I, _P, _P,      # M, Ep, Hp, n_layers, skip, ws, in_cols
            _P, _P, _I, _P, L, _I,           # du_b, du_s, lddu, ss, ss_layer, lds
            _P, L, _I, _P,                   # cs, cs_layer, ldc, c_last
            _P, L, _I, _P, L, _I, _F, _P]    # ds, ds_layer, ldds, dm, dm_layer, lddm, hscale,
                                             # stream
        lib.honerf_trunk_dz.argtypes = [
            _I, _I, _I, _I, _I, _I,          # M, Ep, Hp, Op, n_layers, skip
            _P, _P, _P, _P, _I,              # wts, in_cols, out_cols, top, ldtop
            _P, L, _I, _P, L, _I,            # ss, ss_layer, lds, ds, ds_layer, ldds
            _P, _I, _P, L, _I, _P, L, _I,    # de, ldde, dzf, dzf_layer, lddz, dzb, dzb_layer,
                                             # lddzb
            _F, _F, _P]                      # hscale, escale, stream
        lib.honerf_trunk_ut.restype = lib.honerf_trunk_dz.restype = _I
        lib._honerf_tb16_typed = True
    return lib


def _tdw32lib():
    """The library of csrc/trunk_dw_f32.cu (an f32 pass's weight gradients)."""
    lib = _build.load("trunk_dw_f32")
    if not getattr(lib, "_honerf_tdw32_typed", False):
        L = ctypes.c_longlong
        lib.honerf_trunk_dw_f32.argtypes = [
            _I, _I, _P, _P, _P, _P, _P,      # M, n_maps, bases, cols, lds, layers, planes
            _P, _I, _I, _P, _P, _P,          # items, n_items, n_out, dw, ldw, db
            _P, L, _I, _F, _P]               # part, part_floats, acc, xscale, stream
        lib.honerf_trunk_dw_f32.restype = _I
        lib._honerf_tdw32_typed = True
    return lib


def tf32_operands(w, transpose: bool):
    """The f32 trunk kernels' B operand of the padded f32 weight w: [big;
    small] of w (transpose False: the u-chain's, (2 in_pad, out_pad)) or of
    w^T (True: the forward's, (2 out_pad, in_pad)), big = tf32(x) and small
    = tf32(x - big) (fused_hand.split_tf32: the rounding the kernels give A,
    and gemm_f32_kernel both operands).  Made once per weight tensor and
    kept on it, made anew if the tensor was written since."""
    from honerf_torch.ops import fused_hand as FH

    key = "_honerf_tf32_t" if transpose else "_honerf_tf32"
    kept = getattr(w, key, None)
    if kept is not None and kept[0] == w._version:
        return kept[1]
    with torch.no_grad():
        x = w.T if transpose else w
        big, small = FH.split_tf32(x)
        rows = torch.cat([big, small], dim=0).contiguous()
    setattr(w, key, (w._version, rows))
    return rows


def rcp12_mismatches(dev) -> int:
    """The count of f32 x in [1, 2] at which the fused forward's reciprocal
    (csrc/common.cuh: tf_rcp12) differs from __frcp_rn: 0 keeps the
    sigmoid rows' bits.  Card only."""
    bad = torch.zeros((1,), device=dev, dtype=torch.int64)
    _build.check(_tlib().honerf_rcp12_check(bad.data_ptr(),
                                            torch.cuda.current_stream(dev).cuda_stream),
                 "honerf_rcp12_check")
    return int(bad.item())


def _ptrs(ts):
    return (ctypes.c_void_p * len(ts))(*[0 if t is None else t.data_ptr() for t in ts])


def _ptrs_raw(xs):
    return (ctypes.c_void_p * len(xs))(*xs)


def _ints(xs):
    return (ctypes.c_int * len(xs))(*xs)


def _check_rows(what: str, ts, dtype, m: int, width: int, align: int = 16) -> int:
    """Raise unless every tensor of ts (None skipped) is a 2-D `dtype` view
    of at least m rows and `width` contiguous columns, all with one row
    stride, each base and that stride a multiple of `align` bytes (the
    kernels' vector loads and stores, TMA); returns the stride."""
    lds = {t.stride(0) for t in ts if t is not None}
    if len(lds) != 1 or any(t is not None and (
            t.dtype != dtype or t.dim() != 2 or t.stride(1) != 1 or t.shape[0] < m
            or t.shape[1] < width or t.data_ptr() % align
            or t.stride(0) * t.element_size() % align) for t in ts):
        raise ValueError(f"{what}: {dtype} rows of one stride, at least {m} rows of {width} "
                         f"contiguous columns, bases and rows {align}-byte aligned")
    return lds.pop()


def trunk_fwd(e, m: int, ws, bs, tm: TrunkMeta, ss=None, acts=None, z=None, sdf=None,
              stream=None) -> None:
    """The trunk forward on e[:m] (the trunk dtype T, Ep contiguous
    columns): ss[l][:m] = sigmoid(beta z_l) (ss (n - 1, >= m, Hp) f32),
    acts[l][:m] = T(softplus(z_l)) (with keep: n - 1 T (>= m, Hp) rows),
    and the last layer into z[:m, :z.shape[1]] (f32) or (bf16 only) its sdf
    column into sdf[:m]; each output optional, the last layer formed only
    for z or sdf (one launch: csrc/trunk_fused.cu's hand_trunk_fwd_kernel,
    or for an f32 trunk csrc/trunk_fused_f32.cu's hand_trunk_fwd_f32_kernel,
    which takes the sigmoid rows always).  On a CPU e it writes
    trunk_fwd_plain's rows and launches nothing."""
    n = tm.n_layers
    op = _cast(tm)
    if (tm.dtype not in ("bf16", "f32") or e.dtype != op or (z is not None and sdf is not None)
            or (tm.dtype == "f32" and sdf is not None)):
        raise ValueError("the fused trunk forward takes e in the trunk's dtype (bf16 or f32) "
                         "and one of z and sdf (bf16 only)")
    if e.device.type == "cpu":
        a, s_, zz = trunk_fwd_plain(e, m, ws, bs, tm, last=z is not None or sdf is not None)
        for dst, rows in ((ss, s_), (acts, a)):
            if dst is not None:
                for l in range(n - 1):
                    dst[l][:m] = rows[l]
        if z is not None:
            z[:m] = zz[:, :z.shape[1]]
        if sdf is not None:
            sdf[:m] = zz[:, 0]
        return
    lde = _check_rows("e", [e], op, m, tm.Ep)
    if ss is not None:
        _check_rows("ss", list(ss), torch.float32, m, tm.Hp)
    ldact = _check_rows("acts", list(acts), op, m, tm.Hp) if acts is not None else 0
    if acts is not None and ss is None:
        raise ValueError("the kept activations come with the sigmoid rows")
    if z is not None:
        _check_rows("z", [z], torch.float32, m, z.shape[1], align=4)
    if sdf is not None and (sdf.dtype != torch.float32 or sdf.dim() != 1 or sdf.shape[0] < m
                            or sdf.stride(0) != 1):
        raise ValueError("sdf: f32, at least m contiguous rows")
    if tm.dtype == "f32":
        if ss is None or tm.Hp not in (64, 128, 256):
            raise ValueError("the f32 trunk forward writes the sigmoid rows, Hp 64, 128 or 256")
        TRUNK_FWD_F32.launches += 1
        _build.check(_t32lib().honerf_trunk_fwd_f32(
            e.data_ptr(), lde, m, tm.Ep, tm.Hp, n, tm.skip,
            _ptrs([tf32_operands(w, True) for w in ws]), _ints([w.shape[0] for w in ws]),
            _ints([w.shape[1] for w in ws]), _ptrs(bs), INV_SQRT2, ss.data_ptr(),
            ss.stride(0), ss.stride(1), None if acts is None else _ptrs(acts), ldact,
            0 if z is None else z.data_ptr(), 0 if z is None else z.stride(0),
            0 if z is None else z.shape[1], stream), "honerf_trunk_fwd_f32")
        return
    TRUNK_FWD.launches += 1
    _build.check(_tlib().honerf_trunk_fwd(
        e.data_ptr(), lde, m, tm.Ep, tm.Hp, n, tm.skip, _ptrs(ws),
        _ints([w.shape[0] for w in ws]), _ints([w.shape[1] for w in ws]), _ptrs(bs),
        INV_SQRT2_BF16, 0 if ss is None else ss.data_ptr(), 0 if ss is None else ss.stride(0),
        0 if ss is None else ss.stride(1), None if acts is None else _ptrs(acts), ldact,
        0 if z is None else z.data_ptr(), 0 if z is None else z.stride(0),
        0 if z is None else z.shape[1], 0 if sdf is None else sdf.data_ptr(), stream),
        "honerf_trunk_fwd")


def trunk_uchain(m: int, ws, wts, tm: TrunkMeta, ss, u=None, ts=None, cs=None,
                 stream=None) -> None:
    """The u-chain of m points from the forward's sigmoid rows ss (n - 1,
    >= m, Hp) f32: u[:m, :Ep] (f32; None: layer 0 and the skip's embedding
    columns not formed) and, with keep, ts[l][:m] (the trunk dtype, l <
    n - 1) and cs[l][:m] (f32, 1 <= l < n - 1; cs[0] None) (one launch:
    csrc/trunk_fused.cu's hand_uchain_kernel, wts = the weights transposed,
    or for an f32 trunk csrc/trunk_fused_f32.cu's hand_uchain_f32_kernel,
    which reads ws).  On a CPU ss it writes trunk_uchain_plain's rows (from
    ws) and launches nothing."""
    n = tm.n_layers
    if tm.dtype not in ("bf16", "f32"):
        raise ValueError("the fused u-chain takes a bf16 or f32 trunk")
    if ss.device.type == "cpu":
        uu, t_, c_ = trunk_uchain_plain([ss[l][:m] for l in range(n - 1)], ws, tm,
                                        with_u=u is not None)
        if u is not None:
            u[:m, :tm.Ep] = uu
        for l in range(n - 1):
            if ts is not None:
                ts[l][:m] = t_[l]
            if cs is not None and l > 0:
                cs[l][:m] = c_[l]
        return
    _check_rows("ss", list(ss), torch.float32, m, tm.Hp)
    ldu = _check_rows("u", [u], torch.float32, m, tm.Ep, align=8) if u is not None else 0
    if (ts is None) != (cs is None):
        raise ValueError("the kept t rows come with the kept c rows")
    ldt = _check_rows("ts", list(ts[:n - 1]), _cast(tm), m, tm.Hp) if ts is not None else 0
    ldc = (_check_rows("cs", list(cs[1:n - 1]), torch.float32, m, tm.Hp, align=8)
           if cs is not None else 0)
    wl = ws[n - 1]
    if tm.dtype == "f32":
        if tm.Hp not in (64, 128, 256) or wl.dtype != torch.float32:
            raise ValueError("the f32 u-chain takes f32 weights, Hp 64, 128 or 256")
        TRUNK_UCHAIN_F32.launches += 1
        _build.check(_t32lib().honerf_trunk_uchain_f32(
            m, tm.Ep, tm.Hp, n, tm.skip, _ptrs([tf32_operands(w, False) for w in ws[:n - 1]]),
            _ints([w.shape[0] for w in ws[:n - 1]]), wl.data_ptr(), wl.stride(0),
            ss.data_ptr(), ss.stride(0), ss.stride(1), INV_SQRT2, INV_SQRT2,
            0 if u is None else u.data_ptr(), ldu, None if ts is None else _ptrs(ts[:n - 1]),
            ldt, None if cs is None else _ptrs(cs[:n - 1]), ldc, stream),
            "honerf_trunk_uchain_f32")
        return
    TRUNK_UCHAIN.launches += 1
    _build.check(_tlib().honerf_trunk_uchain(
        m, tm.Ep, tm.Hp, n, tm.skip, _ptrs(wts[:n - 1]), _ints([w.shape[1] for w in wts[:n - 1]]),
        wl.data_ptr(), wl.stride(0), ss.data_ptr(), ss.stride(0), ss.stride(1), INV_SQRT2,
        INV_SQRT2, 0 if u is None else u.data_ptr(), ldu,
        None if ts is None else _ptrs(ts[:n - 1]), ldt,
        None if cs is None else _ptrs(cs[:n - 1]), ldc, stream), "honerf_trunk_uchain")


def _check_backward(tm: TrunkMeta, ws) -> None:
    if tm.dtype not in ("bf16", "f32") or tm.Hp not in (64, 128, 256) or any(
            w.dtype != _cast(tm) for w in ws):
        raise ValueError("the fused backward chains take a bf16 or f32 trunk, weights of its "
                         "dtype, Hp 64, 128 or 256")


def _planes_of(what: str, ts) -> Tuple[int, int]:
    """(base pointer, plane stride in elements) of row blocks that are the
    planes of one tensor, in order (the bf16 backward's 3D maps read them
    so); a single block's stride is 0."""
    ptrs = [t.data_ptr() for t in ts]
    steps = {b - a for a, b in zip(ptrs, ptrs[1:])}
    size = ts[0].element_size()
    if len(steps) > 1 or any(st <= 0 or st % size for st in steps):
        raise ValueError(f"{what}: the planes of one tensor, in order")
    return ptrs[0], (steps.pop() // size if steps else 0)


def trunk_ut(m: int, ws, tm: TrunkMeta, du_b, du_s, ss, cs, c_last, ds, dms=None,
             stream=None) -> None:
    """The u-chain transposed, upward, on m points (one launch: for a bf16
    trunk csrc/trunk_bwd.cu's hand_trunk_ut_kernel, for an f32 one
    csrc/trunk_bwd_f32.cu's hand_trunk_ut_f32_kernel): ds[l][:m] = dt_l
    c_{l+1} (ds (n - 1, >= m, Hp) f32) and, with dms, dms[l][:m] = dm_l
    (1 <= l <= n - 1, trunk dtype; dms[0] None) from du_b = du and du_s =
    du / sqrt2 ((>= m, Ep) in the trunk dtype, one stride), the forward's
    sigmoid rows ss (n - 1, >= m, Hp), the u-chain's c rows cs[l] (1 <= l <
    n - 1) and c_last = c_{n-1} (Hp,); ws the pack's (in, out) weights.  A
    bf16 trunk's cs and dms rows are each the planes of one tensor.  On a
    CPU du_b it writes trunk_ut_plain's rows and launches nothing."""
    n = tm.n_layers
    _check_backward(tm, ws)
    if du_b.device.type == "cpu":
        rows = [None] + [c[:m] for c in cs[1:n - 1]] + [c_last]
        d, kept = trunk_ut_plain(du_b, du_s, m, ws, ss, rows, tm, keep=dms is not None)
        for l in range(n - 1):
            ds[l][:m] = d[l]
            if dms is not None:
                dms[l + 1][:m] = kept[l + 1]
        return
    op = _cast(tm)
    lddu = _check_rows("du", [du_b, du_s], op, m, tm.Ep)
    _check_rows("ss", list(ss), torch.float32, m, tm.Hp)
    _check_rows("ds", list(ds), torch.float32, m, tm.Hp)
    ldc = _check_rows("cs", list(cs[1:n - 1]), torch.float32, m, tm.Hp)
    lddm = _check_rows("dms", list(dms[1:]), op, m, tm.Hp) if dms is not None else 0
    if (c_last.dtype != torch.float32 or c_last.dim() != 1 or c_last.shape[0] < tm.Hp
            or c_last.stride(0) != 1 or c_last.data_ptr() % 16):
        raise ValueError("c_last: Hp contiguous f32 values, 16-byte aligned")
    rows = (_ints([w.shape[0] for w in ws[:n - 1]]), du_b.data_ptr(), du_s.data_ptr(), lddu,
            ss.data_ptr(), ss.stride(0), ss.stride(1))
    ds_args = (ds.data_ptr(), ds.stride(0), ds.stride(1))
    if tm.dtype == "bf16":
        dm = (0, 0) if dms is None else _planes_of("dms", dms[1:])
        TRUNK_UT.launches += 1
        _build.check(_tb16lib().honerf_trunk_ut(
            m, tm.Ep, tm.Hp, n, tm.skip, _ptrs(ws[:n - 1]), *rows,
            *_planes_of("cs", cs[1:n - 1]), ldc, c_last.data_ptr(), *ds_args, *dm, lddm,
            INV_SQRT2, stream), "honerf_trunk_ut")
        return
    TRUNK_UT_F32.launches += 1
    _build.check(_tb32lib().honerf_trunk_ut_f32(
        m, tm.Ep, tm.Hp, n, tm.skip, _ptrs([tf32_operands(w, True) for w in ws[:n - 1]]),
        *rows, _ptrs([None] + list(cs[1:n - 1])), ldc, c_last.data_ptr(), *ds_args,
        None if dms is None else _ptrs([None] + list(dms[1:])), lddm, INV_SQRT2, stream),
        "honerf_trunk_ut_f32")


def trunk_dz(m: int, ws, tm: TrunkMeta, top, ss, ds, de, dzs=None, stream=None, wts=None,
             dzbs=None) -> None:
    """The forward transposed, downward, on m points (one launch: for a
    bf16 trunk csrc/trunk_bwd.cu's hand_trunk_dz_kernel, for an f32 one
    csrc/trunk_bwd_f32.cu's hand_trunk_dz_f32_kernel): de[:m, :Ep] (f32)
    and, with dzs, dzs[l][:m] = dz_l (l < n - 1, f32; a bf16 trunk also its
    bf16 rounding into dzbs[l]) from the top cotangent top[:m, :Op] = dz_{n-1}
    (in the trunk dtype), the sigmoid rows ss and the upward chain's ds (n -
    1, >= m, Hp); ws the pack's weights, wts (a bf16 trunk's) their
    transposes.  A bf16 trunk's dzs and dzbs rows are each the planes of
    one tensor.  On a CPU top it writes trunk_dz_plain's rows and launches
    nothing."""
    n = tm.n_layers
    _check_backward(tm, ws)
    bf16 = tm.dtype == "bf16"
    if bf16 and (dzs is None) != (dzbs is None):
        raise ValueError("a bf16 trunk's downward chain keeps dzbs beside dzs")
    if top.device.type == "cpu":
        d, kept = trunk_dz_plain(top, m, ws, ss, ds, tm, keep=dzs is not None)
        de[:m, :tm.Ep] = d
        for l in range(n - 1 if dzs is not None else 0):
            dzs[l][:m] = kept[l]
            if bf16:
                dzbs[l][:m] = kept[l]
        return
    ldtop = _check_rows("top", [top], _cast(tm), m, tm.Op)
    _check_rows("ss", list(ss), torch.float32, m, tm.Hp)
    _check_rows("ds", list(ds), torch.float32, m, tm.Hp)
    ldde = _check_rows("de", [de], torch.float32, m, tm.Ep)
    lddz = _check_rows("dzs", list(dzs[:n - 1]), torch.float32, m, tm.Hp) if dzs is not None else 0
    rows = (ss.data_ptr(), ss.stride(0), ss.stride(1), ds.data_ptr(), ds.stride(0), ds.stride(1),
            de.data_ptr(), ldde)
    if bf16:
        if wts is None or any(w.dtype != torch.bfloat16 for w in wts):
            raise ValueError("a bf16 trunk's downward chain takes its bf16 wts")
        kept = (0, 0, 0, 0, 0, 0)
        if dzs is not None:
            lddzb = _check_rows("dzbs", list(dzbs[:n - 1]), torch.bfloat16, m, tm.Hp)
            kept = (*_planes_of("dzs", dzs[:n - 1]), lddz, *_planes_of("dzbs", dzbs[:n - 1]),
                    lddzb)
        TRUNK_DZ.launches += 1
        _build.check(_tb16lib().honerf_trunk_dz(
            m, tm.Ep, tm.Hp, tm.Op, n, tm.skip, _ptrs(wts), _ints([w.shape[1] for w in wts]),
            _ints([w.shape[0] for w in wts]), top.data_ptr(), ldtop, *rows, *kept, INV_SQRT2,
            INV_SQRT2, stream), "honerf_trunk_dz")
        return
    TRUNK_DZ_F32.launches += 1
    _build.check(_tb32lib().honerf_trunk_dz_f32(
        m, tm.Ep, tm.Hp, tm.Op, n, tm.skip, _ptrs([tf32_operands(w, False) for w in ws]),
        _ints([w.shape[0] for w in ws]), _ints([w.shape[1] for w in ws]), top.data_ptr(),
        ldtop, *rows, None if dzs is None else _ptrs(list(dzs[:n - 1])), lddz, INV_SQRT2,
        INV_SQRT2, stream), "honerf_trunk_dz_f32")


def planes(n: int, C: int, width: int, dev, dtype) -> List[torch.Tensor]:
    """n (C, width) row blocks, the planes of one (n, C, width) tensor."""
    return list(torch.empty((n, C, width), device=dev, dtype=dtype).unbind(0)) if n else []


def trunk_buffers(tm: TrunkMeta, C: int, dev, keep: bool):
    """Scratch of cuda_trunk_forward for C points: f32 sigmoid rows, and
    with `keep` (K3's and K6's recompute) activations and t rows in the
    trunk dtype, one per layer (the planes of one tensor, which the dW
    launch reads as one map), and the f32 c rows (the two fused launches
    keep them on chip otherwise)."""
    n, Hp = tm.n_layers, tm.Hp
    op, f32 = _cast(tm), torch.float32
    n_act = n - 1 if keep else 0
    buf = dict(
        acts=planes(n_act, C, Hp, dev, op),
        ts=planes(n_act, C, Hp, dev, op),
        ss=torch.empty((n - 1, C, Hp), device=dev, dtype=f32),
    )
    if keep:
        # cs[l] = c_l of the u-chain for l = 1..n-2 (planes: the bf16
        # backward reads them as one map); c_{n-1} = W_{n-1}[:, 0] is the
        # same row for every point (a stride-0 operand)
        buf["cs"] = [None] + planes(n - 2, C, Hp, dev, f32)
    return buf


def cuda_trunk_forward(lib, e, m: int, ws, bs, wts, tm: TrunkMeta, buf, stream, keep=False,
                       z=None, u=None) -> None:
    """The trunk forward and u-chain launches (K2's and K5's, and the
    recompute of K3 and K6) on the first m rows of e (the trunk dtype, Ep
    columns), bf16 or f32, in two launches (trunk_fwd, trunk_uchain):
    s_l = sigmoid(beta z_l) into buf's ss, with `keep` a_{l+1} =
    softplus(z_l) into buf's acts; the last layer into the first z.shape[1]
    columns of z (f32; None: not formed); u into u (f32, Ep columns; None:
    the chain's embedding columns are not formed) and, with `keep`, the
    u-chain's t rows into buf's ts and its c rows into cs."""
    ss, acts, ts, cs = buf["ss"], buf["acts"], buf["ts"], buf.get("cs")
    # two launches: the forward, then the u-chain from its sigmoid rows
    trunk_fwd(e, m, ws, bs, tm, ss=ss, acts=acts if keep else None, z=z, stream=stream)
    trunk_uchain(m, ws, wts, tm, ss, u=u, ts=ts if keep else None,
                 cs=cs if keep else None, stream=stream)


def cuda_trunk_forward_split(lib, e, m: int, ws, bs, wts, tm: TrunkMeta, buf, stream,
                             keep=False, z=None, u=None) -> None:
    """cuda_trunk_forward's outputs for an f32 trunk as the split launches
    the fused pair replaced: one gemm_f32_kernel a layer, then
    uchain_seed_kernel.  No main path calls it: chip_smoke.py and
    bench_gemm.py time and hold the pair against it at the same calls."""
    from honerf_torch.ops import fused_hand as FH

    n, Hp = tm.n_layers, tm.Hp
    if tm.dtype != "f32":
        raise ValueError("the split launches are the f32 trunk's")
    ss, acts, ts, cs = buf["ss"], buf["acts"], buf["ts"], buf.get("cs")
    if not keep:    # two alternating activation and t rows
        acts = [torch.empty((e.shape[0], Hp), device=e.device) for _ in range(2)]
        ts = [torch.empty((e.shape[0], Hp), device=e.device) for _ in range(2)]
    gemm = FH.gemm
    # trunk forward: a_{l+1} = softplus(z_l), ss[l] = sigmoid(beta z_l)
    a = None
    for l in range(n):
        if l == 0:
            A1, K1, A2, K2, scale = e, tm.Ep, None, 0, 0.0
        elif l == tm.skip:
            A1, K1, A2, K2, scale = a, Hp, e, tm.Ep, INV_SQRT2
        else:
            A1, K1, A2, K2, scale = a, Hp, None, 0, 0.0
        w = ws[l]
        if l < n - 1:
            nxt = acts[l] if keep else acts[l % 2]
            gemm(lib, A1, K1, A2, K2, w, w.shape[1], bs[l], m, FH.EPI_SOFTPLUS,
                 nxt, nxt.stride(0), a_scale=scale, S=ss[l], stream=stream)
            a = nxt
        elif z is not None:
            gemm(lib, A1, K1, A2, K2, w, w.shape[1], bs[l], m, FH.EPI_F32, z, z.stride(0),
                 n_store=z.shape[1], a_scale=scale, stream=stream)
    # u-chain: t_{n-2} = W_{n-1}[:, 0] * s_{n-2}, then m_l = t_l W_l^T
    t = ts[n - 2] if keep else ts[0]
    uchain_seed(lib, ws[n - 1], ss[n - 2], m, t, stream)
    for l in range(n - 2, -1, -1):
        wt = wts[l]                            # (out_pad, in_pad) = (Hp, in_pad)
        if l == 0:
            if u is not None:
                gemm(lib, t, Hp, None, 0, wt, wt.shape[1], None, m, FH.EPI_UCHAIN, None, 0,
                     U=u, split=0, u_acc=1, stream=stream)
            break
        nxt = ts[l - 1] if keep else (ts[1] if t is ts[0] else ts[0])
        c_keep = cs[l] if keep else None
        if l == tm.skip:
            width = wt.shape[1] if u is not None else Hp
            gemm(lib, t, Hp, None, 0, wt, width, None, m, FH.EPI_UCHAIN, nxt,
                 nxt.stride(0), S=ss[l - 1], U=u, split=Hp, hscale=INV_SQRT2,
                 escale=INV_SQRT2, Cf=c_keep, stream=stream)
        else:
            gemm(lib, t, Hp, None, 0, wt, wt.shape[1], None, m, FH.EPI_UCHAIN, nxt,
                 nxt.stride(0), S=ss[l - 1], split=wt.shape[1], Cf=c_keep, stream=stream)
        t = nxt


def trunk_bwd_buffers(ws, tm: TrunkMeta, C: int, dev, width: int, want_dw: bool = True):
    """Scratch of cuda_trunk_backward for C points; dzf / dzb (the f32
    and the trunk-dtype cotangent rows) `width` columns wide; with want_dw
    the fused chains' kept rows dms (dm_l, 1 <= l < n, trunk dtype) and dzs
    (dz_l, l < n - 1, f32; a bf16 trunk also dzbs, their bf16 rounding),
    each the planes of one tensor, which the weight gradients (an f32
    trunk's trunk_dw launch, a bf16 trunk's _bf16_dw sequence) read after
    them."""
    n, Hp, Ep, Op = tm.n_layers, tm.Hp, tm.Ep, tm.Op
    op, f32 = _cast(tm), torch.float32
    onehot = torch.zeros((C, Op), device=dev, dtype=op)
    onehot[:, 0] = 1.0
    bw = dict(
        dzf=[torch.empty((C, width), device=dev, dtype=f32) for _ in range(2)],
        dzb=[torch.empty((C, width), device=dev, dtype=op) for _ in range(2)],
        du_b=torch.empty((C, Ep), device=dev, dtype=op),
        du_s=torch.empty((C, Ep), device=dev, dtype=op),
        dm=[torch.empty((C, Hp), device=dev, dtype=op) for _ in range(2)],
        ds=torch.empty((n - 1, C, Hp), device=dev, dtype=f32),
        de=torch.empty((C, Ep), device=dev, dtype=f32),
        onehot=onehot,
        c_last=ws[n - 1][:, 0].float().contiguous(),    # c_{n-1}, every point
    )
    if want_dw:
        bw["dms"] = [None] + planes(n - 1, C, Hp, dev, op)
        bw["dzs"] = planes(n - 1, C, Hp, dev, f32)
        if tm.dtype == "bf16":
            bw["dzbs"] = planes(n - 1, C, Hp, dev, op)
    return bw


def cuda_trunk_backward(lib, m: int, e, ws, wts, tm: TrunkMeta, buf, bw, dws, dbs,
                        want_dw: bool, acc: int, scratch, stream, color=None) -> None:
    """The trunk's backward launches (K3's and K6's) on m points after the
    seeds: the u-chain transposed upward from bw's du_b = T(du) and
    du_s = T(du / sqrt2) (T the trunk dtype), then the forward transposed
    downward from the top cotangent in bw's dzf[0] / dzb[0]; dW and db
    into dws / dbs (f32; acc: add to them, the passes after the first),
    the cotangent of e into bw's de (f32, Ep columns).  buf: the forward's
    rows (cuda_trunk_forward, keep=True).  The two chains are two launches
    (trunk_ut, trunk_dz) in either dtype; then with want_dw an f32 trunk
    runs every dW and db in one launch on the rows they keep (trunk_dw;
    `color`: K3's color rows and gradients, dw_color_rows, join it), a
    bf16 trunk the split launches' dW sequence on them (_bf16_dw)."""
    cs, ss = buf["cs"], buf["ss"]
    du_b, du_s = bw["du_b"], bw["du_s"]
    dms, dzs = (bw["dms"], bw["dzs"]) if want_dw else (None, None)
    trunk_ut(m, ws, tm, du_b, du_s, ss, cs, bw["c_last"], bw["ds"], dms, stream)
    if tm.dtype == "bf16":
        trunk_dz(m, ws, tm, bw["dzb"][0], ss, bw["ds"], bw["de"], dzs, stream, wts=wts,
                 dzbs=bw["dzbs"] if want_dw else None)
        if want_dw:
            _bf16_dw(lib, m, e, ws, tm, buf, bw, dws, dbs, acc, scratch, stream)
        return
    trunk_dz(m, ws, tm, bw["dzf"][0], ss, bw["ds"], bw["de"], dzs, stream)
    if want_dw:
        trunk_dw(m, tm, dw_rows(e, buf, bw), dws, dbs, acc, stream, color)


def _bf16_dw(lib, m: int, e, ws, tm: TrunkMeta, buf, bw, dws, dbs, acc: int, scratch,
             stream) -> None:
    """A bf16 pass's dW and db on the rows the fused chains keep, as the
    split launches run them, in their order: the upward products dW_l (+)=
    dm_l^T t_l (dm_0 = du_b; the skip's du_s rows too; t_{n-1} the one-hot
    sdf column), a gemm_tn_kernel (and its reduce_partials_kernel) each,
    then top down each layer's dW_l += in_l^T dz_l and its column sum
    (_layer_dw)."""
    n, Hp, Ep = tm.n_layers, tm.Hp, tm.Ep
    du_b, du_s, dms, ts = bw["du_b"], bw["du_s"], bw["dms"], buf["ts"]
    for l in range(n):
        Y = bw["onehot"] if l == n - 1 else ts[l]
        A, K = (du_b, Ep) if l == 0 else (dms[l], Hp)
        _tn(lib, A, A.stride(0), K, Y, Y.shape[1], m, dws[l], acc, scratch, stream)
        if l == tm.skip:
            _tn(lib, du_s, du_s.stride(0), Ep, Y, Y.shape[1], m, dws[l][Hp:], acc, scratch,
                stream)
    for l in range(n - 1, -1, -1):
        Zb, Zf = ((bw["dzb"][0], bw["dzf"][0]) if l == n - 1
                  else (bw["dzbs"][l], bw["dzs"][l]))
        _layer_dw(lib, m, e, ws, tm, buf["acts"], l, Zb, Zf, dws, dbs, acc, scratch, stream)


def dw_rows(e, buf, bw) -> dict:
    """The rows an f32 pass's weight gradients read: du_b, du_s and e
    (Ep columns), the backward chains' kept dm_l (dms[l], 1 <= l < n) and
    dz_l (dzs[l], l < n - 1), the forward's activations (acts[l - 1] =
    in_l, 0 < l) and u-chain t rows (ts[l], l < n - 1), the top cotangent
    (dz_{n-1}, Op columns) and the one-hot sdf column (t_{n-1}; only the
    split launches read it)."""
    return dict(du_b=bw["du_b"], du_s=bw["du_s"], e=e, dms=bw["dms"], dzs=bw["dzs"],
                acts=buf["acts"], ts=buf["ts"], top=bw["dzf"][0], onehot=bw["onehot"])


def dw_color_rows(cx2, cacts, cdz, dcws, dcbs) -> dict:
    """K3's color rows for trunk_dw: the color input's second part cx2
    ([feat | grad-PE]; its first part is e), the kept activations
    (cacts[l - 1] = the input of color layer l > 0), one dz row a color
    layer (cdz[l]), and the gradients dcws / dcbs."""
    return dict(cx2=cx2, cacts=cacts, cdz=cdz, dcws=dcws, dcbs=dcbs)


def trunk_dw_plain(m: int, tm: TrunkMeta, rows: dict, dws, dbs, acc: int, color=None) -> None:
    """trunk_dw_f32_kernel's function in plain PyTorch: on the first m
    points of `rows` (dw_rows), dW_l (+)= dm_l^T t_l + in_l^T dz_l and db_l
    (+)= sum dz_l for each trunk layer (dm_0 = du_b; the skip's [dm | du_s]
    and [a | e] / sqrt2; layer n - 1's t the one-hot sdf column, so its
    u-chain part is dm_{n-1}'s column sum in column 0); with `color`
    (dw_color_rows) dcW_l (+)= a_l^T dz_l and dcb_l (+)= sum dz_l (a_0 =
    [e | cx2]).  f32 products (_mm_tn) and sums (.sum(0)); acc: add to the
    outputs (the passes after the first), else overwrite them."""
    if tm.dtype != "f32":
        raise ValueError("the fused dW launch is the f32 trunk's")
    n, skip = tm.n_layers, tm.skip
    r = {k: (v[:m] if torch.is_tensor(v) else [None if x is None else x[:m] for x in v])
         for k, v in rows.items() if k != "onehot"}
    du_b, du_s, e = r["du_b"][:, :tm.Ep], r["du_s"][:, :tm.Ep], r["e"][:, :tm.Ep]

    def put(out, val):
        if acc:
            out += val
        else:
            out.copy_(val)

    for l in range(n):
        N = dws[l].shape[1]
        dz = r["top"][:, :N] if l == n - 1 else r["dzs"][l][:, :N]
        x = e if l == 0 else (torch.cat([r["acts"][l - 1], e], 1) * INV_SQRT2 if l == skip
                              else r["acts"][l - 1])
        dw = _mm_tn(tm, x, dz)
        if l == n - 1:
            dw[:, 0] += r["dms"][l].sum(0)
        else:
            dm = du_b if l == 0 else (torch.cat([r["dms"][l], du_s], 1) if l == skip
                                      else r["dms"][l])
            dw = _mm_tn(tm, dm, r["ts"][l][:, :N]) + dw
        put(dws[l], dw)
        put(dbs[l], dz.sum(0))
    if color is None:
        return
    c = {k: (v[:m] if torch.is_tensor(v) else [x[:m] for x in v])
         for k, v in color.items() if k in ("cx2", "cacts", "cdz")}
    for l, (dcw, dcb) in enumerate(zip(color["dcws"], color["dcbs"])):
        N = dcw.shape[1]
        a = torch.cat([e, c["cx2"]], 1) if l == 0 else c["cacts"][l - 1]
        dz = c["cdz"][l][:, :N]
        put(dcw, _mm_tn(tm, a, dz))
        put(dcb, dz.sum(0))


def _dw_sources(m: int, tm: TrunkMeta, rows: dict, color) -> Tuple[list, list]:
    """The launch's maps (each a stack of planes: (base, cols, ld, planes,
    plane stride)) and its outputs (Tdw32Out), in the kernel's order."""
    n, Hp, Ep, skip = tm.n_layers, tm.Hp, tm.Ep, tm.skip
    f32 = torch.float32

    def stack(name, ts, cols):
        ts = list(ts)
        base = ts[0]
        ld = _check_rows(name, ts, f32, m, cols)
        plane = ts[1].data_ptr() - base.data_ptr() if len(ts) > 1 else 0
        if plane % 16 or any(t.data_ptr() != base.data_ptr() + i * plane
                             for i, t in enumerate(ts)):
            raise ValueError(f"{name}: the rows must be the planes of one tensor")
        return (base.data_ptr(), cols, ld, len(ts), plane // 4)

    S, T, O = WL.Tdw32Seg, WL.Tdw32Prod, WL.Tdw32Out
    MMA, SUM = WL.TDW32_MMA, WL.TDW32_SUM
    DUB, DUS, E, DM, ACT, TS, DZ, TOP, CX, CA, CDZ = range(11)
    maps = [stack("du_b", [rows["du_b"]], Ep), stack("du_s", [rows["du_s"]], Ep),
            stack("e", [rows["e"]], Ep), stack("dms", rows["dms"][1:n], Hp),
            stack("acts", rows["acts"][:n - 1], Hp), stack("ts", rows["ts"][:n - 1], Hp),
            stack("dzs", rows["dzs"][:n - 1], Hp), stack("top", [rows["top"]], tm.Op)]
    outs = []
    for l in range(n):
        if l == 0:
            u = T(MMA, (S(0, Ep, DUB, 0, 0),), (TS, 0))
            f = T(MMA, (S(0, Ep, E, 0, 0),), (DZ, 0))
        elif l == skip:
            u = T(MMA, (S(0, Hp, DM, l - 1, 0), S(Hp, Ep, DUS, 0, 0)), (TS, l))
            f = T(MMA, (S(0, Hp, ACT, l - 1, 0, 1), S(Hp, Ep, E, 0, 0, 1)), (DZ, l))
        elif l == n - 1:
            u = T(SUM, (S(0, Hp, DM, l - 1, 0),))
            f = T(MMA, (S(0, Hp, ACT, l - 1, 0),), (TOP, 0))
        else:
            u = T(MMA, (S(0, Hp, DM, l - 1, 0),), (TS, l))
            f = T(MMA, (S(0, Hp, ACT, l - 1, 0),), (DZ, l))
        outs.append(O(Hp + Ep if l == skip else (Ep if l == 0 else Hp), tm.Op if l == n - 1
                      else Hp, (u, f)))
    if color is not None:
        cdz, cacts, cx2 = color["cdz"], color["cacts"], color["cx2"]
        cw = cdz[0].shape[1]
        maps += [stack("cx2", [cx2], cx2.shape[1]), stack("cacts", cacts, cacts[0].shape[1]),
                 stack("cdz", cdz, cw)]
        none = T(WL.TDW32_NONE, ())
        for l, dcw in enumerate(color["dcws"]):
            if l == 0:
                segs = (S(0, Ep, E, 0, 0), S(Ep, cx2.shape[1], CX, 0, 0))
            else:
                segs = (S(0, dcw.shape[0], CA, l - 1, 0),)
            outs.append(O(dcw.shape[0], dcw.shape[1], (none, T(MMA, segs, (CDZ, l)))))
    return maps, outs


@functools.lru_cache(maxsize=64)
def _dw_plan(outs, m: int, dev: str):
    """The work list of (outs, m) on dev's SM count, made once: (items,
    the int32 tensor the kernel reads)."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    items = WL.tdw32_plan(outs, m, sms)
    return items, torch.tensor(WL.tdw32_item_ints(items), dtype=torch.int32, device=dev)


def trunk_dw(m: int, tm: TrunkMeta, rows: dict, dws, dbs, acc: int, stream=None,
             color=None) -> None:
    """Every dW / db of an f32 trunk pass on m points (and with `color`,
    K3's color net's) in one launch: csrc/trunk_dw_f32.cu's
    trunk_dw_f32_kernel, trunk_dw_plain's function.  rows: dw_rows (each
    list the planes of one f32 tensor); dws / dbs (and color's dcws /
    dcbs): the padded f32 gradients; acc: add to them.  On a CPU e it runs
    trunk_dw_plain and launches nothing."""
    if tm.dtype != "f32" or any(w.dtype != torch.float32 for w in dws):
        raise ValueError("the fused dW launch takes an f32 trunk and f32 gradients")
    if rows["e"].device.type == "cpu":
        trunk_dw_plain(m, tm, rows, dws, dbs, acc, color)
        return
    if m <= 0:
        return
    maps, outs = _dw_sources(m, tm, rows, color)
    items, ints = _dw_plan(tuple(outs), m, str(rows["e"].device))
    dw = list(dws) + (list(color["dcws"]) if color is not None else [])
    db = list(dbs) + (list(color["dcbs"]) if color is not None else [])
    for w, b, o in zip(dw, db, outs):
        if (tuple(w.shape) != (o.K, o.N) or w.stride(1) != 1 or b.shape[0] < o.N
                or w.dtype != torch.float32 or b.dtype != torch.float32):
            raise ValueError("dW / db must be f32 of the layers' padded shapes")
    part = torch.empty((max(len(items), 1), WL.TDW32_PART), device=rows["e"].device,
                       dtype=torch.float32)
    L = ctypes.c_longlong
    TRUNK_DW_F32.launches += 1
    _build.check(_tdw32lib().honerf_trunk_dw_f32(
        m, len(maps), _ptrs_raw([x[0] for x in maps]), _ints([x[1] for x in maps]),
        _ints([x[2] for x in maps]), _ints([x[3] for x in maps]),
        (L * len(maps))(*[x[4] for x in maps]), ints.data_ptr(), len(items), len(dw),
        _ptrs(dw), _ints([w.stride(0) for w in dw]), _ptrs(db), part.data_ptr(), part.numel(),
        acc, INV_SQRT2, stream), "honerf_trunk_dw_f32")


def cuda_trunk_dw_split(lib, m: int, tm: TrunkMeta, rows: dict, dws, dbs, acc: int, scratch,
                        stream, color=None) -> None:
    """trunk_dw's outputs as the launch sequence it replaced: a
    gemm_tn_f32_kernel (and its reduce_partials_kernel) a product, the
    one-hot one included, and a colsum_partial_kernel a layer, for the
    trunk and K3's color net.  No main path calls it: chip_smoke.py and
    bench_gemm.py time and hold trunk_dw against it at the same calls."""
    n, Hp, Ep = tm.n_layers, tm.Hp, tm.Ep
    if tm.dtype != "f32":
        raise ValueError("the split dW launches are the f32 trunk's")
    du_b, du_s, dms, ts = rows["du_b"], rows["du_s"], rows["dms"], rows["ts"]
    for l in range(n):
        Y = rows["onehot"] if l == n - 1 else ts[l]
        A, K = (du_b, Ep) if l == 0 else (dms[l], Hp)
        _tn(lib, A, A.stride(0), K, Y, Y.shape[1], m, dws[l], acc, scratch, stream)
        if l == tm.skip:
            _tn(lib, du_s, du_s.stride(0), Ep, Y, Y.shape[1], m, dws[l][Hp:], acc, scratch,
                stream)
    for l in range(n - 1, -1, -1):
        Z = rows["top"] if l == n - 1 else rows["dzs"][l]
        _layer_dw(lib, m, rows["e"], dws, tm, rows["acts"], l, Z, Z, dws, dbs, acc, scratch,
                  stream)
    if color is None:
        return
    e, cx2 = rows["e"], color["cx2"]
    for l, (dcw, dcb) in enumerate(zip(color["dcws"], color["dcbs"])):
        Z, width = color["cdz"][l], dcw.shape[1]
        if l == 0:
            _tn(lib, e, Ep, Ep, Z, width, m, dcw, acc, scratch, stream)
            _tn(lib, cx2, cx2.stride(0), cx2.shape[1], Z, width, m, dcw[Ep:], acc, scratch,
                stream)
        else:
            a = color["cacts"][l - 1]
            _tn(lib, a, a.stride(0), a.shape[1], Z, width, m, dcw, acc, scratch, stream)
        _colsum(lib, Z, width, m, dcb, acc, scratch, stream)


def _layer_dw(lib, m: int, e, ws, tm: TrunkMeta, acts, l: int, Zb, Zf, dws, dbs, acc: int,
              scratch, stream) -> None:
    """The forward transposed's weight gradients of layer l from dz_l (Zb
    in the trunk dtype, Zf in f32): dW_l += in_l^T dz_l (the skip's concat
    scaled as the forward formed it), db_l (+)= sum dz_l."""
    Hp, Ep = tm.Hp, tm.Ep
    skip_scale = INV_SQRT2 if tm.dtype == "f32" else INV_SQRT2_BF16
    width = ws[l].shape[1]
    if l == 0:
        _tn(lib, e, Ep, Ep, Zb, width, m, dws[0], 1, scratch, stream)
    elif l == tm.skip:
        _tn(lib, acts[l - 1], Hp, Hp, Zb, width, m, dws[l], 1, scratch, stream,
            x_scale=skip_scale)
        _tn(lib, e, Ep, Ep, Zb, width, m, dws[l][Hp:], 1, scratch, stream,
            x_scale=skip_scale)
    else:
        _tn(lib, acts[l - 1], Hp, Hp, Zb, width, m, dws[l], 1, scratch, stream)
    _colsum(lib, Zf, width, m, dbs[l], acc, scratch, stream)


def cuda_trunk_backward_split(lib, m: int, e, ws, wts, tm: TrunkMeta, buf, bw, dws, dbs,
                              want_dw: bool, acc: int, scratch, stream) -> None:
    """cuda_trunk_backward's outputs as the split launches the fused
    chains replaced: one GEMM a layer (gemm_kernel in bf16, gemm_f32_kernel
    in f32; EPI_UT, then EPI_DZ), each layer's weight gradients beside it.
    No main path calls it: chip_smoke.py and bench_gemm.py time and hold
    the chains against it at the same calls."""
    _split_trunk_backward(lib, m, e, ws, wts, tm, buf, bw, dws, dbs, want_dw, acc, scratch,
                          stream)


def _split_trunk_backward(lib, m: int, e, ws, wts, tm: TrunkMeta, buf, bw, dws, dbs,
                          want_dw: bool, acc: int, scratch, stream) -> None:
    """The trunk backward as one GEMM a layer (cuda_trunk_backward_split's
    launches).  A bf16 pass with dW writes each dm_l and dz_l into the
    kept planes the fused chains fill (bw's dms, dzs, dzbs), so that the
    two are compared row by row; else two rows of each alternate."""
    from honerf_torch.ops import fused_hand as FH

    n, Hp, Ep = tm.n_layers, tm.Hp, tm.Ep
    acts, ts, cs, ss = buf["acts"], buf["ts"], buf["cs"], buf["ss"]
    ds, de = bw["ds"], bw["de"]
    du_b, du_s, onehot, c_last = bw["du_b"], bw["du_s"], bw["onehot"], bw["c_last"]
    if want_dw and "dzbs" in bw:
        dm = bw["dms"]
        dzf = bw["dzs"] + [bw["dzf"][0]]
        dzb = bw["dzbs"] + [bw["dzb"][0]]
    else:   # dm_l in dm[l % 2], dz_l in dzf / dzb[(n - 1 - l) % 2]
        dm = [bw["dm"][l % 2] for l in range(n)]
        dzf = [bw["dzf"][(n - 1 - l) % 2] for l in range(n)]
        dzb = [bw["dzb"][(n - 1 - l) % 2] for l in range(n)]
    # u-chain transposed, upward: dt = dm_l W_l, dc = dt s_l,
    # ds_l = dt c_{l+1}, dW_l += dm_l^T t_l
    for l in range(n):
        if l == 0:
            A1, K1, A2, K2 = du_b, Ep, None, 0
        elif l == tm.skip:
            A1, K1, A2, K2 = dm[l], Hp, du_s, Ep
        else:
            A1, K1, A2, K2 = dm[l], Hp, None, 0
        if l < n - 1:
            out = dm[l + 1]
            cs_next = c_last if l + 1 == n - 1 else cs[l + 1]
            FH.gemm(lib, A1, K1, A2, K2, ws[l], Hp, None, m, EPI_UT, out,
                    out.stride(0), S=ss[l], DS=ds[l], CS=cs_next,
                    cs_ld=0 if l + 1 == n - 1 else cs_next.stride(0),
                    hscale=INV_SQRT2 if l + 1 == tm.skip else 1.0, stream=stream)
        if want_dw:
            Y = onehot if l == n - 1 else ts[l]
            _tn(lib, A1, A1.stride(0), K1, Y, Y.shape[1], m, dws[l], acc, scratch, stream)
            if A2 is not None:
                _tn(lib, A2, A2.stride(0), K2, Y, Y.shape[1], m, dws[l][Hp:], acc, scratch,
                    stream)
    # forward transposed, downward: dW_l += in_l^T dz_l, db_l = sum dz_l,
    # din = dz_l W_l^T, dz_{l-1} = da s + ds beta s (1 - s), de at the
    # skip and layer 0
    for l in range(n - 1, -1, -1):
        if want_dw:
            _layer_dw(lib, m, e, ws, tm, acts, l, dzb[l], dzf[l], dws, dbs, acc, scratch,
                      stream)
        wt = wts[l]                            # (out_pad, in_pad)
        width = ws[l].shape[1]
        if l > 0:
            skip = l == tm.skip
            FH.gemm(lib, dzb[l], width, None, 0, wt, wt.shape[1], None, m, EPI_DZ,
                    dzb[l - 1], dzb[l - 1].stride(0), Cf=dzf[l - 1], S=ss[l - 1],
                    DS=ds[l - 1], U=de if skip else None, split=Hp,
                    hscale=INV_SQRT2 if skip else 1.0, escale=INV_SQRT2, u_acc=0,
                    stream=stream)
        else:
            FH.gemm(lib, dzb[l], width, None, 0, wt, wt.shape[1], None, m, EPI_DZ,
                    None, 0, U=de, split=0, u_acc=1, stream=stream)


def _hand_trunk_sdf_u_cuda(e, pack: TrunkPack):
    lib = _lib()
    tm = pack.meta
    dev = e.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    N, E = e.shape
    out = torch.empty((N, tm.d_out), device=dev, dtype=torch.float32)
    u = torch.empty((N, E), device=dev, dtype=torch.float32)
    if N == 0:
        return out, u
    C = chunk_size(N, tm.dtype, CHUNK)
    buf = trunk_buffers(tm, C, dev, keep=False)
    eb = torch.empty((C, tm.Ep), device=dev, dtype=_cast(tm))
    us = torch.empty((C, tm.Ep), device=dev, dtype=torch.float32)
    KERNEL_FWD.launches += 1
    for s in range(0, N, C):
        m = min(C, N - s)
        trunk_pack_e(lib, e[s:], m, eb, stream)
        cuda_trunk_forward(lib, eb, m, pack.ws, pack.bs, pack.wts, tm, buf, stream, z=out[s:],
                           u=us)
        copy_cols(lib, us, m, E, u[s:], stream)
    return out, u


def _hand_trunk_sdf_u_bwd_cuda(e, pack: TrunkPack, dout, du, want_dw: bool):
    lib = _lib()
    tm = pack.meta
    Hp, Ep, Op = tm.Hp, tm.Ep, tm.Op
    dev = e.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    N, E = e.shape
    de = torch.empty((N, E), device=dev, dtype=torch.float32)
    dws = dbs = None
    if want_dw:
        dws = tuple(torch.zeros(w.shape, device=dev, dtype=torch.float32) for w in pack.ws)
        dbs = tuple(torch.zeros(b.shape, device=dev, dtype=torch.float32) for b in pack.bs)
    C = chunk_size(N, tm.dtype, BWD_CHUNK)
    seed = lib.honerf_trunk_bwd_seed_f32 if tm.dtype == "f32" else lib.honerf_trunk_bwd_seed
    if C:
        buf = trunk_buffers(tm, C, dev, keep=True)
        eb = torch.empty((C, Ep), device=dev, dtype=_cast(tm))
        bw = trunk_bwd_buffers(pack.ws, tm, C, dev, max(Hp, Op), want_dw)
        scratch = torch.empty((_WS_FLOATS,), device=dev, dtype=torch.float32)
        KERNEL_BWD.launches += 1
    for s in range(0, N, C or 1):
        m = min(C, N - s)
        trunk_pack_e(lib, e[s:], m, eb, stream)
        # the forward again, keeping every row; the backward reads neither
        # the last layer nor u
        cuda_trunk_forward(lib, eb, m, pack.ws, pack.bs, pack.wts, tm, buf, stream, keep=True)
        dzf, dzb = bw["dzf"][0], bw["dzb"][0]
        _build.check(seed(
            dout[s:].data_ptr(), dout.stride(0), tm.d_out, du[s:].data_ptr(), du.stride(0), E, m,
            dzf.data_ptr(), dzb.data_ptr(), dzf.stride(0), Op, bw["du_b"].data_ptr(),
            bw["du_s"].data_ptr(), bw["du_b"].stride(0), Ep, stream), "honerf_trunk_bwd_seed")
        cuda_trunk_backward(lib, m, eb, pack.ws, pack.wts, tm, buf, bw, dws, dbs, want_dw,
                            int(s > 0), scratch, stream)
        copy_cols(lib, bw["de"], m, E, de[s:], stream)
    return de, dws, dbs


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def _check_trunk(e, pack: TrunkPack, *cts) -> None:
    """Raise on anything the kernels (or their plain versions) do not take."""
    tm = pack.meta
    if e.dim() != 2 or e.shape[1] != tm.emb_width or e.dtype != torch.float32:
        raise ValueError(f"e must be (N, {tm.emb_width}) float32, got {tuple(e.shape)} {e.dtype}")
    for t in (e, *cts, *pack.ws, *pack.bs):
        if t.device != e.device:
            raise ValueError("all operands must be on one device")
    if e.device.type == "cuda":
        if tm.dtype not in ("bf16", "f32") or pack.wts is None:
            raise ValueError("K5/K6 take a bf16 or f32 pack made on the card")
        if not e.is_contiguous() or not all(t.is_contiguous() for t in cts):
            raise ValueError("operands must be contiguous")
    elif e.device.type != "cpu":
        raise ValueError(f"unsupported device {e.device}")


def hand_trunk_sdf_u_fwd(e, pack: TrunkPack):
    """(N, E) f32 embedding -> (out (N, d_out), u (N, E)) on a TrunkPack.
    CUDA tensors launch K5 (bf16 or f32 trunk); CPU tensors run the plain
    version.  No gradient flows through it."""
    _check_trunk(e, pack)
    with torch.no_grad():
        if e.device.type == "cuda":
            return _hand_trunk_sdf_u_cuda(e, pack)
        return hand_trunk_sdf_u_plain(e, pack)


def hand_trunk_sdf_u_bwd(e, pack: TrunkPack, dout, du, want_dw: bool = True):
    """The VJP at cotangents dout (N, d_out) and du (N, E): (de (N, E),
    padded f32 dws, dbs; None, None without want_dw).  CUDA tensors
    launch K6 (bf16 or f32 trunk); CPU tensors run the plain version."""
    N, tm = e.shape[0], pack.meta
    dout, du = dout.float().contiguous(), du.float().contiguous()
    if tuple(dout.shape) != (N, tm.d_out) or tuple(du.shape) != (N, tm.emb_width):
        raise ValueError(f"cotangents must be ({N}, {tm.d_out}) and ({N}, {tm.emb_width})")
    _check_trunk(e, pack, dout, du)
    with torch.no_grad():
        if e.device.type == "cuda":
            return _hand_trunk_sdf_u_bwd_cuda(e, pack, dout, du, want_dw)
        return hand_trunk_sdf_u_plain_bwd(e, pack, dout, du, want_dw)


class _HandTrunkSdfU(torch.autograd.Function):
    """The trunk + u-chain as one differentiable op: JAX's
    hand_trunk_sdf_u custom VJP.  The forward packs the weights (no grad)
    and keeps only e; the backward recomputes the forward.  Nothing
    differentiates the backward (nor the JAX custom_vjp's)."""

    @staticmethod
    def forward(ctx, meta, e, *weights):
        n = meta.n_layers
        ws, bs = weights[:n], weights[n:]
        pack = pack_trunk_weights([w.detach() for w in ws], [b.detach() for b in bs], meta)
        out, u = hand_trunk_sdf_u_fwd(e.detach().contiguous(), pack)
        ctx.save_for_backward(e)
        ctx.pack = pack
        ctx.shapes = [tuple(w.shape) for w in ws]
        return out, u

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dout, du):
        (e,) = ctx.saved_tensors
        pack = ctx.pack
        meta = pack.meta
        e = e.detach().contiguous()
        # an output the loss does not reach comes as zeros (autograd
        # materializes its cotangent)
        need = ctx.needs_input_grad
        want_dw = any(need[2:])
        de, dws, dbs = hand_trunk_sdf_u_bwd(e, pack, dout, du, want_dw)
        ctx.pack = None
        head = (None, de if need[1] else None)
        if not want_dw:
            return head + (None,) * (2 * meta.n_layers)
        dws, dbs = unpad_trunk_grads(dws, dbs, meta, ctx.shapes)
        return head + tuple(g if nd else None for g, nd in zip(dws + dbs, need[2:]))


def hand_trunk_sdf_u(e, ws, bs, meta: TrunkMeta):
    """(N, E) f32 embedding -> (out (N, d_out), u (N, E) = d out[:, 0] /
    d e), differentiable in e and the unpadded (in, out) weights and
    biases.  CUDA tensors launch K5 / K6 (bf16 or f32 trunk), CPU tensors
    run the plain versions."""
    return _HandTrunkSdfU.apply(meta, e, *ws, *bs)
