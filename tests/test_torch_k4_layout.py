"""K4 in one launch (csrc/fused_sdf.cu: obj_sdf_fused_kernel): its layout
arithmetic (honerf_torch/ops/wgmma_layout.py, the K4_* names) held against
the source and against wgmma's operand layout, and a numpy model of the
kernel's order held against the port's plain version and the JAX package's
Pallas kernel (CPU).

The kernel runs only on the card (tests/test_torch_cuda.py holds it
against fused_obj_sdf_plain there).  Here:
  * the source's K4_* constants are the helper's; the block's shared
    memory (the activation tile, es, the weight ring, the barriers) fits
    in the 232,448 bytes a block may use;
  * the epilogue's write address of every (row, column) of a tile is the
    byte the A descriptor makes wgmma read that element from (K-major,
    128-byte swizzle), one to one; the PE's writes land there too;
  * `k4_model`, the kernel's order in numpy (tiles of 128 points, the PE
    of each point into the activation tile and es = bf16(f32(e) /
    sqrt2), each layer in K steps of 64 over the activation and then es,
    bias, softplus, the pre-skip scale, the padding zeroed, one bf16
    rounding, in place; the last layer's sdf column times 1/scale):
    bit for bit equal to fused_obj_sdf_plain where every sum is exact in
    f32 (each weight column holds at most two powers of two, so the sum is
    one rounding in any order) and the transcendentals are the plain
    version's own (torch's sin, cos and logaddexp on arrays laid out as
    the plain version lays them out: ATen's vector and scalar paths differ
    in the last bit); with numpy's functions and the nets' own weights it
    agrees with the Pallas kernel in interpret mode within
    tests/test_torch_fused_sdf.py's tolerance (max 1e-3 of max(1, |want|),
    median 1e-6).
"""

import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from honerf_torch.ops import fused_fine as FT
from honerf_torch.ops import fused_sdf as FS
from honerf_torch.ops import wgmma_layout as WL
from honerf_torch.train.checkpoints import params_from_jax
from test_pallas_ops import fused_eval
from test_torch_fused_sdf import _setup

SOURCE = Path(WL.__file__).resolve().parent / "csrc" / "fused_sdf.cu"
INV_SQRT2 = np.float32(1.0 / math.sqrt(2.0))

torch.set_num_threads(1)


def test_source_constants_are_the_helpers():
    env = {}
    for decl in re.findall(r"^constexpr int (K4_\w+ = [^;]+);", SOURCE.read_text(), flags=re.M):
        name, expr = (x.strip() for x in decl.split("="))
        env[name] = eval(expr.replace("/", "//"), {}, dict(env))  # noqa: S307
    assert set(env) == set(WL.K4_CONSTANTS)
    for name in WL.K4_CONSTANTS:
        assert env[name] == getattr(WL, name), name


def test_shared_memory_fits_one_block():
    parts = WL.k4_smem_bytes()
    assert sum(parts.values()) == WL.K4_SMEM_BYTES <= WL.SMEM_LIMIT == 232448
    # the activation tile: 4 chunks of 64 columns; es one chunk; a stage
    # 64 k-rows of 256 bf16 columns, four TMA boxes of wgmma.cuh's B
    assert parts["act"] == 4 * 128 * 64 * 2 and parts["es"] == 128 * 64 * 2
    assert WL.K4_STAGE_BYTES == (WL.K4_WIDTH // WL.MN_CHUNK) * WL.B_CHUNK_BYTES
    # every operand starts on the swizzle's 1024-byte period
    for off in (WL.K4_CHUNK_BYTES, WL.K4_CHUNK_BYTES // 2, WL.K4_ACT_BYTES,
                WL.K4_ACT_BYTES + WL.K4_ES_BYTES, WL.K4_STAGE_BYTES):
        assert off % 1024 == 0
    # the threads: wgmma.cuh's producer and two consumer warpgroups
    assert WL.THREADS == 384 and WL.K4_TILE == 2 * 64


def _read_address(base, row, col, es=False):
    """The byte wgmma reads tile element (row, col) from, through the A
    descriptor of the consumer that owns the row."""
    c, chunk, kk = row // 64, col // 64, (col % 64) // 16
    desc = WL.k4_a_desc(base, chunk, c, kk, es=es)
    return WL.wgmma_offset(desc, row % 64, col % 16, k_major=True)


def test_epilogue_writes_what_wgmma_reads():
    """Each of the 256 consumer threads' 128 accumulators: the pair's
    store address (plus 2 bytes for the odd column) is where the next
    layer's A descriptor reads that (row, column); the tile's 32,768
    elements are each written once."""
    base = 0x2000
    seen = set()
    for thread in range(256):
        for i in range(128):
            row, col = WL.k4_acc_cell(thread, i)
            j, q = divmod(i, 4)
            addr = base + WL.k4_store_offset(thread, j, q >> 1) + 2 * (q & 1)
            assert addr == _read_address(base, row, col) == base + WL.k4_offset(row, col)
            seen.add((row, col))
    assert len(seen) == WL.K4_TILE * WL.K4_WIDTH


def test_pe_writes_what_wgmma_reads():
    """The prologue's e (the tile's first 64 columns) and es (its own
    tile) land where layer 0's and the skip layer's descriptors read them,
    one to one."""
    base = 0x4400 & ~1023
    e_addr = {base + WL.k4_offset(r, c) for r in range(128) for c in range(64)}
    assert e_addr == {_read_address(base, r, c) for r in range(128) for c in range(64)}
    es = {base + WL.K4_ACT_BYTES + WL.k4_offset(r, c) for r in range(128) for c in range(64)}
    assert es == {_read_address(base, r, c, es=True) for r in range(128) for c in range(64)}
    assert len(e_addr) == len(es) == 128 * 64


def test_layer_table_of_the_object_conf():
    """The bean conf's net: 64 -> 256 x 3 -> 193 | skip [256 | es 64] ->
    256 x 3 -> the sdf column (64): each layer's K steps and k-rows."""
    _, cfg, jp, _ = _setup("full", 1)
    ws, _, meta = FS.pack_obj_sdf_weights(params_from_jax(jp, device="cpu"), cfg)
    layers = WL.k4_layers([w.shape[0] for w in ws], [w.shape[1] for w in ws],
                          [l in meta.skips for l in range(meta.n_layers)])
    assert [(x["kt"], x["skip"], x["n"]) for x in layers] == (
        [(1, 0, 256)] + [(4, 0, 256)] * 3 + [(4, 1, 256)] + [(4, 0, 256)] * 3 + [(4, 0, 64)])
    assert layers[4]["k_rows"] == [0, 64, 128, 192, 256]
    assert meta.out_widths[3] == 193 and meta.Ep == WL.K4_EP
    with pytest.raises(ValueError):   # rows that do not chain
        WL.k4_layers([64, 320], [256, 256], [False, False])


# ---------------------------------------------------------------------------
# The kernel's order in numpy
# ---------------------------------------------------------------------------

def _bf16(x):
    """f32 -> the nearest bf16 value (ties to even), held in f32."""
    b = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    b = (b + 0x7FFF + ((b >> 16) & 1)) & 0xFFFF0000
    return b.astype(np.uint32).view(np.float32)


NUMPY_FNS = dict(sin=np.sin, cos=np.cos,
                 softplus=lambda y: (np.logaddexp(np.float32(100) * y, np.float32(0))
                                     / np.float32(100)).astype(np.float32))


def _torch_fn(fn):
    return lambda a: fn(torch.from_numpy(np.ascontiguousarray(a))).numpy()


# the plain version's own elementwise functions, on the arrays it makes
TORCH_FNS = dict(sin=_torch_fn(torch.sin), cos=_torch_fn(torch.cos),
                 softplus=_torch_fn(FT._softplus_beta))


def k4_model(pts, ws, bs, meta, fns=NUMPY_FNS):
    """(N,) sdf in obj_sdf_fused_kernel's order (numpy f32; bf16 values
    held in f32).  pts (N, 3) f32, ws / bs the packed weights and biases."""
    N, L, Ep = pts.shape[0], meta.multires, WL.K4_EP
    ws = [w.float().numpy() for w in ws]
    bs = [b.numpy() for b in bs]
    # the PE of every point, in the plain version's array layout: (N, 3, L)
    spec = pts[:, :, None] * (np.float32(2.0) ** np.arange(L, dtype=np.float32))
    sin, cos = fns["sin"](spec), fns["cos"](spec)
    layers = WL.k4_layers([w.shape[0] for w in ws], [w.shape[1] for w in ws],
                          [l in meta.skips for l in range(meta.n_layers)])
    out = np.empty((N,), np.float32)
    for t0 in range(0, N, WL.K4_TILE):
        rows = min(WL.K4_TILE, N - t0)
        # prologue: column 3 + 2 L c + k is sin(2^k x_c) for k < L, then cos
        e = np.zeros((WL.K4_TILE, Ep), np.float32)
        e[:rows, :3] = pts[t0:t0 + rows]
        for c in range(3):
            for k in range(2 * L):
                src = sin if k < L else cos
                e[:rows, 3 + 2 * L * c + k] = src[t0:t0 + rows, c, k % L]
        act = np.zeros((WL.K4_TILE, WL.K4_WIDTH), np.float32)
        act[:, :Ep] = _bf16(e)
        es = _bf16(e * INV_SQRT2)
        for l, ly in enumerate(layers):
            n = ly["n"]
            acc = np.zeros((WL.K4_TILE, n), np.float32)
            for step, k0 in enumerate(ly["k_rows"]):
                a = act[:, k0:k0 + 64] if step < ly["kt"] else es
                for kk in range(0, 64, 16):
                    acc = acc + a[:, kk:kk + 16] @ ws[l][k0 + kk:k0 + kk + 16]
            z = acc + bs[l]
            if l == len(layers) - 1:
                out[t0:t0 + rows] = z[:rows, 0] * np.float32(1.0 / meta.scale)
                break
            sp = fns["softplus"](z)
            if l + 1 in meta.skips:
                sp = sp * INV_SQRT2
            sp[:, meta.out_widths[l]:] = 0.0
            act[:, :n] = _bf16(sp)
    return out


def _exact_net(cfg, seed):
    """Packed weights whose every column holds at most two nonzero
    weights, each +-2^p (bf16-exact; products of bf16 activations exact in
    f32, and a sum of two rounds once whatever the order), a skip layer's
    columns one from the activation and one from es; biases of the pack's
    shape, small, so the softplus inputs spread over its curve."""
    from honerf_torch.models.fields import init_sdf_params

    ws, bs, meta = FS.pack_obj_sdf_weights(init_sdf_params(torch.Generator().manual_seed(seed),
                                                           cfg, device="cpu"), cfg)
    rng = np.random.default_rng(seed)
    new_ws, new_bs = [], []
    d_in = meta.emb_width
    for l, (w, b) in enumerate(zip(ws, bs)):
        K, n = w.shape
        width = meta.out_widths[l]
        W = np.zeros((K, n), np.float32)
        live = np.arange(d_in) if l == 0 else np.arange(meta.out_widths[l - 1])
        for j in range(width):
            pows = np.float32(2.0) ** rng.integers(-3, 2, size=2).astype(np.float32)
            sign = rng.choice([-1.0, 1.0], size=2).astype(np.float32)
            if l in meta.skips:
                ap = K - meta.Ep
                W[rng.choice(live), j] = sign[0] * pows[0]
                W[ap + rng.integers(0, meta.emb_width), j] = sign[1] * pows[1]
            else:
                r = rng.choice(live, size=min(2, live.size), replace=False)
                W[r, j] = (sign * pows)[:r.size]
        bias = np.zeros((n,), np.float32)
        bias[:width] = rng.normal(size=width).astype(np.float32) * 0.02
        new_ws.append(torch.from_numpy(W).to(torch.bfloat16))
        new_bs.append(torch.from_numpy(bias))
        d_in = width
    return tuple(new_ws), tuple(new_bs), meta


@pytest.mark.parametrize("net,n", [("full", 256), ("full", 300), ("small", 131)])
def test_model_equals_plain_bit_for_bit(net, n):
    _, cfg, _, pts = _setup(net, n, seed=2)
    ws, bs, meta = _exact_net(cfg, 2)
    assert all(torch.equal(w.float().to(torch.bfloat16).float(), w.float()) for w in ws)
    want = FS.fused_obj_sdf_plain(torch.from_numpy(pts), ws, bs, meta).numpy()
    got = k4_model(pts, ws, bs, meta, TORCH_FNS)
    assert np.isfinite(want).all() and np.abs(want).max() > 0
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("net,n", [("full", 200), ("small", 100)])
def test_model_matches_pallas_interpret(net, n):
    """The model with numpy's own functions on the nets' own weights
    against JAX's K4 (interpret mode), test_torch_fused_sdf.py's rule."""
    jcfg, cfg, jp, pts = _setup(net, n)
    want = np.asarray(fused_eval(jp, jcfg, jnp.asarray(pts)))
    ws, bs, meta = FS.pack_obj_sdf_weights(params_from_jax(jp, device="cpu"), cfg)
    got = k4_model(pts, ws, bs, meta)
    err = np.abs(got - want) / max(1.0, float(np.abs(want).max()))
    assert err.max() <= 1e-3 and np.median(err) <= 1e-6, (err.max(), np.median(err))
