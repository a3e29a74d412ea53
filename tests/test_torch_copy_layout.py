"""The padded-row copy's plan (honerf_torch/ops/perpoint_layout.py:
copy_plan, copy_columns), held against csrc/trunk.cuh and against the
copy's contract, and its wrapper on the CPU.

copy_cols_kernel runs only on the card (tests/test_torch_cuda.py holds it
bit for bit against the copy there); here: the header's CP_* constants are
the helper's; at every call shape of the main path and every source and
destination offset mod 16 bytes, each row's head, body vectors and tail
write every column once and only those, each body vector on both sides at
its own alignment; the width-1 call takes the narrow path; on CPU tensors
the wrapper writes copy_cols_plain's rows, counts no launch and refuses
what the kernel does not take.  Runs in a few seconds.
"""

import re
from pathlib import Path

import pytest
import torch

from honerf_torch.ops import fused_fine as FT
from honerf_torch.ops import perpoint_layout as PL

HEADER = Path(PL.__file__).resolve().parent / "csrc" / "trunk.cuh"

# (source element bytes, source row stride, destination row stride, width)
# of each call the main path makes (ops/fused_fine_full.py: no-color K2 and
# K3; ops/fused_fine.py: K5's u and K6's de), in elements
CALLS = {
    "K2 e": (2, 1408, 1386, 1386),
    "K3 de": (4, 1386, 1792, 1386),
    "K3 dfeat": (4, 257, 1792, 256),
    "K3 dsdf": (4, 257, 1, 1),
    "K5 u, K6 de": (4, 1408, 1386, 1386),
}


def test_header_constants_are_the_helpers():
    env = {}
    for decl in re.findall(r"^constexpr int (CP_\w+ = [^;]+);", HEADER.read_text(), flags=re.M):
        name, expr = (x.strip() for x in decl.split("="))
        env[name] = eval(expr.replace("/", "//"), {}, dict(env))  # noqa: S307
    assert set(env) == set(PL.CP_CONSTANTS)
    for name in PL.CP_CONSTANTS:
        assert env[name] == getattr(PL, name), name


def _check_row(s_addr, d_addr, width, esize):
    """Every column of the row written once; each body vector's 16-byte
    store aligned and its loads at the plan's width aligned; the head
    shorter than a vector, the tail too; lanes within a warp."""
    acc = PL.copy_columns(s_addr, d_addr, width, esize)
    cols = [c for _, _, cs in acc for c in cs]
    assert sorted(cols) == list(range(width)), (s_addr, d_addr, width, esize)
    if width <= PL.CP_NARROW:
        assert [p for p, _, _ in acc] == ["narrow"]
        return
    V, h, lb = PL.copy_plan(s_addr, d_addr, width, esize)
    assert (V, h, lb) == (1, 0, esize) or (V == 4 and h < 4 and lb in (esize, 2 * esize,
                                                                        4 * esize))
    for p, lane, cs in acc:
        assert 0 <= lane < 32
        if p == "body":
            assert cs == list(range(cs[0], cs[0] + V))
            assert (d_addr + 4 * cs[0]) % 16 == 0      # one 16-byte store
            assert (s_addr + esize * cs[0]) % lb == 0  # loads of lb bytes
    if V > 1:
        tail = [c for p, _, cs in acc if p == "tail" for c in cs]
        assert len(tail) < V and len([1 for p, _, _ in acc if p == "body"]) == (width - h) // V


@pytest.mark.parametrize("call", list(CALLS))
def test_every_column_once_at_every_offset(call):
    """Each call shape's first 16 rows (odd strides give the rows their
    own alignments) at every base offset mod 16 of source and destination."""
    esize, lds, ldd, width = CALLS[call]
    for so in range(0, 16, esize):
        for do in range(0, 16, 4):
            for m in range(16):
                _check_row(4096 + so + m * lds * esize, 8192 + do + m * ldd * 4, width, esize)


@pytest.mark.parametrize("esize", [2, 4])
def test_widths_and_vectors(esize):
    """Every width 1-40 and some wide ones at every offset; loads as wide
    as the source's alignment after the destination's head allows."""
    for width in list(range(1, 41)) + [255, 256, 1386]:
        for so in range(0, 16, esize):
            for do in range(0, 16, 4):
                _check_row(so, do, width, esize)
    assert PL.copy_plan(0, 0, 1386, esize) == (4, 0, 4 * esize)
    if esize == 4:
        # ldd 1386's odd rows (8 bytes past 16): two head columns, the
        # source then 8 bytes past its 16: loads of 8 bytes
        assert PL.copy_plan(0, 8, 1386, 4) == (4, 2, 8)
        assert PL.copy_plan(4, 0, 1386, 4) == (4, 0, 4)     # only 4 bytes shared
        assert PL.copy_plan(12, 12, 256, 4) == (4, 1, 16)   # one head column to 16 bytes
        assert PL.copy_plan(12, 4, 6, 4) == (1, 0, 4)       # no whole vector after the head
    else:
        assert PL.copy_plan(0, 8, 1386, 2) == (4, 2, 4)     # bf16 -> f32, dst 8 past 16
        assert PL.copy_plan(2, 4, 1386, 2) == (4, 3, 8)


def test_wrapper_on_the_cpu_writes_the_plain_copy():
    gen = torch.Generator().manual_seed(0)
    for sdt in (torch.float32, torch.bfloat16):
        base = torch.randn((11, 257), generator=gen).to(sdt)
        dst = torch.full((12, 300), float("nan"))
        before = FT.COPY.launches
        FT.copy_cols(None, base[:, 1:], 9, 256, dst[:, 5:], None)
        assert FT.COPY.launches == before
        assert torch.equal(dst[:9, 5:261], base[:9, 1:257].float())
        assert torch.equal(dst[:9, 5:261], FT.copy_cols_plain(base[:, 1:], 9, 256))
        keep = torch.ones_like(dst, dtype=torch.bool)
        keep[:9, 5:261] = False
        assert bool(torch.isnan(dst[keep]).all())


def test_wrapper_refuses_what_the_kernel_does_not_take():
    src, dst = torch.randn((8, 64)), torch.empty((8, 64))
    for args in ((src.double(), 8, 64, dst), (src, 8, 64, dst.to(torch.bfloat16)),
                 (src[:, ::2], 8, 32, dst), (src, 9, 64, dst), (src, 8, 65, dst),
                 (src[0], 1, 64, dst), (src, -1, 64, dst)):
        with pytest.raises(ValueError):
            FT.copy_cols(None, *args, None)
    if torch.cuda.is_available():
        with pytest.raises(ValueError):   # operands on two devices
            FT.copy_cols(None, src, 8, 64, dst.cuda(), None)
