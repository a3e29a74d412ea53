"""The f32 GEMMs' arithmetic (honerf_torch/ops/csrc/common.cuh), modelled
on the CPU by honerf_torch.ops.fused_hand's tf32_round / split_tf32 /
matmul_3xtf32: each f32 operand split into two TF32 values (round to
nearest, ties away from zero), three TF32 products (small.big, big.small,
big.big), summed here in f64.

At the trunk's real widths (the products of one f32 pass and their dW,
with the skip concat's f32 1/sqrt2) the 3xTF32 product sits far under
chip_smoke's TOL_F32 (1e-4) from the exact product of the same f32
values, and a single TF32 product at least 100x further away: why the
kernels take three products and not one.  The card's own readings (the
kernels sum in f32, a fresh accumulator per K step) are chip_smoke's f32
GEMMs phase.
"""

import math

import numpy as np
import pytest
import torch

from honerf_torch.ops import fused_hand as FH

TOL_F32 = 1e-4          # chip_smoke.TOL_F32: the f32 kernels' rule
SPLIT_TOL = 1e-6        # the 3xTF32 product's relative L2, 100x under it
SINGLE_OVER = 100.0     # a single TF32 product's distance over 3xTF32's


def _tf32_reference(x: np.ndarray) -> np.ndarray:
    """TF32 rounding by arithmetic (not by bits): 11 significant bits,
    ties away from zero."""
    x = x.astype(np.float64)
    out = np.zeros_like(x)
    nz = x != 0
    e = np.floor(np.log2(np.abs(x[nz])))
    q = np.abs(x[nz]) / 2.0 ** (e - 10)       # in [1024, 2048)
    out[nz] = np.sign(x[nz]) * np.floor(q + 0.5) * 2.0 ** (e - 10)
    return out.astype(np.float32)


def test_tf32_round_matches_the_arithmetic_rule():
    rng = np.random.default_rng(0)
    x = np.concatenate([
        rng.standard_normal(20000).astype(np.float32) * 10.0 ** rng.integers(-6, 6, 20000),
        np.float32([0.0, 1.0, -1.0, 1 + 2 ** -11, -(1 + 2 ** -11), 1 + 3 * 2 ** -11,
                    2 - 2 ** -12, 3.0 * 2 ** -20])])   # ties away from zero, carries
    got = FH.tf32_round(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, _tf32_reference(x))
    assert not (got.view(np.int32) & 0x1FFF).any()
    np.testing.assert_array_equal(FH.tf32_round(torch.from_numpy(got)).numpy(), got)


def test_split_keeps_22_bits():
    """x = big + small + r, both parts TF32, |r| <= 2^-22 |x|."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal(200000).astype(np.float32))
    big, small = FH.split_tf32(x)
    for part in (big, small):
        assert not (part.view(torch.int32) & 0x1FFF).any()
    r = x.double() - big.double() - small.double()
    assert float((r.abs() / x.double().abs()).max()) <= 2.0 ** -22
    assert float((small.abs() / x.abs()).max()) <= 2.0 ** -11


# (M, K, N, scale): an f32 pass's products at their real K and N (fewer
# rows): layer 0, a hidden layer, the skip concat, the last layer, a
# u-chain step into the embedding; then dW over a split of points (K =
# the split's 2,352 points) for layer 0, the skip's embedding rows and a
# hidden layer
SHAPES = {"layer0": (256, 1408, 256, 0.0), "hidden": (256, 256, 256, 0.0),
          "skip": (256, 1664, 256, 1 / math.sqrt(2)), "last": (256, 256, 320, 0.0),
          "uchain": (256, 256, 1408, 0.0), "dw_layer0": (1408, 2352, 256, 0.0),
          "dw_skip": (1408, 2352, 256, 1 / math.sqrt(2)), "dw_hidden": (256, 2352, 256, 0.0)}


@pytest.mark.parametrize("shape", list(SHAPES))
def test_3xtf32_is_the_f32_product_and_one_tf32_product_is_not(shape):
    M, K, N, scale = SHAPES[shape]
    rng = np.random.default_rng(2)
    a = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32))
    b = torch.from_numpy((rng.standard_normal((K, N)) / math.sqrt(K)).astype(np.float32))
    if scale:
        a = a * torch.tensor(scale, dtype=torch.float32)   # in f32, before the split
    exact = a.double() @ b.double()

    def rel(c):
        return float((c - exact).norm() / exact.norm())

    three, one = rel(FH.matmul_3xtf32(a, b)), rel(FH.matmul_1xtf32(a, b))
    assert three <= SPLIT_TOL < TOL_F32
    assert one >= SINGLE_OVER * three
    assert one > TOL_F32    # a single TF32 product fails the f32 rule outright
