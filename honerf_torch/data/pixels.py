"""Host-side pixel/ray samplers (numpy); a copy of
honerf_tpu.data.pixels, which the port cannot import without JAX.

These run on the host as part of the input pipeline — they are
data-dependent (mask-conditioned) with dynamic candidate sets, which is
what stays off the device step, which receives fixed-shape
(n_rays, ...) batches.

Reference parity: `sample_rays` == get_rays_xy (utils/dataset.py:23-50),
`sample_patch` == get_rays_xy_mask (utils/dataset.py:52-78).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def sample_rays(
    image: np.ndarray,
    mask: np.ndarray,
    mask_xy: Tuple[np.ndarray, np.ndarray],
    n_rays: int,
    threshold: float = 0.4,
    rng: np.random.Generator | None = None,
):
    """Sample `n_rays` pixels: a `threshold` fraction uniformly from the
    mask, the rest uniformly over the image.

    Returns (rays_xy_ndc (N,2) float32, rgb (N,3), mask (N,1)).
    """
    rng = rng or np.random.default_rng()
    H, W = image.shape[:2]
    mask_r, mask_c = mask_xy  # row (y), col (x) indices
    n_in = min(int(n_rays * threshold), len(mask_r))
    sel = rng.integers(0, max(len(mask_r), 1), size=n_in) if len(mask_r) else np.zeros(0, int)
    in_r, in_c = mask_r[sel], mask_c[sel]
    n_out = n_rays - n_in
    u = rng.random((n_out, 2))
    out_r = (u[:, 0] * H).astype(np.int64)
    out_c = (u[:, 1] * W).astype(np.int64)
    rows = np.concatenate([in_r, out_r])
    cols = np.concatenate([in_c, out_c])
    rgb = image[rows, cols, :]
    m = mask[rows, cols, :]
    xy = np.stack([cols, rows], axis=-1).astype(np.float32)
    xy[:, 0] = (xy[:, 0] - W / 2.0) / (H / 2.0)
    xy[:, 1] = (xy[:, 1] - H / 2.0) / (H / 2.0)
    xy *= -1.0
    return xy, rgb.astype(np.float32), m.astype(np.float32)


def sample_patch(
    image: np.ndarray,
    mask: np.ndarray,
    mask_xy: Tuple[np.ndarray, np.ndarray],
    n_rays: int,
    rng: np.random.Generator | None = None,
):
    """Sample a contiguous sqrt(n) x sqrt(n) patch overlapping the mask
    bbox (for the VGG perceptual loss; reference utils/dataset.py:52-78 —
    note the reference divides BOTH axes by H/2, preserved here)."""
    rng = rng or np.random.default_rng()
    H, W = mask.shape[:2]
    mask_r, mask_c = mask_xy
    c_len = int(np.sqrt(n_rays))
    r_min, r_max = int(mask_r.min()), int(mask_r.max())
    c_min, c_max = int(mask_c.min()), int(mask_c.max())
    r_lo, r_hi = min(r_min + c_len, r_max), max(r_min + c_len, r_max)
    c_lo, c_hi = min(c_min + c_len, c_max), max(c_min + c_len, c_max)
    end_r = int(rng.integers(r_lo, r_hi + 1))
    end_c = int(rng.integers(c_lo, c_hi + 1))
    rs = np.arange(end_r - c_len, end_r)
    cs = np.arange(end_c - c_len, end_c)
    rr, cc = np.meshgrid(rs, cs, indexing="xy")
    rr = np.clip(rr.reshape(-1), 0, H - 1)
    cc = np.clip(cc.reshape(-1), 0, W - 1)
    rgb = image[rr, cc, :]
    m = mask[rr, cc, :]
    # reference normalizes row by H/2 and col by H/2 with swapped names
    # (utils/dataset.py:73-76)
    y = (rr - H / 2.0) / (H / 2.0)
    x = (cc - W / 2.0) / (H / 2.0)
    xy = -np.stack([x, y], axis=-1).astype(np.float32)
    return xy, rgb.astype(np.float32), m.astype(np.float32)
