"""Synthetic hand pose and camera (numpy only); the subset of
honerf_tpu.data.synthetic that the render smoke test needs, so the port
renders the same pose and camera as the JAX package's benchmark."""

from __future__ import annotations

import numpy as np


def look_at_camera(position: np.ndarray, target: np.ndarray):
    """(R, T) in the row-vector convention X_view = X @ R + T with the
    view +z axis pointing from `position` to `target`."""
    f = target - position
    f = f / np.linalg.norm(f)
    up = np.asarray([0.0, 1.0, 0.0])
    if abs(np.dot(up, f)) > 0.98:
        up = np.asarray([1.0, 0.0, 0.0])
    x = np.cross(up, f)
    x /= np.linalg.norm(x)
    y = np.cross(f, x)
    M = np.stack([x, y, f], axis=0)
    R = M.T
    T = -(M @ position)
    return R.astype(np.float32), T.astype(np.float32)


def posed_hand_example(curl: float = 0.35, angle: float = 0.9, axis=(0.3, 0.8, 0.52),
                       cam_pos=(0.0, 0.2, -0.9)):
    """Canonical joints curled and rotated by a Rodrigues rotation, with a
    camera looking at the hand center.  Returns (joints (21,3), cam_R, cam_T)."""
    joints = canonical_hand_joints(curl=curl).astype(np.float32)
    a = np.asarray(axis, dtype=np.float64)
    a /= np.linalg.norm(a)
    K = np.asarray([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
    R3 = np.eye(3) + np.sin(angle) * K + (1 - np.cos(angle)) * (K @ K)
    joints = (joints @ R3.T).astype(np.float32)
    R, T = look_at_camera(np.asarray(cam_pos, np.float64), joints.mean(0))
    return joints, R, T


def canonical_hand_joints(curl: float = 0.0) -> np.ndarray:
    """A right-hand 21-joint skeleton in the repo's MANO order (0 = wrist,
    then 4-joint chains: 1-4 thumb, 5-8 index, 9-12 middle, 13-16 ring,
    17-20 pinky), in meters; `curl` is the per-segment flexion (radians)."""
    j = np.zeros((21, 3), dtype=np.float32)
    fingers = [
        ("thumb", 1, np.asarray([0.9, 0.55, 0.15]), [0.048, 0.034, 0.028, 0.024]),
        ("index", 5, np.asarray([0.25, 1.0, 0.0]), [0.095, 0.030, 0.022, 0.020]),
        ("middle", 9, np.asarray([0.0, 1.0, 0.0]), [0.092, 0.034, 0.025, 0.022]),
        ("ring", 13, np.asarray([-0.25, 1.0, 0.0]), [0.090, 0.030, 0.022, 0.020]),
        ("pinky", 17, np.asarray([-0.45, 0.9, 0.0]), [0.086, 0.022, 0.016, 0.016]),
    ]
    for _name, base, d, Ls in fingers:
        d = d / np.linalg.norm(d)
        flex_axis = np.cross(d, np.asarray([0.0, 0.0, 1.0]))
        flex_axis /= np.linalg.norm(flex_axis)
        p = j[0] + d * Ls[0]
        seg_dir = d.copy()
        for k in range(4):
            j[base + k] = p
            if k < 3:
                if curl != 0.0:
                    c, s = np.cos(curl), np.sin(curl)
                    seg_dir = (
                        seg_dir * c
                        + np.cross(flex_axis, seg_dir) * s
                        + flex_axis * np.dot(flex_axis, seg_dir) * (1 - c)
                    )
                p = p + seg_dir * Ls[k + 1]
    return j
