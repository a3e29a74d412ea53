"""Synthetic scenes in the reference on-disk layout (numpy only); the
part of honerf_tpu.data.synthetic that the port's runner, tests and
chip_smoke.py need, copied because the port cannot import it without
JAX: the posed hand and camera of the JAX package's benchmark, and the
analytic sphere "object" and capsule-skeleton "hand" datasets read by
`honerf_torch.data.datasets.load_offline_dataset`, and the fitting
stage's catch sequence (`generate_catch_sequence`, read by
`honerf_torch.data.fit_datasets.load_fit_sequence`), whose JPEGs the
port's own encoder writes (utils.jpeg), so a machine without cv2 or PIL
makes it too.
"""

from __future__ import annotations

import os
import pickle
from typing import Tuple

import numpy as np

from honerf_torch.data.datasets import BONE_CHILDREN, BONE_FATHERS
from honerf_torch.utils.ply import save_ply


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


def icosphere(radius: float, subdiv: int = 2) -> Tuple[np.ndarray, np.ndarray]:
    """Icosahedron-based sphere mesh."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.asarray(
        [
            [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
            [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
            [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
        ],
        dtype=np.float64,
    )
    faces = np.asarray(
        [
            [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
            [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
            [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
            [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
        ],
        dtype=np.int64,
    )
    for _ in range(subdiv):
        mids = {}
        new_faces = []
        vlist = list(verts)

        def midpoint(a, b):
            key = (min(a, b), max(a, b))
            if key not in mids:
                m = (vlist[a] + vlist[b]) / 2.0
                vlist.append(m)
                mids[key] = len(vlist) - 1
            return mids[key]

        for f in faces:
            a, b, c = int(f[0]), int(f[1]), int(f[2])
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        verts = np.asarray(vlist)
        faces = np.asarray(new_faces, dtype=np.int64)
    verts = verts / np.linalg.norm(verts, axis=-1, keepdims=True) * radius
    return verts, faces


def render_sphere_view(
    R: np.ndarray,
    T: np.ndarray,
    focal: np.ndarray,
    principal: np.ndarray,
    H: int,
    W: int,
    center: np.ndarray,
    radius: float,
    albedo=(0.85, 0.55, 0.35),
):
    """Analytic ray-traced sphere image through the framework camera model.

    Background pixels are exactly 0 so the loaders' (img > 0) mask
    extraction reproduces the reference behaviour."""
    cols, rows = np.meshgrid(np.arange(W), np.arange(H))
    x_ndc = -((cols - W / 2.0) / (H / 2.0))
    y_ndc = -((rows - H / 2.0) / (H / 2.0))
    # unproject at depths 1, 2 (row-vector convention)
    def unproject(depth):
        vx = (x_ndc - principal[0]) * depth / focal[0]
        vy = (y_ndc - principal[1]) * depth / focal[1]
        v = np.stack([vx, vy, np.full_like(vx, depth)], axis=-1)
        return (v - T) @ R.T

    p1 = unproject(1.0)
    p2 = unproject(2.0)
    d = p2 - p1
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = p1 - d
    # ray-sphere intersection
    oc = o - center
    b = np.sum(oc * d, axis=-1)
    c = np.sum(oc * oc, axis=-1) - radius**2
    disc = b * b - c
    hit = disc > 0
    t_hit = -b - np.sqrt(np.maximum(disc, 0.0))
    hit &= t_hit > 0
    pts = o + t_hit[..., None] * d
    normals = (pts - center) / radius
    light = np.asarray([0.3, 0.5, -0.8])
    light = light / np.linalg.norm(light)
    shade = np.clip(np.sum(normals * light, axis=-1), 0.0, 1.0) * 0.7 + 0.3
    img = np.zeros((H, W, 3), dtype=np.float32)
    img[hit] = np.asarray(albedo) * shade[hit][..., None]
    img_u8 = np.clip(img * 255.0, 0, 255).astype(np.uint8)
    # guarantee nonzero channels inside the mask (mask = all channels > 0)
    img_u8[hit] = np.maximum(img_u8[hit], 1)
    return img_u8, hit


VIEW_NAMES = [
    "21320018", "21320027", "21320028", "21320029",
    "21320030", "21320034", "21320035", "21320036",
]


def generate_object_dataset(
    root: str,
    n_frames: int = 1,
    n_views: int = 8,
    H: int = 64,
    W: int = 72,
    radius: float = 0.12,
    center=(0.0, 0.0, 0.0),
    cam_dist: float = 0.95,
    seed: int = 0,
    pose_noise: float = 0.0,
) -> None:
    """Write a synthetic object dataset under `root` in the reference layout
    consumed by `load_offline_dataset(root, 'obj')`."""
    rng = np.random.default_rng(seed)
    center = np.asarray(center, dtype=np.float64)
    os.makedirs(os.path.join(root, "PARAM_266"), exist_ok=True)
    os.makedirs(os.path.join(root, "pred_objpose_8view"), exist_ok=True)
    verts, faces = icosphere(radius)
    save_ply(os.path.join(root, "bean_ours.ply"), verts * 1000.0, faces)
    focal = np.asarray([3.0, 3.0], np.float32)
    principal = np.asarray([0.0, 0.0], np.float32)
    for cid in range(n_frames):
        # GT object pose: identity rotation, translation = sphere center
        pose = np.eye(4, dtype=np.float32)
        pose[:3, 3] = center
        if pose_noise > 0:
            noisy = pose.copy()
            noisy[:3, 3] += rng.normal(0, pose_noise, 3)
        else:
            noisy = pose
        np.savetxt(os.path.join(root, "pred_objpose_8view", f"{cid}.txt"), noisy)
        for vi in range(n_views):
            az = 2 * np.pi * vi / n_views
            el = 0.35 + 0.1 * np.sin(1.7 * vi)
            pos = center + cam_dist * np.asarray(
                [np.cos(az) * np.cos(el), np.sin(el), np.sin(az) * np.cos(el)]
            )
            R, T = look_at_camera(pos, center)
            img, _ = render_sphere_view(
                R, T, focal, principal, H, W, center, radius
            )
            param = {
                "color_img": img,
                "cam_R": R,
                "cam_T": T,
                "fx_ndc": float(focal[0]),
                "fy_ndc": float(focal[1]),
                "px_ndc": float(principal[0]),
                "py_ndc": float(principal[1]),
                "H": H,
                "W": W,
                "obj_R": pose[:3, :3],
                "obj_T": pose[:3, 3],
                "joint3d_21": np.zeros((21, 3), np.float32),
            }
            name = f"{cid}_{VIEW_NAMES[vi % len(VIEW_NAMES)]}.pickle"
            with open(os.path.join(root, "PARAM_266", name), "wb") as f:
                pickle.dump(param, f)


def _segment_distances(pts: np.ndarray, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Distance from points (..., 3) to segments a->b (S, 3)."""
    ab = b - a  # (S, 3)
    ab2 = np.sum(ab * ab, axis=-1)  # (S,)
    ap = pts[..., None, :] - a  # (..., S, 3)
    t = np.clip(np.sum(ap * ab, axis=-1) / np.maximum(ab2, 1e-12), 0.0, 1.0)
    closest = a + t[..., None] * ab
    return np.linalg.norm(pts[..., None, :] - closest, axis=-1)  # (..., S)


def render_capsule_hand_view(
    R: np.ndarray,
    T: np.ndarray,
    focal: np.ndarray,
    principal: np.ndarray,
    H: int,
    W: int,
    joints: np.ndarray,
    radius: float = 0.012,
    albedo=(0.8, 0.6, 0.5),
    n_steps: int = 48,
):
    """Sphere-march a capsule-skeleton 'hand' through the framework camera
    (coarse but watertight enough for mask/color supervision)."""
    a = joints[BONE_FATHERS]
    b = joints[BONE_CHILDREN]
    cols, rows = np.meshgrid(np.arange(W), np.arange(H))
    x_ndc = -((cols - W / 2.0) / (H / 2.0))
    y_ndc = -((rows - H / 2.0) / (H / 2.0))

    def unproject(depth):
        vx = (x_ndc - principal[0]) * depth / focal[0]
        vy = (y_ndc - principal[1]) * depth / focal[1]
        v = np.stack([vx, vy, np.full_like(vx, depth)], axis=-1)
        return (v - T) @ R.T

    p1 = unproject(1.0)
    d = p1 - unproject(2.0)
    d = -d / np.linalg.norm(d, axis=-1, keepdims=True)
    o = p1 - d

    t = np.full((H, W), 0.4, dtype=np.float64)
    # march the rays still short of the far limit: a ray at 1.6 stays there
    # (the same t as marching every ray every step)
    live = np.ones((H, W), dtype=bool)
    for _ in range(n_steps):
        tl = t[live]
        pts = o[live] + tl[..., None] * d[live]
        dist = _segment_distances(pts, a, b).min(axis=-1) - radius
        t[live] = np.minimum(tl + np.maximum(dist, 1e-4), 1.6)
        live &= t < 1.6
    pts = o + t[..., None] * d
    sdf = _segment_distances(pts, a, b).min(axis=-1) - radius
    hit = (sdf < 2e-3) & (t < 1.55)
    # approximate normal from nearest segment
    dmin = _segment_distances(pts, a, b)
    near_idx = dmin.argmin(axis=-1)
    ab = b - a
    ab2 = np.sum(ab * ab, axis=-1)
    an = a[near_idx]
    abn = ab[near_idx]
    tt = np.clip(
        np.sum((pts - an) * abn, axis=-1) / np.maximum(ab2[near_idx], 1e-12), 0, 1
    )
    normals = pts - (an + tt[..., None] * abn)
    normals /= np.maximum(np.linalg.norm(normals, axis=-1, keepdims=True), 1e-9)
    light = np.asarray([0.3, 0.5, -0.8])
    light /= np.linalg.norm(light)
    shade = np.clip(np.sum(normals * light, axis=-1), 0, 1) * 0.7 + 0.3
    img = np.zeros((H, W, 3), dtype=np.float32)
    img[hit] = np.asarray(albedo) * shade[hit][..., None]
    img_u8 = np.clip(img * 255, 0, 255).astype(np.uint8)
    img_u8[hit] = np.maximum(img_u8[hit], 1)
    return img_u8, hit


def generate_hand_dataset(
    root: str,
    n_frames: int = 1,
    n_views: int = 8,
    H: int = 64,
    W: int = 72,
    curl: float = 0.3,
    cam_dist: float = 0.95,
    seed: int = 0,
) -> None:
    """Write a synthetic hand dataset under `root` in the reference layout
    consumed by `load_offline_dataset(root, 'hand')`: PARAM_266 pickles,
    mppose_3d predicted joints, t_pose_mppose.pickle canonical pose."""
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "PARAM_266"), exist_ok=True)
    os.makedirs(os.path.join(root, "mppose_3d"), exist_ok=True)
    os.makedirs(os.path.join(root, "IMG"), exist_ok=True)
    t_pose = canonical_hand_joints(curl=0.0)
    with open(os.path.join(root, "t_pose_mppose.pickle"), "wb") as f:
        pickle.dump({"T_pose_21": t_pose}, f)
    focal = np.asarray([3.0, 3.0], np.float32)
    principal = np.asarray([0.0, 0.0], np.float32)
    for cid in range(n_frames):
        joints = canonical_hand_joints(curl=curl + 0.05 * cid)
        # generic pose so the HALO canonicalization is non-degenerate
        axis = np.asarray([0.3, 0.8, 0.52])
        axis /= np.linalg.norm(axis)
        th = 0.9
        K = np.asarray(
            [[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]]
        )
        Rh = np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * (K @ K)
        joints = (joints - joints.mean(0)) @ Rh.T
        center = joints.mean(0)
        with open(os.path.join(root, "mppose_3d", f"{cid}.pickle"), "wb") as f:
            pickle.dump(joints.astype(np.float32), f)
        for vi in range(n_views):
            az = 2 * np.pi * vi / n_views
            el = 0.35 + 0.1 * np.sin(1.7 * vi)
            pos = center + cam_dist * np.asarray(
                [np.cos(az) * np.cos(el), np.sin(el), np.sin(az) * np.cos(el)]
            )
            R, T = look_at_camera(pos, center)
            img, _ = render_capsule_hand_view(R, T, focal, principal, H, W, joints)
            param = {
                "color_img": img,
                "cam_R": R,
                "cam_T": T,
                "fx_ndc": float(focal[0]),
                "fy_ndc": float(focal[1]),
                "px_ndc": float(principal[0]),
                "py_ndc": float(principal[1]),
                "H": H,
                "W": W,
                "obj_R": np.eye(3, dtype=np.float32),
                "obj_T": np.zeros(3, np.float32),
                "joint3d_21": joints.astype(np.float32),
            }
            name = f"{cid}_{VIEW_NAMES[vi % len(VIEW_NAMES)]}"
            with open(os.path.join(root, "PARAM_266", name + ".pickle"), "wb") as f:
                pickle.dump(param, f)
            open(os.path.join(root, "IMG", name + ".jpeg"), "wb").close()


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


def generate_catch_sequence(
    data_root: str,
    obj_name: str = "person1_bean",
    frame_name: str = "seq0",
    n_frames: int = 2,
    n_views: int = 8,
    H: int = 48,
    W: int = 56,
    sphere_radius: float = 0.1,
    seed: int = 0,
) -> None:
    """Write a synthetic fitting sequence in the catch-sequence layout
    consumed by `load_fit_sequence` (utils/dataset.py:409-760): per-view
    MASK jpegs + PARAM_266 pickles, t-pose pickle, object PLY, predicted
    joints/pose initializations.  The JPEGs: 4:4:4 at quality 95 by
    utils.jpeg."""
    rng = np.random.default_rng(seed)
    per, obj = obj_name.split("_")
    frame_path = os.path.join(data_root, obj_name, frame_name)
    os.makedirs(os.path.join(frame_path, "MASK"), exist_ok=True)
    os.makedirs(os.path.join(frame_path, "PARAM_266"), exist_ok=True)
    os.makedirs(os.path.join(frame_path, f"pred_joint3d_{n_views}view"), exist_ok=True)
    os.makedirs(os.path.join(frame_path, f"pred_objpose_{n_views}view"), exist_ok=True)
    t_pose = canonical_hand_joints(curl=0.0)
    with open(os.path.join(frame_path, per + "_tmppose.pickle"), "wb") as f:
        pickle.dump({"T_pose_21": t_pose}, f)
    verts, faces = icosphere(sphere_radius)
    save_ply(os.path.join(frame_path, obj + "_ours.ply"), verts * 1000.0, faces)
    focal = np.asarray([3.0, 3.0], np.float32)
    principal = np.asarray([0.0, 0.0], np.float32)

    from honerf_torch.data.fit_datasets import VIEW_LISTS
    from honerf_torch.utils.jpeg import write_jpeg

    view_names = VIEW_LISTS[str(n_views)] if str(n_views) in VIEW_LISTS else VIEW_NAMES

    for fid in range(n_frames):
        joints = canonical_hand_joints(curl=0.3 + 0.05 * fid)
        axis = np.asarray([0.3, 0.8, 0.52])
        axis /= np.linalg.norm(axis)
        th = 0.9
        K = np.asarray(
            [[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]]
        )
        Rh = np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * (K @ K)
        joints = ((joints - joints.mean(0)) @ Rh.T).astype(np.float32)
        center = joints.mean(0)
        obj_center = center + np.asarray([0.0, -0.02, 0.06], np.float32)
        Ro_gt = np.eye(3, dtype=np.float32)
        To_gt = obj_center
        # noisy initial predictions
        joints_pred = joints + rng.normal(0, 0.003, joints.shape).astype(np.float32)
        pose_pred = np.eye(4, dtype=np.float32)
        pose_pred[:3, 3] = To_gt + rng.normal(0, 0.004, 3).astype(np.float32)
        with open(
            os.path.join(frame_path, f"pred_joint3d_{n_views}view", f"{fid}.pickle"),
            "wb",
        ) as f:
            pickle.dump({"pred_joint_3d": joints_pred}, f)
        np.savetxt(
            os.path.join(frame_path, f"pred_objpose_{n_views}view", f"{fid}.txt"),
            pose_pred,
        )
        for vi, view_name in enumerate(view_names[:n_views]):
            az = 2 * np.pi * vi / n_views
            el = 0.35 + 0.1 * np.sin(1.7 * vi)
            pos = center + 0.95 * np.asarray(
                [np.cos(az) * np.cos(el), np.sin(el), np.sin(az) * np.cos(el)]
            )
            R, T = look_at_camera(pos, center)
            hand_img, hand_hit = render_capsule_hand_view(
                R, T, focal, principal, H, W, joints
            )
            obj_img, obj_hit = render_sphere_view(
                R, T, focal, principal, H, W, obj_center, sphere_radius,
                albedo=(0.4, 0.6, 0.9),
            )
            img = np.where(hand_hit[..., None], hand_img, obj_img)
            write_jpeg(os.path.join(frame_path, "MASK", f"{fid}_{view_name}.jpeg"), img,
                       quality=95)
            param = {
                "cam_R": R,
                "cam_T": T,
                "fx_ndc": float(focal[0]),
                "fy_ndc": float(focal[1]),
                "px_ndc": float(principal[0]),
                "py_ndc": float(principal[1]),
                "H": H,
                "W": W,
                "obj_R": Ro_gt,
                "obj_T": To_gt,
                "joint3d_21": joints,
            }
            with open(
                os.path.join(frame_path, "PARAM_266", f"{fid}_{view_name}.pickle"),
                "wb",
            ) as f:
                pickle.dump(param, f)
