"""Dataset loaders for the reference on-disk layout (numpy only); a copy
of honerf_tpu.data.datasets, which the port cannot import without JAX.
The fitting stage's FrameWindowSampler is not here yet.

Mirrors the data contracts of the reference Dataset classes
(utils/dataset.py:116-382): per-view `PARAM_266/{cid}_{view}.pickle` files
carrying the image (`color_img`), camera (cam_R, cam_T, *_ndc), object pose
(obj_R/obj_T), and hand keypoints; predicted poses in
`pred_objpose_*view/{cid}.txt` and `mppose_3d/{cid}.pickle`; canonical hand
`t_pose_mppose.pickle`; object meshes `<obj>_ours.ply` (mm -> m, ::50
vertex subsampling like utils/dataset.py:153-155).

Everything is preloaded into host numpy arrays once; the train step sees
fixed-shape batches produced by the samplers in `honerf_torch.data.pixels`.
"""

from __future__ import annotations

import os
import pickle
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from honerf_torch.data.pixels import sample_patch, sample_rays
from honerf_torch.utils.ply import load_ply

# Parent/child joint pairs of the 21-joint MANO-ordered skeleton
# (utils/dataset.py:80-89).
BONE_FATHERS = [0, 0, 0, 0, 0, 1, 5, 9, 13, 17, 2, 6, 10, 14, 18, 3, 7, 11, 15, 19]
BONE_CHILDREN = [1, 5, 9, 13, 17, 2, 6, 10, 14, 18, 3, 7, 11, 15, 19, 4, 8, 12, 16, 20]


def get_bone_length(t_pose_21: np.ndarray) -> np.ndarray:
    """20 bone lengths from a 21-joint skeleton (utils/dataset.py:80-89)."""
    diffs = t_pose_21[BONE_CHILDREN] - t_pose_21[BONE_FATHERS]
    return np.linalg.norm(diffs, axis=-1)


def _read_pickle(path: str):
    with open(path, "rb") as f:
        return pickle.load(f)


@dataclass
class ViewRecord:
    """One training/test view with camera + pose annotations."""

    image: np.ndarray  # (H, W, 3) float32 in [0, 1]
    mask: np.ndarray  # (H, W, 1) float32 in {0, 1}
    mask_xy: Tuple[np.ndarray, np.ndarray]
    cam_R: np.ndarray  # (3, 3)
    cam_T: np.ndarray  # (3,)
    focal: np.ndarray  # (2,)
    principal: np.ndarray  # (2,)
    Ro: np.ndarray  # (3, 3) object rotation
    To: np.ndarray  # (3,)
    joints: np.ndarray  # (21, 3) hand keypoints (zeros for obj model)
    name: str = ""


@dataclass
class SceneData:
    """A fully preloaded offline-stage dataset (train or test split)."""

    views: List[ViewRecord]
    model_type: str  # 'hand' | 'obj'
    t_pose_21: np.ndarray  # (21, 3)
    bone_length: np.ndarray  # (20,)
    obj_verts: np.ndarray  # (V, 3) subsampled model verts (obj) / zeros

    def __len__(self) -> int:
        return len(self.views)


def _mask_from_image(img_u8: np.ndarray, thresh: int = 0) -> np.ndarray:
    """(img > thresh).all(-1) like utils/dataset.py:169/:209 (offline uses
    > 0; the fitting stage uses > 10 on jpeg-decoded images)."""
    return (img_u8 > thresh).all(axis=-1)[..., None].astype(np.uint8)


def load_offline_dataset(
    data_root: str, model_type: str, split: str = "train",
    data_type: str = "real",
) -> SceneData:
    """Load the offline-stage dataset (TrainDataLoad/TestDataLoad parity,
    utils/dataset.py:116-382).

    `data_type` selects the image naming flavor: the reference's hand
    loaders enumerate the IMG directory and map image names to PARAM_266
    pickles — '.png' for syn, '.jpeg' for real (utils/dataset.py:196-202,
    :336-339).  We map any extension by stem, so both flavors load; when
    no IMG directory exists the PARAM_266 listing is used directly."""
    param_path = os.path.join(data_root, "PARAM_266")
    img_path = os.path.join(data_root, "IMG")
    if model_type == "hand" and os.path.isdir(img_path):
        names = sorted(
            n.split(".")[0] + ".pickle" for n in os.listdir(img_path)
        )
    else:
        names = sorted(os.listdir(param_path))
    views: List[ViewRecord] = []

    if model_type == "obj":
        pose_dir = os.path.join(data_root, "pred_objpose_8view")
        ply_file = None
        for cand in os.listdir(data_root):
            if cand.endswith("_ours.ply"):
                ply_file = os.path.join(data_root, cand)
        if ply_file is None:
            raise FileNotFoundError(f"no *_ours.ply under {data_root}")
        verts, _ = load_ply(ply_file)
        verts = np.asarray(verts[::50, :]) / 1000.0
        t_pose = np.zeros((21, 3), np.float32)
        bone_length = np.zeros((20,), np.float32)
        for pname in names:
            cid = pname.split(".")[0].split("_")[0]
            param = _read_pickle(os.path.join(param_path, pname))
            if split == "train":
                cosypose = np.loadtxt(os.path.join(pose_dir, cid + ".txt")).astype(
                    np.float32
                )
                Ro, To = cosypose[:3, :3], cosypose[:3, 3]
            else:
                Ro, To = np.asarray(param["obj_R"]), np.asarray(param["obj_T"])
            img_u8 = np.asarray(param["color_img"])
            mask = _mask_from_image(img_u8)
            views.append(
                ViewRecord(
                    image=(img_u8 / 255.0).astype(np.float32),
                    mask=mask.astype(np.float32),
                    mask_xy=np.where(mask[:, :, 0] > 0),
                    cam_R=np.asarray(param["cam_R"], np.float32),
                    cam_T=np.asarray(param["cam_T"], np.float32),
                    focal=np.asarray([param["fx_ndc"], param["fy_ndc"]], np.float32),
                    principal=np.asarray([param["px_ndc"], param["py_ndc"]], np.float32),
                    Ro=np.asarray(Ro, np.float32),
                    To=np.asarray(To, np.float32),
                    joints=np.zeros((21, 3), np.float32),
                    name=pname,
                )
            )
        return SceneData(views, "obj", t_pose, bone_length, verts.astype(np.float32))

    # hand
    mppose_path = os.path.join(data_root, "mppose_3d")
    ori = _read_pickle(os.path.join(data_root, "t_pose_mppose.pickle"))
    t_pose = np.asarray(ori["T_pose_21"], np.float32)
    bone_length = get_bone_length(t_pose).astype(np.float32)
    for pname in names:
        cid = pname.split(".")[0].split("_")[0]
        param = _read_pickle(os.path.join(param_path, pname))
        img_u8 = np.asarray(param["color_img"])
        mask = _mask_from_image(img_u8)
        img_u8 = img_u8 * mask  # hand images are pre-masked (dataset.py:211)
        if split == "train":
            joints = np.asarray(
                _read_pickle(os.path.join(mppose_path, cid + ".pickle")), np.float32
            )
        else:
            joints = np.asarray(param["joint3d_21"], np.float32)
        views.append(
            ViewRecord(
                image=(img_u8 / 255.0).astype(np.float32),
                mask=mask.astype(np.float32),
                mask_xy=np.where(mask[:, :, 0] > 0),
                cam_R=np.asarray(param["cam_R"], np.float32),
                cam_T=np.asarray(param["cam_T"], np.float32),
                focal=np.asarray([param["fx_ndc"], param["fy_ndc"]], np.float32),
                principal=np.asarray([param["px_ndc"], param["py_ndc"]], np.float32),
                Ro=np.eye(3, dtype=np.float32),
                To=np.zeros(3, np.float32),
                joints=joints,
                name=pname,
            )
        )
    return SceneData(views, "hand", t_pose, bone_length, np.zeros((1, 3), np.float32))


class FrameWindowSampler:
    """Sliding overlapping frame windows [i, i + window), the video fitter's
    iteration order: max(n_frames - window + 1, 1) windows by default."""

    def __init__(self, n_frames: int, window: int = 4, n_iter: Optional[int] = None):
        self.n_frames = n_frames
        self.window = window
        self.n_iter = n_iter if n_iter is not None else max(n_frames - window + 1, 1)

    def __iter__(self):
        for i in range(self.n_iter):
            yield list(range(i, min(i + self.window, self.n_frames)))

    def __len__(self) -> int:
        return self.n_iter


@dataclass
class RayBatchLoader:
    """Iterates shuffled views, producing fixed-shape ray batches for the
    device step (the ray batch is formed per view like the reference's
    in-dataset sampling, utils/dataset.py:268-269)."""

    scene: SceneData
    n_rays: int
    seed: int = 0
    patch: bool = False

    def __post_init__(self):
        self.rng = np.random.default_rng(self.seed)

    def epoch(self, patch: Optional[bool] = None):
        order = self.rng.permutation(len(self.scene.views))
        for idx in order:
            yield self.get(int(idx), patch=patch)

    def get(self, idx: int, patch: Optional[bool] = None) -> Dict[str, np.ndarray]:
        v = self.scene.views[idx]
        use_patch = self.patch if patch is None else patch
        sampler = sample_patch if use_patch else sample_rays
        xy, rgb, m = sampler(v.image, v.mask, v.mask_xy, self.n_rays, rng=self.rng)
        return {
            "rays_xy": xy,
            "true_rgb": rgb,
            "true_mask": m,
            "cam_R": v.cam_R,
            "cam_T": v.cam_T,
            "focal": v.focal,
            "principal": v.principal,
            "Ro": v.Ro,
            "To": v.To,
            "joints": v.joints,
            "t_pose_21": self.scene.t_pose_21,
            "bone_length": self.scene.bone_length,
            "index": np.asarray(idx, np.int32),
        }
