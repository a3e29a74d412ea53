"""Fitting-stage dataset loaders (catch-sequence tree); a copy of
honerf_tpu.data.fit_datasets, which the port cannot import without JAX.

`data/catch_sequence/test/<per>_<obj>/<frame>/` holds per-view MASK jpegs +
PARAM_266 pickles (camera + GT poses), `<per>_tmppose.pickle`,
`<obj>_ours.ply`, and per-frame predicted poses
(`pred_joint3d_{n}view/<cid>.pickle`, `pred_objpose_{n}view/<cid>.txt`).
Later fit stages read the previous stage's `pose_*` pickles from
`./fit_res` (resume by artifact).  Images are read with cv2, else PIL,
else the port's own baseline JPEG decoder (utils.jpeg), which machines
with neither need.
"""

from __future__ import annotations

import os
import pickle
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np

from honerf_torch.data.datasets import get_bone_length
from honerf_torch.utils.ply import load_ply

VIEW_LISTS = {
    "8": ["21320018", "21320027", "21320028", "21320029",
          "21320030", "21320034", "21320035", "21320036"],
    "6": ["21320018", "21320027", "21320028",
          "21320034", "21320035", "21320036"],
    "3": ["21320027", "21320030", "21320035"],
}
TEST_VIEWS = ["21320018"]
RENDER_TEST_VIEWS = ["21320018", "21320028", "21320029", "21320034", "21320036"]


def _read_pickle(path: str):
    with open(path, "rb") as f:
        return pickle.load(f)


def _read_image(path: str, size_wh: Tuple[int, int] = (266, 230)) -> np.ndarray:
    """(H, W, 3) uint8 RGB at size_wh: cv2, else PIL (the JAX package's
    order), else utils.jpeg (a baseline decoder and a bilinear resize)."""
    try:
        import cv2

        img = cv2.imread(path)
        img = cv2.resize(img, size_wh)
        return img[..., ::-1]  # BGR -> RGB
    except ImportError:
        pass
    try:
        from PIL import Image
    except ImportError:
        from honerf_torch.utils.jpeg import read_jpeg, resize_linear

        return resize_linear(read_jpeg(path), size_wh)
    return np.asarray(Image.open(path).convert("RGB").resize(size_wh))


@dataclass
class FitView:
    image: np.ndarray  # (H, W, 3) float32
    mask: np.ndarray  # (H, W, 1) float32
    mask_xy: Tuple[np.ndarray, np.ndarray]
    cam_R: np.ndarray
    cam_T: np.ndarray
    focal: np.ndarray
    principal: np.ndarray
    proj: np.ndarray  # (3, 4) pixel projection matrix
    name: str


@dataclass
class FitFrame:
    """One frame of a fitting sequence: all views + pose annotations."""

    frame_id: int
    views: List[FitView]
    joints_pred: np.ndarray  # (21, 3) initialization
    obj_pose_pred: np.ndarray  # (4, 4) initialization
    joints_gt: np.ndarray  # (21, 3)
    Ro_gt: np.ndarray
    To_gt: np.ndarray
    test_views: List[FitView] = field(default_factory=list)


@dataclass
class FitSequence:
    obj_name: str
    frame_name: str
    frames: List[FitFrame]
    t_pose_21: np.ndarray
    bone_length: np.ndarray
    obj_verts: np.ndarray  # meters
    obj_faces: np.ndarray
    hand_model_path: str
    obj_model_path: str

    def __len__(self) -> int:
        return len(self.frames)


def _camera_from_param(param: Dict, H: int, W: int) -> Tuple[np.ndarray, ...]:
    R = np.asarray(param["cam_R"], np.float32)
    T = np.asarray(param["cam_T"], np.float32)
    focal = np.asarray([param["fx_ndc"], param["fy_ndc"]], np.float32)
    principal = np.asarray([param["px_ndc"], param["py_ndc"]], np.float32)
    s = min(H, W) - 1
    fx = -focal[0] * s / 2.0
    fy = -focal[1] * s / 2.0
    cx = -principal[0] * s / 2.0 + (W - 1) / 2.0
    cy = -principal[1] * s / 2.0 + (H - 1) / 2.0
    K = np.eye(3, dtype=np.float32)
    K[0, 0], K[1, 1], K[0, 2], K[1, 2] = fx, fy, cx, cy
    view = np.zeros((3, 4), np.float32)
    view[:3, :3] = R.T
    view[:3, 3] = T
    proj = K @ view
    return R, T, focal, principal, proj


def load_fit_sequence(
    data_root: str,
    obj_name: str,
    frame_name: str,
    view_num: str = "8",
    fit_type: str = "1",
    fit_res_root: str = "./fit_res",
    exp_root: str = "./exp",
    image_hw: Tuple[int, int] = (230, 266),
    load_test_views: bool = False,
) -> FitSequence:
    """Load one <per>_<obj>/<frame_name> sequence for fitting.

    fit_type selects the pose initialization source (utils/dataset.py:491-513):
    '1' reads the network predictions; '12' reads fit-'1' outputs; '123'/'1234'
    read fit-'12' outputs.
    """
    H, W = image_hw
    per, obj = obj_name.split("_")
    frame_path = os.path.join(data_root, obj_name, frame_name)
    img_path = os.path.join(frame_path, "MASK")
    verts, faces = load_ply(os.path.join(frame_path, obj + "_ours.ply"))
    verts = np.asarray(verts) / 1000.0
    ori = _read_pickle(os.path.join(frame_path, per + "_tmppose.pickle"))
    t_pose = np.asarray(ori["T_pose_21"], np.float32)
    bone_length = get_bone_length(t_pose).astype(np.float32)
    view_names = VIEW_LISTS[str(view_num)]

    frames: List[FitFrame] = []
    for frame_id in range(2000):
        probe = os.path.join(img_path, f"{frame_id}_21320018.jpeg")
        if not os.path.exists(probe):
            continue
        # pose initialization
        if fit_type == "1":
            jd = _read_pickle(
                os.path.join(
                    frame_path, f"pred_joint3d_{len(view_names)}view",
                    f"{frame_id}.pickle",
                )
            )
            joints_pred = np.asarray(jd["pred_joint_3d"], np.float32)
            obj_pose = np.loadtxt(
                os.path.join(
                    frame_path, f"pred_objpose_{len(view_names)}view",
                    f"{frame_id}.txt",
                )
            ).astype(np.float32)
        else:
            prev = {"12": "1", "123": "12", "1234": "12"}[fit_type]
            prev_file = os.path.join(
                fit_res_root, f"view_{len(view_names)}", prev, obj_name,
                frame_name, f"pose_{prev}", f"{frame_id}.pickle",
            )
            prev_param = _read_pickle(prev_file)
            joints_pred = np.asarray(prev_param["pred_joint3d"], np.float32)
            obj_pose = np.eye(4, dtype=np.float32)
            obj_pose[:3, :3] = prev_param["pred_Ro"]
            obj_pose[:3, 3] = prev_param["pred_To"]

        views: List[FitView] = []
        joints_gt = Ro_gt = To_gt = None
        for view_name in view_names:
            fname = f"{frame_id}_{view_name}"
            img_u8 = _read_image(os.path.join(img_path, fname + ".jpeg"), (W, H))
            mask = (img_u8 > 10).all(axis=-1)[..., None].astype(np.float32)
            param = _read_pickle(
                os.path.join(frame_path, "PARAM_266", fname + ".pickle")
            )
            R, T, focal, principal, proj = _camera_from_param(param, H, W)
            views.append(
                FitView(
                    image=(img_u8 / 255.0).astype(np.float32),
                    mask=mask,
                    mask_xy=np.where(mask[:, :, 0] > 0),
                    cam_R=R, cam_T=T, focal=focal, principal=principal,
                    proj=proj, name=fname + ".jpeg",
                )
            )
            if joints_gt is None:
                joints_gt = np.asarray(param["joint3d_21"], np.float32)
                Ro_gt = np.asarray(param["obj_R"], np.float32)
                To_gt = np.asarray(param["obj_T"], np.float32)

        test_views: List[FitView] = []
        if load_test_views:
            for view_name in RENDER_TEST_VIEWS:
                fname = f"{frame_id}_{view_name}"
                ppath = os.path.join(frame_path, "PARAM_266", fname + ".pickle")
                if not os.path.exists(ppath):
                    continue
                param = _read_pickle(ppath)
                R, T, focal, principal, proj = _camera_from_param(param, H, W)
                test_views.append(
                    FitView(
                        image=np.zeros((H, W, 3), np.float32),
                        mask=np.zeros((H, W, 1), np.float32),
                        mask_xy=(np.zeros(0, int), np.zeros(0, int)),
                        cam_R=R, cam_T=T, focal=focal, principal=principal,
                        proj=proj, name=fname + ".jpeg",
                    )
                )

        frames.append(
            FitFrame(
                frame_id=frame_id,
                views=views,
                joints_pred=joints_pred,
                obj_pose_pred=obj_pose,
                joints_gt=joints_gt,
                Ro_gt=Ro_gt,
                To_gt=To_gt,
                test_views=test_views,
            )
        )

    return FitSequence(
        obj_name=obj_name,
        frame_name=frame_name,
        frames=frames,
        t_pose_21=t_pose,
        bone_length=bone_length,
        obj_verts=verts.astype(np.float32),
        obj_faces=np.asarray(faces),
        hand_model_path=os.path.join(exp_root, per, "wmask_realhand"),
        obj_model_path=os.path.join(exp_root, obj, "wmask_realobj"),
    )


def list_fit_sequences(data_root: str) -> List[Tuple[str, str]]:
    """All (obj_name, frame_name) pairs under the catch-sequence tree
    (fit_single_dataset walks them all, utils/dataset.py:446-454)."""
    out = []
    for obj_name in sorted(os.listdir(data_root)):
        obj_path = os.path.join(data_root, obj_name)
        if not os.path.isdir(obj_path):
            continue
        for frame_name in sorted(os.listdir(obj_path)):
            if os.path.isdir(os.path.join(obj_path, frame_name)):
                out.append((obj_name, frame_name))
    return out


def load_sequence_manifest(path: str) -> List[Dict[str, str]]:
    """The pickled 15-entry sequence list selecting which video a fit_id
    processes (reference sequence_list_for_fitting.pickle,
    fitting_video.py:129-139)."""
    return _read_pickle(path)
