"""transforms.json dataset parser.

Counterpart of `gaussctrl_tpu/data/dataparser.py` (numpy, host side):
frames sorted by filename, global or per-frame intrinsics, OPENCV
distortion, orientation ("up") and centring ("poses") of the poses and
their scaling into the unit box, the whole set as the training split, the
sparse point cloud of `ply_file_path`, and discovery of precomputed edit
artifacts (depth_npy/, z_0/, mask_npy/, unedited/) for the resume path.
`load_mask` is a real field, on by default.
"""

from __future__ import annotations

import dataclasses
import json
import os
from pathlib import Path
from typing import Optional

import numpy as np

from gaussctrl_tpu_torch.data.ply import read_point_cloud

MAX_AUTO_RESOLUTION = 1600


@dataclasses.dataclass
class DataparserConfig:
    data: Path = Path(".")
    scale_factor: float = 1.0
    downscale_factor: Optional[int] = None
    scene_scale: float = 1.0
    orientation_method: str = "up"       # "up" | "none"
    center_method: str = "poses"         # "poses" | "none"
    auto_scale_poses: bool = True
    train_split_fraction: float = 1.0    # gc default: everything is train
    load_3d_points: bool = True
    load_mask: bool = True


@dataclasses.dataclass
class DataparserOutputs:
    image_filenames: list
    c2w: np.ndarray              # [N, 3, 4] oriented/centered/scaled
    fx: np.ndarray               # [N]
    fy: np.ndarray
    cx: np.ndarray
    cy: np.ndarray
    width: int
    height: int
    distortion: np.ndarray       # [N, 6] (k1, k2, k3, k4, p1, p2)
    dataparser_transform: np.ndarray   # [3, 4]
    dataparser_scale: float
    points_xyz: Optional[np.ndarray] = None   # [M, 3] (transformed)
    points_rgb: Optional[np.ndarray] = None   # [M, 3] in [0,1]
    depth_filenames: Optional[list] = None
    z0_filenames: Optional[list] = None
    mask_filenames: Optional[list] = None
    unedited_filenames: Optional[list] = None

    def __len__(self):
        return len(self.image_filenames)


def _rotation_between(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Rotation matrix taking unit vector a to unit vector b (Rodrigues)."""
    a = a / np.linalg.norm(a)
    b = b / np.linalg.norm(b)
    v = np.cross(a, b)
    c = float(a @ b)
    if c < -1 + 1e-8:  # antiparallel: rotate 180° about any orthogonal axis
        axis = np.cross(a, [1.0, 0.0, 0.0])
        if np.linalg.norm(axis) < 1e-6:
            axis = np.cross(a, [0.0, 1.0, 0.0])
        axis /= np.linalg.norm(axis)
        return 2.0 * np.outer(axis, axis) - np.eye(3)
    skew = np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])
    return np.eye(3) + skew + skew @ skew * (1.0 / (1.0 + c))


def auto_orient_and_center_poses(
    poses: np.ndarray, method: str = "up", center_method: str = "poses"
) -> tuple[np.ndarray, np.ndarray]:
    """nerfstudio-equivalent orientation: mean up-vector → +z, origins centered.

    Args: poses [N, 4, 4] or [N, 3, 4]. Returns (oriented [N, 3, 4], transform [3, 4]).
    """
    origins = poses[:, :3, 3]
    translation = origins.mean(0) if center_method == "poses" else np.zeros(3)
    if method == "up":
        up = poses[:, :3, 1].mean(0)
        up = up / np.linalg.norm(up)
        rot = _rotation_between(up, np.array([0.0, 0.0, 1.0]))
    else:
        rot = np.eye(3)
    transform = np.concatenate([rot, rot @ -translation[:, None]], axis=1)  # [3,4]
    homog = np.concatenate(
        [poses[:, :3, :4], np.tile(np.array([[[0.0, 0.0, 0.0, 1.0]]]), (poses.shape[0], 1, 1))],
        axis=1,
    )
    oriented = transform @ homog  # [N, 3, 4]
    return oriented.astype(np.float32), transform.astype(np.float32)


def _frame_value(meta, frame, key, default=0.0):
    if key in frame:
        return float(frame[key])
    if key in meta:
        return float(meta[key])
    return default


def parse_dataset(config: DataparserConfig) -> DataparserOutputs:
    data_dir = Path(config.data)
    meta_path = data_dir / "transforms.json" if data_dir.is_dir() else data_dir
    if not data_dir.is_dir():
        data_dir = meta_path.parent
    with open(meta_path) as f:
        meta = json.load(f)

    frames = meta["frames"]
    # sort by resolved filename
    fnames = [str(data_dir / frame["file_path"]) for frame in frames]
    order = np.argsort(fnames)
    frames = [frames[i] for i in order]

    image_filenames = []
    poses = []
    fx, fy, cx, cy = [], [], [], []
    distort = []
    for frame in frames:
        image_filenames.append(data_dir / frame["file_path"])
        poses.append(np.asarray(frame["transform_matrix"], np.float32))
        fx.append(_frame_value(meta, frame, "fl_x"))
        fy.append(_frame_value(meta, frame, "fl_y"))
        cx.append(_frame_value(meta, frame, "cx"))
        cy.append(_frame_value(meta, frame, "cy"))
        distort.append([
            _frame_value(meta, frame, "k1"), _frame_value(meta, frame, "k2"),
            _frame_value(meta, frame, "k3"), _frame_value(meta, frame, "k4"),
            _frame_value(meta, frame, "p1"), _frame_value(meta, frame, "p2"),
        ])
    poses = np.stack(poses)
    width = int(meta.get("w", frames[0].get("w", 0)))
    height = int(meta.get("h", frames[0].get("h", 0)))

    oriented, transform = auto_orient_and_center_poses(
        poses, config.orientation_method, config.center_method
    )
    scale = 1.0
    if config.auto_scale_poses:
        scale /= float(np.max(np.abs(oriented[:, :3, 3])))
    scale *= config.scale_factor
    oriented[:, :3, 3] *= scale

    # downscale: auto halves until the larger side is at most 1600 px
    df = config.downscale_factor
    if df is None:
        max_res = max(width, height)
        df = 1
        while max_res / df > MAX_AUTO_RESOLUTION:
            df *= 2
    if df > 1:
        alt = [data_dir / f"images_{df}" / Path(f["file_path"]).name for f in frames]
        if all(p.exists() for p in alt):
            image_filenames = alt
        fx = [v / df for v in fx]
        fy = [v / df for v in fy]
        cx = [v / df for v in cx]
        cy = [v / df for v in cy]
        width, height = width // df, height // df

    points_xyz = points_rgb = None
    if config.load_3d_points and "ply_file_path" in meta:
        ply_path = data_dir / meta["ply_file_path"]
        if ply_path.exists():
            pts, cols = read_point_cloud(ply_path)
            homog = np.concatenate([pts, np.ones_like(pts[:, :1])], -1)
            points_xyz = (homog @ transform.T) * scale
            points_rgb = cols

    n = len(image_filenames)

    def artifact_list(dirname, ext):
        d = data_dir / dirname
        if d.exists():
            return [d / f"frame_{i + 1:05d}.{ext}" for i in range(n)]
        return None

    return DataparserOutputs(
        image_filenames=image_filenames,
        c2w=oriented[:, :3, :4],
        fx=np.asarray(fx, np.float32), fy=np.asarray(fy, np.float32),
        cx=np.asarray(cx, np.float32), cy=np.asarray(cy, np.float32),
        width=width, height=height,
        distortion=np.asarray(distort, np.float32),
        dataparser_transform=transform,
        dataparser_scale=scale,
        points_xyz=points_xyz,
        points_rgb=points_rgb,
        depth_filenames=artifact_list("depth_npy", "npy"),
        z0_filenames=artifact_list("z_0", "npy"),
        mask_filenames=artifact_list("mask_npy", "npy") if config.load_mask else None,
        unedited_filenames=artifact_list("unedited", "jpg"),
    )
