"""Host-side data management: image cache, undistortion, view subsampling.

Counterpart of `gaussctrl_tpu/data/datamanager.py`: every view is loaded
and undistorted (the native helper, or cv2 with the optimal-new-camera crop
resized back to the dataset's size, so that every view keeps one shape),
4 subsets × 10 views are drawn with a seeded `random.Random` when a scene
has more than 40, precomputed edit artifacts are read for the resume path,
and `next_train` samples views at random without replacement.
`stacked_images` returns the cache as one [V, H, W, 3] array.
"""

from __future__ import annotations

import dataclasses
import random
from pathlib import Path
from typing import Optional

import numpy as np

from gaussctrl_tpu_torch.cameras.camera import Cameras, make_cameras
from gaussctrl_tpu_torch.data.dataparser import (DataparserConfig,
                                                 DataparserOutputs,
                                                 parse_dataset)


@dataclasses.dataclass
class DataManagerConfig:
    dataparser: DataparserConfig = dataclasses.field(default_factory=DataparserConfig)
    subset_num: int = 4
    sampled_views_every_subset: int = 10
    load_all: bool = False
    seed: int = 13789


def _load_image(path) -> np.ndarray:
    from PIL import Image

    img = np.asarray(Image.open(path).convert("RGB"), np.float32) / 255.0
    return img


def _undistort(image: np.ndarray, K: np.ndarray, dist6: np.ndarray,
               width: int, height: int):
    """Undistort one cached view; dist6 is (k1, k2, k3, k4, p1, p2). The
    native helper keeps K (so intrinsics and shapes stay as they are); the
    cv2 fallback crops to the optimal new camera's ROI and resizes back."""
    if not np.any(dist6):
        return image, K

    from gaussctrl_tpu_torch import native
    if native.available():
        out = native.undistort(image, K[0, 0], K[1, 1], K[0, 2], K[1, 2],
                               np.asarray(dist6, np.float64))
        return out, K

    import cv2

    # cv2 order (k1,k2,p1,p2,k3[,k4,k5,k6]) — pad to the 8-coeff model
    d = np.array([dist6[0], dist6[1], dist6[4], dist6[5], dist6[2], dist6[3],
                  0.0, 0.0], np.float64)
    newK, roi = cv2.getOptimalNewCameraMatrix(K, d, (image.shape[1], image.shape[0]), 0)
    und = cv2.undistort(image, K, d, None, newK)
    x, y, w, h = roi
    und = und[y: y + h, x: x + w]
    K2 = newK.copy()
    K2[0, 2] -= x
    K2[1, 2] -= y
    if (w, h) != (width, height):
        sx, sy = width / w, height / h
        und = cv2.resize(und, (width, height), interpolation=cv2.INTER_AREA)
        K2[0, 0] *= sx
        K2[0, 2] *= sx
        K2[1, 1] *= sy
        K2[1, 2] *= sy
    return und, K2


class DataManager:
    """Loads, undistorts and subsamples the edit views.

    Attributes after construction:
      cameras: `Cameras` over the selected views (undistorted intrinsics).
      train_data: list of dicts per selected view: image [H,W,3] f32 and —
        when precomputed artifacts exist — depth_image [1,H,W],
        z_0_image [1,4,h/8,w/8], mask_image [H,W], unedited_image [H,W,3].
    """

    def __init__(self, config: DataManagerConfig, parsed: Optional[DataparserOutputs] = None):
        self.config = config
        self.parsed = parsed if parsed is not None else parse_dataset(config.dataparser)
        p = self.parsed
        W, H = p.width, p.height

        images = []
        fx, fy, cx, cy = [], [], [], []
        for i, path in enumerate(p.image_filenames):
            img = _load_image(path)
            K = np.array([[p.fx[i], 0, p.cx[i]], [0, p.fy[i], p.cy[i]], [0, 0, 1]],
                         np.float64)
            img, K = _undistort(img, K, p.distortion[i], W, H)
            images.append(img)
            fx.append(K[0, 0]); fy.append(K[1, 1]); cx.append(K[0, 2]); cy.append(K[1, 2])

        all_cameras = make_cameras(p.c2w, np.asarray(fx), np.asarray(fy),
                                   np.asarray(cx), np.asarray(cy), W, H)

        n = len(images)
        cap = config.subset_num * config.sampled_views_every_subset
        if n <= cap or config.load_all:
            selected = list(range(n))
        else:
            rng = random.Random(config.seed)
            anchors = list(range(0, n, n // config.subset_num))[: config.subset_num] + [n]
            selected = []
            for lo, hi in zip(anchors[:-1], anchors[1:]):
                selected += sorted(rng.sample(range(lo, hi), config.sampled_views_every_subset))
        self.selected_indices = selected
        self.cameras: Cameras = all_cameras[np.asarray(selected)]

        self.train_data = []
        for new_idx, orig_idx in enumerate(selected):
            item = {"image_idx": new_idx, "image": images[orig_idx]}
            if p.depth_filenames is not None and Path(p.depth_filenames[orig_idx]).exists():
                depth = np.load(p.depth_filenames[orig_idx])  # [H,W,1]
                item["depth_image"] = np.transpose(depth, (2, 0, 1)).astype(np.float32)
            if p.z0_filenames is not None and Path(p.z0_filenames[orig_idx]).exists():
                item["z_0_image"] = np.load(p.z0_filenames[orig_idx]).astype(np.float32)
            if p.mask_filenames is not None and Path(p.mask_filenames[orig_idx]).exists():
                item["mask_image"] = np.load(p.mask_filenames[orig_idx]).astype(np.float32)
            if p.unedited_filenames is not None and Path(p.unedited_filenames[orig_idx]).exists():
                item["unedited_image"] = _load_image(p.unedited_filenames[orig_idx])
            self.train_data.append(item)

        self._unseen = list(range(len(self.train_data)))
        self._sampler_rng = random.Random(config.seed + 1)

    def __len__(self):
        return len(self.train_data)

    def next_train(self, step: int):
        """Random-without-replacement full-image sampling."""
        idx = self._unseen.pop(self._sampler_rng.randrange(len(self._unseen)))
        if not self._unseen:
            self._unseen = list(range(len(self.train_data)))
        return idx, self.train_data[idx]

    def stacked_images(self) -> np.ndarray:
        """[V, H, W, 3] training images (edited, once the pipeline ran)."""
        return np.stack([d["image"] for d in self.train_data])
