"""Checkpoint IO: npz scene checkpoints and the splatfacto `.ckpt` importer.

Counterpart of `gaussctrl_tpu/core/ckpt.py`, in the same file format: an npz
whose keys are the scene's field names, step-numbered `step-{step:09d}.npz` files with latest-only
pruning, and an fp16 archive of a scene (`compress_scene_npz`). A
checkpoint written here loads with the JAX package's `load_scene_npz`, and
the other way round. `import_splatfacto_ckpt` reads a nerfstudio
splatfacto checkpoint (the flat parameter names of nerfstudio 1.0 or the
newer `gauss_params.*`). The sharded orbax checkpoints of a device mesh are
not ported: `latest_checkpoint` sees them, as the JAX package's does, and
`load_scene_npz` raises on them.
"""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np
import torch

from gaussctrl_tpu_torch.splat.scene import _FIELDS, GaussianScene


def import_splatfacto_ckpt(path) -> tuple[GaussianScene, int]:
    """Load a torch splatfacto checkpoint → (GaussianScene on the CPU, step)."""
    # tensors and plain containers only: the file comes from outside
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    state = ckpt.get("pipeline", ckpt)
    step = int(ckpt.get("step", 0))
    found = {}
    for key, val in state.items():
        if not isinstance(val, torch.Tensor):
            continue
        # "_model.gauss_params.means", "_model.means", "model.means", …
        leaf = key.split(".")[-1]
        if leaf in _FIELDS and ("gauss_params" in key or "_model" in key
                                or key == leaf):
            found[leaf] = val.detach().to(torch.float32).numpy()
    missing = set(_FIELDS) - set(found)
    if missing:
        raise ValueError(f"splatfacto checkpoint {path} missing params: "
                         f"{sorted(missing)}")
    if found["opacities"].ndim == 1:
        found["opacities"] = found["opacities"][:, None]
    if found["features_dc"].ndim == 3:      # some exports keep [N, 1, 3]
        found["features_dc"] = found["features_dc"][:, 0, :]
    return GaussianScene.from_numpy(found), step


def save_pytree(path, scene: GaussianScene) -> None:
    """Save a scene to npz, one array per field."""
    np.savez_compressed(path, **{k: getattr(scene, k).detach().cpu().numpy()
                                 for k in _FIELDS})


def load_scene_npz(path, device="cpu") -> GaussianScene:
    """Load a GaussianScene from a checkpoint npz, always as float32 (an
    fp16 archive resumes at full precision). The JAX package's sharded orbax
    checkpoints are not read yet."""
    if Path(path).is_dir() or str(path).endswith(".orbax"):
        raise NotImplementedError(
            f"{path} is an orbax checkpoint of the JAX package's device mesh; "
            f"the port reads npz checkpoints only")
    data = np.load(path)
    return GaussianScene(**{k: torch.tensor(data[k].astype(np.float32),
                                            device=device) for k in _FIELDS})


def compress_scene_npz(src, dst, dtype=np.float16) -> Path:
    """Re-encode a scene checkpoint with a reduced-precision payload; the
    means stay float32 (position quantisation shows), the other fields sit
    behind exp/sigmoid/normalisation or are SH colours."""
    data = np.load(src)
    out = {}
    for k in data.files:
        arr = data[k]
        if k != "means" and arr.dtype == np.float32:
            arr = arr.astype(dtype)
        out[k] = arr
    dst = Path(dst)
    np.savez_compressed(dst, **out)
    return dst


def save_checkpoint(ckpt_dir, step: int, scene: GaussianScene,
                    keep_only_latest: bool = True):
    """`step-{step:09d}.npz` in `ckpt_dir`; older full-precision checkpoints
    are removed (fp16 archives are kept)."""
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    out = ckpt_dir / f"step-{step:09d}.npz"
    save_pytree(out, scene)
    if keep_only_latest:
        for f in ckpt_dir.glob("step-*.npz"):
            if f != out and not f.name.endswith(".fp16.npz"):
                f.unlink()
    return out


def latest_checkpoint(ckpt_dir) -> Path | None:
    """The highest-step checkpoint across the npz files and the JAX
    package's orbax directories (`step-*.orbax`); at equal steps the
    full-precision npz, then the first listed, as the JAX package picks."""
    ckpts = list(Path(ckpt_dir).glob("step-*.npz")) + \
        list(Path(ckpt_dir).glob("step-*.orbax"))
    return max(ckpts, key=lambda p: (checkpoint_step(p),
                                     not p.name.endswith(".fp16.npz"))
               ) if ckpts else None


def checkpoint_step(path) -> int:
    m = re.search(r"step-(\d+)", str(path))
    return int(m.group(1)) if m else 0
