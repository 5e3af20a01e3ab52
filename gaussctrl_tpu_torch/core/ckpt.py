"""Checkpoint IO: npz scene checkpoints and the splatfacto `.ckpt` importer.

Counterpart of `gaussctrl_tpu/core/ckpt.py`, in the same file format: an npz
whose keys are the scene's field names, step-numbered `step-{step:09d}.npz` files with latest-only
pruning, and an fp16 archive of a scene (`compress_scene_npz`). A
checkpoint written here loads with the JAX package's `load_scene_npz`, and
the other way round. `import_splatfacto_ckpt` reads a nerfstudio
splatfacto checkpoint (the flat parameter names of nerfstudio 1.0 or the
newer `gauss_params.*`).

Sharded checkpoints, the counterpart of the JAX package's orbax pair:
`save_checkpoint_sharded` writes a gaussian-sharded scene (each rank its
block of rows) as DTensors sharded over the mesh with
`torch.distributed.checkpoint` to `step-{step:09d}.dcp/`, and
`load_checkpoint_sharded` restores each rank's block without building the
whole scene anywhere. The JAX package's `step-*.orbax` directories are read
with tensorstore (`core/orbax_read.py`) where it is installed; elsewhere
loading one raises and names tensorstore. `latest_checkpoint` sees npz
files, `.orbax` and `.dcp` directories, and `load_scene_npz` loads any of
them.
"""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np
import torch

from gaussctrl_tpu_torch.core.mesh import rows_of_rank, shard_views
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
    """Load a GaussianScene from a checkpoint, always as float32 (an fp16
    archive resumes at full precision): an npz, a JAX `.orbax` directory or
    a `.dcp` directory of `save_checkpoint_sharded`, whole."""
    if str(path).rstrip("/").endswith(".dcp"):
        return _read_dcp(path, device=device)
    if Path(path).is_dir() or str(path).endswith(".orbax"):
        from gaussctrl_tpu_torch.core.orbax_read import read_orbax
        data = read_orbax(path)
    else:
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


def save_checkpoint_sharded(ckpt_dir, step: int, scene: GaussianScene, mesh,
                            keep_only_latest: bool = True) -> Path:
    """Write this rank's block of a gaussian-sharded scene (every rank
    calls it with its own rows, one row count on all) as DTensors sharded
    over `mesh` with `torch.distributed.checkpoint`: `step-{step:09d}.dcp/`
    in `ckpt_dir`, one file a rank and the metadata. Older `step-*.dcp`
    directories are removed, as the JAX package prunes its orbax ones."""
    import shutil

    import torch.distributed as dist
    import torch.distributed.checkpoint as dcp
    from torch.distributed.tensor import DTensor

    out = Path(ckpt_dir) / f"step-{step:09d}.dcp"
    state = {k: DTensor.from_local(getattr(scene, k).detach().contiguous(),
                                   mesh, shard_views(mesh), run_check=False)
             for k in _FIELDS}
    dcp.save(state, checkpoint_id=out)
    if keep_only_latest and mesh.get_local_rank() == 0:
        for f in Path(ckpt_dir).glob("step-*.dcp"):
            if f != out:
                shutil.rmtree(f, ignore_errors=True)
    dist.barrier(group=mesh.get_group())
    return out


def load_checkpoint_sharded(path, like: GaussianScene, mesh) -> GaussianScene:
    """Restore this rank's block of rows of a `.dcp` checkpoint (the global
    row count must split evenly over `mesh`), read without building the
    whole scene on any rank. `like`, this rank's block of the scene to be
    restored (its values are not read), gives the device and is checked
    against the checkpoint. `load_scene_npz` reads the whole scene."""
    return _read_dcp(path, like, mesh)


def _read_dcp(path, like: GaussianScene | None = None, mesh=None,
              device="cpu") -> GaussianScene:
    """A `.dcp` checkpoint as float32: this rank's rows with `mesh`, all of
    them (no process group needed) without."""
    import torch.distributed.checkpoint as dcp
    from torch.distributed.tensor import DTensor

    sizes = {k: tuple(v.size) for k, v in dcp.FileSystemReader(path)
             .read_metadata().state_dict_metadata.items()}
    n = sizes["means"][0]
    if mesh is not None:
        rows = rows_of_rank(n, mesh)
        n = rows.stop - rows.start
    state = {}
    for k in _FIELDS:
        shape = (n,) + sizes[k][1:]
        ref = None if like is None else getattr(like, k)
        if ref is not None and tuple(ref.shape) != shape:
            raise ValueError(f"{path}: {k} restores as {shape}, `like` holds "
                             f"{tuple(ref.shape)}")
        local = torch.empty(shape, dtype=torch.float32,
                            device=device if ref is None else ref.device)
        state[k] = local if mesh is None else DTensor.from_local(
            local, mesh, shard_views(mesh), run_check=False)
    dcp.load(state, checkpoint_id=path)
    return GaussianScene(**{k: v if mesh is None else v.to_local()
                            for k, v in state.items()})


def latest_checkpoint(ckpt_dir) -> Path | None:
    """The highest-step checkpoint across the npz files, the JAX package's
    orbax directories (`step-*.orbax`) and the sharded `step-*.dcp`
    directories; at equal steps the full-precision npz, then the first
    listed, as the JAX package picks."""
    ckpts = list(Path(ckpt_dir).glob("step-*.npz")) + \
        list(Path(ckpt_dir).glob("step-*.orbax")) + \
        list(Path(ckpt_dir).glob("step-*.dcp"))
    return max(ckpts, key=lambda p: (checkpoint_step(p),
                                     not p.name.endswith(".fp16.npz"))
               ) if ckpts else None


def checkpoint_step(path) -> int:
    m = re.search(r"step-(\d+)", str(path))
    return int(m.group(1)) if m else 0
