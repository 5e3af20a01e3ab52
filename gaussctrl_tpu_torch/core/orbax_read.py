"""Read the JAX package's orbax checkpoint directories without orbax or JAX.

`gaussctrl_tpu/core/ckpt.py:save_checkpoint_sharded` writes a pytree with
orbax's `StandardCheckpointer`: `_METADATA` (JSON) names the leaves and
says whether they are zarr v2 or v3 arrays, and the arrays live in an OCDBT
key-value store rooted at the directory. tensorstore opens each leaf as a
`zarr` (or `zarr3`) array over an `ocdbt` kvstore, with `path` set to the
leaf's name. tensorstore is imported when a checkpoint is read; where it is
not installed, reading raises and names it.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np


def read_orbax(path) -> dict[str, np.ndarray]:
    """Every top-level leaf of an orbax `StandardCheckpointer` directory, by
    name, as numpy arrays."""
    path = Path(path).absolute()
    meta_file = path / "_METADATA"
    if not meta_file.is_file():
        raise ValueError(f"{path} holds no orbax checkpoint (no _METADATA)")
    try:
        import tensorstore as ts
    except ImportError as e:
        raise NotImplementedError(
            f"{path} is an orbax checkpoint of the JAX package; reading it "
            f"needs the tensorstore package, which is not installed") from e
    meta = json.loads(meta_file.read_text())
    array_format = "zarr3" if meta.get("use_zarr3") else "zarr"
    kvstore = {"driver": "ocdbt", "base": f"file://{path}"}
    out = {}
    for leaf in meta["tree_metadata"].values():
        # orbax names a leaf's array by its keys joined with "."
        name = ".".join(k["key"] for k in leaf["key_metadata"])
        spec = {"driver": array_format, "kvstore": kvstore, "path": name}
        arr = ts.open(spec, open=True, read=True).result()
        out[name] = np.asarray(arr.read().result())
    return out
