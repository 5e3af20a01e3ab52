"""Checkpoint IO, logging, seeded initialisation and the device mesh.

Exports what `gaussctrl_tpu/core/__init__.py` does: the mesh helpers
`make_mesh`, `shard_views` and `replicate`. The JAX package's
`enable_persistent_cache` (XLA's compile cache) has no counterpart: the
port's kernels are built once per hash of their sources into
`gaussctrl_tpu_torch/_build/` (`ops/_lib.py`), which is their cache.
"""

from gaussctrl_tpu_torch.core.mesh import make_mesh, replicate, shard_views  # noqa: F401
