"""The port's device mesh (`core/mesh.py`), sharded checkpoints and
`SectionTimers`, against the JAX package on the CPU (the gaussian-sharded
re-optimisation step is held in `test_torch_mesh_pipeline.py`).

Sharded paths run in two spawned processes on a gloo group
(`core.mesh.spawn_ranks`: a rendezvous file in a temporary directory, a
60 s group timeout, and a deadline after which every rank is stopped and the
test fails with the rank's traceback). The rank bodies live at the top of
this file and the JAX package is imported inside the tests only, so that a
spawned rank imports torch and the port alone. The JAX side runs on the
8-device CPU mesh that `tests/conftest.py` sets up.
"""

import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from gaussctrl_tpu_torch.core import ckpt as tckpt
from gaussctrl_tpu_torch.core import mesh as tmesh
from gaussctrl_tpu_torch.core.writer import SectionTimers
from gaussctrl_tpu_torch.splat import trainer as ttrainer
from gaussctrl_tpu_torch.splat.scene import GaussianScene

torch.set_num_threads(2)

FIELDS = ("means", "scales", "quats", "opacities", "features_dc",
          "features_rest")


class _Mesh:
    """What `rows_of_rank` and `share_of` read of a 1-D DeviceMesh."""

    def __init__(self, rank, world):
        self.rank, self.world = rank, world

    def size(self):
        return self.world

    def get_local_rank(self):
        return self.rank


# -- rank bodies (run in spawned processes) -----------------------------------

def _helpers(mesh):
    r = mesh.get_local_rank()
    x = torch.arange(6.0).reshape(3, 2) + 100 * r
    y = (torch.arange(4.0).reshape(2, 2) + 10 * r).requires_grad_()
    z = tmesh.AllGatherRows.apply(y, mesh)
    (z * torch.arange(8.0).reshape(4, 2)).sum().backward()
    return dict(rank=r, size=mesh.size(), rows=rows_of(10, mesh),
                share=tmesh.share_of(list(range(5)), mesh),
                gathered=tmesh.gather_rows(x, mesh).numpy(),
                bf16=tmesh.gather_rows(x.bfloat16(), mesh).float().numpy(),
                grad=y.grad.numpy(),
                placements=(repr(tmesh.shard_views(mesh)),
                            repr(tmesh.replicate(mesh))))


def rows_of(n, mesh):
    s = tmesh.rows_of_rank(n, mesh)
    return (s.start, s.stop)


def _dcp(mesh, arrays, ckpt_dir):
    local = ttrainer.shard_scene(GaussianScene.from_numpy(arrays), mesh)
    first = tckpt.save_checkpoint_sharded(ckpt_dir, 10, local, mesh)
    path = tckpt.save_checkpoint_sharded(ckpt_dir, 20, local, mesh)
    back = tckpt.load_checkpoint_sharded(path, like=local, mesh=mesh)
    wrong = GaussianScene(**{k: getattr(local, k)[:2] for k in FIELDS})
    try:
        tckpt.load_checkpoint_sharded(path, like=wrong, mesh=mesh)
        refused = ""
    except ValueError as e:
        refused = str(e)
    return dict(first=str(first), path=str(path), refused=refused,
                equal=all(torch.equal(getattr(back, k), getattr(local, k))
                          for k in FIELDS))


def _rank_body(arrays, ckpt_dir):
    """The helpers, then the `.dcp` round trip, on one 2-rank group."""
    torch.set_num_threads(1)
    mesh = tmesh.make_mesh("cpu")
    return dict(helpers=_helpers(mesh), dcp=_dcp(mesh, arrays, ckpt_dir))


def _rank_mismatched_collective():
    mesh = tmesh.make_mesh("cpu")
    if mesh.get_local_rank() == 0:
        tmesh.gather_rows(torch.zeros(2), mesh)   # rank 1 never joins it
    return "done"


def _rank_sleeps():
    time.sleep(120)


# -- tests --------------------------------------------------------------------

@pytest.mark.parametrize("world", [1, 2, 3, 8])
@pytest.mark.parametrize("n", [1, 5, 8, 13, 40, 44])
def test_padding_and_shares_match_jax(n, world):
    """pad_to_multiple is the JAX one; the ranks' shares of n views tile the
    JAX pipeline's `_round_up_views(n)` (the views padded by repeating the
    last), contiguously and in rank order, one size on every rank."""
    from gaussctrl_tpu.core.mesh import pad_to_multiple as j_pad
    from gaussctrl_tpu.pipeline.gaussctrl import GaussCtrlPipeline as JPipe

    assert tmesh.pad_to_multiple(n, world) == j_pad(n, world)
    jmesh = SimpleNamespace(devices=np.empty(world))
    padded = JPipe._round_up_views(SimpleNamespace(mesh=jmesh), n)
    shares = [tmesh.share_of(list(range(n)), _Mesh(r, world))
              for r in range(world)]
    assert sum(shares, []) == list(range(n)) + [n - 1] * (padded - n)
    assert len({len(s) for s in shares}) == 1
    assert tmesh.share_of(list(range(n)), None) == list(range(n))


def test_rows_of_rank_names_the_padding():
    """Rows that do not split evenly raise, naming the padded count (the
    gaussian-sharded step's N must be a multiple of the world size)."""
    assert rows_of(12, _Mesh(2, 3)) == (8, 12)
    with pytest.raises(ValueError, match="pad them to 12"):
        tmesh.rows_of_rank(10, _Mesh(0, 4))
    scene = GaussianScene.from_numpy({k: np.zeros((7, 3), np.float32)
                                      for k in FIELDS})
    with pytest.raises(ValueError, match="pad them to 8"):
        ttrainer.shard_scene(scene, _Mesh(1, 2))


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """One spawn of 2 gloo ranks for the helpers and the checkpoint: (their
    reports, the scene's arrays, the checkpoint directory)."""
    rng = np.random.default_rng(3)
    arrays = {k: rng.normal(size=s).astype(np.float32) for k, s in
              dict(means=(8, 3), scales=(8, 3), quats=(8, 4),
                   opacities=(8, 1), features_dc=(8, 3),
                   features_rest=(8, 3, 3)).items()}
    ckpt_dir = tmp_path_factory.mktemp("dcp")
    res = tmesh.spawn_ranks(_rank_body, 2, args=(arrays, str(ckpt_dir)),
                            device="cpu")
    return res, arrays, ckpt_dir


def test_mesh_helpers_on_two_ranks(two_ranks):
    """On a real 2-rank gloo mesh: the placements, each rank's rows, the
    gather in rank order (bf16 bit for bit), and AllGatherRows' backward
    handing each rank its own rows of the gradient."""
    for r, out in enumerate(rep["helpers"] for rep in two_ranks[0]):
        assert out["rank"] == r and out["size"] == 2
        assert out["rows"] == (5 * r, 5 * r + 5)
        assert out["share"] == [[0, 1, 2], [3, 4, 4]][r]
        want = np.concatenate([np.arange(6.0).reshape(3, 2),
                               np.arange(6.0).reshape(3, 2) + 100])
        np.testing.assert_array_equal(out["gathered"], want)
        np.testing.assert_array_equal(out["bf16"], want)
        np.testing.assert_array_equal(
            out["grad"], np.arange(8.0).reshape(4, 2)[2 * r:2 * r + 2])
        assert out["placements"] == ("[Shard(dim=0)]", "[Replicate()]")


def test_a_failing_or_hanging_rank_fails_the_call():
    """A collective that one rank never joins fails at the group timeout
    with that rank's traceback, and a rank that outlives the deadline is
    stopped: no test can hang."""
    with pytest.raises(RuntimeError, match="rank 0 of 2 failed"):
        tmesh.spawn_ranks(_rank_mismatched_collective, 2, device="cpu",
                          group_timeout_s=3)
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="did not finish in 2 s"):
        tmesh.spawn_ranks(_rank_sleeps, 2, device="cpu", timeout_s=2)
    assert time.monotonic() - t0 < 30


def test_sharded_checkpoint_round_trip_then_world_one(two_ranks):
    """`save_checkpoint_sharded` on 2 ranks writes `step-*.dcp`, prunes the
    older one, and each rank reads its own rows back bit for bit (and
    refuses a `like` of other shapes); in this process, with no group,
    `load_scene_npz` loads the whole scene equal to the original."""
    res, arrays, ckpt_dir = two_ranks
    path = ckpt_dir / "step-000000020.dcp"
    for rep in res:
        assert rep["dcp"]["equal"]
        assert rep["dcp"]["path"] == str(path)
        assert ("restores as (4, 3), `like` holds (2, 3)"
                in rep["dcp"]["refused"])
    assert sorted(p.name for p in ckpt_dir.iterdir()) == [path.name]
    assert tckpt.latest_checkpoint(ckpt_dir) == path
    loaded = tckpt.load_scene_npz(path)
    for k in FIELDS:
        assert torch.equal(getattr(loaded, k), torch.tensor(arrays[k])), k


def test_jax_orbax_checkpoint_loads_in_the_port(tmp_path):
    """A JAX `save_checkpoint_sharded` of a gaussian-sharded scene (8 CPU
    devices) loads in the port bit for bit through tensorstore, with no
    orbax and no JAX (`test_torch_isolation.py` holds the imports)."""
    pytest.importorskip("tensorstore", reason="the orbax reader needs tensorstore")
    import jax
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from gaussctrl_tpu.core import ckpt as jckpt
    from gaussctrl_tpu.splat.scene import random_scene

    gauss = NamedSharding(Mesh(np.asarray(jax.devices()[:8]), ("gauss",)),
                          P("gauss"))
    js = jax.tree_util.tree_map(
        lambda x: jax.device_put(x, gauss),
        random_scene(jax.random.PRNGKey(6), 64, sh_degree=2))
    path = jckpt.save_checkpoint_sharded(tmp_path, 7, js)
    assert tckpt.latest_checkpoint(tmp_path) == path
    scene = tckpt.load_scene_npz(path)
    for k in FIELDS:
        want = np.asarray(getattr(js, k))
        got = getattr(scene, k).numpy()
        assert got.dtype == np.float32 and got.shape == want.shape, k
        np.testing.assert_array_equal(got, want, err_msg=k)


def test_orbax_read_without_tensorstore_names_it(tmp_path, monkeypatch):
    """Where tensorstore does not import, loading an orbax directory raises
    and names tensorstore (the refusal the port made before it could read
    them)."""
    import sys

    path = tmp_path / "step-000000001.orbax"
    path.mkdir()
    (path / "_METADATA").write_text("{}")
    monkeypatch.setitem(sys.modules, "tensorstore", None)
    with pytest.raises(NotImplementedError, match="tensorstore"):
        tckpt.load_scene_npz(path)


@pytest.mark.parametrize("files,latest", [
    (["step-000000100.npz", "step-000000200.orbax/", "step-000000300.dcp/"],
     "step-000000300.dcp"),
    (["step-000000300.npz", "step-000000200.dcp/"], "step-000000300.npz"),
    # equal steps: the npz, then the orbax directory (the first listed)
    (["step-000000300.dcp/", "step-000000300.npz"], "step-000000300.npz"),
    (["step-000000300.dcp/", "step-000000300.orbax/"], "step-000000300.orbax"),
])
def test_latest_checkpoint_across_npz_orbax_and_dcp(tmp_path, files, latest):
    """The highest step across the three kinds; where the JAX package sees
    every file (no `.dcp`), both packages pick the same one."""
    from gaussctrl_tpu.core import ckpt as jckpt

    for name in files:
        if name.endswith("/"):
            (tmp_path / name).mkdir()
        else:
            (tmp_path / name).write_bytes(b"")
    assert tckpt.latest_checkpoint(tmp_path) == tmp_path / latest
    for d in tmp_path.glob("*.dcp"):
        d.rmdir()
    assert tckpt.latest_checkpoint(tmp_path) == jckpt.latest_checkpoint(tmp_path)


def test_section_timers_match_jax(monkeypatch):
    """The same sections on one scripted clock give the JAX summary."""
    from gaussctrl_tpu.core import writer as jwriter
    from gaussctrl_tpu_torch.core import writer as twriter

    summaries = []
    for mod in (jwriter, twriter):
        ticks = iter([0.0, 1.25, 2.0, 2.5, 3.0, 3.50041])
        monkeypatch.setattr(mod.time, "perf_counter", lambda: next(ticks))
        timers = mod.SectionTimers()
        for name in ("render", "edit", "render"):
            with timers.section(name):
                pass
        summaries.append(timers.summary())
    assert summaries[0] == summaries[1]
    assert summaries[1]["render"] == {"total_s": 1.75, "count": 2,
                                      "mean_s": 0.8752}
    assert isinstance(SectionTimers().summary(), dict)
