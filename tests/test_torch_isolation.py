"""The port stands alone: no JAX and nothing of gaussctrl_tpu at run time,
and no silent CPU fallback when a CUDA device is asked for."""

import os
import pkgutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import gaussctrl_tpu_torch
from gaussctrl_tpu_torch.device import resolve_device
from gaussctrl_tpu_torch.ops import flash_attention as fa
from gaussctrl_tpu_torch.ops import launch_counts
from gaussctrl_tpu_torch.ops import splat_blend as sb

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _all_modules():
    pkg = gaussctrl_tpu_torch
    return sorted(m.name for m in pkgutil.walk_packages(pkg.__path__,
                                                        pkg.__name__ + "."))


def test_package_imports_no_jax_or_reference_package():
    """Import every module of the port in a fresh interpreter, then check
    that neither jax nor any gaussctrl_tpu module was loaded."""
    mods = _all_modules()
    for m in ("gaussctrl_tpu_torch.ops.flash_attention",
              "gaussctrl_tpu_torch.seg.sam", "gaussctrl_tpu_torch.seg.dino",
              "gaussctrl_tpu_torch.metrics.clip_metrics",
              "gaussctrl_tpu_torch.cli.eval", "gaussctrl_tpu_torch.cli.render",
              "gaussctrl_tpu_torch.cli.export", "gaussctrl_tpu_torch.cli.viewer",
              "gaussctrl_tpu_torch.cli.certify", "gaussctrl_tpu_torch.certify",
              "gaussctrl_tpu_torch.cameras.stereo",
              "gaussctrl_tpu_torch.viewer.server",
              "gaussctrl_tpu_torch.core.mesh", "gaussctrl_tpu_torch.entry",
              "gaussctrl_tpu_torch.core.orbax_read"):
        assert m in mods, m
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
            " or m == 'flax' or m.startswith('flax.')"
            " or m == 'gaussctrl_tpu' or m.startswith('gaussctrl_tpu.')]\n"
            "print(repr(bad))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=REPO, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_chip_smoke_imports_no_jax():
    """chip_smoke.py names no JAX module and nothing of the JAX package."""
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        src = f.read()
    for bad in ("import jax", "from jax", "import flax", "from flax",
                "import gaussctrl_tpu\n", "import gaussctrl_tpu.",
                "from gaussctrl_tpu ", "from gaussctrl_tpu."):
        assert bad not in src, bad


def test_cuda_request_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)        # the default is the card


def test_pipeline_default_device_raises_without_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from gaussctrl_tpu_torch.diffusion.config import SDConfig
    from gaussctrl_tpu_torch.diffusion.sample import SDModels
    with pytest.raises(RuntimeError, match="CUDA"):
        SDModels.create(SDConfig.tiny())


@pytest.mark.parametrize("argv", [
    ["render", "dataset", "--data", "data/example_scene"],
    ["render", "camera-path", "--camera-path-filename", "path.json"],
    ["render", "interpolate", "--data", "data/example_scene"],
    ["render", "spiral", "--data", "data/example_scene"],
    ["export", "--output", "scene.ply"],
    ["viewer"],
    ["certify"],
], ids=lambda a: "-".join(a[:2]) if a[0] == "render" else a[0])
def test_new_clis_ask_for_the_card(argv, tmp_path):
    """Called without --device, each of the render, export, viewer and
    certify CLIs asks for the card and raises here before it reads or
    writes anything (its checkpoint does not even exist)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    import importlib
    mod = importlib.import_module(f"gaussctrl_tpu_torch.cli.{argv[0]}")
    rest = argv[1:]
    if argv[0] == "certify":
        rest += ["--out", str(tmp_path / "v.json")]
    else:
        rest += ["--load-checkpoint", str(tmp_path / "missing.npz")]
    if argv[0] == "render":
        rest += ["--output-path", str(tmp_path / "out")]
    with pytest.raises(RuntimeError, match="CUDA"):
        mod.main(rest)
    assert list(tmp_path.iterdir()) == []


@pytest.mark.parametrize("which", ["flash_attention_t", "cross_view_attention",
                                   "attention_full", "attention_stream",
                                   "splat_blend", "splat_blend_bwd"])
def test_wrappers_refuse_non_cpu_tensors_without_fallback(which):
    """A tensor that is not on the CPU goes to the kernel or raises; it is
    never handed to the plain version (meta tensors stand in for a device
    the plain path would have to serve)."""
    before = dict(launch_counts)
    meta = dict(device="meta")
    with pytest.raises((ValueError, RuntimeError)):
        if which == "splat_blend":
            i = torch.zeros(4, dtype=torch.int32, **meta)
            f = torch.zeros(4, 2, **meta)
            sb.blend(i, i, i, f, torch.zeros(4, 3, **meta),
                     torch.zeros(4, 4, **meta), torch.zeros(4, **meta),
                     torch.zeros(4, **meta), 2, 2)
        elif which == "splat_blend_bwd":
            i = torch.zeros(4, dtype=torch.int32, **meta)
            sb.blend_bwd(i, i, i, i, torch.zeros(4, 12, **meta),
                         torch.zeros(4, 256, 4, **meta),
                         torch.zeros(4, 256, **meta), torch.zeros(4, **meta),
                         torch.zeros(4, 256, 4, **meta),
                         torch.zeros(4, 256, **meta), 2, 2)
        else:
            x = torch.zeros(4, 64, 32, dtype=torch.bfloat16, **meta)
            fn = getattr(fa, which)
            fn(x, x, x, 2, 1, 0.6, 2) if which == "cross_view_attention" else fn(x, x, x, 2)
    assert launch_counts == before


def test_plain_versions_are_used_on_cpu_without_counting():
    """On CPU tensors the wrappers compute with the plain versions and leave
    the launch counts alone."""
    before = dict(launch_counts)
    rng = np.random.default_rng(0)
    q = torch.tensor(rng.normal(size=(4, 40, 16)), dtype=torch.float32)
    out = fa.cross_view_attention(q, q, q, 2, 2, 0.6, 2)
    ref = fa.cross_view_attention_plain(q, q, q, 2, 2, 0.6, 2)
    assert torch.equal(out, ref)
    assert torch.equal(fa.flash_attention_t(q, q, q, 2), fa.attention_plain(q, q, q, 2))
    assert torch.equal(fa.attention_full(q, q, q, 2), fa.attention_plain(q, q, q, 2))
    assert torch.equal(fa.attention_stream(q, q, q, 2),
                       fa.attention_stream_plain(q, q, q, 2))
    assert launch_counts == before


def test_modules_and_chip_smoke_import_with_jax_and_safetensors_blocked(tmp_path):
    """With `jax`, `flax`, `gaussctrl_tpu` and `safetensors` blocked in
    `sys.modules`, every module of the port and chip_smoke.py import, and
    the port's safetensors reader and writer work."""
    mods = _all_modules()
    for m in ("gaussctrl_tpu_torch.diffusion.weights",
              "gaussctrl_tpu_torch.splat.densify",
              "gaussctrl_tpu_torch.splat.pretrain",
              "gaussctrl_tpu_torch.core.writer",
              "gaussctrl_tpu_torch.cli.splat_train",
              "gaussctrl_tpu_torch.seg.masker", "gaussctrl_tpu_torch.seg.sam",
              "gaussctrl_tpu_torch.seg.weights",
              "gaussctrl_tpu_torch.seg.grounding",
              "gaussctrl_tpu_torch.seg.dino",
              "gaussctrl_tpu_torch.seg.dino_weights",
              "gaussctrl_tpu_torch.metrics.clip_metrics",
              "gaussctrl_tpu_torch.cli.eval", "gaussctrl_tpu_torch.cli.render",
              "gaussctrl_tpu_torch.cli.export", "gaussctrl_tpu_torch.cli.viewer",
              "gaussctrl_tpu_torch.cli.certify", "gaussctrl_tpu_torch.certify",
              "gaussctrl_tpu_torch.cameras.stereo",
              "gaussctrl_tpu_torch.viewer.server",
              "gaussctrl_tpu_torch.core.mesh", "gaussctrl_tpu_torch.entry",
              "gaussctrl_tpu_torch.core.orbax_read"):
        assert m in mods, m
    path = tmp_path / "t.safetensors"
    code = ("import importlib, sys\n"
            "for b in ('jax', 'flax', 'gaussctrl_tpu', 'safetensors'):\n"
            "    sys.modules[b] = None\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "import chip_smoke\n"
            "import torch\n"
            "from gaussctrl_tpu_torch.diffusion import weights as w\n"
            "t = {'a': torch.arange(6.).reshape(2, 3).half()}\n"
            f"w.save_safetensors({str(path)!r}, t)\n"
            f"got = w.read_safetensors({str(path)!r})\n"
            "assert torch.equal(got['a'], t['a'].float())\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=REPO, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "ok"


def test_segmentation_and_metrics_default_to_the_card():
    """The masker stack and the CLIP scorer without a device ask for the
    card, and raise without one rather than run on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from gaussctrl_tpu_torch.metrics import CLIPScorer
    from gaussctrl_tpu_torch.seg.grounding import build_langsam_equivalent
    with pytest.raises(RuntimeError, match="CUDA"):
        build_langsam_equivalent()
    with pytest.raises(RuntimeError, match="CUDA"):
        CLIPScorer.from_dir(None)


def test_pretrain_and_splat_train_default_to_the_card(tmp_path):
    """`pretrain` and `cli.splat_train` without a device ask for the card,
    and raise without one rather than run on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from gaussctrl_tpu_torch.cameras.camera import make_cameras
    from gaussctrl_tpu_torch.cli import splat_train
    from gaussctrl_tpu_torch.splat.pretrain import PretrainConfig, pretrain
    cams = make_cameras(np.eye(4, dtype=np.float32)[None, :3], 8, 8, 4, 4, 8, 8)
    pts = np.zeros((4, 3), np.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        pretrain(cams, np.zeros((1, 8, 8, 3), np.float32), pts, pts,
                 PretrainConfig(num_steps=1))
    with pytest.raises(RuntimeError, match="CUDA"):
        splat_train.main(["--data", os.path.join(REPO, "data", "example_scene"),
                          "--output-dir", str(tmp_path),
                          "--trainer.num_steps", "1"])


def test_mesh_entry_and_dry_run_default_to_the_card():
    """`make_mesh()`, `spawn_ranks`, `dryrun_multichip(2)` and `entry()`
    without a device ask for the card and raise without one, before any
    process group is joined or any rank is started."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    import torch.distributed as dist

    from gaussctrl_tpu_torch.core.mesh import make_mesh, spawn_ranks
    from gaussctrl_tpu_torch.entry import dryrun_multichip, entry
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        spawn_ranks(print, 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        dryrun_multichip(2)
    with pytest.raises(RuntimeError, match="CUDA"):
        entry()
    assert not dist.is_initialized()


def test_orbax_reader_imports_no_orbax_or_jax(tmp_path):
    """The port reads a JAX orbax checkpoint in a fresh interpreter with
    `jax`, `flax`, `orbax` and `gaussctrl_tpu` blocked, and neither orbax
    nor JAX is loaded afterwards."""
    pytest.importorskip("tensorstore", reason="the orbax reader needs tensorstore")
    import jax

    from gaussctrl_tpu.core.ckpt import save_checkpoint_sharded
    from gaussctrl_tpu.splat.scene import random_scene

    js = random_scene(jax.random.PRNGKey(0), 16, sh_degree=1)
    path = save_checkpoint_sharded(tmp_path, 3, js)
    code = ("import sys\n"
            "for b in ('jax', 'flax', 'orbax', 'gaussctrl_tpu'):\n"
            "    sys.modules[b] = None\n"
            "from gaussctrl_tpu_torch.core.ckpt import load_scene_npz\n"
            f"s = load_scene_npz({str(path)!r})\n"
            "bad = [m for m in sys.modules if sys.modules[m] is not None and"
            " m.split('.')[0] in ('jax', 'flax', 'orbax', 'gaussctrl_tpu')]\n"
            "print(tuple(s.means.shape), bad)\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=REPO, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "(16, 3) []"
