"""`entry.dryrun_multichip(2)` on two spawned gloo ranks, its results held
against the port's single-process run and the JAX package.

The dry run is given its inputs: stage 2's scene (64·2 gaussians, SH 1)
and background are the JAX dry run's (`__graft_entry__.py:161-189`), and
stage 3 runs on a 200-gaussian JAX scene with one numpy-drawn parameter
tree for both stacks (`SDConfig.tiny()`, float32; 5 ring views at 64×64,
which 2 ranks pad to 6; 2 DDIM steps, 2 reference views, 2
re-optimisation steps; `run()` with `chunk_size=0`, then `edit_images()`
with `chunk_size=2`). While the ranks run, this process computes the same
stages in the JAX package (the step on a gaussian-sharded scene over the
8-device CPU mesh that `tests/conftest.py` provides) and the port's
single-process run. Tolerances: the JAX dry run's for the step (loss rtol
1e-5; every leaf rtol 1e-4, atol 1e-6), and those of the JAX package's
sharded-against-unsharded pipeline tests (`tests/test_pipeline.py:120-165`)
for the run: 2e-3 on the edits, 5e-3 on the means.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from gaussctrl_tpu_torch.entry import (RUN_ARTIFACTS, RUN_CONFIG, RUN_SIZE,
                                       RUN_VIEWS, dryrun_multichip,
                                       dryrun_pipeline, ring_c2ws,
                                       run_artifacts)
from gaussctrl_tpu_torch.splat.scene import GaussianScene

torch.set_num_threads(2)

FIELDS = ("means", "scales", "quats", "opacities", "features_dc",
          "features_rest")


def _jax_sharded_step():
    """The JAX dry run's stage 2 over the 8-device CPU mesh: (start scene,
    stepped scene, loss, background)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from gaussctrl_tpu.splat.scene import random_scene
    from gaussctrl_tpu.splat.trainer import (TrainConfig, init_optimizer_state,
                                             train_step)

    devices = np.asarray(jax.devices()[:8])
    assert len(devices) == 8
    gauss = NamedSharding(Mesh(devices, ("gauss",)), P("gauss"))
    scene0 = random_scene(jax.random.PRNGKey(2), 64 * 2, sh_degree=1)
    scene = jax.tree_util.tree_map(lambda x: jax.device_put(x, gauss), scene0)
    opt = jax.jit(lambda s: init_optimizer_state(s, TrainConfig()))(scene)
    c2w = jnp.eye(4)[:3].at[2, 3].set(2.0)
    scene2, _, metrics = train_step(scene, opt, c2w, 40.0, 40.0, 16.0, 16.0,
                                    jnp.zeros((32, 32, 3)),
                                    jax.random.PRNGKey(3), 32, 32, sh_degree=1)
    bg = np.asarray(jax.random.uniform(jax.random.PRNGKey(3), (3,)))
    start = {k: np.asarray(getattr(scene0, k)) for k in FIELDS}
    stepped = {k: np.asarray(getattr(scene2, k)) for k in FIELDS}
    return start, stepped, float(metrics["loss"]), bg


def _jax_run(jscene, params):
    """The JAX package's unsharded `run()`, then its chunked edit."""
    import jax
    import jax.numpy as jnp

    from gaussctrl_tpu.cameras.camera import make_cameras as j_make_cameras
    from gaussctrl_tpu.diffusion.config import SDConfig as JSDConfig
    from gaussctrl_tpu.pipeline.gaussctrl import GaussCtrlConfig as JConfig
    from gaussctrl_tpu.pipeline.gaussctrl import GaussCtrlPipeline as JPipeline

    s = RUN_SIZE
    jpipe = JPipeline(JConfig(**RUN_CONFIG), jscene,
                      j_make_cameras(ring_c2ws(RUN_VIEWS), s, s, s / 2, s / 2,
                                     s, s),
                      sd_config=JSDConfig.tiny(),
                      sd_params=jax.tree_util.tree_map(jnp.asarray, params),
                      dtype=jnp.float32)
    jpipe.run()
    ref = {"edited_chunk0": np.asarray(jpipe.edited),
           "means": np.asarray(jpipe.scene.means)}
    jpipe.config.chunk_size = 2
    jpipe.edit_images()
    ref["edited_chunk2"] = np.asarray(jpipe.edited)
    return ref


@pytest.fixture(scope="module")
def runs():
    import jax

    from gaussctrl_tpu.diffusion.config import SDConfig as JSDConfig
    from gaussctrl_tpu.diffusion.sample import SDModels as JSDModels
    from gaussctrl_tpu.splat.scene import random_scene as j_random_scene
    from test_torch_diffusion import random_flax_params

    jscene = j_random_scene(jax.random.PRNGKey(7), 200, sh_degree=1,
                            extent=0.5)
    run_scene = {k: np.asarray(getattr(jscene, k)) for k in FIELDS}
    params = random_flax_params(JSDModels.create(JSDConfig.tiny()), seed=1)
    start, stepped, jloss, bg = _jax_sharded_step()
    inputs = dict(step_scene=start, step_background=bg, run_scene=run_scene,
                  sd_params=params)
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(dryrun_multichip, 2, "cpu", inputs)
        single = run_artifacts(dryrun_pipeline(
            GaussianScene.from_numpy(run_scene), params, "cpu"))
        ref = _jax_run(jscene, params)
        reports = ranks.result()
    return dict(reports=reports, single=single, ref=ref, start=start,
                stepped=stepped, jloss=jloss)


def test_dryrun_multichip_two_ranks(runs):
    """`dryrun_multichip(2)` passed its own checks on both ranks (the
    view-sharded edit == replicated at rtol 2e-4 / atol 2e-5, the nano eps
    evaluation at the SD-1.5 token ladder finite, the gaussian-sharded
    step == unsharded on every leaf, a sharded `run()` at 5 views), and
    both ranks report the same numbers."""
    a, b = runs["reports"]
    assert a["edit"] == b["edit"] == "sharded == replicated"
    assert a["nano_eps"] == b["nano_eps"] == "finite"
    assert a["train_step"]["loss"] == b["train_step"]["loss"]
    for k in FIELDS:
        np.testing.assert_array_equal(a["train_step"]["rows"][k],
                                      b["train_step"]["rows"][k], err_msg=k)
    assert a["run"]["loss"] == b["run"]["loss"]


def test_gaussian_sharded_step_matches_jax_sharded_step(runs):
    """Stage 2, the port's gaussian-sharded `train_step` on 2 gloo ranks,
    against the JAX `train_step` on the same scene sharded over 8 devices,
    same background, and against the port's own unsharded step: the loss at
    rtol 1e-5 and all six leaves (whose gradients reach each rank through
    the gather's backward) at rtol 1e-4 / atol 1e-6."""
    start, stepped = runs["start"], runs["stepped"]
    for r in runs["reports"]:
        step = r["train_step"]
        np.testing.assert_allclose(step["loss"], runs["jloss"], rtol=1e-5)
        np.testing.assert_allclose(step["loss"], step["unsharded_loss"],
                                   rtol=1e-5)
        for k in FIELDS:
            got = step["rows"][k]
            assert got.shape == start[k].shape, k
            np.testing.assert_allclose(got, stepped[k], rtol=1e-4, atol=1e-6,
                                       err_msg=k)
            np.testing.assert_allclose(got, step["unsharded"][k], rtol=1e-4,
                                       atol=1e-6, err_msg=k)
            assert np.abs(got - start[k]).max() > 0, k   # the step moved it


def test_ranks_hold_the_same_gathered_results(runs):
    """After the gathers every rank holds every view's artifacts, bit for
    bit the same, at the unpadded count."""
    a, b = (r["run"] for r in runs["reports"])
    for k in RUN_ARTIFACTS + ("edited_chunk0", "edited_chunk2", "means"):
        assert a[k].shape[0] == (RUN_VIEWS if k != "means" else 200), k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_sharded_render_reverse_matches_single_process(runs):
    """Renders, depths and masks are per view: equal to the single-process
    run; the inverted latents (each rank inverts its share as one batch)
    at rtol/atol 2e-4, the port-against-JAX tolerance of `z_T`."""
    sharded, single = runs["reports"][0]["run"], runs["single"]
    for k in ("unedited", "depths", "masks"):
        np.testing.assert_allclose(sharded[k], single[k], rtol=1e-6,
                                   atol=1e-6, err_msg=k)
    np.testing.assert_allclose(sharded["z_T"], single["z_T"], rtol=2e-4,
                               atol=2e-4)


@pytest.mark.parametrize("chunk", [0, 2])
def test_sharded_edit_matches_single_process_and_jax(runs, chunk):
    """The view-sharded edit (chunk 0: refs + each rank's share in one
    batch; chunk 2: the chunks dealt to the ranks) against the port's
    single-process edit and the JAX package's unsharded edit: atol 2e-3."""
    sharded = runs["reports"][0]["run"]
    k = f"edited_chunk{chunk}"
    assert np.isfinite(sharded[k]).all()
    np.testing.assert_allclose(sharded[k], runs["single"][k], atol=2e-3)
    np.testing.assert_allclose(sharded[k], runs["ref"][k], atol=2e-3)


def test_sharded_run_means_match_single_process_and_jax(runs):
    """Re-optimisation takes the same steps on every rank from the gathered
    edits: the means match the single-process and the JAX runs at atol
    5e-3, and the losses agree."""
    sharded, single = runs["reports"][0]["run"], runs["single"]
    np.testing.assert_allclose(sharded["means"], single["means"], atol=5e-3)
    np.testing.assert_allclose(sharded["means"], runs["ref"]["means"],
                               atol=5e-3)
    np.testing.assert_allclose(sharded["loss"], single["loss"], rtol=1e-2,
                               atol=1e-3)
