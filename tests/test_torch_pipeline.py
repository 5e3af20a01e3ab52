"""The port's pipeline (render_reverse + edit_images) against the JAX package.

Tiny configuration on the CPU in float32: the same 200-gaussian scene, five
ring cameras at 64×64, one numpy-drawn parameter tree for both stacks
(`test_torch_diffusion.random_flax_params`), two DDIM steps, two reference
views. The JAX pipeline runs as it does on the CPU (XLA blend, einsum
attention); the port's wrappers take their kernels' plain versions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussctrl_tpu.cameras.camera import make_cameras as j_make_cameras
from gaussctrl_tpu.diffusion.clip import HashTokenizer as JHash
from gaussctrl_tpu.diffusion.clip import NEGATIVE_PROMPT as J_NEG
from gaussctrl_tpu.diffusion.clip import POSITIVE_SUFFIX as J_SUFFIX
from gaussctrl_tpu.diffusion.config import SDConfig as JSDConfig
from gaussctrl_tpu.diffusion.sample import SDModels as JSDModels
from gaussctrl_tpu.pipeline.gaussctrl import GaussCtrlConfig as JConfig
from gaussctrl_tpu.pipeline.gaussctrl import GaussCtrlPipeline as JPipeline
from gaussctrl_tpu.pipeline.gaussctrl import depth_to_disparity as j_disp
from gaussctrl_tpu.pipeline.gaussctrl import select_ref_views as j_select
from gaussctrl_tpu.splat.scene import random_scene as j_random_scene

from gaussctrl_tpu_torch.cameras.camera import make_cameras
from gaussctrl_tpu_torch.diffusion.clip import (NEGATIVE_PROMPT,
                                                POSITIVE_SUFFIX, HashTokenizer)
from gaussctrl_tpu_torch.diffusion.config import SDConfig
from gaussctrl_tpu_torch.pipeline.gaussctrl import (GaussCtrlConfig,
                                                    GaussCtrlPipeline,
                                                    depth_to_disparity,
                                                    select_ref_views)
from gaussctrl_tpu_torch.splat.scene import GaussianScene

from test_torch_diffusion import random_flax_params

torch.set_num_threads(2)

V, SIZE = 5, 64


def _ring_c2ws(v):
    c2ws = []
    for i in range(v):
        a = 2 * np.pi * i / v
        pos = np.array([np.sin(a) * 2, 0.0, np.cos(a) * 2])
        fwd = -pos / np.linalg.norm(pos)
        right = np.cross(fwd, [0, 1, 0])
        right /= np.linalg.norm(right)
        up = np.cross(right, fwd)
        c2ws.append(np.stack([right, up, -fwd, pos], axis=1))
    return np.asarray(c2ws, np.float32)


def _cfg_kwargs(chunk_size):
    return dict(edit_prompt="a red scene", reverse_prompt="a scene",
                num_inference_steps=2, ref_view_num=2, render_batch=4,
                chunk_size=chunk_size)


@pytest.fixture(scope="module")
def runs():
    """The JAX pipeline once (chunked), the port chunked and all-at-once."""
    jscene = j_random_scene(jax.random.PRNGKey(0), 200, sh_degree=1,
                            extent=0.5)
    params = random_flax_params(JSDModels.create(JSDConfig.tiny()), seed=1)
    c2ws = _ring_c2ws(V)
    jpipe = JPipeline(JConfig(**_cfg_kwargs(2)), jscene,
                      j_make_cameras(c2ws, SIZE, SIZE, SIZE / 2, SIZE / 2,
                                     SIZE, SIZE),
                      sd_config=JSDConfig.tiny(),
                      sd_params=jax.tree_util.tree_map(jnp.asarray, params),
                      dtype=jnp.float32)
    jpipe.render_reverse()
    jpipe.edit_images()

    scene = GaussianScene.from_numpy(
        {k: np.asarray(getattr(jscene, k)) for k in
         ("means", "scales", "quats", "opacities", "features_dc",
          "features_rest")})
    cams = make_cameras(c2ws, SIZE, SIZE, SIZE / 2, SIZE / 2, SIZE, SIZE)
    tpipe = GaussCtrlPipeline(GaussCtrlConfig(**_cfg_kwargs(2)), scene, cams,
                              sd_config=SDConfig.tiny(), sd_params=params,
                              dtype=torch.float32, device="cpu")
    tpipe.render_reverse()
    tpipe.edit_images()
    chunked = tpipe.edited.clone()
    tpipe.config.chunk_size = 0
    tpipe.edit_images()
    return jpipe, tpipe, chunked


def test_unedited_and_depth_match(runs):
    """Renders: rgb rtol 1e-4 / atol 1e-5, depth rtol/atol 1e-3 (the render
    test's tolerances); disparity likewise."""
    jpipe, tpipe, _ = runs
    np.testing.assert_allclose(tpipe.unedited.numpy(), np.asarray(jpipe.unedited),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tpipe.depths.numpy(), np.asarray(jpipe.depths),
                               rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(tpipe.disparity.numpy(),
                               np.asarray(jpipe.disparity), rtol=1e-3, atol=1e-4)
    assert tpipe.unedited.shape == (V, SIZE, SIZE, 3)


def test_z_T_matches(runs):
    """Inverted latents after two DDIM steps: atol/rtol 2e-4."""
    jpipe, tpipe, _ = runs
    assert tpipe.z_T.shape == (V, SIZE // 8, SIZE // 8, 4)
    np.testing.assert_allclose(tpipe.z_T.numpy(), np.asarray(jpipe.z_T),
                               atol=2e-4, rtol=2e-4)


def test_edited_matches(runs):
    """Chunked edit (refs prepended per chunk) against the JAX pipeline's:
    atol 1e-3 on [0,1] images."""
    jpipe, _, chunked = runs
    assert np.isfinite(chunked.numpy()).all()
    np.testing.assert_allclose(chunked.numpy(), np.asarray(jpipe.edited),
                               atol=1e-3)


def test_chunked_equals_all_at_once(runs):
    """Reference views only attend to reference K/V, so chunking leaves every
    view's edit unchanged; atol 2e-3 as the JAX pipeline test states."""
    _, tpipe, chunked = runs
    np.testing.assert_allclose(chunked.numpy(), tpipe.edited.numpy(), atol=2e-3)


@pytest.mark.parametrize("n,r,seed", [(40, 4, 13789), (8, 4, 13789),
                                      (5, 2, 13789), (7, 3, 1)])
def test_select_ref_views_identical(n, r, seed):
    assert select_ref_views(n, r, seed) == j_select(n, r, seed)


def test_hash_tokenizer_and_prompts_identical():
    for vocab, length in ((49408, 77), (1000, 16)):
        a, b = HashTokenizer(vocab, length), JHash(vocab, length)
        for text in ("a photo of a bear" + POSITIVE_SUFFIX, NEGATIVE_PROMPT,
                     "", "x " * 100):
            np.testing.assert_array_equal(a.encode(text), b.encode(text))
    assert POSITIVE_SUFFIX == J_SUFFIX and NEGATIVE_PROMPT == J_NEG


def test_depth_to_disparity_matches():
    d = np.random.default_rng(3).uniform(0.5, 9.0, (3, 8, 8, 1)).astype(np.float32)
    np.testing.assert_allclose(depth_to_disparity(torch.tensor(d)).numpy(),
                               np.asarray(j_disp(jnp.asarray(d))), rtol=1e-6)


def test_non_multiple_size_raises():
    """Resizing into the diffusion stack is not ported: 40×40 raises."""
    scene = GaussianScene.from_numpy(
        {k: np.zeros(s, np.float32) for k, s in
         (("means", (4, 3)), ("scales", (4, 3)), ("quats", (4, 4)),
          ("opacities", (4, 1)), ("features_dc", (4, 3)),
          ("features_rest", (4, 3, 3)))})
    cams = make_cameras(_ring_c2ws(2), 40, 40, 20, 20, 40, 40)
    with pytest.raises(ValueError, match="multiple"):
        GaussCtrlPipeline(GaussCtrlConfig(), scene, cams,
                          sd_config=SDConfig.tiny(), device="cpu")
