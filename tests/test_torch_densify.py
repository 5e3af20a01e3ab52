"""The port's fixed-capacity densification against the JAX package.

Every case of tests/test_densify.py (padding, split, duplicate, cull,
capacity overflow, the childless-split guard, capacity growth, the
opacity reset), and random mixed cases under each gating flag, go through
`gaussctrl_tpu.splat.densify` and `gaussctrl_tpu_torch.splat.densify` on the
same numpy inputs, with the JAX package's children offsets (its
`jax.random.normal` draws from the same key) passed to the port's
`refine`. Alive masks, stats and states must be equal; scene leaves agree
to 1e-6 (the children's offsets are a rotation of noise × scale, summed in
another order; `log(1.6)` and sigmoid may round in the last bit).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussctrl_tpu.splat import densify as jd
from gaussctrl_tpu.splat.scene import GaussianScene as JScene
from gaussctrl_tpu.splat.scene import random_scene as j_random_scene

from gaussctrl_tpu_torch.splat import densify as td
from gaussctrl_tpu_torch.splat.scene import GaussianScene

torch.set_num_threads(2)

FIELDS = ("means", "scales", "quats", "opacities", "features_dc",
          "features_rest")
LEAF_TOL = dict(rtol=1e-6, atol=1e-6)


def _np_scene(scene):
    return {k: np.array(getattr(scene, k)) for k in FIELDS}


def _np_state(st):
    return {f.name: np.array(getattr(st, f.name))
            for f in dataclasses.fields(st)}


def _jax(scene_np, state_np):
    return (JScene(**{k: jnp.asarray(v) for k, v in scene_np.items()}),
            jd.DensifyState(**{k: jnp.asarray(v) for k, v in state_np.items()}))


def _torch(scene_np, state_np):
    return (GaussianScene(**{k: torch.tensor(v) for k, v in scene_np.items()}),
            td.DensifyState(**{k: torch.tensor(v) for k, v in state_np.items()}))


def _padded(n=8, cap=20):
    """tests/test_densify.py's scene: n gaussians at opacity logit 2 in a
    buffer of `cap`, as numpy (scene, state)."""
    scene = j_random_scene(jax.random.PRNGKey(0), n, sh_degree=1, extent=0.5)
    scene = scene.replace(opacities=jnp.full((n, 1), 2.0))
    scene, st = jd.init_state(scene, cap)
    return _np_scene(scene), _np_state(st)


def _jax_noise(key, cap):
    """The offsets JAX's refine draws for its three placements."""
    return [np.asarray(jax.random.normal(k, (cap, 3)))
            for k in jax.random.split(key, 3)]


def _cfg_pair(**kw):
    return jd.DensifyConfig(**kw), td.DensifyConfig(**kw)


def _refine_both(scene_np, state_np, cfg_kw, seed=1, **flags):
    """refine in both packages; asserts they agree and returns the port's
    (scene, state, stats) as numpy."""
    jcfg, tcfg = _cfg_pair(**cfg_kw)
    key = jax.random.PRNGKey(seed)
    js, jst = _jax(scene_np, state_np)
    js2, jst2, jstats = jd.refine(js, jst, key, jcfg, **flags)
    ts, tst = _torch(scene_np, state_np)
    ts2, tst2, tstats = td.refine(ts, tst, cfg=tcfg,
                                  noise=_jax_noise(key, len(state_np["alive"])),
                                  **flags)
    assert ts2 is ts                              # updated in place
    assert {k: int(v) for k, v in jstats.items()} == tstats
    got_state, ref_state = _np_state(tst2), _np_state(jst2)
    for k in ref_state:
        np.testing.assert_array_equal(got_state[k], ref_state[k], err_msg=k)
    got, ref = _np_scene(ts2), _np_scene(js2)
    for k in FIELDS:
        np.testing.assert_allclose(got[k], ref[k], err_msg=k, **LEAF_TOL)
    return got, got_state, tstats


def test_init_state_pads_dead():
    scene = j_random_scene(jax.random.PRNGKey(0), 8, sh_degree=1, extent=0.5)
    ref_scene, ref_st = jd.init_state(scene, 20)
    got_scene, got_st = td.init_state(
        GaussianScene(**{k: torch.tensor(v) for k, v in _np_scene(scene).items()}),
        20)
    for k, v in _np_scene(ref_scene).items():
        np.testing.assert_array_equal(_np_scene(got_scene)[k], v, err_msg=k)
    for k, v in _np_state(ref_st).items():
        np.testing.assert_array_equal(_np_state(got_st)[k], v, err_msg=k)
    assert int(got_st.alive.sum()) == 8
    assert float(torch.sigmoid(got_scene.opacities[10, 0])) < 1e-5


def test_refine_split_grows_and_kills_parent():
    scene, st = _padded()
    st["grad_accum"][0], st["grad_count"][0] = 100.0, 1.0
    scene["scales"][0] = np.log(0.5)
    _, st2, stats = _refine_both(scene, st, dict(
        grad_thresh=1.0, densify_size_thresh=0.1, cull_scale3d=10.0))
    assert stats["n_split"] == 1 and stats["n_born"] == 2
    assert not st2["alive"][0] and st2["alive"].sum() == 9


def test_refine_duplicate_keeps_parent():
    scene, st = _padded()
    st["grad_accum"][3], st["grad_count"][3] = 100.0, 1.0
    scene["scales"][3] = np.log(1e-4)
    got, st2, stats = _refine_both(scene, st, dict(
        grad_thresh=1.0, densify_size_thresh=0.1, cull_scale3d=10.0))
    assert stats["n_dup"] == 1 and st2["alive"][3] and st2["alive"].sum() == 9
    born = np.nonzero(st2["alive"] & ~st["alive"])[0]
    np.testing.assert_array_equal(got["means"][born[0]], scene["means"][3])


def test_refine_culls_transparent():
    scene, st = _padded()
    scene["opacities"][5] = -15.0
    _, st2, stats = _refine_both(scene, st, dict(grad_thresh=1e9,
                                                 cull_scale3d=10.0))
    assert stats["n_cull"] == 1 and not st2["alive"][5]


def test_capacity_overflow_is_safe():
    scene, st = _padded(n=18, cap=20)
    st["grad_accum"][:18], st["grad_count"][:18] = 100.0, 1.0
    scene["scales"][:] = np.log(1e-4)
    _, st2, stats = _refine_both(scene, st, dict(
        grad_thresh=1.0, densify_size_thresh=0.1, cull_scale3d=10.0))
    assert st2["alive"].sum() == 20 and stats["n_born"] == 2
    assert stats["n_unplaced"] == 16


def test_full_buffer_split_keeps_parent():
    scene, st = _padded(n=20, cap=20)
    st["grad_accum"][0], st["grad_count"][0] = 100.0, 1.0
    scene["scales"][0] = np.log(0.5)
    got, st2, stats = _refine_both(scene, st, dict(
        grad_thresh=1.0, densify_size_thresh=0.1, cull_scale3d=10.0))
    assert stats["n_split"] == 0 and st2["alive"][0]
    np.testing.assert_array_equal(got["scales"][0], scene["scales"][0])


def _mixed(seed, n=150, cap=256):
    """A buffer of `cap` with n alive gaussians whose statistics, sizes,
    opacities and screen radii straddle every threshold, and a few dead
    slots inside the alive range."""
    rng = np.random.default_rng(seed)
    scene = j_random_scene(jax.random.PRNGKey(seed), n, sh_degree=1,
                           extent=0.5)
    scene, st = jd.init_state(scene, cap)
    scene, st = _np_scene(scene), _np_state(st)
    scene["scales"][:n] = np.log(rng.uniform(0.002, 0.8, size=(n, 3)))
    scene["scales"][: n // 2] = np.log(rng.uniform(0.001, 0.015,
                                                   size=(n // 2, 3)))
    scene["opacities"][:n, 0] = rng.normal(0.0, 2.5, size=n)
    st["grad_accum"][:n] = rng.uniform(0.0, 6e-4, size=n) * 5
    st["grad_count"][:n] = rng.integers(0, 6, size=n)
    st["radii_max"][:n] = rng.uniform(0.0, 0.2, size=n)
    dead = rng.choice(n, size=10, replace=False)
    st["alive"][dead] = False
    scene["opacities"][dead] = -15.0
    scene["scales"][dead] = -15.0
    return scene, st


@pytest.mark.parametrize("flags", [
    dict(),
    dict(screen_split=True),
    dict(scale_cull=False),
    dict(screen_split=True, screen_cull=True),
    dict(cull_only=True),
])
@pytest.mark.parametrize("quantile", [0.0, 0.5])
def test_refine_mixed_decisions_match_jax(flags, quantile):
    """Split, duplicate and cull all at once, under each gating flag and
    with the quantile cap on and off."""
    scene, st = _mixed(seed=len(flags) + int(10 * quantile))
    _, _, stats = _refine_both(scene, st, dict(densify_quantile=quantile),
                               seed=7, **flags)
    if not flags.get("cull_only"):
        assert stats["n_split"] > 0
        # the screen-size criterion makes most small gaussians split
        assert stats["n_dup"] > 0 or flags.get("screen_split")
    assert stats["n_cull"] > 0


def test_refine_childless_split_guard_with_a_nearly_full_buffer():
    """Fewer free slots than two per split: only the first ⌊free/2⌋ split
    ranks are made, duplicates take what is left, the rest go unplaced."""
    scene, st = _mixed(seed=3, n=240, cap=256)
    _, _, stats = _refine_both(scene, st, dict(), seed=2)
    assert stats["n_unplaced"] > 0


def test_grow_capacity_pads_scene_and_state():
    scene, st = _padded(n=8, cap=10)
    js, jst = _jax(scene, st)
    js2, jst2, _ = jd.grow_capacity(js, jst, {}, 24)
    ts, tst = _torch(scene, st)
    ts2, tst2 = td.grow_capacity(ts, tst, 24)
    for k, v in _np_scene(js2).items():
        np.testing.assert_array_equal(_np_scene(ts2)[k], v, err_msg=k)
    for k, v in _np_state(jst2).items():
        np.testing.assert_array_equal(_np_state(tst2)[k], v, err_msg=k)
    # the grown buffer still refines identically
    _refine_both(_np_scene(ts2), _np_state(tst2), dict(cull_scale3d=10.0),
                 seed=0)


def test_accumulate_matches_jax():
    rng = np.random.default_rng(0)
    _, st = _padded(n=8, cap=20)
    st["radii_max"] = rng.uniform(0, 0.1, 20).astype(np.float32)
    g = rng.normal(scale=1e-5, size=(20, 2)).astype(np.float32)
    vis = rng.uniform(size=20) > 0.3
    radii = rng.uniform(0, 40, 20).astype(np.float32)
    for r in (None, radii):
        ref = jd.accumulate(jd.DensifyState(**{k: jnp.asarray(v) for k, v
                                               in st.items()}),
                            jnp.asarray(g), jnp.asarray(vis),
                            96, 64, None if r is None else jnp.asarray(r))
        got = td.accumulate(td.DensifyState(**{k: torch.tensor(v) for k, v
                                               in st.items()}), torch.tensor(g),
                            torch.tensor(vis), 96, 64,
                            None if r is None else torch.tensor(r))
        for k, v in _np_state(ref).items():
            np.testing.assert_allclose(_np_state(got)[k], v, rtol=1e-6,
                                       err_msg=k)


def test_reset_opacities_only_alive():
    scene, st = _padded()
    scene["opacities"][1] = -3.0
    ref = jd.reset_opacities(_jax(scene, st)[0], jnp.asarray(st["alive"]), 0.01)
    ts = _torch(scene, st)[0]
    td.reset_opacities(ts, torch.tensor(st["alive"]), 0.01)
    np.testing.assert_array_equal(ts.opacities.numpy(), np.asarray(ref.opacities))
    assert float(torch.sigmoid(ts.opacities[:8]).max()) <= 0.0101
    assert float(ts.opacities[10, 0]) == -15.0
