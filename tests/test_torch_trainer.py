"""The port's re-optimisation (losses, one training step, `reoptimize`,
camera optimisation) against the JAX package on the CPU.

A 200-gaussian scene at SH degree 1 and 64×64 views, made with numpy from a
seed, goes through both packages; the JAX blend runs as XLA on the CPU. The
random backgrounds of the JAX `reoptimize` (`jax.random.uniform` over
`split(PRNGKey(seed), steps)`) are handed to the port's. Tolerances are
stated per test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussctrl_tpu.cameras.camera import make_cameras as j_make_cameras
from gaussctrl_tpu.splat import losses as jlosses
from gaussctrl_tpu.splat import trainer as jtrainer
from gaussctrl_tpu.splat.render import render_rgbd as j_render_rgbd
from gaussctrl_tpu.splat.scene import GaussianScene as JScene

from gaussctrl_tpu_torch.cameras.camera import make_cameras
from gaussctrl_tpu_torch.splat import losses as tlosses
from gaussctrl_tpu_torch.splat import trainer as ttrainer
from gaussctrl_tpu_torch.splat.scene import GaussianScene

from test_torch_pipeline import _ring_c2ws
from test_torch_splat import _random_scene_np, _t

torch.set_num_threads(2)

FIELDS = ("means", "scales", "quats", "opacities", "features_dc",
          "features_rest")
SIZE, V = 64, 4


def _scene_np(seed=5, n=200):
    s = _random_scene_np(np.random.default_rng(seed), n, sh_degree=1)
    s["means"] *= 0.5
    return s


def _jscene(s):
    return JScene(**{k: jnp.asarray(s[k]) for k in FIELDS})


def _targets(seed=9):
    """Smooth random [V, H, W, 3] targets (a coarse grid upsampled)."""
    rng = np.random.default_rng(seed)
    coarse = rng.uniform(size=(V, 8, 8, 3)).astype(np.float32)
    return np.repeat(np.repeat(coarse, 8, axis=1), 8, axis=2)


@pytest.mark.parametrize("hw", [(64, 48), (9, 12), (4, 7)])
def test_ssim_and_splat_loss_match_jax(hw):
    """SSIM and L1+SSIM on random images, including sizes below the 11×11
    window (it shrinks to 9 and 3); rtol 1e-5 on the metrics, and the
    SSIM gradient at rtol 1e-4 / atol 1e-6 of its largest value."""
    rng = np.random.default_rng(hw[0])
    a = rng.uniform(size=hw + (3,)).astype(np.float32)
    b = np.clip(a + rng.normal(scale=0.1, size=a.shape), 0, 1).astype(np.float32)
    ref_loss, ref_m = jlosses.splat_loss(jnp.asarray(a), jnp.asarray(b))
    got_loss, got_m = tlosses.splat_loss(_t(a), _t(b))
    for k in ("l1", "ssim", "psnr", "loss"):
        np.testing.assert_allclose(float(got_m[k]), float(ref_m[k]), rtol=1e-5,
                                   err_msg=k)
    assert np.isfinite(float(got_m["ssim"]))
    ref_g = np.asarray(jax.grad(lambda x: jlosses.ssim(x, jnp.asarray(b)))(
        jnp.asarray(a)))
    x = _t(a).requires_grad_()
    tlosses.ssim(x, _t(b)).backward()
    np.testing.assert_allclose(x.grad.numpy(), ref_g, rtol=1e-4,
                               atol=1e-6 * np.abs(ref_g).max())


def test_ssim_flat_windows_match_jax():
    """A constant image against itself and a flat region beside an edge.
    On a flat window the variances are float round-off (~1e-8) that SSIM
    divides by c2 = 9e-4, so two fp32 filters that round differently
    agree to ~1e-4 there and no closer: the value is held at atol 1e-4
    and the gradient at atol 2e-6 (its largest entry is 0.045)."""
    a = np.full((20, 20, 3), 0.3, np.float32)
    b = a.copy()
    b[:, 10:] = 0.8
    for x, y in ((a, a), (a, b), (b, a)):
        ref = jax.value_and_grad(jlosses.ssim)(jnp.asarray(x), jnp.asarray(y))
        t = _t(x).requires_grad_()
        got = tlosses.ssim(t, _t(y))
        got.backward()
        np.testing.assert_allclose(float(got.detach()), float(ref[0]), atol=1e-4)
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(ref[1]),
                                   atol=2e-6)


def test_train_step_gradients_match_jax():
    """One step's loss and the gradient of every scene field against
    `jax.value_and_grad` of the JAX loss, same background: loss rtol 1e-5,
    gradients rtol 1e-3 and atol 1e-4 of each field's largest magnitude
    (float32 through projection, SH, blend and SSIM in two orders)."""
    s = _scene_np()
    c2w = _ring_c2ws(V)[1]
    gt = _targets()[1]
    bg = np.asarray([0.3, 0.6, 0.2], np.float32)
    kw = dict(fx=SIZE, fy=SIZE, cx=SIZE / 2, cy=SIZE / 2, width=SIZE,
              height=SIZE)

    def jloss(scene):
        out = j_render_rgbd(scene, jnp.asarray(c2w), background=jnp.asarray(bg),
                            sh_degree=1, **kw)
        return jlosses.splat_loss(out["rgb"], jnp.asarray(gt))[0]

    ref_loss, ref_g = jax.value_and_grad(jloss)(_jscene(s))
    scene = ttrainer.trainable(GaussianScene.from_numpy(s))
    loss, _ = ttrainer.render_loss(scene, _t(c2w), gt_image=_t(gt),
                                   background=_t(bg), sh_degree=1, **kw)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(ref_loss), rtol=1e-5)
    for k in FIELDS:
        r = np.asarray(getattr(ref_g, k))
        g = getattr(scene, k).grad.numpy()
        assert np.abs(r).max() > 0, k
        np.testing.assert_allclose(g, r, rtol=1e-3, atol=1e-4 * np.abs(r).max(),
                                   err_msg=k)


def _reopt_both(steps, seed, camopt=False):
    """`reoptimize` in both packages: (start scene, JAX scene, JAX metrics,
    JAX per-step losses, port scene, port metrics)."""
    s = _scene_np()
    c2ws = _ring_c2ws(V)
    images = _targets()
    tcfg_kw = dict(use_camera_opt=True, camera_opt_accum=2) if camopt else {}
    jcams = j_make_cameras(c2ws, SIZE, SIZE, SIZE / 2, SIZE / 2, SIZE, SIZE)
    losses = []
    jscene, jm = jtrainer.reoptimize(
        _jscene(s), jcams, jnp.asarray(images), steps, seed=seed,
        train_cfg=jtrainer.TrainConfig(**tcfg_kw), log_every=1,
        log_fn=lambda i, m: losses.append(m["loss"]))
    keys = jax.random.split(jax.random.PRNGKey(seed), steps)
    bgs = np.stack([np.asarray(jax.random.uniform(k, (3,))) for k in keys])
    cams = make_cameras(c2ws, SIZE, SIZE, SIZE / 2, SIZE / 2, SIZE, SIZE)
    tscene, tm = ttrainer.reoptimize(
        GaussianScene.from_numpy(s), cams, _t(images), steps, seed=seed,
        train_cfg=ttrainer.TrainConfig(**tcfg_kw), backgrounds=_t(bgs))
    return s, jscene, jm, np.asarray(losses), tscene, tm


def test_reoptimize_matches_jax():
    """Three steps of `reoptimize` from the same scene, views (numpy's
    permutation) and backgrounds (the JAX draws). The loss trajectory is
    held at rtol 1e-4. Adam with eps 1e-15 moves every parameter whose
    gradient is not exactly zero by a full lr per step whatever the
    gradient's size, so a gradient that is float noise can take either
    sign: each field is held to 2·lr·steps (the most a sign flip on every
    step can move it), and all but 2% of its entries to 1e-4·lr·steps."""
    steps = 3
    s, jscene, _, j_history, tscene, tm = _reopt_both(steps, seed=4)
    np.testing.assert_allclose(tm["loss_history"].numpy(), j_history, rtol=1e-4)
    cfg = ttrainer.TrainConfig()
    lrs = dict(means=cfg.lr_means_final, scales=cfg.lr_scales,
               quats=cfg.lr_quats, opacities=cfg.lr_opacities,
               features_dc=cfg.lr_features_dc,
               features_rest=cfg.lr_features_rest)
    for k in FIELDS:
        r = np.asarray(getattr(jscene, k))
        g = getattr(tscene, k).numpy()
        moved = np.abs(r - s[k]).max()
        assert moved > 0.5 * lrs[k], k
        diff = np.abs(g - r)
        assert diff.max() <= 2 * lrs[k] * steps * 1.01, (k, diff.max())
        assert (diff > 1e-4 * lrs[k] * steps).mean() <= 0.02, \
            (k, (diff > 1e-4 * lrs[k] * steps).mean())


def test_camera_opt_matches_jax():
    """`exp_so3` (Taylor branch and large angles) and `apply_camera_opt` at
    atol 1e-6; one loss gradient with respect to the pose delta against
    `jax.grad` at rtol 1e-3; and two steps of `reoptimize` with the camera
    group stepped every 2 (the MultiSteps mean): loss trajectory rtol 1e-4,
    the learned deltas to 2·lr."""
    rng = np.random.default_rng(1)
    for phi in (np.zeros(3), np.full(3, 1e-9), rng.normal(size=3) * 0.3,
                rng.normal(size=3) * 2.0):
        phi = phi.astype(np.float32)
        np.testing.assert_allclose(ttrainer.exp_so3(_t(phi)).numpy(),
                                   np.asarray(jtrainer.exp_so3(jnp.asarray(phi))),
                                   atol=1e-6)
    c2w = _ring_c2ws(V)[2]
    delta = (rng.normal(size=6) * 0.05).astype(np.float32)
    np.testing.assert_allclose(
        ttrainer.apply_camera_opt(_t(c2w), _t(delta)).numpy(),
        np.asarray(jtrainer.apply_camera_opt(jnp.asarray(c2w), jnp.asarray(delta))),
        atol=1e-6)

    s = _scene_np()
    gt = _targets()[2]
    bg = np.zeros(3, np.float32)
    kw = dict(fx=SIZE, fy=SIZE, cx=SIZE / 2, cy=SIZE / 2, width=SIZE,
              height=SIZE)

    def jloss(d):
        out = j_render_rgbd(_jscene(s), jtrainer.apply_camera_opt(
            jnp.asarray(c2w), d), background=jnp.asarray(bg), sh_degree=1, **kw)
        return jlosses.splat_loss(out["rgb"], jnp.asarray(gt))[0]

    ref = np.asarray(jax.grad(jloss)(jnp.asarray(delta)))
    d = _t(delta).requires_grad_()
    loss, _ = ttrainer.render_loss(
        GaussianScene.from_numpy(s), ttrainer.apply_camera_opt(_t(c2w), d),
        gt_image=_t(gt), background=_t(bg), sh_degree=1, **kw)
    loss.backward()
    np.testing.assert_allclose(d.grad.numpy(), ref, rtol=1e-3,
                               atol=1e-4 * np.abs(ref).max())

    _, _, jm, j_history, _, tm = _reopt_both(2, seed=2, camopt=True)
    np.testing.assert_allclose(tm["loss_history"].numpy(), j_history, rtol=1e-4)
    jd = np.asarray(jm["camera_deltas"])
    td = tm["camera_deltas"].numpy()
    assert np.abs(jd).max() > 0
    assert np.abs(td - jd).max() <= 2 * 1e-3 * 1.01


def test_exp_decay_and_groups_match_jax():
    """The means' lr at the re-optimisation steps (the schedule sits at its
    final value past the 30k offset) and the group learning rates."""
    cfg = ttrainer.TrainConfig()
    jsched = jtrainer._exp_decay(cfg.lr_means, cfg.lr_means_final,
                                 cfg.lr_means_max_steps, cfg.lr_step_offset)
    tsched = ttrainer._exp_decay(cfg.lr_means, cfg.lr_means_final,
                                 cfg.lr_means_max_steps, cfg.lr_step_offset)
    for step in (0, 1, 499):
        np.testing.assert_allclose(tsched(step), float(jsched(step)), rtol=1e-6)
    np.testing.assert_allclose(
        ttrainer._exp_decay(1e-2, 1e-4, 100)(37),
        float(jtrainer._exp_decay(1e-2, 1e-4, 100)(37)), rtol=1e-6)
    opt = ttrainer.make_optimizer(
        ttrainer.trainable(GaussianScene.from_numpy(_scene_np(n=4))), cfg)
    assert [g["name"] for g in opt.param_groups] == list(ttrainer.GROUPS)
    assert all(g["eps"] == 1e-15 for g in opt.param_groups)
