"""The port's from-scratch pre-training against the JAX package on the CPU:
`from_points`, the `xys_shift` gradient, `render_camera`, one
`pretrain_step`, capacity growth with Adam's state, short `pretrain` loops
fed the JAX package's draws (the CLI is held in
tests/test_torch_splat_train.py).

Scenes are made with numpy (or by the JAX package from a fixed key) and go
through both packages; the JAX blend runs as XLA on the CPU, the port's as
the plain version of K1/K4. The JAX package's random backgrounds
(`jax.random.uniform(keys[step], (3,))`) and refine offsets
(`jax.random.normal` from `keys[-1]`) are handed to the port. Tolerances
are stated per test.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussctrl_tpu.cameras.camera import make_cameras as j_make_cameras
from gaussctrl_tpu.splat import densify as jd
from gaussctrl_tpu.splat import losses as jlosses
from gaussctrl_tpu.splat import pretrain as jpre
from gaussctrl_tpu.splat import scene as jscene_mod
from gaussctrl_tpu.splat import trainer as jtrainer
from gaussctrl_tpu.splat.rasterize import RasterConfig as JRasterConfig
from gaussctrl_tpu.splat.render import render_camera as j_render_camera
from gaussctrl_tpu.splat.render import render_rgbd as j_render_rgbd
from gaussctrl_tpu.splat.scene import GaussianScene as JScene

from gaussctrl_tpu_torch.cameras.camera import make_cameras
from gaussctrl_tpu_torch.splat import densify as td
from gaussctrl_tpu_torch.splat import pretrain as tpre
from gaussctrl_tpu_torch.splat import trainer as ttrainer
from gaussctrl_tpu_torch.splat.rasterize import RasterConfig
from gaussctrl_tpu_torch.splat.render import render_camera, render_rgbd
from gaussctrl_tpu_torch.splat.scene import GaussianScene, from_points

from test_torch_data import pin_knn_branch
from test_torch_pipeline import _ring_c2ws
from test_torch_splat import _random_scene_np

torch.set_num_threads(2)

FIELDS = ("means", "scales", "quats", "opacities", "features_dc",
          "features_rest")
SIZE, V = 48, 4


def _jscene(s):
    return JScene(**{k: jnp.asarray(v) for k, v in s.items()})


def _tscene(s):
    return GaussianScene(**{k: torch.tensor(np.array(v)) for k, v in s.items()})


def _np(scene):
    return {k: np.array(getattr(scene, k).detach() if hasattr(
        getattr(scene, k), "detach") else getattr(scene, k)) for k in FIELDS}


def _scene_np(seed=5, n=120):
    s = _random_scene_np(np.random.default_rng(seed), n, sh_degree=1)
    s["means"] *= 0.4
    return s


def _targets(seed=9, size=SIZE):
    rng = np.random.default_rng(seed)
    coarse = rng.uniform(size=(V, 6, 6, 3)).astype(np.float32)
    return np.repeat(np.repeat(coarse, size // 6, 1), size // 6, 2)


def _cams(size=SIZE):
    c2ws = _ring_c2ws(V)
    return (j_make_cameras(c2ws, size, size, size / 2, size / 2, size, size),
            make_cameras(c2ws, size, size, size / 2, size / 2, size, size))


@pytest.mark.parametrize("branch", ["exact", "native"])
@pytest.mark.parametrize("n", [50, 400])
def test_from_points_matches_jax(n, branch, monkeypatch, request):
    """Seed scenes from one point cloud, both packages on one kNN branch
    (`pin_knn_branch`): scales from the 3-NN distances at rtol 1e-5 (the
    native helper's mean distance, or the exact search's root mean square
    distance: ROADMAP F9), the other fields exactly."""
    pin_knn_branch(monkeypatch, request, branch)
    rng = np.random.default_rng(n)
    pts = rng.normal(size=(n, 3)).astype(np.float32)
    cols = rng.uniform(size=(n, 3)).astype(np.float32)
    ref = _np(jscene_mod.from_points(pts, cols, sh_degree=2))
    got = _np(from_points(pts, cols, sh_degree=2))
    for k in FIELDS:
        if k == "scales":
            np.testing.assert_allclose(got[k], ref[k], rtol=1e-5, err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def test_xys_shift_gradient_matches_jax():
    """The gradient of L1 + SSIM with respect to a zero `xys_shift` (the
    densify statistic; K4's xy rows summed per gaussian on the card)
    against `jax.grad` with respect to the JAX `xys_shift`: rtol 1e-3 and
    atol 1e-4 of its largest magnitude (float32 through SH, blend and SSIM
    in two orders)."""
    s, gt = _scene_np(), _targets()[2]
    c2w = _ring_c2ws(V)[2]
    bg = np.asarray([0.2, 0.5, 0.7], np.float32)
    kw = dict(fx=SIZE, fy=SIZE, cx=SIZE / 2, cy=SIZE / 2, width=SIZE,
              height=SIZE)

    def jloss(shift):
        out = j_render_rgbd(_jscene(s), jnp.asarray(c2w),
                            background=jnp.asarray(bg), sh_degree=1,
                            xys_shift=shift, **kw)
        return jlosses.splat_loss(out["rgb"], jnp.asarray(gt))[0]

    ref = np.asarray(jax.jit(jax.grad(jloss))(jnp.zeros((len(s["means"]), 2))))
    shift = torch.zeros((len(s["means"]), 2), requires_grad=True)
    out = render_rgbd(_tscene(s), torch.tensor(c2w), background=torch.tensor(bg),
                      sh_degree=1, xys_shift=shift, **kw)
    ttrainer.splat_loss(out["rgb"], torch.tensor(gt))[0].backward()
    assert np.abs(ref).max() > 0
    np.testing.assert_allclose(shift.grad.numpy(), ref, rtol=1e-3,
                               atol=1e-4 * np.abs(ref).max())
    # a zero shift changes nothing in the render
    plain = render_rgbd(_tscene(s), torch.tensor(c2w),
                        background=torch.tensor(bg), sh_degree=1, **kw)
    assert torch.equal(plain["rgb"], out["rgb"].detach())


def test_render_camera_matches_jax():
    """One camera of a batch, rgb/depth/accumulation at atol 1e-5, and the
    projection's radii returned beside them."""
    s = _scene_np()
    jc, tc = _cams()
    bg = np.asarray([0.1, 0.2, 0.3], np.float32)
    ref = j_render_camera(_jscene(s), jc, jnp.int32(1), jnp.asarray(bg), 1)
    got = render_camera(_tscene(s), tc, 1, torch.tensor(bg), 1)
    for k in ("rgb", "depth", "accumulation"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   atol=1e-5, err_msg=k)
    assert got["radii"].shape == (len(s["means"]),)
    assert int((got["radii"] > 0).sum()) > 0


def _j_step(s, dstate_np, c2w, gt, key, width, sh, train_cfg):
    """The JAX package's pretrain_step from numpy inputs (it donates)."""
    opt = jtrainer.make_optimizer(train_cfg)
    scene = _jscene(s)
    return jpre.pretrain_step(
        scene, opt.init(scene),
        jd.DensifyState(**{k: jnp.asarray(v) for k, v in dstate_np.items()}),
        jnp.asarray(c2w), jnp.float32(width), jnp.float32(width),
        jnp.float32(width / 2), jnp.float32(width / 2), jnp.asarray(gt), key,
        width, width, sh, train_cfg=train_cfg)


def test_pretrain_step_matches_jax():
    """One pre-training step from one state, with the JAX step's background:
    the metrics (rtol 1e-5; SSIM atol 1e-4, see below), every field's gradient (rtol 1e-3, atol 1e-4
    of the field's largest magnitude, as tests/test_torch_trainer.py), the
    xy gradient, the DensifyState after it (grad_accum rtol 1e-3, counts
    and radii exact), and the scene after Adam's first step (2·lr: a
    gradient that is float noise may take the other sign, and Adam's first
    step is ±lr whatever its size)."""
    s = _scene_np()
    jc, tc = _cams()
    gt = _targets()[0]
    cap = 128
    scene_np = {k: np.concatenate([v, np.zeros((cap - len(v),) + v.shape[1:],
                                               np.float32)]) for k, v in s.items()}
    scene_np["opacities"][len(s["means"]):] = -15.0
    scene_np["scales"][len(s["means"]):] = -15.0
    scene_np["quats"][len(s["means"]):, 0] = 1.0
    alive = np.arange(cap) < len(s["means"])
    dstate_np = dict(alive=alive, grad_accum=np.zeros(cap, np.float32),
                     grad_count=np.zeros(cap, np.float32),
                     radii_max=np.zeros(cap, np.float32))
    key = jax.random.PRNGKey(3)
    train_cfg = jtrainer.TrainConfig(lr_step_offset=0)
    c2w = np.asarray(jc.c2w[0])
    jscene2, _, jdst, jm = _j_step(scene_np, dstate_np, c2w, gt, key, SIZE, 1,
                                   train_cfg)
    bg = np.asarray(jax.random.uniform(key, (3,)))

    # the JAX gradients of the same loss, for the comparison
    def jloss(scene, shift):
        out = j_render_rgbd(scene, jnp.asarray(c2w), SIZE, SIZE, SIZE / 2,
                            SIZE / 2, SIZE, SIZE, jnp.asarray(bg), 1,
                            xys_shift=shift)
        return jlosses.splat_loss(out["rgb"], jnp.asarray(gt))[0]

    jg, jg_xy = jax.jit(jax.grad(jloss, argnums=(0, 1)))(_jscene(scene_np),
                                                jnp.zeros((cap, 2)))
    scene = ttrainer.trainable(_tscene(scene_np))
    opt = ttrainer.make_optimizer(scene, ttrainer.TrainConfig(lr_step_offset=0))
    dstate = td.DensifyState(**{k: torch.tensor(v) for k, v in dstate_np.items()})
    grads = {}

    def keep(k):
        return lambda g: grads.__setitem__(k, g.clone())

    hooks = [getattr(scene, k).register_hook(keep(k)) for k in FIELDS]
    dstate, m, g_xy = tpre.pretrain_step(
        scene, opt, dstate, 0, tc.c2w[0], tc.fx[0], tc.fy[0], tc.cx[0],
        tc.cy[0], torch.tensor(gt), torch.tensor(bg), SIZE, SIZE, 1)
    for h in hooks:
        h.remove()
    for k in ("loss", "l1", "psnr", "isect_frac"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5,
                                   err_msg=k)
    # the targets are flat 8×8 blocks: SSIM's flat windows agree to ~1e-4
    np.testing.assert_allclose(float(m["ssim"]), float(jm["ssim"]), atol=1e-4)
    for k in FIELDS:
        r = np.asarray(getattr(jg, k))
        np.testing.assert_allclose(grads[k].numpy(), r, rtol=1e-3,
                                   atol=1e-4 * np.abs(r).max(), err_msg=k)
    r = np.asarray(jg_xy)
    np.testing.assert_allclose(g_xy.numpy(), r, rtol=1e-3,
                               atol=1e-4 * np.abs(r).max())
    np.testing.assert_array_equal(dstate.grad_count.numpy(),
                                  np.asarray(jdst.grad_count))
    np.testing.assert_array_equal(dstate.alive.numpy(), np.asarray(jdst.alive))
    np.testing.assert_allclose(dstate.radii_max.numpy(),
                               np.asarray(jdst.radii_max), rtol=1e-6)
    ref_acc = np.asarray(jdst.grad_accum)
    np.testing.assert_allclose(dstate.grad_accum.numpy(), ref_acc, rtol=1e-3,
                               atol=1e-4 * ref_acc.max())
    assert int(dstate.grad_count.sum()) > 0
    lrs = {g["name"]: g["lr"] for g in opt.param_groups}
    for k in FIELDS:
        np.testing.assert_allclose(getattr(scene, k).detach().numpy(),
                                   np.asarray(getattr(jscene2, k)), rtol=0,
                                   atol=2 * lrs[k] + 1e-6, err_msg=k)


def _adam_rows(opt, name):
    st = opt.state[[g for g in opt.param_groups if g["name"] == name][0]["params"][0]]
    return st


def test_grow_capacity_keeps_adam_and_the_next_step_matches_jax():
    """Two steps, capacity growth 128 → 256, one more step in both
    packages: the port's Adam keeps its moments (padded with zero rows) and
    its step on the new leaves, as the JAX package's padded opt_state does,
    and the third step's scene agrees (3 × 2·lr, as above). Without the
    moved state the third step would be a first step again: ±lr for every
    touched entry."""
    s = _scene_np(seed=6)
    jc, tc = _cams()
    gt = _targets(seed=4)
    cap = 128
    js, jst = jd.init_state(_jscene(s), cap)
    ts, tst = td.init_state(_tscene(s), cap)
    ts = ttrainer.trainable(ts)
    cfg = jtrainer.TrainConfig(lr_step_offset=0)
    jopt = jtrainer.make_optimizer(cfg)
    jos = jopt.init(js)
    topt = ttrainer.make_optimizer(ts, ttrainer.TrainConfig(lr_step_offset=0))
    keys = jax.random.split(jax.random.PRNGKey(0), 3)

    def both(i, js, jos, jst, tst):
        v = i % V
        c2w = jc.c2w[v]
        js, jos, jst, _ = jpre.pretrain_step(
            js, jos, jst, c2w, jc.fx[v], jc.fy[v], jc.cx[v], jc.cy[v],
            jnp.asarray(gt[v]), keys[i], SIZE, SIZE, 1, train_cfg=cfg)
        bg = torch.tensor(np.asarray(jax.random.uniform(keys[i], (3,))))
        tst, _, _ = tpre.pretrain_step(
            ts, topt, tst, i, tc.c2w[v], tc.fx[v], tc.fy[v], tc.cx[v],
            tc.cy[v], torch.tensor(gt[v]), bg, SIZE, SIZE, 1)
        return js, jos, jst, tst

    for i in range(2):
        js, jos, jst, tst = both(i, js, jos, jst, tst)
    old_leaf = ts.means
    step_before = float(_adam_rows(topt, "means")["step"])
    mu_before = _adam_rows(topt, "means")["exp_avg"].clone()
    js, jst, jos = jd.grow_capacity(js, jst, jos, 256)
    ts2, tst = td.grow_capacity(ts, tst, 256)
    ttrainer.adopt_params(topt, ts2)
    assert ts2 is ts and ts.means is not old_leaf and ts.means.requires_grad
    assert ts.num_gaussians == 256 and int(tst.alive.sum()) == len(s["means"])
    st = _adam_rows(topt, "means")
    assert st["exp_avg"].shape[0] == 256 and float(st["step"]) == step_before
    assert torch.equal(st["exp_avg"][:cap], mu_before)
    assert float(st["exp_avg"][cap:].abs().max()) == 0.0
    assert all(g["params"][0] is getattr(ts, g["name"]) for g in topt.param_groups)
    assert len(topt.state) == len(FIELDS)
    js, jos, jst, tst = both(2, js, jos, jst, tst)
    for k in FIELDS:
        lr = [g["lr"] for g in topt.param_groups if g["name"] == k][0]
        np.testing.assert_allclose(getattr(ts, k).detach().numpy(),
                                   np.asarray(getattr(js, k)), rtol=0,
                                   atol=3 * 2 * lr + 1e-6, err_msg=k)


def test_moment_resets_match_jax():
    """Newborn rows zeroed in every group (step kept) and one group's whole
    state zeroed after an opacity reset, against the JAX helpers on the
    same moments."""
    s = _scene_np(seed=8, n=40)
    cfg = jtrainer.TrainConfig(lr_step_offset=0)
    jopt = jtrainer.make_optimizer(cfg)
    scene = ttrainer.trainable(_tscene(s))
    topt = ttrainer.make_optimizer(scene, ttrainer.TrainConfig(lr_step_offset=0))
    rng = np.random.default_rng(0)
    for k in FIELDS:                      # one step with random gradients
        getattr(scene, k).grad = torch.tensor(
            rng.normal(size=getattr(scene, k).shape).astype(np.float32))
    topt.step()

    def j_state():
        """The JAX opt_state holding the port's moments."""
        jos = jopt.init(_jscene(s))

        def fill(path, x):
            names = [getattr(p, "name", getattr(p, "key", None)) for p in path]
            for f in FIELDS:
                if f in names and hasattr(x, "ndim") and x.ndim >= 1:
                    st = _adam_rows(topt, f)
                    moment = "exp_avg" if "mu" in names else "exp_avg_sq"
                    return jnp.asarray(st[moment].numpy())
            return x
        return jax.tree_util.tree_map_with_path(fill, jos)

    born = np.zeros(len(s["means"]), bool)
    born[[1, 7, 30]] = True
    ref = jpre._reset_newborn_moments(j_state(), jnp.asarray(born))
    ttrainer.zero_adam_rows(topt, torch.tensor(born))
    ref_l = jpre._reset_label_moments(ref, "opacities", jopt, _jscene(s))
    ttrainer.reset_group_moments(topt, "opacities")
    leaves = jax.tree_util.tree_leaves_with_path(ref_l)
    checked = 0
    for path, x in leaves:
        names = [getattr(p, "name", getattr(p, "key", None)) for p in path]
        for f in FIELDS:
            if f in names and hasattr(x, "ndim") and x.ndim >= 1:
                moment = "exp_avg" if "mu" in names else "exp_avg_sq"
                np.testing.assert_array_equal(
                    _adam_rows(topt, f)[moment].numpy(), np.asarray(x),
                    err_msg=f"{f} {moment}")
                checked += 1
    assert checked == 2 * len(FIELDS)
    assert float(_adam_rows(topt, "opacities")["step"]) == 0.0
    assert float(_adam_rows(topt, "means")["step"]) == 1.0


def _loop_setup(n_gt=60, n_pts=30, size=SIZE):
    """Targets rendered (by the port, on black) from a JAX random scene,
    and the first `n_pts` of its means as grey seeds."""
    gt_scene = jscene_mod.random_scene(jax.random.PRNGKey(5), n_gt, sh_degree=1,
                                       extent=0.4)
    jc, tc = _cams(size)
    with torch.no_grad():
        gt = np.stack([render_camera(_tscene(_np(gt_scene)), tc, i,
                                     torch.zeros(3), 1)["rgb"].numpy()
                       for i in range(V)])
    pts = np.asarray(gt_scene.means[:n_pts])
    cols = np.full((n_pts, 3), 0.5, np.float32)
    return jc, tc, gt, pts, cols


def _jax_draws(seed, num_steps):
    keys = jax.random.split(jax.random.PRNGKey(seed), num_steps + 1)
    bgs = np.stack([np.asarray(jax.random.uniform(k, (3,))) for k in keys[:-1]])
    ks = jax.random.split(keys[-1], 3)

    def noise(cap):
        return [np.asarray(jax.random.normal(k, (cap, 3))) for k in ks]

    return torch.tensor(bgs), noise


def _both_loops(cfg_kw, dcfg_kw, num_steps, seed=0, **setup):
    jc, tc, gt, pts, cols = _loop_setup(**setup)
    jlog, tlog = [], []
    jcfg = jpre.PretrainConfig(num_steps=num_steps,
                               densify=jd.DensifyConfig(**dcfg_kw), **cfg_kw)
    tcfg = tpre.PretrainConfig(num_steps=num_steps,
                               densify=td.DensifyConfig(**dcfg_kw), **cfg_kw)
    # segments of 128 instances and 16 tiles a step in both blends: the
    # same function as the defaults, and 30× faster for the JAX package's
    # XLA blend on the CPU at these sizes
    rc = dict(tile_capacity=128, tile_chunk=16)
    jres = jpre.pretrain(jc, gt, pts, cols, jcfg, sh_degree=1, seed=seed,
                         raster_cfg=JRasterConfig(**rc),
                         log_fn=lambda s, m: jlog.append((s, m)))
    bgs, noise = _jax_draws(seed, num_steps)
    tres = tpre.pretrain(tc, gt, pts, cols, tcfg, sh_degree=1, seed=seed,
                         raster_cfg=RasterConfig(**rc),
                         log_fn=lambda s, m: tlog.append((s, m)), device="cpu",
                         backgrounds=bgs, refine_noise=noise)
    return jres, tres, jlog, tlog


STAT_KEYS = ("n_alive", "n_split", "n_dup", "n_cull", "n_born", "n_unplaced")


def _refines(log):
    return [(s, {k: int(m[k]) for k in STAT_KEYS}) for s, m in log
            if "n_split" in m]


@pytest.mark.parametrize("branch", ["exact", "native"])
def test_pretrain_short_loop_matches_jax(branch, monkeypatch, request):
    """A tests/test_densify.py-sized loop from one seed scene (60 seed
    points, both packages seeded on one kNN branch by `pin_knn_branch`, 4
    views trained at 1/4 of 48×48, 25 steps) with refines at
    steps 16 and 24 (warmup 5, refine_every 8), fed the JAX package's
    backgrounds and offsets. The first refine starts from identical state
    and its split, duplicate, cull and birth counts must equal the JAX
    package's exactly; `grad_thresh` sits between the logged p50 and p98 of
    the statistic, so its decisions are mixed, and the quantiles agree to
    rtol 1e-3 (float32 gradients that the two blends sum in other orders).
    The second refine comes after 24 steps of Adam (eps 1e-15: a float-noise
    gradient may take the other sign, a full ±lr step), so its counts get a
    slack of 2 gaussians each, and the final gaussian count the same; the
    final loss agrees to 5%."""
    pin_knn_branch(monkeypatch, request, branch)
    (jscene_, jm), (tscene_, tm), jlog, tlog = _both_loops(
        dict(capacity_mult=2.0, sh_degree_interval=1000, eval_every=0),
        dict(warmup=5, refine_every=8, stop_at=35, reset_alpha_every=1000,
             grad_thresh=8e-4), num_steps=25, n_pts=60)
    jr, tr = _refines(jlog), _refines(tlog)
    assert [s for s, _ in tr] == [s for s, _ in jr] == [16, 24]
    assert tr[0] == jr[0]
    assert tr[0][1]["n_split"] + tr[0][1]["n_dup"] > 0
    jq = [m for s, m in jlog if "grad_p50" in m][0]
    tq = [m for s, m in tlog if "grad_p50" in m][0]
    for k in ("grad_p50", "grad_p90", "grad_p98"):
        np.testing.assert_allclose(tq[k], jq[k], rtol=1e-3, err_msg=k)
    assert tq["grad_p50"] < 8e-4 < tq["grad_p98"]
    for k in STAT_KEYS:
        assert abs(tr[1][1][k] - jr[1][1][k]) <= 2, k
    assert abs(tscene_.num_gaussians - jscene_.num_gaussians) <= 2
    assert tscene_.num_gaussians > 0 and np.isfinite(tm["loss"])
    np.testing.assert_allclose(tm["loss"], float(jm["loss"]), rtol=5e-2)


def test_pretrain_growth_reset_and_cull_only():
    """The port's schedule on its own draws: the refines of the window with
    the settling pause after the opacity reset at step 20 (4 views + 5
    steps), cull-only passes after the window, only alive gaussians
    returned, and a resumed run picking up the schedules."""
    jc, tc, gt, pts, cols = _loop_setup(n_pts=30, size=24)
    log = []
    cfg = tpre.PretrainConfig(
        num_steps=46, capacity_mult=200.0, eval_every=0, num_downscales=1,
        resolution_schedule=20, sh_degree_interval=10,
        densify=td.DensifyConfig(warmup=2, refine_every=5, stop_at=40,
                                 reset_alpha_every=20, grad_thresh=1e-7))
    scene, m = tpre.pretrain(tc, gt, pts, cols, cfg, sh_degree=1,
                             log_fn=lambda s, x: log.append((s, x)),
                             device="cpu")
    refines = [s for s, x in log if "n_split" in x]
    assert refines == [10, 15, 30, 35, 40, 45]
    post = [x for s, x in log if "n_split" in x and s >= 40]
    assert all(x["n_split"] == x["n_dup"] == x["n_born"] == 0 for x in post)
    assert np.isfinite(m["loss"]) and scene.num_gaussians == [
        x for _, x in log if "n_alive" in x][-1]["n_alive"]
    # resume from the result at step 46 for 4 more steps
    cfg2 = dataclasses.replace(cfg, num_steps=50)
    scene2, m2 = tpre.pretrain(tc, gt, pts, cols, cfg2, sh_degree=1,
                               init_scene=scene, start_step=46, device="cpu")
    assert np.isfinite(m2["loss"]) and scene2.num_gaussians > 0


def test_pretrain_grows_its_buffer():
    """2,730 seeds start in 4,096 slots (1.5 × the seeds, rounded up to 4,096);
    a refine that duplicates every visible gaussian fills it past 80%, the
    buffer doubles to 8,192, Adam follows the new leaves with its steps
    kept, and the next step trains on."""
    jc, tc, gt, pts, cols = _loop_setup(n_pts=60, size=24)
    rng = np.random.default_rng(0)
    seeds = (np.repeat(pts, 46, 0)[:2730]
             + rng.normal(scale=0.01, size=(2730, 3))).astype(np.float32)
    log, seen = [], {}
    real_adopt = tpre.adopt_params

    def adopt(opt, scene):
        real_adopt(opt, scene)
        seen["steps"] = {float(opt.state[g["params"][0]]["step"])
                         for g in opt.param_groups}
        seen["leaves"] = all(g["params"][0] is getattr(scene, g["name"])
                             for g in opt.param_groups)

    cfg = tpre.PretrainConfig(
        num_steps=14, capacity_mult=4.0, eval_every=0, num_downscales=0,
        densify=td.DensifyConfig(warmup=1, refine_every=4, stop_at=100,
                                 reset_alpha_every=1000, grad_thresh=0.0,
                                 densify_size_thresh=10.0, cull_opacity=0.0))
    tpre.adopt_params = adopt
    try:
        scene, m = tpre.pretrain(tc, gt, seeds, np.full_like(seeds, 0.5), cfg,
                                 sh_degree=1, device="cpu",
                                 log_fn=lambda s, x: log.append((s, x)))
    finally:
        tpre.adopt_params = real_adopt
    stats = [x for s, x in log if "n_dup" in x]
    assert [s for s, x in log if "n_dup" in x] == [12]
    assert stats[0]["n_alive"] > 0.8 * 4096
    assert [x["capacity"] for _, x in log if "capacity" in x] == [8192]
    assert seen == {"steps": {13.0}, "leaves": True}
    assert np.isfinite(m["loss"]) and scene.num_gaussians == stats[0]["n_alive"]
