"""The port's diffusion stack against the JAX package at SDConfig.tiny().

One parameter tree is drawn with numpy from a seed in the JAX package's
layout (shapes from `SDModels.init_params` via `jax.eval_shape`; every leaf
random, so the ControlNet's zero convs carry signal too) and carried into the
port with `bridge.load_flax_params`. Inputs are numpy arrays from a seed;
both sides run in float32 on the CPU, NHWC at the public functions.
Tolerance: atol/rtol 1e-4 unless a test says otherwise — the two frameworks
sum convolutions and matmuls in other orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussctrl_tpu.diffusion import sample as jsample
from gaussctrl_tpu.diffusion import ddim as jddim
from gaussctrl_tpu.diffusion.clip import HashTokenizer as JHash
from gaussctrl_tpu.diffusion.config import SDConfig as JSDConfig
from gaussctrl_tpu.diffusion.processors import (
    CrossViewAttnProcessor as JCross)

from gaussctrl_tpu_torch.diffusion import bridge
from gaussctrl_tpu_torch.diffusion import ddim as tddim
from gaussctrl_tpu_torch.diffusion import sample as tsample
from gaussctrl_tpu_torch.diffusion.clip import HashTokenizer
from gaussctrl_tpu_torch.diffusion.config import SDConfig
from gaussctrl_tpu_torch.diffusion.processors import (
    CrossViewAttnProcessor, FlashSelfAttnProcessor)

torch.set_num_threads(2)

TOL = dict(atol=1e-4, rtol=1e-4)


def random_flax_params(models, seed=0):
    """A full parameter tree in the JAX layout, every leaf drawn from numpy."""
    shapes = jax.eval_shape(models.init_params, jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        if name == "kernel":
            std = 1.0 / np.sqrt(np.prod(s.shape[:-1]))
        elif name == "scale":
            return (1.0 + 0.05 * rng.normal(size=s.shape)).astype(np.float32)
        elif name == "embedding":
            std = 1.0 / np.sqrt(s.shape[-1])
        else:                       # biases, position embedding
            std = 0.05
        return (std * rng.normal(size=s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


@pytest.fixture(scope="module")
def stacks():
    jm = jsample.SDModels.create(JSDConfig.tiny())
    params = random_flax_params(jm)
    tm = tsample.SDModels.create(SDConfig.tiny(), device="cpu")
    bridge.load_flax_params(tm, params)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    return jm, jparams, tm, params


def _t(x):
    return torch.tensor(np.asarray(x), dtype=torch.float32)


def _close(got, ref, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               **(tol or TOL))


def _inputs(cfg, b, seed):
    rng = np.random.default_rng(seed)
    s = cfg.sample_size
    lat = rng.normal(size=(b, s, s, 4)).astype(np.float32)
    ctx = rng.normal(size=(b, cfg.text.max_position_embeddings,
                           cfg.unet.cross_attention_dim)).astype(np.float32)
    img = rng.uniform(size=(b, s * 8, s * 8, 3)).astype(np.float32)
    return lat, ctx, img


def test_bridge_raises_on_unused_or_missing_leaves(stacks):
    _, _, _, params = stacks
    tm = tsample.SDModels.create(SDConfig.tiny(), device="cpu")
    extra = dict(params, text=dict(params["text"], stray={"kernel": np.zeros((2, 2))}))
    with pytest.raises(KeyError, match="unused"):
        bridge.load_flax_params(tm, extra)
    short = dict(params, text={k: v for k, v in params["text"].items()
                               if k != "final_layer_norm"})
    with pytest.raises(KeyError, match="final_layer_norm"):
        bridge.load_flax_params(tm, short)


def test_text_encoder_matches(stacks):
    jm, jp, tm, _ = stacks
    tok = HashTokenizer(SDConfig.tiny().text.vocab_size, 16)
    ids = np.stack([tok.encode("a photo of a bear"), tok.encode("a statue")])
    ref = jsample.encode_text(jm, jp, jnp.asarray(ids))
    got = tsample.encode_text(tm, torch.tensor(ids))
    _close(got, ref)


def test_vae_encode_matches(stacks):
    jm, jp, tm, _ = stacks
    _, _, img = _inputs(jm.cfg, 2, 1)
    _close(tsample.vae_encode(tm, _t(img)), jsample.vae_encode(jm, jp, img))


def test_vae_decode_matches(stacks):
    jm, jp, tm, _ = stacks
    lat, _, _ = _inputs(jm.cfg, 2, 2)
    _close(tsample.vae_decode(tm, _t(lat)), jsample.vae_decode(jm, jp, lat))


def test_embed_hint_matches(stacks):
    jm, jp, tm, _ = stacks
    _, _, img = _inputs(jm.cfg, 2, 3)
    _close(tsample.embed_hint(tm, _t(img)), jsample.embed_hint(jm, jp, img))


def test_controlnet_matches(stacks):
    """Every down residual and the mid residual (zero convs random here)."""
    jm, jp, tm, _ = stacks
    lat, ctx, img = _inputs(jm.cfg, 2, 4)
    t = np.array([10, 900])
    down_r, mid_r = jm.controlnet.apply({"params": jp["controlnet"]}, lat, t,
                                        ctx, img)
    down, mid = tm.controlnet(tsample.nhwc_to_nchw(_t(lat)), torch.tensor(t),
                              _t(ctx), tsample.nhwc_to_nchw(_t(img)))
    assert len(down) == len(down_r)
    for d, r in zip(down, down_r):
        _close(tsample.nchw_to_nhwc(d), r)
    _close(tsample.nchw_to_nhwc(mid), mid_r)
    assert float(np.abs(np.asarray(mid_r)).max()) > 0


def test_unet_matches(stacks):
    """UNet with ControlNet residuals added on every skip and the mid block."""
    jm, jp, tm, _ = stacks
    lat, ctx, img = _inputs(jm.cfg, 2, 5)
    t = np.array([10, 900])
    down_r, mid_r = jm.controlnet.apply({"params": jp["controlnet"]}, lat, t,
                                        ctx, img)
    ref = jm.unet.apply({"params": jp["unet"]}, lat, t, ctx, None, down_r, mid_r)
    down = [tsample.nhwc_to_nchw(_t(d)) for d in down_r]
    got = tm.unet(tsample.nhwc_to_nchw(_t(lat)), torch.tensor(t), _t(ctx),
                  None, down, tsample.nhwc_to_nchw(_t(mid_r)))
    _close(tsample.nchw_to_nhwc(got), ref)


@pytest.mark.parametrize("proc", ["none", "flash", "cross_view"])
def test_eps_model_matches(stacks, proc):
    """eps_model under each processor. The port's processors take their
    kernels' plain versions on the CPU; the JAX side computes the same
    functions with einsum (no processor, or its composed cross-view)."""
    jm, jp, tm, _ = stacks
    lat, ctx, img = _inputs(jm.cfg, 4, 6)
    if proc == "none":
        jproc = tproc = tcproc = jcproc = None
    elif proc == "flash":
        jproc = jcproc = None
        tproc = tcproc = FlashSelfAttnProcessor()
    else:
        jproc, jcproc = JCross(2, 0.6, 2), JCross(2, 0.0, 2)
        tproc, tcproc = CrossViewAttnProcessor(2, 0.6, 2), CrossViewAttnProcessor(2, 0.0, 2)
    ref = jsample.eps_model(jm, jp, lat, jnp.int32(501), ctx, img, 1.0,
                            jproc, jcproc)
    got = tsample.eps_model(tm, _t(lat), 501, _t(ctx), _t(img), 1.0, tproc,
                            tcproc)
    _close(got, ref)


def test_ddim_schedule_and_steps_match():
    """Timestep pairs identical; both step directions within 1e-6."""
    for n in (2, 10, 20):
        jt, jtp = jddim.timestep_pairs(n)
        tt, ttp = tddim.timestep_pairs(n)
        assert tt == np.asarray(jt).tolist() and ttp == np.asarray(jtp).tolist()
    js, ts = jddim.DDIMSchedule.sd15(), tddim.DDIMSchedule.sd15()
    np.testing.assert_array_equal(ts.alphas_cumprod, np.asarray(js.alphas_cumprod))
    rng = np.random.default_rng(9)
    x, eps = rng.normal(size=(2, 3, 4)).astype(np.float32), rng.normal(size=(2, 3, 4)).astype(np.float32)
    for t, tp in ((951, 901), (1, -49)):
        np.testing.assert_allclose(
            tddim.ddim_step(ts, _t(x), _t(eps), t, tp).numpy(),
            np.asarray(jddim.ddim_step(js, x, eps, t, tp)), atol=1e-6)
        np.testing.assert_allclose(
            tddim.ddim_inverse_step(ts, _t(x), _t(eps), t, tp).numpy(),
            np.asarray(jddim.ddim_inverse_step(js, x, eps, t, tp)), atol=1e-6)


@pytest.mark.parametrize("rho", [0.0, 0.85])
def test_invert_matches(stacks, rho):
    """Two-step inversion; the port's lane goes through K2's processor.
    EasyInv ρ = 0.85 blends the high-noise iterates (t ≥ 400)."""
    jm, jp, tm, _ = stacks
    lat, ctx, img = _inputs(jm.cfg, 3, 7)
    sched = jddim.DDIMSchedule.sd15()
    ref = jsample.invert(jm, jp, sched, lat, ctx, img, num_steps=2,
                         easyinv_rho=rho)
    got = tsample.invert(tm, tddim.DDIMSchedule.sd15(), _t(lat), _t(ctx),
                         _t(img), num_steps=2, easyinv_rho=rho,
                         unet_processor=FlashSelfAttnProcessor(),
                         controlnet_processor=FlashSelfAttnProcessor())
    _close(got, ref, atol=2e-4, rtol=2e-4)


def test_denoise_matches(stacks):
    """Two-step CFG denoise with the cross-view processors on both nets
    (F = 3 views, 2 refs, [uncond | cond] groups); atol/rtol 2e-4."""
    jm, jp, tm, _ = stacks
    lat, ctx, img = _inputs(jm.cfg, 3, 8)
    neg = np.random.default_rng(10).normal(size=ctx.shape).astype(np.float32)
    sched = jddim.DDIMSchedule.sd15()
    ref = jsample.denoise(jm, jp, sched, lat, ctx, neg, img, 5.0, 2,
                          unet_processor=JCross(2, 0.6, 2),
                          controlnet_processor=JCross(2, 0.0, 2))
    got = tsample.denoise(tm, tddim.DDIMSchedule.sd15(), _t(lat), _t(ctx),
                          _t(neg), _t(img), 5.0, 2,
                          unet_processor=CrossViewAttnProcessor(2, 0.6, 2),
                          controlnet_processor=CrossViewAttnProcessor(2, 0.0, 2))
    _close(got, ref, atol=2e-4, rtol=2e-4)


def test_init_params_matches_flax_scales():
    """The port's own random init draws lecun-normal kernels as flax does:
    per-layer std within 10% of 1/√fan_in, zero biases, zeroed ControlNet
    output convs."""
    tm = tsample.SDModels.create(SDConfig.tiny(), device="cpu")
    tm.init_params(seed=0)
    w = tm.unet.down_blocks[0].resnets[0].conv1.weight
    fan_in = w[0].numel()
    assert abs(float(w.std()) * np.sqrt(fan_in) - 1.0) < 0.1
    assert float(tm.unet.down_blocks[0].resnets[0].conv1.bias.abs().max()) == 0.0
    assert float(tm.controlnet.controlnet_mid_block.weight.abs().max()) == 0.0
    tok = HashTokenizer(SDConfig.tiny().text.vocab_size, 16)
    jtok = JHash(SDConfig.tiny().text.vocab_size, 16)
    np.testing.assert_array_equal(tok.encode("a photo of a bear"),
                                  jtok.encode("a photo of a bear"))
