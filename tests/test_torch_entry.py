"""The port's `entry()`, the flagship denoise step of the root
`__graft_entry__.py`, against the JAX `entry` step on carried weights, on
the CPU at `SDConfig.tiny()` widths. `dryrun_multichip(2)` is held in
`test_torch_mesh_pipeline.py`, which reuses its ranks' results.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from gaussctrl_tpu.diffusion.config import SDConfig as JSDConfig
from gaussctrl_tpu.diffusion.ddim import DDIMSchedule as JDDIMSchedule
from gaussctrl_tpu.diffusion.ddim import ddim_step as j_ddim_step
from gaussctrl_tpu.diffusion.ddim import timestep_pairs as j_timestep_pairs
from gaussctrl_tpu.diffusion.processors import CrossViewAttnProcessor as JProc
from gaussctrl_tpu.diffusion.sample import SDModels as JSDModels
from gaussctrl_tpu.diffusion.sample import eps_model as j_eps_model

from gaussctrl_tpu_torch.diffusion.bridge import load_flax_params
from gaussctrl_tpu_torch.diffusion.config import SDConfig
from gaussctrl_tpu_torch.entry import entry

from test_torch_diffusion import random_flax_params

torch.set_num_threads(2)


def _jax_entry_step(params, latents, ctx, disp):
    """The body of `__graft_entry__.entry`'s `fn` at `SDConfig.tiny()`."""
    models = JSDModels.create(JSDConfig.tiny(), dtype=jnp.float32)
    sched = JDDIMSchedule.sd15()
    ts, ts_prev = j_timestep_pairs(20)

    @jax.jit
    def fn(params, latents, ctx, disp):
        xin = jnp.concatenate([latents, latents])
        eps = j_eps_model(models, params, xin, ts[0], ctx, disp, 1.0,
                          unet_processor=JProc(1, 0.6, 2),
                          controlnet_processor=JProc(1, 0.0, 2))
        eps_u, eps_c = jnp.split(eps, 2)
        eps = eps_u + 5.0 * (eps_c - eps_u)
        return j_ddim_step(sched, latents, eps.astype(latents.dtype), ts[0],
                           ts_prev[0])

    return np.asarray(fn(params, jnp.asarray(latents), jnp.asarray(ctx),
                         jnp.asarray(disp)))


def test_entry_step_matches_jax_entry_step():
    """`entry()` at `SDConfig.tiny()` widths on the CPU: on its zero weights
    and inputs the step is finite and of the latents' shape; on weights
    carried from one numpy-drawn JAX tree and random inputs it equals the
    JAX `entry` step at rtol/atol 2e-4 (float32, the pipeline test's
    tolerance for latents)."""
    fn, (models, latents, ctx, disp) = entry(device="cpu",
                                             sd_config=SDConfig.tiny(),
                                             dtype=torch.float32)
    out = fn(models, latents, ctx, disp)
    assert out.shape == latents.shape == (2, 8, 8, 4)
    assert bool(torch.isfinite(out).all())

    params = random_flax_params(JSDModels.create(JSDConfig.tiny()), seed=2)
    load_flax_params(models, params)
    rng = np.random.default_rng(4)
    lat = rng.normal(size=latents.shape).astype(np.float32)
    c = rng.normal(size=ctx.shape).astype(np.float32)
    d = rng.uniform(size=disp.shape).astype(np.float32)
    got = fn(models, torch.tensor(lat), torch.tensor(c), torch.tensor(d))
    want = _jax_entry_step(jax.tree_util.tree_map(jnp.asarray, params),
                           lat, c, d)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)

