"""The port's CLIP metrics (`gaussctrl_tpu_torch.metrics`) and its CLIPModel
loader against the JAX package's.

Tiny CLIP towers on the CPU in float32, one parameter tree carried into the
port with `diffusion.bridge.load_clip_params`, and a transformers-layout
CLIPModel directory written here with the port's safetensors writer and
read by both packages. Tolerance: embeddings within 1e-4 of their largest
magnitude, the metrics (cosines) within 1e-5 (seen ~1e-7).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussctrl_tpu.diffusion.clip import CLIPTextConfig as JTextCfg
from gaussctrl_tpu.diffusion.clip import CLIPTextModel as JTextModel
from gaussctrl_tpu.diffusion.clip import CLIPVisionConfig as JVisionCfg
from gaussctrl_tpu.diffusion.clip import CLIPVisionModel as JVisionModel
from gaussctrl_tpu.diffusion.clip import HashTokenizer as JHash
from gaussctrl_tpu import metrics as jmetrics

from gaussctrl_tpu_torch import metrics as tmetrics
from gaussctrl_tpu_torch.diffusion import weights as tw
from gaussctrl_tpu_torch.diffusion.bridge import load_clip_params
from gaussctrl_tpu_torch.diffusion.clip import (CLIPModel, CLIPVisionConfig,
                                                HashTokenizer)
from gaussctrl_tpu_torch.diffusion.config import CLIPTextConfig

from test_torch_seg import clip_shapes, close, random_tree

torch.set_num_threads(2)


def jax_scorer(params):
    tcfg = JTextCfg.tiny()
    return jmetrics.CLIPScorer(
        JVisionModel(JVisionCfg.tiny()), JTextModel(tcfg),
        {k: (jnp.asarray(v) if not isinstance(v, dict) else v)
         for k, v in params.items()},
        JHash(tcfg.vocab_size, tcfg.max_position_embeddings))


def port_scorer(clip):
    tcfg = CLIPTextConfig.tiny()
    return tmetrics.CLIPScorer(
        clip.eval(), HashTokenizer(tcfg.vocab_size, tcfg.max_position_embeddings))


def carried_scorers(seed=7):
    """(JAX CLIPScorer, port CLIPScorer, numpy params) on one tree."""
    params = random_tree(clip_shapes(), seed)
    clip = CLIPModel(CLIPVisionConfig.tiny(), CLIPTextConfig.tiny())
    load_clip_params(clip, params)
    return jax_scorer(params), port_scorer(clip), params


@pytest.fixture(scope="module")
def scorers():
    return carried_scorers()


def _images(n, seed, h=40, w=48):
    return np.random.default_rng(seed).uniform(size=(n, h, w, 3)).astype(np.float32)


def test_scorer_embeddings_match(scorers):
    """Image embeddings (antialiased resize 40×48 -> 32, class token,
    projection) and text embeddings (EOS pooling, projection)."""
    js, ts, _ = scorers
    imgs = _images(3, 0)
    close(ts.embed_images(imgs).numpy(), js.embed_images(jnp.asarray(imgs)))
    prompts = ["a polar bear", "a bronze bear statue", "x"]
    close(ts.embed_texts(prompts).numpy(), js.embed_texts(prompts))


def test_clip_metrics_match(scorers):
    """Similarity and directional similarity, and determinism."""
    js, ts, _ = scorers
    edited, original = _images(3, 1), _images(3, 2)
    s = tmetrics.clip_similarity(ts, edited, "a bronze bear")
    assert abs(s - jmetrics.clip_similarity(js, edited, "a bronze bear")) <= 1e-5
    assert s == tmetrics.clip_similarity(ts, edited, "a bronze bear")
    d = tmetrics.clip_directional_similarity(ts, edited, original, "a panda",
                                             "a bear")
    jd = jmetrics.clip_directional_similarity(js, edited, original, "a panda",
                                              "a bear")
    assert -1.0 <= d <= 1.0 and abs(d - jd) <= 1e-5


def test_directional_similarity_rejects_unpaired(scorers):
    _, ts, _ = scorers
    with pytest.raises(ValueError, match="paired views"):
        tmetrics.clip_directional_similarity(ts, _images(2, 3), _images(3, 4),
                                             "x", "y")


def write_clip_dir(path, clip: CLIPModel):
    """A transformers CLIPModel directory: model.safetensors with both
    towers, the projections, logit_scale and the I64 position_ids buffers."""
    path.mkdir(parents=True, exist_ok=True)
    sd = {k: v.detach().clone() for k, v in clip.state_dict().items()}
    sd["logit_scale"] = torch.tensor(2.6592)
    sd["text_model.embeddings.position_ids"] = torch.arange(
        clip.text_cfg.max_position_embeddings)[None]
    sd["vision_model.embeddings.position_ids"] = torch.arange(
        1 + clip.vision_cfg.grid ** 2)[None]
    tw.save_safetensors(path / "model.safetensors", sd)
    return path


def test_load_clip_model_from_dir_matches_jax(scorers, tmp_path):
    """The directory read by both packages' loaders gives the same
    embeddings; every tensor of the port's model is the file's; a tensor
    the model does not have raises."""
    from gaussctrl_tpu.diffusion.weights import load_clip_model as j_load

    _, ts, _ = scorers
    d = write_clip_dir(tmp_path / "clip", ts.clip)
    loaded = tw.load_clip_model(str(d), CLIPVisionConfig.tiny(),
                                CLIPTextConfig.tiny())
    for k, v in ts.clip.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v), k
    js, ls = jax_scorer(j_load(str(d))), port_scorer(loaded)
    imgs = _images(2, 5)
    close(ls.embed_images(imgs).numpy(), js.embed_images(jnp.asarray(imgs)))
    close(ls.embed_texts(["a bear"]).numpy(), js.embed_texts(["a bear"]))
    sd = tw.read_safetensors(d / "model.safetensors")
    sd["vision_model.extra.weight"] = torch.zeros(2)
    tw.save_safetensors(d / "model.safetensors", sd)
    with pytest.raises(RuntimeError, match="extra"):
        tw.load_clip_model(str(d), CLIPVisionConfig.tiny(), CLIPTextConfig.tiny())


def test_scorer_from_dir_without_weights_is_tiny_and_on_request_cpu():
    s = tmetrics.CLIPScorer.from_dir(None, device="cpu")
    assert s.clip.vision_cfg == CLIPVisionConfig.tiny()
    e = s.embed_images(_images(2, 6))
    assert e.shape == (2, CLIPVisionConfig.tiny().projection_dim)
    assert torch.isfinite(e).all()
