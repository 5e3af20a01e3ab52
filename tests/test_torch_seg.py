"""The port's segmentation stack (`gaussctrl_tpu_torch.seg`: SAM, the CLIP
vision tower and box proposer, the grounded masker, LangSAM, the loaders)
against the JAX package's, and the masked pipeline.

Tiny configurations on the CPU in float32. The JAX modules' parameter
trees, their leaves moved off their initial values with numpy noise so that
zero-initialised tables (relative positions, position embeddings) matter,
are carried into the port with `diffusion.bridge`; the loaders are held on
`.pth` files and HF directories written here. Tolerances: outputs agree
within 1e-4 of their largest magnitude (float32 through a few layers;
seen ~1e-6), boxes and masks exactly.
"""

import copy
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussctrl_tpu.diffusion.clip import CLIPTextConfig as JTextCfg
from gaussctrl_tpu.diffusion.clip import CLIPTextModel as JTextModel
from gaussctrl_tpu.diffusion.clip import CLIPVisionConfig as JVisionCfg
from gaussctrl_tpu.diffusion.clip import CLIPVisionModel as JVisionModel
from gaussctrl_tpu.diffusion.clip import HashTokenizer as JHash
from gaussctrl_tpu.seg import grounding as jground
from gaussctrl_tpu.seg.sam import SAM as JSAM
from gaussctrl_tpu.seg.sam import SAMConfig as JSAMConfig
from gaussctrl_tpu.seg.sam import window_partition as j_partition

from gaussctrl_tpu_torch.diffusion.bridge import (load_clip_params,
                                                  load_sam_params)
from gaussctrl_tpu_torch.diffusion.clip import (CLIPModel, CLIPVisionConfig,
                                                HashTokenizer)
from gaussctrl_tpu_torch.diffusion.config import CLIPTextConfig
from gaussctrl_tpu_torch.seg import grounding as tground
from gaussctrl_tpu_torch.seg.sam import (SAM, SAMConfig, window_partition,
                                         window_unpartition)
from gaussctrl_tpu_torch.seg.weights import sam_for_checkpoint

torch.set_num_threads(2)

REL_TOL = 1e-4


def close(got, ref, tol=REL_TOL):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    if got.size:
        err = np.abs(got - ref).max()
        assert err <= tol * max(1.0, np.abs(ref).max()), err


def random_tree(shapes, seed):
    """A numpy parameter tree of the JAX package's shapes (from
    `jax.eval_shape`, nothing compiled): kernels N(0, 1/fan_in), norm scales
    1 + N(0, 0.05²), every other leaf N(0, 0.2²) so that tables the JAX
    package initialises to zero (relative positions, position embeddings)
    take part."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        if name == "kernel":
            std = 1.0 / np.sqrt(np.prod(s.shape[:-1]))
        elif name == "scale":
            return (1.0 + 0.05 * rng.normal(size=s.shape)).astype(np.float32)
        else:
            std = 0.2
        return (std * rng.normal(size=s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


class JaxSAM:
    """The JAX SAM with its two calls compiled once (it runs them op by op)."""

    def __init__(self, sam):
        self.sam, self.cfg = sam, sam.cfg
        self.encode = jax.jit(sam.encode)
        self.predict_boxes = jax.jit(sam.predict_boxes)


def carried_sam(seed=0):
    """(JAX SAM, port SAM, numpy params) at SAMConfig.tiny(), one tree."""
    params = random_tree(jax.eval_shape(
        lambda: JSAM.create(JSAMConfig.tiny()).params), seed)
    jsam = JSAM(cfg=JSAMConfig.tiny(),
                params=jax.tree_util.tree_map(jnp.asarray, params))
    tsam = SAM(SAMConfig.tiny())
    load_sam_params(tsam, params)
    return JaxSAM(jsam), tsam.eval(), params


def clip_shapes():
    vcfg, tcfg = JVisionCfg.tiny(), JTextCfg.tiny()
    k = jax.random.PRNGKey(0)
    return {
        "vision": jax.eval_shape(lambda: JVisionModel(vcfg).init(
            k, jnp.zeros((1, vcfg.image_size, vcfg.image_size, 3)))["params"]),
        "text": jax.eval_shape(lambda: JTextModel(tcfg).init(
            k, jnp.zeros((1, tcfg.max_position_embeddings), jnp.int32)
        )["params"]),
        "visual_projection": jax.ShapeDtypeStruct(
            (vcfg.hidden_size, vcfg.projection_dim), jnp.float32),
        "text_projection": jax.ShapeDtypeStruct(
            (tcfg.hidden_size, vcfg.projection_dim), jnp.float32),
    }


def carried_clip(seed=1):
    """(JAX ClipBoxProposer, port ClipBoxProposer, numpy params) on the tiny
    CLIP towers with one carried tree and the hash tokenizer."""
    params = random_tree(clip_shapes(), seed)
    jprop = jground.ClipBoxProposer(
        JVisionModel(JVisionCfg.tiny()), JTextModel(JTextCfg.tiny()),
        jax.tree_util.tree_map(jnp.asarray, params),
        JHash(JTextCfg.tiny().vocab_size, JTextCfg.tiny().max_position_embeddings))
    clip = CLIPModel(CLIPVisionConfig.tiny(), CLIPTextConfig.tiny())
    load_clip_params(clip, params)
    tprop = tground.ClipBoxProposer(
        clip.eval(), HashTokenizer(CLIPTextConfig.tiny().vocab_size,
                                   CLIPTextConfig.tiny().max_position_embeddings))
    return jprop, tprop, params


@pytest.fixture(scope="module")
def sams():
    return carried_sam()


@pytest.fixture(scope="module")
def clips():
    return carried_clip()


def _images(v, h, w, seed):
    return np.random.default_rng(seed).uniform(size=(v, h, w, 3)).astype(np.float32)


# --------------------------------------------------------------------------
# SAM
# --------------------------------------------------------------------------

@pytest.mark.parametrize("hw", [(10, 14), (8, 8)])
def test_window_partition_matches_and_round_trips(hw):
    """Padding to a multiple of the window and the crop back: the port's
    windows are the JAX package's, and unpartition inverts them."""
    x = np.random.default_rng(0).normal(size=(2, *hw, 8)).astype(np.float32)
    win, pad = window_partition(torch.tensor(x), 4)
    jwin, jpad = j_partition(jnp.asarray(x), 4)
    assert pad == jpad
    np.testing.assert_array_equal(win.numpy(), np.asarray(jwin))
    np.testing.assert_array_equal(
        window_unpartition(win, 4, pad, hw).numpy(), x)


def test_sam_encode_and_decode_match(sams):
    """Image embeddings, mask logits and IoU of box prompts (one inside the
    frame, one with a corner on it, one off-centre) against the JAX SAM."""
    jsam, tsam, _ = sams
    img = _images(3, 64, 64, 1)
    emb = jsam.encode(jnp.asarray(img))
    temb = tsam.encode(torch.tensor(img))
    close(temb.numpy(), emb)
    boxes = np.array([[4, 4, 40, 40], [0, 0, 60, 60], [30, 20, 62, 50]],
                     np.float32)
    m, iou = jsam.predict_boxes(emb, jnp.asarray(boxes))
    tm, tiou = tsam.predict_boxes(torch.tensor(np.asarray(emb)),
                                  torch.tensor(boxes))
    assert tm.shape == (3, 4 * SAMConfig.tiny().grid, 4 * SAMConfig.tiny().grid)
    close(tm.numpy(), m)
    close(tiou.numpy(), iou)
    # the box moves the mask
    assert (tm[0] - tm[2]).abs().max() > 1e-5


def test_sam_global_attention_blocks_match_unblocked(sams, monkeypatch):
    """The global block's attention computed in blocks of query rows equals
    it computed whole."""
    from gaussctrl_tpu_torch.seg import sam as tsam_mod
    _, tsam, _ = sams
    img = torch.tensor(_images(1, 64, 64, 2))
    whole = tsam.encode(img)
    monkeypatch.setattr(tsam_mod, "QUERY_BLOCK", 8)     # one grid row a block
    close(tsam.encode(img).numpy(), whole.numpy(), 1e-6)


def _save_pth(path, sd, nest_model=False, module_prefix=False):
    t = {("module." if module_prefix else "") + k:
         torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}
    torch.save({"model": t} if nest_model else t, path)


def test_load_sam_from_pth_matches_jax(sams, tmp_path):
    """A facebook-layout .pth (the JAX tests' `_fake_sam_sd`, with the
    prompt encoder's mask-prompt weights a real checkpoint also holds) read
    by both packages' loaders runs the same; a missing key raises."""
    from gaussctrl_tpu.seg.weights import load_sam as j_load_sam
    from gaussctrl_tpu_torch.seg.weights import load_sam
    from test_sam import _fake_sam_sd

    _, _, params = sams
    sd = _fake_sam_sd(params)
    c = SAMConfig.tiny().out_chans
    rng = np.random.default_rng(3)
    sd["prompt_encoder.not_a_point_embed.weight"] = rng.normal(size=(1, c))
    sd["prompt_encoder.mask_downscaling.0.weight"] = rng.normal(size=(4, 1, 2, 2))
    p = tmp_path / "sam_tiny.pth"
    _save_pth(p, sd)
    loaded = j_load_sam(str(p), cfg=JSAMConfig.tiny())
    jsam = JaxSAM(JSAM(cfg=loaded.cfg, params=jax.tree_util.tree_map(
        jnp.asarray, loaded.params)))
    tsam = load_sam(str(p), cfg=SAMConfig.tiny())
    img = _images(1, 64, 64, 4)
    boxes = np.array([[4.0, 4.0, 60.0, 60.0]], np.float32)
    m, iou = jsam.predict_boxes(jsam.encode(jnp.asarray(img)), jnp.asarray(boxes))
    tm, tiou = tsam.predict_boxes(tsam.encode(torch.tensor(img)),
                                  torch.tensor(boxes))
    close(tm.numpy(), m)
    close(tiou.numpy(), iou)
    del sd["mask_decoder.iou_token.weight"]
    _save_pth(p, sd)
    with pytest.raises(RuntimeError, match="iou_token"):
        load_sam(str(p), cfg=SAMConfig.tiny())


def test_sam_config_from_checkpoint_width():
    """The loader's config detection is the JAX loader's: pos_embed width
    1280/1024/768 means ViT-H/L/B; an explicit config wins."""
    assert sam_for_checkpoint(1280) == SAMConfig.vit_h()
    assert sam_for_checkpoint(1024) == SAMConfig.vit_l()
    assert sam_for_checkpoint(768) == SAMConfig.vit_b()
    assert sam_for_checkpoint(32, SAMConfig.tiny()) == SAMConfig.tiny()
    for name in ("vit_h", "vit_l", "vit_b", "tiny"):
        assert dataclasses.asdict(getattr(SAMConfig, name)()) == \
            dataclasses.asdict(getattr(JSAMConfig, name)())


def test_bridge_raises_on_unused_or_missing_sam_leaves(sams):
    _, _, params = sams
    extra = dict(params, extra={"w": np.zeros(2, np.float32)})
    with pytest.raises(KeyError, match="unused"):
        load_sam_params(SAM(SAMConfig.tiny()), extra)
    enc = dict(params["image_encoder"])
    del enc["pos_embed"]
    with pytest.raises(KeyError, match="pos_embed"):
        load_sam_params(SAM(SAMConfig.tiny()), dict(params, image_encoder=enc))


# --------------------------------------------------------------------------
# CLIP vision tower and the CLIP box proposer
# --------------------------------------------------------------------------

def test_clip_towers_match(clips):
    """The vision tower's tokens (post-LN, every token) and the pooled,
    projected text embedding against the JAX towers."""
    jp, tp, params = clips
    x = np.random.default_rng(5).normal(size=(2, 32, 32, 3)).astype(np.float32)
    ref = jp.vision.apply({"params": jp.params["vision"]}, jnp.asarray(x))
    close(tp.clip.vision_model(torch.tensor(x)).detach().numpy(), ref)
    ids = np.stack([jp.tokenizer.encode("a bear"), jp.tokenizer.encode("x y z")])
    ref = jp.text.apply({"params": jp.params["text"]}, jnp.asarray(ids),
                        jp.params["text_projection"], method=JTextModel.embed)
    close(tp.clip.text_embed(torch.tensor(ids).long()).detach().numpy(), ref)


def test_clip_heatmap_and_boxes_match(clips):
    """The patch/text heatmap, each view's best box and the multi-detection
    contract (scores best first) agree with the JAX proposer."""
    jp, tp, _ = clips
    imgs = _images(4, 48, 40, 6)
    close(tp._sims(torch.tensor(imgs), "a bear"),
          jp._sims(jnp.asarray(imgs), "a bear"))
    np.testing.assert_array_equal(tp(torch.tensor(imgs), "a bear"),
                                  jp(jnp.asarray(imgs), "a bear"))
    for thr in (0.0, 0.55):
        b, s, ph = tp.predict_boxes(imgs[0], "a bear", box_threshold=thr)
        jb, js, jph = jp.predict_boxes(imgs[0], "a bear", box_threshold=thr)
        np.testing.assert_array_equal(b, jb)
        close(s, js)
        assert ph == jph


def test_label_components_match():
    """Connected components and their order come out as the JAX package's
    host numpy makes them."""
    rng = np.random.default_rng(7)
    for _ in range(5):
        hot = rng.uniform(size=(12, 12)) > 0.6
        a, b = tground._label_components(hot), jground._label_components(hot)
        assert len(a) == len(b)
        for (ys, xs), (jys, jxs) in zip(a, b):
            np.testing.assert_array_equal(ys, jys)
            np.testing.assert_array_equal(xs, jxs)


# --------------------------------------------------------------------------
# the mask machinery with controlled inputs (tests/test_mask_iou.py)
# --------------------------------------------------------------------------

H, W, G = 96, 128, 16


def _two_blobs():
    s = np.zeros((G, G), np.float32)
    s[2:6, 3:7] = 1.0
    s[10:14, 9:13] = 0.9
    return s


class _TorchOracleSAM:
    """Logits positive exactly inside each box (encoder pixels)."""

    def __init__(self, img_size=64):
        self.cfg = types.SimpleNamespace(img_size=img_size)
        self.device = torch.device("cpu")

    def encode(self, images01):
        return torch.zeros(images01.shape[0], 1, 1, 1)

    def predict_boxes(self, emb, boxes):
        s = self.cfg.img_size
        yy = torch.arange(s, dtype=torch.float32)[None, :, None] + 0.5
        xx = torch.arange(s, dtype=torch.float32)[None, None, :] + 0.5
        b = boxes[:, None, None]
        inside = ((xx >= b[..., 0]) & (xx < b[..., 2])
                  & (yy >= b[..., 1]) & (yy < b[..., 3]))
        return torch.where(inside, 1.0, -1.0), torch.ones(boxes.shape[0])


def _patched(prop, heat):
    prop = copy.copy(prop)
    prop._sims = lambda images, prompt: np.broadcast_to(
        heat, (images.shape[0],) + heat.shape[-2:])
    return prop


@pytest.mark.parametrize("heat", ["two_blobs", "none"])
def test_mask_machinery_matches_jax(clips, heat):
    """Injected heatmaps and an oracle SAM: boxes, scores, the LangSAM
    masks of every detection (nearest resize back to 96×128) and the
    grounded masker's per-view masks, including the all-zero masks of views
    without a box, equal the JAX package's."""
    from test_mask_iou import _OracleSAM

    jp, tp, _ = clips
    hm = _two_blobs() if heat == "two_blobs" else np.full((G, G), -1.0, np.float32)
    jp, tp = _patched(jp, hm), _patched(tp, hm)
    img = np.zeros((H, W, 3), np.float32)
    b, s, _ = tp.predict_boxes(img, "a bear")
    jb, js, _ = jp.predict_boxes(img, "a bear")
    np.testing.assert_array_equal(b, jb)
    np.testing.assert_array_equal(s, js)

    tls, jls = (tground.LangSAM(_TorchOracleSAM(), tp),
                jground.LangSAM(_OracleSAM(), jp))
    got, jgot = tls.predict(img, "a bear"), jls.predict(img, "a bear")
    np.testing.assert_array_equal(got[0], np.asarray(jgot[0]))
    assert got[2] == jgot[2]

    tm = tground.GroundedSAMMasker(_TorchOracleSAM(), tp, batch=2)
    jm = jground.GroundedSAMMasker(_OracleSAM(), jp, batch=2)
    mask = tm(torch.zeros(3, H, W, 3), "a bear").numpy()
    np.testing.assert_array_equal(mask, np.asarray(jm(jnp.zeros((3, H, W, 3)),
                                                      "a bear")))
    if heat == "none":
        assert mask.max() == 0.0
    else:
        assert mask[:, 12:36, 24:56].min() == 1.0 and mask.mean() < 0.2


def test_resize_nearest_is_jax_nearest():
    """`nearest-exact` is `jax.image.resize(..., "nearest")` at sizes that
    do not divide (256 -> 200, 32 -> 48x40)."""
    x = np.random.default_rng(8).uniform(size=(2, 256, 256, 1)).astype(np.float32)
    np.testing.assert_array_equal(
        tground.resize_nearest(torch.tensor(x), 200, 200).numpy(),
        np.asarray(jax.image.resize(jnp.asarray(x), (2, 200, 200, 1), "nearest")))
    x = x[:, :32, :32]
    np.testing.assert_array_equal(
        tground.resize_nearest(torch.tensor(x), 48, 40).numpy(),
        np.asarray(jax.image.resize(jnp.asarray(x), (2, 48, 40, 1), "nearest")))


# --------------------------------------------------------------------------
# the grounded masker and LangSAM with carried networks
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def clip_maskers(sams, clips):
    jsam, tsam, _ = sams
    jp, tp, _ = clips
    return (jground.GroundedSAMMasker(jsam, jp),
            tground.GroundedSAMMasker(tsam, tp))


def test_grounded_masker_matches_jax(clip_maskers):
    """CLIP boxes -> SAM masks on five 48×40 views (two batches): binary
    masks equal to the JAX masker's."""
    jm, tm = clip_maskers
    imgs = _images(5, 48, 40, 9)
    got = tm(torch.tensor(imgs), "a bear").numpy()
    ref = np.asarray(jm(jnp.asarray(imgs), "a bear"))
    assert got.shape == (5, 48, 40, 1)
    assert set(np.unique(got)) <= {0.0, 1.0}
    np.testing.assert_array_equal(got, ref)


def test_langsam_predict_matches_jax(clip_maskers):
    """LangSAM.predict's four outputs (masks, boxes, phrases, logits) on one
    image through the carried SAM and CLIP proposer."""
    jm, tm = clip_maskers
    img = _images(1, 56, 48, 10)[0]
    got = tground.LangSAM(tm.sam, tm.proposer).predict(img, "a bear", 0.0)
    ref = jground.LangSAM(jm.sam, jm.proposer).predict(img, "a bear", 0.0)
    assert len(got[1]) > 0
    np.testing.assert_array_equal(got[0], np.asarray(ref[0]))
    np.testing.assert_array_equal(got[1], ref[1])
    assert got[2] == ref[2]
    close(got[3], ref[3])


def test_build_langsam_equivalent_without_checkpoints():
    """Without checkpoints the stack is tiny, random and on the CPU when
    asked; its masks are binary and of the images' size."""
    m = tground.build_langsam_equivalent(device="cpu")
    assert m.sam.cfg == SAMConfig.tiny()
    out = m(torch.tensor(_images(2, 40, 48, 11)), "a bear")
    assert out.shape == (2, 40, 48, 1)
    assert set(out.unique().tolist()) <= {0.0, 1.0}


# --------------------------------------------------------------------------
# the masked pipeline: render_reverse through edit_images
# --------------------------------------------------------------------------

def test_masked_pipeline_matches_jax(clip_maskers):
    """render_reverse + edit_images on a tiny SD stack with one carried tree
    and the carried CLIP-proposer masker (two 32×32 views): the masks equal
    the JAX pipeline's, the edited images agree within 2e-4, and wherever a mask is
    0 the port's edited image is its unedited render bit for bit."""
    from gaussctrl_tpu.cameras.camera import make_cameras as j_make_cameras
    from gaussctrl_tpu.diffusion.config import SDConfig as JSDConfig
    from gaussctrl_tpu.diffusion.sample import SDModels as JSDModels
    from gaussctrl_tpu.pipeline.gaussctrl import GaussCtrlConfig as JConfig
    from gaussctrl_tpu.pipeline.gaussctrl import GaussCtrlPipeline as JPipeline
    from gaussctrl_tpu.splat.scene import random_scene as j_random_scene

    from gaussctrl_tpu_torch.cameras.camera import make_cameras
    from gaussctrl_tpu_torch.diffusion.config import SDConfig
    from gaussctrl_tpu_torch.pipeline.gaussctrl import (GaussCtrlConfig,
                                                        GaussCtrlPipeline)
    from gaussctrl_tpu_torch.splat.scene import GaussianScene
    from test_torch_diffusion import random_flax_params
    from test_torch_pipeline import _ring_c2ws

    jm, tm = clip_maskers
    # every view gets a box: the random towers' cosines are all below 0 on
    # these renders, under the proposer's default floor
    jprop, tprop = copy.copy(jm.proposer), copy.copy(tm.proposer)
    jprop.min_score = tprop.min_score = -1.0
    jm = jground.GroundedSAMMasker(jm.sam, jprop)
    tm = tground.GroundedSAMMasker(tm.sam, tprop)
    v, size = 2, 32
    kw = dict(edit_prompt="a red scene", reverse_prompt="a scene",
              num_inference_steps=1, ref_view_num=1, render_batch=4,
              chunk_size=0, langsam_obj="bear")
    jscene = j_random_scene(jax.random.PRNGKey(0), 200, sh_degree=1, extent=0.5)
    params = random_flax_params(JSDModels.create(JSDConfig.tiny()), seed=2)
    c2ws = _ring_c2ws(v)
    half = size / 2
    jpipe = JPipeline(JConfig(**kw), jscene,
                      j_make_cameras(c2ws, size, size, half, half, size, size),
                      sd_config=JSDConfig.tiny(), masker=jm,
                      sd_params=jax.tree_util.tree_map(jnp.asarray, params),
                      dtype=jnp.float32)
    jpipe.render_reverse()
    jpipe.edit_images()
    scene = GaussianScene(**{k: torch.tensor(np.asarray(getattr(jscene, k)))
                             for k in ("means", "scales", "quats", "opacities",
                                       "features_dc", "features_rest")})
    pipe = GaussCtrlPipeline(GaussCtrlConfig(**kw), scene,
                             make_cameras(c2ws, size, size, half, half, size, size),
                             sd_config=SDConfig.tiny(), sd_params=params,
                             dtype=torch.float32, device="cpu", masker=tm)
    pipe.render_reverse()
    pipe.edit_images()
    masks = pipe.masks.numpy()
    np.testing.assert_array_equal(masks, np.asarray(jpipe.masks))
    assert 0.0 < masks.mean() < 1.0
    close(pipe.edited.numpy(), np.asarray(jpipe.edited), 2e-4)
    off = np.broadcast_to(masks == 0, pipe.edited.shape)
    np.testing.assert_array_equal(pipe.edited.numpy()[off],
                                  pipe.unedited.numpy()[off])


def _zeros_like_shapes(shapes):
    """Read-only zero leaves of the given shapes (no memory per leaf)."""
    return jax.tree_util.tree_map(
        lambda s: np.broadcast_to(np.zeros((), np.float32), s.shape), shapes)


@pytest.mark.slow
@pytest.mark.parametrize("which", ["sam_vit_h", "clip_vit_l14"])
def test_full_width_trees_carry_onto_the_port(which):
    """At the reference's widths (SAM ViT-H; CLIP ViT-L/14 with the SD-1.5
    text tower) every leaf of the JAX package's tree lands on a parameter
    of the port's module with its shape, and every parameter is filled."""
    if which == "sam_vit_h":
        shapes = jax.eval_shape(lambda: JSAM.create(JSAMConfig.vit_h()).params)
        load_sam_params(SAM(SAMConfig.vit_h()), _zeros_like_shapes(shapes))
    else:
        vcfg, tcfg = JVisionCfg.vit_l14(), JTextCfg.sd15()
        k = jax.random.PRNGKey(0)
        shapes = {
            "vision": jax.eval_shape(lambda: JVisionModel(vcfg).init(
                k, jnp.zeros((1, 224, 224, 3)))["params"]),
            "text": jax.eval_shape(lambda: JTextModel(tcfg).init(
                k, jnp.zeros((1, 77), jnp.int32))["params"]),
            "visual_projection": jax.ShapeDtypeStruct((1024, 768), jnp.float32),
            "text_projection": jax.ShapeDtypeStruct((768, 768), jnp.float32)}
        load_clip_params(CLIPModel(CLIPVisionConfig.vit_l14(),
                                   CLIPTextConfig.sd15()),
                         _zeros_like_shapes(shapes))


def test_flax_conv_transpose_is_the_flipped_torch_one():
    """The convention SAM's decoder upscaling rests on (ROADMAP F7): flax's
    `ConvTranspose` with a [kh,kw,I,O] kernel computes torch's
    `conv_transpose2d` with the [I,O,kh,kw] weight flipped in both spatial
    axes, not with the weight as it is; the port reproduces the former."""
    import torch.nn.functional as F
    from flax import linen as nn

    x = np.random.default_rng(12).normal(size=(1, 3, 3, 4)).astype(np.float32)
    m = nn.ConvTranspose(2, (2, 2), strides=(2, 2))
    p = m.init(jax.random.PRNGKey(0), x)
    ref = np.asarray(m.apply(p, x))
    w = torch.tensor(np.asarray(p["params"]["kernel"]).transpose(2, 3, 0, 1))
    b = torch.tensor(np.asarray(p["params"]["bias"]))
    xt = torch.tensor(x).permute(0, 3, 1, 2)

    def run(weight):
        return F.conv_transpose2d(xt, weight, b, stride=2).permute(0, 2, 3, 1).numpy()

    close(run(w.flip(2, 3)), ref, 1e-6)
    assert np.abs(run(w) - ref).max() > 0.1
