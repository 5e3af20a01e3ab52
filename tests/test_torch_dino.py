"""The port's GroundingDINO (`gaussctrl_tpu_torch.seg.dino`) and its loader
against the JAX package's: the phrase masks, the deformable sampling, the
tokenizer, the forward pass, the box proposer, and the grounded masker and
LangSAM over it.

Tiny configuration (`DinoConfig.tiny()`) on the CPU in float32. The
forward is held on two routes: a parameter tree carried with
`diffusion.bridge.load_dino_params`, and the JAX tests' torch state dict
(`tests/test_dino.py::_fake_torch_sd`) written as the official checkpoint
layout and read by both packages' loaders. Tolerances: logits and boxes
within 1e-4 of their largest magnitude (seen ~1e-6), boxes in pixels and
masks exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussctrl_tpu.seg import dino as jdino
from gaussctrl_tpu.seg import grounding as jground

from gaussctrl_tpu_torch.diffusion.bridge import load_dino_params
from gaussctrl_tpu_torch.seg import dino as tdino
from gaussctrl_tpu_torch.seg import grounding as tground

from test_dino import CFG, _fake_torch_sd, _text_inputs
from test_torch_seg import carried_sam, close, random_tree, _save_pth

torch.set_num_threads(2)

VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", ".", "?", "bear", "pol", "##ar",
         "the"] + [f"tok{i}" for i in range(40)]


@pytest.fixture(scope="module")
def vocab(tmp_path_factory):
    return write_vocab(tmp_path_factory.mktemp("vocab") / "vocab.txt")


def _t(x):
    return torch.as_tensor(np.asarray(x))


class JaxDino:
    """The JAX model and a parameter tree, its forward compiled once."""

    def __init__(self, params):
        self.model = jdino.GroundingDINO(CFG)
        self.params = jax.tree_util.tree_map(jnp.asarray, params)
        self.fwd = jax.jit(lambda p, *a: self.model.apply({"params": p}, *a))

    def __call__(self, *args):
        return self.fwd(self.params, *args)


def carried_dino(seed=4):
    """(JAX, port) GroundingDINO on one random tree carried by the bridge."""
    ids, pos, attn, mask = _text_inputs()
    shapes = jax.eval_shape(lambda: jdino.GroundingDINO(CFG).init(
        jax.random.PRNGKey(0), jnp.zeros((1, CFG.img_size, CFG.img_size, 3)),
        ids, pos, attn, mask)["params"])
    params = random_tree(shapes, seed)
    model = tdino.GroundingDINO(tdino.DinoConfig.tiny())
    load_dino_params(model, params)
    return JaxDino(params), model.eval()


def write_vocab(path):
    path.write_text("\n".join(VOCAB) + "\n")
    return str(path)


@pytest.fixture(scope="module")
def dinos():
    return carried_dino()


def _inputs(b, seed):
    ids, pos, attn, mask = (np.repeat(x, b, 0) for x in _text_inputs())
    im = np.random.default_rng(seed).normal(
        size=(b, CFG.img_size, CFG.img_size, 3)).astype(np.float32)
    return im, ids, pos, attn, mask


def _forward(model, im, ids, pos, attn, mask):
    logits, boxes = model(_t(im), _t(ids).long(), _t(pos).long(), _t(attn),
                          _t(mask))
    return logits.numpy(), boxes.numpy()


def test_config_matches():
    import dataclasses
    for name in ("swin_b", "tiny"):
        assert dataclasses.asdict(getattr(tdino.DinoConfig, name)()) == \
            dataclasses.asdict(getattr(jdino.DinoConfig, name)())


def test_phrase_masks_match():
    """Per-phrase attention masks and restarting position ids."""
    rng = np.random.default_rng(0)
    ids = rng.integers(5, 20, size=(3, 12))
    ids[:, 0] = 101
    ids[0, [3, 7]] = 1012
    ids[1, [5, 11]] = 102
    ids[2, 1] = 1012
    for a, b in zip(tdino.phrase_masks(ids, (101, 102, 1012)),
                    jdino.phrase_masks(ids, (101, 102, 1012))):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("spread", [(0.1, 0.9), (-0.4, 1.4)])
def test_deform_sample_matches(spread):
    """Bilinear samples over two levels × three points × two heads, summed
    with weights; the wide spread puts many points outside the grid, where
    they contribute zero."""
    rng = np.random.default_rng(1)
    shapes = [(4, 6), (2, 3)]
    val = rng.normal(size=(2, 24 + 6, 2, 5)).astype(np.float32)
    locs = rng.uniform(*spread, size=(2, 7, 2, 2, 3, 2)).astype(np.float32)
    w = rng.uniform(size=(2, 7, 2, 2, 3)).astype(np.float32)
    got = tdino.deform_sample(_t(val), shapes, _t(locs), _t(w))
    ref = jdino.deform_sample(jnp.asarray(val), shapes, jnp.asarray(locs),
                              jnp.asarray(w))
    close(got.numpy(), ref)


def test_deform_sample_zero_far_outside():
    out = tdino.deform_sample(torch.ones(1, 16, 1, 2), [(4, 4)],
                              torch.full((1, 1, 1, 1, 1, 2), 2.0),
                              torch.ones(1, 1, 1, 1, 1))
    assert out.abs().max() == 0


def test_dino_forward_matches(dinos):
    """Contrastive logits (real tokens) and boxes of every query, batch 2."""
    jm, tm = dinos
    args = _inputs(2, 2)
    logits, boxes = jm(*args)
    tl, tb = _forward(tm, *args)
    n = int(args[4][0].sum())
    close(tl[:, :, :n], np.asarray(logits)[:, :, :n])
    assert tl[:, :, n:].max() < -1e8
    close(tb, boxes)


def test_load_dino_from_checkpoint_matches_jax(tmp_path, vocab):
    """The official layout (nested under "model", "module." prefixes, the
    shared box head's copies, Swin's relative_position_index buffers,
    BERT's pooler and position_ids) read by both loaders runs the same; a
    key the model does not know raises."""
    from gaussctrl_tpu.seg.dino_weights import load_dino as j_load_dino
    from gaussctrl_tpu_torch.seg.dino_weights import load_dino

    sd = _fake_torch_sd()
    sd["backbone.0.layers.0.blocks.0.attn.relative_position_index"] = \
        np.zeros((CFG.window ** 2,) * 2, np.int64)
    sd["bert.pooler.dense.weight"] = np.zeros((CFG.bert_hidden,) * 2, np.float32)
    sd["bert.embeddings.position_ids"] = np.arange(512)[None]
    for j in range(3):
        for k in ("weight", "bias"):
            sd[f"transformer.decoder.bbox_embed.0.layers.{j}.{k}"] = \
                sd[f"bbox_embed.0.layers.{j}.{k}"]
    p = tmp_path / "groundingdino_tiny.pth"
    _save_pth(p, sd, nest_model=True, module_prefix=True)
    jmodel, jparams, jtok = j_load_dino(str(p), vocab, cfg=CFG)
    tmodel, ttok = load_dino(str(p), vocab, cfg=tdino.DinoConfig.tiny())
    args = _inputs(1, 3)
    logits, boxes = JaxDino(jparams)(*args)
    tl, tb = _forward(tmodel, *args)
    n = int(args[4][0].sum())
    close(tl[:, :, :n], np.asarray(logits)[:, :, :n])
    close(tb, boxes)
    assert ttok.encode("the polar bear.") == jtok.encode("the polar bear.")
    sd["transformer.unknown.weight"] = np.zeros(2, np.float32)
    _save_pth(p, sd, nest_model=True, module_prefix=True)
    with pytest.raises(RuntimeError, match="unknown"):
        load_dino(str(p), vocab, cfg=tdino.DinoConfig.tiny())


@pytest.mark.parametrize("text", ["The polar bear.", "zzz bear?", "a  bear . the",
                                  "POLAR"])
def test_wordpiece_tokenizer_matches(vocab, text):
    """Token ids, the special set and decode against the JAX tokenizer."""
    t, j = tdino.WordPieceTokenizer(vocab), jdino.WordPieceTokenizer(vocab)
    assert t.encode(text) == j.encode(text)
    assert t.specials == j.specials and t.pad == j.pad
    assert t.decode(t.encode(text)) == j.decode(j.encode(text))


@pytest.fixture(scope="module")
def proposers(dinos, vocab):
    jm, tm = dinos
    tok = tdino.WordPieceTokenizer(vocab)
    jprop = jdino.DinoBoxProposer(jm.model, jm.params,
                                  jdino.WordPieceTokenizer(vocab),
                                  box_threshold=0.0)
    return jprop, tdino.DinoBoxProposer(tm, tok, box_threshold=0.0)


def test_dino_proposer_matches(proposers):
    """Each view's best box (threshold 0: every view gets one) over two
    batches, and one image's detections, scores and phrases above 0.3."""
    jprop, tprop = proposers
    jprop.batch = tprop.batch = 2
    imgs = np.random.default_rng(4).uniform(size=(3, 40, 48, 3)).astype(np.float32)
    got, ref = tprop(imgs, "bear"), jprop(imgs, "bear")
    close(got, ref)
    assert (got[:, 2] > got[:, 0]).all()
    b, s, ph = tprop.predict_boxes(imgs[0], "bear", 0.3, 0.25)
    jb, js, jph = jprop.predict_boxes(imgs[0], "bear", 0.3, 0.25)
    close(b, jb)
    close(s, js)
    assert ph == jph and len(ph) > 0


@pytest.fixture(scope="module")
def dino_maskers(proposers):
    jsam, tsam, _ = carried_sam()
    jprop, tprop = proposers
    return (jground.GroundedSAMMasker(jsam, jprop),
            tground.GroundedSAMMasker(tsam, tprop))


def test_grounded_masker_with_dino_matches_jax(dino_maskers):
    """GroundingDINO boxes -> SAM masks on three views: binary masks equal
    to the JAX masker's."""
    jm, tm = dino_maskers
    imgs = np.random.default_rng(5).uniform(size=(3, 40, 48, 3)).astype(np.float32)
    got = tm(torch.tensor(imgs), "bear").numpy()
    assert set(np.unique(got)) <= {0.0, 1.0}
    np.testing.assert_array_equal(got, np.asarray(jm(jnp.asarray(imgs), "bear")))


def test_langsam_predict_with_dino_matches_jax(dino_maskers):
    """LangSAM.predict's four outputs with GroundingDINO boxes (every
    detection above 0.3, best first), and the empty result of an
    impossible threshold."""
    jm, tm = dino_maskers
    img = np.random.default_rng(6).uniform(size=(56, 48, 3)).astype(np.float32)
    got = tground.LangSAM(tm.sam, tm.proposer).predict(img, "bear", 0.3)
    ref = jground.LangSAM(jm.sam, jm.proposer).predict(img, "bear", 0.3)
    assert len(got[1]) > 0
    np.testing.assert_array_equal(got[0], np.asarray(ref[0]))
    close(got[1], ref[1])
    assert got[2] == ref[2]
    close(got[3], ref[3])
    masks, boxes, phrases, logits = tground.LangSAM(tm.sam, tm.proposer).predict(
        img, "bear", box_threshold=2.0)
    assert masks.shape == (0, 56, 48) and len(boxes) == 0 == len(phrases)


@pytest.mark.slow
def test_swin_b_tree_carries_onto_the_port():
    """At Swin-B width (768 px, 900 queries, BERT-base) every leaf of the
    JAX GroundingDINO's tree lands on a parameter of the port's module with
    its shape, and every parameter is filled."""
    from test_torch_seg import _zeros_like_shapes
    cfg = jdino.DinoConfig.swin_b()
    t = cfg.max_text_len
    shapes = jax.eval_shape(lambda: jdino.GroundingDINO(cfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, cfg.img_size, cfg.img_size, 3)),
        jnp.zeros((1, t), jnp.int32), jnp.zeros((1, t), jnp.int32),
        jnp.ones((1, t, t), bool), jnp.ones((1, t), bool))["params"])
    load_dino_params(tdino.GroundingDINO(tdino.DinoConfig.swin_b()),
                     _zeros_like_shapes(shapes))
