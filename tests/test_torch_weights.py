"""Diffusers checkpoints from disk: the port's `diffusion/weights.py` against
the JAX package's `load_sd_params`, at two widths of the layout: SDConfig.tiny()
(two UNet levels) and SD-1.5's four levels at SDConfig.nano() widths with
sample size 16, built the same way in both packages, so that both loaders
are held on `down_blocks.2-3` and `up_blocks.0-3` (no attention in down 3
and up 0).

One random parameter tree in the JAX layout (numpy, seeded; rounded to
fp16 so that fp16 files hold it exactly) is written as synthetic diffusers
directories with tests/test_weights.py's writers, in two layouts:

  safetensors  unet/vae/controlnet `diffusion_pytorch_model.safetensors` and
               text_encoder `model.safetensors`, fp16, written by the port's
               own writer, the text encoder with its I64 `position_ids`
               buffer as transformers saves it; the VAE mid-block under the
               legacy query/key/value/proj_attn names;
  bin          the same as fp16 torch `.bin` files, text_encoder as
               `pytorch_model.bin` (the stem fallback) with a `position_ids`
               buffer, modern VAE names.

The VAE's mid-block q/k/v biases are zero in these files, because the JAX
package has no slot for them; nonzero ones are tested on the port alone.
Both packages read the files and run their forwards in float32 on the CPU:
atol/rtol 1e-4 (the same tolerance as tests/test_torch_diffusion.py, for the
same reason: two frameworks sum convolutions and matmuls in other orders).
"""

import dataclasses
import hashlib
import json
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussctrl_tpu.diffusion import sample as jsample
from gaussctrl_tpu.diffusion.clip import load_tokenizer as j_load_tokenizer
from gaussctrl_tpu.diffusion.config import SDConfig as JSDConfig
from gaussctrl_tpu.diffusion.weights import load_sd_params

from gaussctrl_tpu_torch.cli import train as ttrain
from gaussctrl_tpu_torch.cli.flags import apply_overrides
from gaussctrl_tpu_torch.diffusion import bridge
from gaussctrl_tpu_torch.diffusion import sample as tsample
from gaussctrl_tpu_torch.diffusion import weights as tw
from gaussctrl_tpu_torch.diffusion.clip import (CLIPTokenizer,
                                                load_tokenizer)
from gaussctrl_tpu_torch.diffusion.config import SDConfig

from test_tokenizer_golden import _write_mini_vocab
from test_torch_diffusion import _inputs, random_flax_params
from test_weights import (_fake_clip_sd, _fake_controlnet_sd, _fake_unet_sd,
                          _fake_vae_sd)

torch.set_num_threads(2)

TOL = dict(atol=1e-4, rtol=1e-4)
LEGACY = {"to_q": "query", "to_k": "key", "to_v": "value",
          "to_out.0": "proj_attn"}
QKV_BIASES = [f"{side}.mid_block.attentions.0.{n}.bias"
              for side in ("encoder", "decoder") for n in ("to_q", "to_k", "to_v")]


def _fp16_exact(tree):
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float16).astype(np.float32), tree)


def _vae_sd(params, legacy: bool, bias_value: float = 0.0, seed: int = 0):
    """The VAE's diffusers dict with mid-block q/k/v biases (`bias_value`
    × a seeded normal), under the legacy attention names if asked."""
    sd = _fake_vae_sd(params)
    rng = np.random.default_rng(seed)
    for k in QKV_BIASES:
        c = sd[k.replace(".bias", ".weight")].shape[0]
        sd[k] = (bias_value * rng.normal(size=(c,))).astype(np.float32)
    if legacy:
        out = {}
        for k, v in sd.items():
            if ".mid_block.attentions.0." in k:
                head, leaf = k.rsplit(".", 1)
                for new, old in LEGACY.items():
                    if head.endswith("." + new):
                        head = head[: -len(new)] + old
                k = f"{head}.{leaf}"
            out[k] = v
        sd = out
    return sd


def _sds(params, legacy, vae_bias=0.0):
    return {"unet": _fake_unet_sd(params["unet"]),
            "vae": _vae_sd(params["vae"], legacy, vae_bias),
            "text": _fake_clip_sd(params["text"]),
            "controlnet": _fake_controlnet_sd(params["controlnet"])}


def _write_dirs(root, sds, layout):
    """A diffusers pipeline dir + a ControlNet dir, fp16 files."""
    sd_dir, cn_dir = root / "pipe", root / "controlnet"
    for d in ("unet", "vae", "text_encoder", "tokenizer"):
        (sd_dir / d).mkdir(parents=True)
    cn_dir.mkdir()
    half = {k: {n: torch.tensor(np.asarray(v, np.float32)).half()
                for n, v in sd.items()} for k, sd in sds.items()}
    places = {"unet": sd_dir / "unet", "vae": sd_dir / "vae",
              "controlnet": cn_dir}
    for k, d in places.items():
        if layout == "safetensors":
            tw.save_safetensors(d / "diffusion_pytorch_model.safetensors", half[k])
        else:
            torch.save(half[k], d / "diffusion_pytorch_model.bin")
    text = dict(half["text"])
    n = text["text_model.embeddings.position_embedding.weight"].shape[0]
    text["text_model.embeddings.position_ids"] = torch.arange(n)[None]
    if layout == "safetensors":
        tw.save_safetensors(sd_dir / "text_encoder" / "model.safetensors", text)
    else:
        torch.save(text, sd_dir / "text_encoder" / "pytorch_model.bin")
    _write_mini_vocab(sd_dir / "tokenizer")
    return str(sd_dir), str(cn_dir)


def four_level(config_cls):
    """SD-1.5's four levels and attention pattern at nano widths, at sample
    size 16 (latents 16², images 128²)."""
    return dataclasses.replace(config_cls.nano(), sample_size=16)


WIDTHS = {"tiny": lambda cls: cls.tiny(), "four_level": four_level}


@pytest.fixture(scope="module", params=list(WIDTHS))
def configs(request):
    """(JAX SDConfig, port SDConfig) of one width."""
    return WIDTHS[request.param](JSDConfig), WIDTHS[request.param](SDConfig)


@pytest.fixture(scope="module")
def tree(configs):
    jm = jsample.SDModels.create(configs[0])
    return jm, _fp16_exact(random_flax_params(jm, seed=3))


@pytest.fixture(scope="module", params=["safetensors", "bin"])
def loaded(request, tree, configs, tmp_path_factory):
    """(JAX models, JAX params read from disk, port models read from disk,
    the directories) for one layout."""
    if request.param == "safetensors":
        pytest.importorskip("safetensors")   # the JAX package reads with it
    jm, params = tree
    root = tmp_path_factory.mktemp(f"diffusers_{request.param}")
    sd_dir, cn_dir = _write_dirs(root, _sds(params, request.param == "safetensors"),
                                 request.param)
    jp = jax.tree_util.tree_map(jnp.asarray, load_sd_params(sd_dir, cn_dir))
    tm = tsample.SDModels.create(configs[1], device="cpu")
    tw.load_sd_models(tm, sd_dir, cn_dir)
    return jm, jp, tm, (sd_dir, cn_dir)


def _t(x):
    return torch.tensor(np.asarray(x), dtype=torch.float32)


def _close(got, ref):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("net", ["text", "vae_encode", "vae_decode",
                                 "controlnet_unet"])
def test_loaded_networks_match_jax(loaded, net):
    """Each network read from disk by the port against the JAX package's
    read of the same files, through the same forward (atol/rtol 1e-4)."""
    jm, jp, tm, _ = loaded
    lat, ctx, img = _inputs(jm.cfg, 2, 11)
    if net == "text":
        ids = np.random.default_rng(0).integers(
            0, jm.cfg.text.vocab_size, size=(2, 16)).astype(np.int32)
        _close(tsample.encode_text(tm, torch.tensor(ids)),
               jsample.encode_text(jm, jp, jnp.asarray(ids)))
    elif net == "vae_encode":
        _close(tsample.vae_encode(tm, _t(img)), jsample.vae_encode(jm, jp, img))
    elif net == "vae_decode":
        _close(tsample.vae_decode(tm, _t(lat)), jsample.vae_decode(jm, jp, lat))
    else:
        ref = jsample.eps_model(jm, jp, lat, jnp.int32(501), ctx, img, 1.0)
        got = tsample.eps_model(tm, _t(lat), 501, _t(ctx), _t(img), 1.0)
        _close(got, ref)
        assert float(np.abs(np.asarray(ref)).max()) > 0


def test_loaded_tensors_are_the_written_ones(loaded, tree, configs):
    """The fp16 files read back as float32 equal to the tree, bit for bit
    (the tree is fp16-exact), through the bridge's mapping."""
    _, params = tree
    _, _, tm, _ = loaded
    ref = tsample.SDModels.create(configs[1], device="cpu")
    bridge.load_flax_params(ref, params)
    for a, b in zip(tm.modules(), ref.modules()):
        sa, sb = a.state_dict(), b.state_dict()
        assert sa.keys() == sb.keys()
        for k in sa:
            assert torch.equal(sa[k], sb[k]), k


def test_vae_mid_block_biases_load_and_matter(tree, configs, tmp_path):
    """Nonzero mid-block q/k/v biases (legacy names) load into the port's
    VAE, change its output, and the bridge fills them the same from the
    JAX package's converted tree (`convert_vae` keeps them as
    attn/to_q/bias leaves); zero biases reproduce the JAX VAE (the
    layouts above)."""
    jm, params = tree
    sd = _vae_sd(params["vae"], legacy=True, bias_value=0.5, seed=1)
    d = tmp_path / "vae"
    d.mkdir()
    tw.save_safetensors(d / "diffusion_pytorch_model.safetensors",
                        {k: torch.tensor(v) for k, v in sd.items()})
    tm = tsample.SDModels.create(configs[1], device="cpu")
    bridge.load_flax_params(tm, params)
    lat, _, _ = _inputs(jm.cfg, 2, 12)
    without = tsample.vae_decode(tm, _t(lat))
    tw.load_module(tm.vae, "vae", tw.load_state_dict(str(d)))
    q = tm.vae.decoder.mid_block.attentions[0].to_q.bias
    np.testing.assert_array_equal(
        q.numpy(), sd["decoder.mid_block.attentions.0.query.bias"])
    with_b = tsample.vae_decode(tm, _t(lat))
    assert float((with_b - without).abs().max()) > 1e-3
    from gaussctrl_tpu.diffusion.weights import convert_vae
    via_bridge = tsample.SDModels.create(configs[1], device="cpu")
    bridge.load_flax_params(via_bridge, dict(params, vae=convert_vae(sd)))
    for k, v in tm.vae.state_dict().items():
        assert torch.equal(v, via_bridge.vae.state_dict()[k]), k


def test_strict_keys_name_the_culprit(tree, configs):
    jm, params = tree
    cfg = configs[1]
    sds = {k: {n: torch.tensor(v) for n, v in sd.items()}
           for k, sd in _sds(params, legacy=False).items()}
    vae = tsample.SDModels.create(cfg, device="cpu").vae
    gone = dict(sds["vae"])
    del gone["decoder.conv_out.weight"]
    with pytest.raises(KeyError, match="decoder.conv_out.weight"):
        tw.load_module(vae, "vae", gone)
    stray = dict(sds["vae"], **{"decoder.extra.weight": torch.zeros(2)})
    with pytest.raises(KeyError, match="decoder.extra.weight"):
        tw.load_module(vae, "vae", stray)
    bad = dict(sds["vae"])
    bad["decoder.conv_out.bias"] = torch.zeros(7)
    with pytest.raises(ValueError, match="decoder.conv_out.bias"):
        tw.load_module(vae, "vae", bad)
    ints = dict(sds["vae"])
    ints["decoder.conv_out.bias"] = ints["decoder.conv_out.bias"].long()
    with pytest.raises(ValueError, match="decoder.conv_out.bias"):
        tw.load_module(vae, "vae", ints)
    # a text encoder file's other towers are skipped, its position_ids dropped
    text = dict(sds["text"], **{"vision_model.x.weight": torch.zeros(2),
                                "text_projection.weight": torch.zeros(2, 2),
                                "text_model.embeddings.position_ids":
                                    torch.arange(16)[None]})
    tw.load_module(tsample.SDModels.create(cfg, device="cpu").text,
                   "text", text)
    with pytest.raises(KeyError, match="text_model.encoder.stray.weight"):
        tw.load_module(
            tsample.SDModels.create(cfg, device="cpu").text, "text",
            dict(text, **{"text_model.encoder.stray.weight": torch.zeros(2)}))


def test_one_by_one_reshapes(tree, configs):
    """A [O, I] proj_in (SD-2-style Linear) loads into the 1×1 Conv2d, and
    a [O, I, 1, 1] VAE attention weight (old conv exports) into the Linear."""
    _, params = tree
    unet = _fake_unet_sd(params["unet"])
    key = "down_blocks.0.attentions.0.proj_in.weight"
    flat = {k: torch.tensor(v) for k, v in unet.items()}
    flat[key] = flat[key][:, :, 0, 0].clone()
    m = tsample.SDModels.create(configs[1], device="cpu")
    tw.load_module(m.unet, "unet", flat)
    assert torch.equal(m.unet.state_dict()[key][:, :, 0, 0], flat[key])
    vae = {k: torch.tensor(v) for k, v in _vae_sd(params["vae"], False).items()}
    k = "encoder.mid_block.attentions.0.to_q.weight"
    vae[k] = vae[k][:, :, None, None].clone()
    tw.load_module(m.vae, "vae", vae)
    assert torch.equal(m.vae.state_dict()[k], vae[k][:, :, 0, 0])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16])
def test_safetensors_reader_against_the_package(tmp_path, dtype):
    """The port's reader on a file of the `safetensors` package, and the
    package on a file of the port's writer: the same tensors, as float32."""
    st = pytest.importorskip("safetensors.torch")
    rng = np.random.default_rng(0)
    tensors = {"a.weight": torch.tensor(rng.normal(size=(5, 3))).to(dtype),
               "b": torch.tensor(rng.normal(size=(7,))).to(dtype),
               "scalar": torch.tensor(1.5).to(dtype),
               "empty": torch.zeros((0, 4), dtype=dtype)}
    st.save_file(tensors, str(tmp_path / "pkg.safetensors"),
                 metadata={"format": "pt"})
    got = tw.read_safetensors(tmp_path / "pkg.safetensors")
    assert got.keys() == tensors.keys()
    for k, v in tensors.items():
        assert got[k].dtype == torch.float32 and got[k].shape == v.shape
        assert torch.equal(got[k], v.float()), k
    tw.save_safetensors(tmp_path / "port.safetensors", tensors)
    back = st.load_file(str(tmp_path / "port.safetensors"))
    for k, v in tensors.items():
        assert back[k].dtype == dtype and torch.equal(back[k], v), k


@pytest.mark.parametrize("dtype", [torch.int64, torch.int32, torch.uint8,
                                   torch.bool])
def test_safetensors_reader_keeps_integer_tensors(tmp_path, dtype):
    """Integer and bool tensors (a text encoder's I64 `position_ids`) read
    as stored, both ways against the `safetensors` package."""
    st = pytest.importorskip("safetensors.torch")
    tensors = {"text_model.embeddings.position_ids":
               (torch.arange(77)[None] % 2 if dtype == torch.bool
                else torch.arange(77)[None]).to(dtype),
               "w": torch.ones((2, 3), dtype=torch.float16)}
    st.save_file(tensors, str(tmp_path / "pkg.safetensors"))
    got = tw.read_safetensors(tmp_path / "pkg.safetensors")
    k = "text_model.embeddings.position_ids"
    assert got[k].dtype == dtype and torch.equal(got[k], tensors[k])
    assert got["w"].dtype == torch.float32
    tw.save_safetensors(tmp_path / "port.safetensors", tensors)
    back = st.load_file(str(tmp_path / "port.safetensors"))
    assert back[k].dtype == dtype and torch.equal(back[k], tensors[k])


def test_safetensors_reader_refuses_other_dtypes(tmp_path):
    """A float type other than F32, F16 and BF16 raises, naming it."""
    header = json.dumps({"f": {"dtype": "F64", "shape": [2],
                               "data_offsets": [0, 16]}}).encode()
    path = tmp_path / "f64.safetensors"
    path.write_bytes(struct.pack("<Q", len(header)) + header + bytes(16))
    with pytest.raises(ValueError, match="F64"):
        tw.read_safetensors(path)


def test_load_state_dict_stems(tmp_path, capsys):
    """model ↔ pytorch_model fall back to each other (logged); a diffusers
    stem never falls back to a transformers one; bf16 reads as float32."""
    d = tmp_path / "enc"
    d.mkdir()
    torch.save({"w": torch.ones((2, 2), dtype=torch.bfloat16)},
               d / "pytorch_model.bin")
    sd = tw.load_state_dict(str(d), "model")
    assert sd["w"].dtype == torch.float32 and torch.equal(sd["w"], torch.ones(2, 2))
    assert "loading equivalent 'pytorch_model.*'" in capsys.readouterr().out
    with pytest.raises(FileNotFoundError):
        tw.load_state_dict(str(d))
    with pytest.raises(FileNotFoundError):
        tw.load_state_dict(str(tmp_path / "nope"))


def test_load_tokenizer_matches_jax(tmp_path):
    """`<ckpt>/tokenizer/{vocab.json,merges.txt}` selects the BPE tokenizer
    in both packages, with the same ids (the mini vocabulary of
    tests/test_tokenizer_golden.py); no directory selects the hash one."""
    (tmp_path / "tokenizer").mkdir()
    _write_mini_vocab(tmp_path / "tokenizer")
    cfg, jcfg = SDConfig.tiny().text, JSDConfig.tiny().text
    tok = load_tokenizer(str(tmp_path), cfg)
    jtok = j_load_tokenizer(str(tmp_path), jcfg)
    assert isinstance(tok, CLIPTokenizer)
    for text in ("bear cat", "  BEAR \n Cat ", "act", "a bear, a cat!",
                 "bear " * 30):
        np.testing.assert_array_equal(tok.encode(text), jtok.encode(text))
    assert not isinstance(load_tokenizer(str(tmp_path / "none"), cfg),
                          CLIPTokenizer)


def test_pipeline_from_disk_matches_sd_params(loaded, tree, configs):
    """A tiny GaussCtrlPipeline built from the directories through
    --pipeline.diffusion_ckpt/--pipeline.controlnet_ckpt (parsed by the
    CLI) holds the same weights as one built from the tree via
    `sd_params`, and both take the BPE tokenizer of the directory."""
    from gaussctrl_tpu_torch.cameras.camera import make_cameras
    from gaussctrl_tpu_torch.pipeline.gaussctrl import (GaussCtrlConfig,
                                                        GaussCtrlPipeline)
    from gaussctrl_tpu_torch.splat.scene import random_scene
    _, params = tree
    sd_dir, cn_dir = loaded[3]
    args = ttrain.build_parser().parse_args(
        ["--data", "x", "--load-checkpoint", "y",
         "--pipeline.diffusion_ckpt", sd_dir,
         "--pipeline.controlnet_ckpt", cn_dir])
    cfg = apply_overrides(GaussCtrlConfig(), args, "pipeline")
    assert (cfg.diffusion_ckpt, cfg.controlnet_ckpt) == (sd_dir, cn_dir)
    scene = random_scene(torch.Generator().manual_seed(0), 16, sh_degree=1)
    cams = make_cameras(np.eye(4, dtype=np.float32)[None, :3], 32, 32, 16, 16,
                        32, 32)
    kw = dict(sd_config=configs[1], dtype=torch.float32, device="cpu")
    disk = GaussCtrlPipeline(cfg, scene, cams, **kw)
    tree_pipe = GaussCtrlPipeline(cfg, scene, cams, sd_params=params, **kw)
    for a, b in zip(disk.models.modules(), tree_pipe.models.modules()):
        for k, v in a.state_dict().items():
            assert torch.equal(v, b.state_dict()[k]), k
    assert isinstance(disk.tokenizer, CLIPTokenizer)
    np.testing.assert_array_equal(disk.tokenizer.encode("a bear"),
                                  tree_pipe.tokenizer.encode("a bear"))
    with pytest.raises(ValueError, match="controlnet_ckpt"):
        GaussCtrlPipeline(GaussCtrlConfig(controlnet_ckpt=cn_dir), scene, cams,
                          **kw)


def _file_sha256(path) -> str:
    return hashlib.sha256(open(path, "rb").read()).hexdigest()


def test_seeded_writer_is_deterministic(tmp_path):
    """`write_seeded_sd` at the four-level width: the same seed gives the
    same bytes (the sha256 it returns is the file's), and another seed
    gives other bytes in every file."""
    cfg = four_level(SDConfig)
    first = tw.write_seeded_sd(str(tmp_path / "a"), 0, cfg, threads=2)
    again = tw.write_seeded_sd(str(tmp_path / "b"), 0, cfg, threads=1)
    other = tw.write_seeded_sd(str(tmp_path / "c"), 1, cfg, threads=2)
    assert sorted(first) == sorted(tw.SEEDED_FILES.values())
    assert first == again
    for rel, digest in first.items():
        assert _file_sha256(tmp_path / "a" / rel) == digest, rel
        assert other[rel] != digest, rel


def test_seeded_files_load_strictly_in_both_packages(tmp_path):
    """The seeded files at the four-level width: the port loads them
    strictly; the JAX package's `load_sd_params` gives a tree with every
    leaf of its models' own and no other but the VAE mid-block's q/k/v
    biases (zero in the files; the JAX VAE has no slot for them), each of
    its shape; both read the same values, and the text encoder and the
    VAE decoder agree at atol/rtol 1e-4."""
    pytest.importorskip("safetensors")   # the JAX package reads with it
    cfg, jcfg = four_level(SDConfig), four_level(JSDConfig)
    tw.write_seeded_sd(str(tmp_path), 0, cfg, threads=2)
    sd_dir = str(tmp_path / tw.SEEDED_SD_DIR)
    cn_dir = str(tmp_path / tw.SEEDED_CN_DIR)
    tm = tsample.SDModels.create(cfg, device="cpu")
    tw.load_sd_models(tm, sd_dir, cn_dir)
    jm = jsample.SDModels.create(jcfg)
    want = {jax.tree_util.keystr(p): v.shape for p, v in
            jax.tree_util.tree_leaves_with_path(
                jax.eval_shape(jm.init_params, jax.random.PRNGKey(0)))}
    tree = load_sd_params(sd_dir, cn_dir)
    got = {jax.tree_util.keystr(p): v for p, v in
           jax.tree_util.tree_leaves_with_path(tree)}
    extra = sorted(set(got) - set(want))
    assert extra == sorted(
        f"['vae']['{side}']['mid_block']['attentions_0']['attn']['{n}']['bias']"
        for side in ("decoder", "encoder") for n in ("to_k", "to_q", "to_v"))
    assert all(not np.any(got[k]) for k in extra)
    assert sorted(set(want) - set(got)) == []
    for k, shape in want.items():
        assert got[k].shape == shape, k
    ref = tsample.SDModels.create(cfg, device="cpu")
    bridge.load_flax_params(ref, tree)
    for a, b in zip(tm.modules(), ref.modules()):
        for k, v in a.state_dict().items():
            assert torch.equal(v, b.state_dict()[k]), k
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    ids = np.random.default_rng(1).integers(
        0, cfg.text.vocab_size, size=(2, cfg.text.max_position_embeddings)
    ).astype(np.int32)
    _close(tsample.encode_text(tm, torch.tensor(ids)),
           jsample.encode_text(jm, jp, jnp.asarray(ids)))
    lat, _, _ = _inputs(jcfg, 2, 13)
    _close(tsample.vae_decode(tm, _t(lat)), jsample.vae_decode(jm, jp, lat))
