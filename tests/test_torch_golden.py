"""The port held against the JAX package at the reference's widths.

`tests/golden/torch_sd15.npz` holds the JAX package's outputs of the cases
of `gaussctrl_tpu_torch/golden.py` (SD-1.5 widths; a 200,000-gaussian scene
at 512²), computed on the CPU in float32 from seeded weight files both
packages read (`scripts/torch_golden.py`, which regenerates it). This file
imports no JAX: the port reads the same inputs and weights and is compared
with the file.

`test_golden_file` (fast) checks the file itself: its size cap, the seeds,
the cases and shapes, the sha256 of the scene arrays the port draws, and
the weight files' names and hashes. The `slow` tests (not in tier-1; run
them with `JAX_PLATFORMS=cpu python -m pytest tests/test_torch_golden.py -m
slow`) write the SD-1.5 weight files from their seed (2.7 GB in a temporary
directory), refuse unless every sha256 equals the golden's, and run every
case on the CPU in float32. Each output is held to its relative RMS and
largest absolute error in `golden.tolerances()`, stated there with the
reason for each: relative RMS 1e-4 for every float output and 1e-3 for
the gradients; largest absolute error 1e-4 of the output's largest value
for the diffusion stages, 2e-3 and 4e-3 on `run`'s z_T and edits, 1/255 of
the largest value on the renders (the blend's alpha gate is a step that an
ulp can move) and 1e-2 of each field's largest golden gradient; the
counters and reference views exactly; the stepped scene rows within what
their Adam steps can move, and in `reopt_step` no step the other way where
the gradient is signal.
"""

import os

import numpy as np
import pytest
import torch

from gaussctrl_tpu_torch import golden as g
from gaussctrl_tpu_torch.diffusion import weights as tw

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "torch_sd15.npz")
MAX_BYTES = 16 * 2**20


@pytest.fixture(scope="module")
def golden():
    with np.load(GOLDEN) as f:
        return {k: f[k] for k in f.files}


def test_golden_file(golden):
    """The file's size cap, seeds, cases, shapes and hashes."""
    assert os.path.getsize(GOLDEN) <= MAX_BYTES
    assert golden["meta.seeds"].tolist() == [g.WEIGHTS_SEED, g.INPUT_SEED]
    assert golden["meta.cases"].tolist() == list(g.CASES)
    assert sorted(golden["meta.weight_files"].tolist()) == sorted(
        tw.SEEDED_FILES.values())
    assert all(len(h) == 64 for h in golden["meta.weight_sha256"].tolist())
    scene = g.scene_arrays()
    assert golden["meta.scene_fields"].tolist() == list(g.FIELDS)
    assert golden["meta.scene_sha256"].tolist() == [g.sha256(scene[f])
                                                    for f in g.FIELDS]
    shapes = dict(s.split(":") for s in golden["meta.shapes"].tolist())
    arrays = {k for k in golden if not k.startswith("meta.")}
    assert set(shapes) == arrays
    for k in arrays:
        assert shapes[k] == str(list(golden[k].shape)), k
    for case, outputs in g.tolerances().items():
        for name in outputs:
            assert f"{case}.{name}" in arrays, (case, name)
        assert all(np.isfinite(golden[f"{case}.{n}"]).all() for n in outputs)
    assert int(golden["meta.run_ddim_steps"]) in (1, 2)
    render = g.case_inputs("render")
    assert golden["render.rgb"].shape == (
        g.RENDER_VIEWS, g.SIZE // g.STRIDE, g.SIZE // g.STRIDE, 3)
    assert render["c2ws"].shape == (g.RENDER_VIEWS, 3, 4)


@pytest.fixture(scope="module")
def weight_dirs(golden, tmp_path_factory):
    """The SD-1.5 weight files, rewritten from the seed; refused unless
    every file's sha256 is the golden's."""
    root = str(tmp_path_factory.mktemp("golden_weights"))
    hashes = tw.write_seeded_sd(root, g.WEIGHTS_SEED)
    want = dict(zip(golden["meta.weight_files"].tolist(),
                    golden["meta.weight_sha256"].tolist()))
    assert hashes == want, "the seeded weight files differ from the golden's"
    return (os.path.join(root, tw.SEEDED_SD_DIR),
            os.path.join(root, tw.SEEDED_CN_DIR))


@pytest.fixture(scope="module")
def models(weight_dirs):
    from gaussctrl_tpu_torch.diffusion.config import SDConfig
    from gaussctrl_tpu_torch.diffusion.sample import SDModels
    m = SDModels.create(SDConfig.sd15(), device="cpu")
    tw.load_sd_models(m, *weight_dirs)
    return m


@pytest.mark.slow
@pytest.mark.parametrize("case", g.CASES)
def test_port_matches_golden(case, golden, weight_dirs, request):
    """One case of the port on the CPU in float32 against the JAX
    package's output, each output within `golden.tolerances()[case]`."""
    torch.set_num_threads(os.cpu_count() or 1)
    models = request.getfixturevalue("models") if case in g.DIFFUSION_CASES \
        else None
    x = g.case_inputs(case)
    got = g.port_case(
        case, x, "cpu", models=models, sd_dirs=weight_dirs,
        background=golden["reopt_step.background"],
        backgrounds=golden["run.backgrounds"],
        ddim_steps=int(golden["meta.run_ddim_steps"]))
    errs = g.compare(got, golden, case)
    print(case, errs)
    assert set(errs) == set(g.tolerances()[case])
    bad = g.over_tolerance(case, errs)
    assert not bad, bad
    if case == "reopt_step":
        flips = g.flips_on_signal(got, golden)
        print("flips on signal", flips)
        assert not any(flips.values()), flips
