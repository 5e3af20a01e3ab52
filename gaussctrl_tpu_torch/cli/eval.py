"""`python -m gaussctrl_tpu_torch.cli.eval`: CLIP metrics of an edit.

Counterpart of `gaussctrl_tpu/cli/eval.py`: the CLIP text-image similarity
of the edited renders against the edit prompt and, given the unedited
renders and the reverse prompt, the directional similarity of
(original -> edited) against (reverse prompt -> edit prompt). Prints one
JSON object; with `--run <edit run dir>` the directories and prompts come
from the run's config.json and the object is also written to
`<run>/eval_metrics.json`. `--clip-ckpt` names a transformers CLIPModel
directory (ViT-L/14); without it the towers are tiny random ones and the
numbers say so. Runs on the card unless `--device cpu`.

    python -m gaussctrl_tpu_torch.cli.eval --run outputs/bear/gaussctrl/<time> \\
        --clip-ckpt <clip dir>
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np


def _load_images(d: Path) -> np.ndarray:
    from PIL import Image

    files = sorted(list(d.glob("*.png")) + list(d.glob("*.jpg")))
    if not files:
        raise FileNotFoundError(f"no images in {d}")
    return np.stack([np.asarray(Image.open(f).convert("RGB"), np.float32) / 255.0
                     for f in files])


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="gaussctrl-eval")
    p.add_argument("--run", default=None,
                   help="a gaussctrl run directory: reads edited/unedited "
                        "dirs and both prompts from its config.json and "
                        "writes eval_metrics.json back into the run")
    p.add_argument("--edited", default=None, help="dir of edited renders")
    p.add_argument("--original", default=None, help="dir of unedited renders")
    p.add_argument("--edit-prompt", default=None)
    p.add_argument("--reverse-prompt", default=None)
    p.add_argument("--clip-ckpt", default="",
                   help="local HF CLIPModel dir (random towers if omitted — "
                        "numbers are then only self-consistent)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; 'cpu' on request)")
    return p


def main(argv=None):
    p = build_parser()
    args = p.parse_args(argv)
    if args.run:
        run = Path(args.run)
        cfg = json.loads((run / "config.json").read_text())
        pipe = cfg.get("pipeline", cfg)
        args.edited = args.edited or str(run / "edited")
        if (run / "unedited").is_dir():
            args.original = args.original or str(run / "unedited")
        args.edit_prompt = args.edit_prompt or pipe["edit_prompt"]
        args.reverse_prompt = args.reverse_prompt or pipe.get("reverse_prompt")
    if not args.edited or not args.edit_prompt:
        p.error("--edited and --edit-prompt are required unless --run is given")

    from gaussctrl_tpu_torch.metrics import (CLIPScorer,
                                             clip_directional_similarity,
                                             clip_similarity)

    scorer = CLIPScorer.from_dir(args.clip_ckpt or None, device=args.device)
    edited = _load_images(Path(args.edited))
    out = {
        "clip_similarity": clip_similarity(scorer, edited, args.edit_prompt),
        "num_views": int(edited.shape[0]),
        "real_clip_weights": bool(args.clip_ckpt),
        # random towers give deterministic numbers that say nothing of
        # the edit's quality; "weights" names the checkpoint when one is used
        "weights": args.clip_ckpt or "random",
        "quality_meaningful": bool(args.clip_ckpt),
    }
    if not args.clip_ckpt:
        out["note"] = ("structural-only: CLIP towers are randomly "
                       "initialized (no --clip-ckpt); scores are "
                       "self-consistent, not quality evidence")
    if args.original and args.reverse_prompt:
        original = _load_images(Path(args.original))
        out["clip_directional_similarity"] = clip_directional_similarity(
            scorer, edited, original, args.edit_prompt, args.reverse_prompt)
    print(json.dumps(out))
    if args.run:
        (Path(args.run) / "eval_metrics.json").write_text(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
