"""`python -m gaussctrl_tpu_torch.cli.certify`: the one-command real-weight
fidelity verdict.

Counterpart of `gaussctrl_tpu/cli/certify.py`, with its options and the
port's `--device` (the card unless `--device cpu`). The first machine that
has the real checkpoints certifies the port's SD-1.5 + ControlNet, SAM and
GroundingDINO with:

    python -m gaussctrl_tpu_torch.cli.certify \\
        --diffusers-dir /weights/sd15 --controlnet-dir /weights/cn-depth \\
        --sam-ckpt /weights/sam_vit_h.pth \\
        --dino-ckpt /weights/groundingdino_swinb.pth \\
        --dino-vocab /weights/bert/vocab.txt \\
        --image photo.png --out certify.json

It writes one JSON verdict (`certify.run_battery`) and exits 0 if and only
if every check that could run passed. Checks whose inputs are missing are
listed under "skipped", never failed. `--image` is read with OpenCV.
"""

from __future__ import annotations

import argparse
import json
import sys

from gaussctrl_tpu_torch.device import resolve_device


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Certify real-weight ports with the full golden battery")
    p.add_argument("--diffusers-dir", default=None,
                   help="SD-1.5 diffusers layout dir (unet/ vae/ text_encoder/ tokenizer/)")
    p.add_argument("--controlnet-dir", default=None,
                   help="ControlNet-depth dir (diffusion_pytorch_model.*)")
    p.add_argument("--sam-ckpt", default=None, help="SAM ViT-H checkpoint")
    p.add_argument("--dino-ckpt", default=None,
                   help="GroundingDINO SwinB checkpoint")
    p.add_argument("--dino-vocab", default=None, help="BERT vocab.txt")
    p.add_argument("--image", default=None,
                   help="real test image (synthetic fallback if omitted)")
    p.add_argument("--prompt", default="a photo of a bear")
    p.add_argument("--num-inference-steps", type=int, default=20)
    p.add_argument("--out", default="certify.json")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; 'cpu' on request)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)

    from gaussctrl_tpu_torch.certify import run_battery
    verdict = run_battery(
        sd_dir=args.diffusers_dir, controlnet_dir=args.controlnet_dir,
        sam_ckpt=args.sam_ckpt, dino_ckpt=args.dino_ckpt,
        dino_vocab=args.dino_vocab, image=args.image, prompt=args.prompt,
        num_steps=args.num_inference_steps, device=device)
    with open(args.out, "w") as f:
        json.dump(verdict, f, indent=2, default=str)
    print(json.dumps(verdict, indent=2, default=str))
    print(f"[certify] verdict -> {args.out}  all_ok={verdict['all_ok']}")
    return 0 if verdict["all_ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
