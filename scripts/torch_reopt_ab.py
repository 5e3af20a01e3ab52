"""Time the port's re-optimisation step in two source trees, in turns.

Each tree is a checkout holding `gaussctrl_tpu_torch/` (for example one
unpacked with `git archive`). For every pair the script starts one worker
process per tree, in the order A, B for even pairs and B, A for odd ones,
so that a drift of the host's load falls on both sides alike. A worker
imports the package from its tree (building its kernels there), makes the
200,000-gaussian scene of chip_smoke.py and eight 512x512 orbit views with
smooth random targets, warms up with a short `reoptimize()`, then times
`--runs` calls of `reoptimize(num_steps=--steps)` between device
synchronisations. Reported: each run's ms per step, each worker's median,
and for every pair the difference of the second tree's median from the
first's.

    python scripts/torch_reopt_ab.py --tree parent=../parent --tree change=. \
        --pairs 4 --out chiprun_out/reopt_ab

Needs a CUDA card; prints the card's name and power limit first and one
JSON summary last.
"""

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import time

GAUSSIANS, SIZE, VIEWS, SEED = 200_000, 512, 8, 1234
DEVICE = "cuda"


def worker(tree: str, steps: int, runs: int, warm: int) -> dict:
    sys.path.insert(0, os.path.abspath(tree))
    import numpy as np
    import torch
    import torch.nn.functional as F
    import gaussctrl_tpu_torch
    from gaussctrl_tpu_torch.cameras.camera import make_cameras
    from gaussctrl_tpu_torch.ops import _lib
    from gaussctrl_tpu_torch.splat.scene import random_scene
    from gaussctrl_tpu_torch.splat.trainer import reoptimize

    assert os.path.dirname(gaussctrl_tpu_torch.__file__).startswith(
        os.path.abspath(tree)), gaussctrl_tpu_torch.__file__
    dev = DEVICE
    _lib.library()
    c2ws = []
    for i in range(VIEWS):
        a = 2 * math.pi * i / VIEWS
        pos = np.array([math.sin(a) * 3.5, 0.6, math.cos(a) * 3.5])
        fwd = -pos / np.linalg.norm(pos)
        right = np.cross(fwd, [0.0, 1.0, 0.0])
        right /= np.linalg.norm(right)
        up = np.cross(right, fwd)
        c2ws.append(np.stack([right, up, -fwd, pos], axis=1))
    f = SIZE / (2 * math.tan(math.radians(50.0) / 2))
    cams = make_cameras(np.asarray(c2ws, np.float32), f, f, SIZE / 2,
                        SIZE / 2, SIZE, SIZE, device=dev)
    scene = random_scene(torch.Generator(device=dev).manual_seed(SEED),
                         GAUSSIANS, sh_degree=3, extent=1.0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(11)
    images = F.interpolate(
        torch.rand((VIEWS, 3, 32, 32), generator=gen, device=dev),
        size=(SIZE, SIZE), mode="bilinear").permute(0, 2, 3, 1).contiguous()

    reoptimize(scene, cams, images, warm)
    ms = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t = time.perf_counter()
        reoptimize(scene, cams, images, steps)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t) * 1e3 / steps)
    return dict(tree=tree, steps=steps, ms_per_step=ms,
                median_ms=statistics.median(ms),
                peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", action="append", default=[],
                    help="label=path, twice: the first is the baseline")
    ap.add_argument("--pairs", type=int, default=4)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--warm", type=int, default=20)
    ap.add_argument("--timeout", type=int, default=300,
                    help="seconds for one worker")
    ap.add_argument("--out", default="")
    ap.add_argument("--worker", default="", help=argparse.SUPPRESS)
    args = ap.parse_args()

    if args.worker:
        print(json.dumps(worker(args.worker, args.steps, args.runs,
                                args.warm)))
        return 0

    import torch
    if not torch.cuda.is_available() or len(args.tree) != 2:
        print("torch_reopt_ab: needs a CUDA card and two --tree label=path",
              file=sys.stderr)
        return 1
    trees = [t.split("=", 1) for t in args.tree]
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
    results = {label: [] for label, _ in trees}
    for p in range(args.pairs):
        for label, path in (trees if p % 2 == 0 else trees[::-1]):
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--worker", path,
                 "--steps", str(args.steps), "--runs", str(args.runs),
                 "--warm", str(args.warm)],
                capture_output=True, text=True, timeout=args.timeout)
            if args.out:
                with open(os.path.join(args.out, f"{label}_{p}.log"), "w") as f:
                    f.write(proc.stdout + proc.stderr)
            if proc.returncode != 0:
                print(proc.stderr[-4000:], file=sys.stderr)
                return 1
            rec = json.loads(proc.stdout.strip().splitlines()[-1])
            rec.update(label=label, pair=p)
            print(json.dumps(rec), flush=True)
            results[label].append(rec)
    (a, _), (b, _) = trees
    diffs = [rb["median_ms"] - ra["median_ms"]
             for ra, rb in zip(results[a], results[b])]
    summary = dict(
        steps=args.steps, runs=args.runs, pairs=args.pairs,
        median_ms={k: [r["median_ms"] for r in v] for k, v in results.items()},
        diff_ms=diffs, diff_mean_ms=statistics.mean(diffs),
        diff_sd_ms=statistics.stdev(diffs) if len(diffs) > 1 else None)
    if args.out:
        with open(os.path.join(args.out, "summary.json"), "w") as f:
            json.dump(summary, f, indent=1)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
