"""Minimal PLY reader/writer (ascii and binary).

Counterpart of `gaussctrl_tpu/data/ply.py`: host-side numpy IO for the
vertex x/y/z + red/green/blue point clouds the scenes ship, and the INRIA
3DGS layout for gaussian scenes (`write_gaussian_ply` /
`read_gaussian_ply`, whose scenes are the port's torch `GaussianScene`).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

_DTYPES = {
    "float": "<f4", "float32": "<f4", "double": "<f8", "float64": "<f8",
    "uchar": "u1", "uint8": "u1", "char": "i1", "int8": "i1",
    "short": "<i2", "ushort": "<u2", "int": "<i4", "int32": "<i4",
    "uint": "<u4", "uint32": "<u4",
}


def read_ply(path) -> dict[str, np.ndarray]:
    """Read vertex properties from a PLY file → {name: [N] array}."""
    path = Path(path)
    with open(path, "rb") as f:
        magic = f.readline().strip()
        if magic != b"ply":
            raise ValueError(f"{path} is not a PLY file")
        fmt = None
        n_vertex = None
        props: list[tuple[str, str]] = []
        in_vertex = False
        while True:
            line = f.readline()
            if not line:
                raise ValueError("unexpected EOF in PLY header")
            tokens = line.decode("ascii", "replace").strip().split()
            if not tokens:
                continue
            if tokens[0] == "format":
                fmt = tokens[1]
            elif tokens[0] == "element":
                in_vertex = tokens[1] == "vertex"
                if in_vertex:
                    n_vertex = int(tokens[2])
            elif tokens[0] == "property" and in_vertex:
                if tokens[1] == "list":
                    raise ValueError("list properties unsupported for vertices")
                props.append((tokens[2], _DTYPES[tokens[1]]))
            elif tokens[0] == "end_header":
                break
        assert n_vertex is not None and fmt is not None
        if fmt == "ascii":
            body = np.loadtxt(f, max_rows=n_vertex)
            body = body.reshape(n_vertex, len(props))
            return {
                name: body[:, i].astype(np.dtype(dt).base)
                for i, (name, dt) in enumerate(props)
            }
        if fmt in ("binary_little_endian", "binary_big_endian"):
            order = "<" if fmt == "binary_little_endian" else ">"
            rec = np.dtype([(name, dt.replace("<", order)) for name, dt in props])
            raw = np.frombuffer(f.read(rec.itemsize * n_vertex), dtype=rec)
            return {name: np.ascontiguousarray(raw[name]) for name, _ in props}
        raise ValueError(f"unsupported PLY format {fmt}")


def read_point_cloud(path) -> tuple[np.ndarray, np.ndarray]:
    """→ (points [N,3] f32, colors [N,3] f32 in [0,1])."""
    v = read_ply(path)
    pts = np.stack([v["x"], v["y"], v["z"]], -1).astype(np.float32)
    if "red" in v:
        cols = np.stack([v["red"], v["green"], v["blue"]], -1).astype(np.float32)
        if cols.max() > 1.0:
            cols = cols / 255.0
    else:
        cols = np.full_like(pts, 0.5)
    return pts, cols


def write_ply(path, points: np.ndarray, colors: np.ndarray | None = None):
    """Write a binary point cloud (for exporting edited scenes)."""
    n = points.shape[0]
    props = [("x", "<f4"), ("y", "<f4"), ("z", "<f4")]
    if colors is not None:
        props += [("red", "u1"), ("green", "u1"), ("blue", "u1")]
    rec = np.zeros(n, dtype=np.dtype(props))
    rec["x"], rec["y"], rec["z"] = points[:, 0], points[:, 1], points[:, 2]
    if colors is not None:
        c = np.clip(colors * 255.0, 0, 255).astype(np.uint8) if colors.max() <= 1.0 else colors.astype(np.uint8)
        rec["red"], rec["green"], rec["blue"] = c[:, 0], c[:, 1], c[:, 2]
    with open(path, "wb") as f:
        f.write(b"ply\nformat binary_little_endian 1.0\n")
        f.write(f"element vertex {n}\n".encode())
        typemap = {"<f4": "float", "u1": "uchar"}
        for name, dt in props:
            f.write(f"property {typemap[dt]} {name}\n".encode())
        f.write(b"end_header\n")
        f.write(rec.tobytes())


def write_gaussian_ply(path, scene) -> None:
    """Export a `GaussianScene` in the INRIA 3DGS PLY layout, in the order of
    gaussian-splatting's `GaussianModel.save_ply`: x/y/z, zero normals,
    f_dc_0..2, f_rest channel-major (all R coefficients, then G, then B),
    raw logit opacity, log scales, unnormalised wxyz rotation (the scene's
    storage conventions as they are)."""
    def arr(x):
        return np.asarray(x.detach().cpu().numpy() if hasattr(x, "detach")
                          else x, np.float32)

    means = arr(scene.means)
    n = means.shape[0]
    f_dc = arr(scene.features_dc)
    # [N, K-1, 3] coeff-major -> [N, 3, K-1] channel-major -> flat
    f_rest = arr(scene.features_rest)
    k_rest = f_rest.shape[1]
    f_rest = f_rest.transpose(0, 2, 1).reshape(n, 3 * k_rest)
    opac = arr(scene.opacities).reshape(n)
    scales = arr(scene.scales)
    quats = arr(scene.quats)

    names = (["x", "y", "z", "nx", "ny", "nz"]
             + [f"f_dc_{i}" for i in range(3)]
             + [f"f_rest_{i}" for i in range(3 * k_rest)]
             + ["opacity"]
             + [f"scale_{i}" for i in range(3)]
             + [f"rot_{i}" for i in range(4)])
    rec = np.zeros(n, dtype=np.dtype([(m, "<f4") for m in names]))
    rec["x"], rec["y"], rec["z"] = means.T
    for i in range(3):
        rec[f"f_dc_{i}"] = f_dc[:, i]
        rec[f"scale_{i}"] = scales[:, i]
    for i in range(3 * k_rest):
        rec[f"f_rest_{i}"] = f_rest[:, i]
    rec["opacity"] = opac
    for i in range(4):
        rec[f"rot_{i}"] = quats[:, i]
    with open(path, "wb") as f:
        f.write(b"ply\nformat binary_little_endian 1.0\n")
        f.write(f"element vertex {n}\n".encode())
        for m in names:
            f.write(f"property float {m}\n".encode())
        f.write(b"end_header\n")
        f.write(rec.tobytes())


def read_gaussian_ply(path):
    """Load an INRIA-layout 3DGS PLY as a `GaussianScene` (float32, CPU)."""
    from gaussctrl_tpu_torch.splat.scene import GaussianScene

    data = read_ply(path)
    n = data["x"].shape[0]
    k_rest3 = len([k for k in data if k.startswith("f_rest_")])
    assert k_rest3 % 3 == 0, k_rest3
    k_rest = k_rest3 // 3
    means = np.stack([data["x"], data["y"], data["z"]], 1).astype(np.float32)
    f_dc = np.stack([data[f"f_dc_{i}"] for i in range(3)], 1).astype(np.float32)
    f_rest = np.stack([data[f"f_rest_{i}"] for i in range(k_rest3)],
                      1).astype(np.float32)
    # channel-major flat -> [N, 3, K-1] -> coeff-major [N, K-1, 3]
    f_rest = f_rest.reshape(n, 3, k_rest).transpose(0, 2, 1)
    scales = np.stack([data[f"scale_{i}"] for i in range(3)], 1).astype(np.float32)
    quats = np.stack([data[f"rot_{i}"] for i in range(4)], 1).astype(np.float32)
    opac = data["opacity"].astype(np.float32).reshape(n, 1)
    return GaussianScene.from_numpy(dict(
        means=means, scales=scales, quats=quats, opacities=opac,
        features_dc=f_dc, features_rest=f_rest))
