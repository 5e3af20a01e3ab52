"""The port's viewer server against the JAX package's, over real HTTP on
127.0.0.1 (port 0: a free local port), on the CPU.

`/info` answers the same JSON; the frames (`_frame_array`, the uint8 image
the JPEG encodes) agree with the JAX server's in every mode, with the
training-camera markers and with a jump to a training view, within 1/255
on every value and equal on ≥ 99.9% of them (uint8 truncations of renders
~1e-5 apart); two requests served at once on two threads each answer the
JPEG of their own frame.
"""

import json
import threading
import urllib.request

import jax
import numpy as np
import pytest
import torch

from gaussctrl_tpu.cameras.camera import make_cameras as j_make_cameras
from gaussctrl_tpu.splat.scene import random_scene as j_random_scene
from gaussctrl_tpu.viewer import server as jserver

from gaussctrl_tpu_torch.cameras.camera import make_cameras
from gaussctrl_tpu_torch.splat.scene import GaussianScene
from gaussctrl_tpu_torch.viewer import ViewerServer
from gaussctrl_tpu_torch.viewer.server import _orbit_c2w

torch.set_num_threads(2)

FIELDS = ("means", "scales", "quats", "opacities", "features_dc",
          "features_rest")
QUERIES = [
    {"az": 0.3, "el": 0.2, "r": 2.5, "center": [0, 0, 0], "depth": False},
    {"az": 0.3, "el": 0.2, "r": 2.5, "center": [0, 0, 0], "depth": True},
    {"az": 0.1, "el": 0.1, "r": 2.5, "center": [0, 0, 0], "mode": "alpha",
     "view": -1},
    {"az": 0.1, "el": 0.1, "r": 4.5, "center": [0.1, 0, 0], "mode": "rgb",
     "markers": True, "view": -1},
    {"az": 0, "el": 0, "r": 0, "center": [0, 0, 0], "mode": "depth",
     "view": 1},
    {"az": 0, "el": 0, "r": 0, "center": [0, 0, 0], "mode": "rgb",
     "markers": True, "view": 2},
]


class _LocalServer(jserver.ThreadingHTTPServer):
    """The JAX server, bound to 127.0.0.1 whatever host it asks for."""

    def __init__(self, address, handler):
        super().__init__(("127.0.0.1", address[1]), handler)


@pytest.fixture(scope="module")
def servers():
    """(JAX server, port server) over one random scene of 50 gaussians and
    three training cameras at 64×64 (the viewport too), both serving."""
    js = j_random_scene(jax.random.PRNGKey(1), 50, sh_degree=1, extent=0.4)
    ts = GaussianScene.from_numpy({k: np.asarray(getattr(js, k)) for k in FIELDS})
    c2ws = np.stack([np.eye(4)[:3] + 0.0 for _ in range(3)])
    c2ws[:, 2, 3] = [2.0, 2.5, 3.0]
    c2ws[1, 0, 3] = 0.3
    c2ws = c2ws.astype(np.float32)
    jcams = j_make_cameras(c2ws, 64, 64, 32, 32, 64, 64)
    tcams = make_cameras(c2ws, 64, 64, 32, 32, 64, 64)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jserver, "ThreadingHTTPServer", _LocalServer)
        jsrv = jserver.ViewerServer(js, width=64, height=64, port=0,
                                    cameras=jcams)
        jsrv.serve(blocking=False)
    tsrv = ViewerServer(ts, width=64, height=64, port=0, cameras=tcams,
                        host="127.0.0.1")
    tsrv.serve(blocking=False)
    yield jsrv, tsrv
    jsrv.shutdown()
    tsrv.shutdown()


def _get(srv, path):
    port = srv.httpd.server_address[1]
    return urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                  timeout=60).read()


def _post(srv, q):
    port = srv.httpd.server_address[1]
    req = urllib.request.Request(f"http://127.0.0.1:{port}/render",
                                 data=json.dumps(q).encode())
    return urllib.request.urlopen(req, timeout=120).read()


def _jax_frame_array(jsrv, q, monkeypatch):
    """The uint8 array the JAX server's `_frame` encodes, caught at PIL."""
    from PIL import Image
    seen = []
    real = Image.fromarray

    def catch(arr, *a, **kw):
        seen.append(np.array(arr))
        return real(arr, *a, **kw)

    monkeypatch.setattr(Image, "fromarray", catch)
    jsrv._frame(q)
    monkeypatch.setattr(Image, "fromarray", real)
    return seen[-1]


def test_page_and_info_match_jax(servers):
    jsrv, tsrv = servers
    assert _get(tsrv, "/") == _get(jsrv, "/")
    assert json.loads(_get(tsrv, "/info")) == json.loads(_get(jsrv, "/info")) \
        == {"num_views": 3, "num_gaussians": 50}


@pytest.mark.parametrize("q", QUERIES, ids=lambda q: (
    f"{q.get('mode', 'depth' if q.get('depth') else 'rgb')}"
    f"{'-markers' if q.get('markers') else ''}-view{q.get('view', -1)}"))
def test_frames_match_jax(servers, q, monkeypatch):
    """Each mode, with markers and with a view jump: the port's frame
    against the JAX server's, and the JPEG served over HTTP is the port's
    encoding of it."""
    jsrv, tsrv = servers
    got = tsrv._frame_array(q)
    ref = _jax_frame_array(jsrv, q, monkeypatch)
    assert got.shape == ref.shape == (64, 64, 3) and got.dtype == np.uint8
    diff = np.abs(got.astype(int) - ref.astype(int))
    assert diff.max() <= 1 and (diff == 0).mean() >= 0.999
    if q.get("markers"):
        assert (got == (0, 255, 90)).all(-1).any()
    assert _post(tsrv, q) == tsrv._jpeg(got)


def test_two_requests_at_once(servers):
    """Two POSTs sent together from two threads: each answers the JPEG of
    its own frame."""
    _, tsrv = servers
    qs = [QUERIES[0], QUERIES[4]]
    out = [None, None]
    go = threading.Barrier(2)

    def send(i):
        go.wait(timeout=30)
        out[i] = _post(tsrv, qs[i])

    threads = [threading.Thread(target=send, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    for i in range(2):
        assert out[i] == tsrv._jpeg(tsrv._frame_array(qs[i]))
    assert out[0] != out[1]


def test_orbit_camera_matches_jax():
    for args in [(0.3, 0.2, 2.5, [0, 0, 0]), (1.2, -0.4, 1.0, [0.1, 0.2, 0.3]),
                 (0.0, 1.5707, 2.0, [0, 0, 0])]:
        np.testing.assert_array_equal(_orbit_c2w(*args), jserver._orbit_c2w(*args))
