"""Minimal web viewer: orbit the scene in a browser, rendered server-side.

Counterpart of `gaussctrl_tpu/viewer/server.py` (the `ns-viewer` role): a
dependency-free HTTP server. The browser posts orbit camera parameters,
the server renders one view (`render_rgbd`, one K1 launch on the card) on
the scene's device and answers with a JPEG. Output types rgb / depth /
accumulation, the training cameras projected into the viewport as markers,
and the exact jump to a training view; the page is the JAX package's.
`ThreadingHTTPServer` renders each request on its own thread.
"""

from __future__ import annotations

import io
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

_PAGE = """<!doctype html>
<html><head><title>gaussctrl_tpu viewer</title><style>
body{margin:0;background:#111;color:#ddd;font-family:monospace}
#v{display:block;margin:auto;margin-top:8px}
#hud{position:fixed;top:8px;left:8px;line-height:1.7}
select,input,button{background:#222;color:#ddd;border:1px solid #555}
#view{width:3em}
</style></head><body>
<img id="v" width="%WIDTH%" height="%HEIGHT%">
<div id="hud">drag: orbit &nbsp; wheel: zoom &nbsp; shift-drag: pan<br>
output <select id="mode"><option value="rgb">rgb</option>
<option value="depth">depth</option>
<option value="alpha">accumulation</option></select><br>
<label><input type="checkbox" id="markers"> train cameras</label><br>
view <input type="number" id="view" min="0" value="0">
<button id="goto">go</button> <button id="orbit">orbit</button>
<span id="nviews"></span></div>
<script>
let az=0, el=0.3, r=2.5, cx=0, cy=0, cz=0, busy=false, dirty=true, view=-1;
const img=document.getElementById('v');
fetch('/info').then(r=>r.json()).then(i=>{
  document.getElementById('nviews').textContent = i.num_views ?
    'of ' + i.num_views : '(no cameras)'; });
async function tick(){
  if(dirty && !busy){ busy=true; dirty=false;
    const q = {az:az, el:el, r:r, center:[cx,cy,cz],
               mode:document.getElementById('mode').value,
               markers:document.getElementById('markers').checked,
               view:view};
    const res = await fetch('/render', {method:'POST', body:JSON.stringify(q)});
    const blob = await res.blob();
    img.src = URL.createObjectURL(blob);
    busy=false; }
  requestAnimationFrame(tick); }
let drag=null;
img.onmousedown = e=>{drag=[e.clientX,e.clientY,e.shiftKey];};
window.onmouseup = ()=>{drag=null;};
window.onmousemove = e=>{ if(!drag) return;
  const dx=e.clientX-drag[0], dy=e.clientY-drag[1];
  if(drag[2]){ cx-=dx*0.002*r; cy+=dy*0.002*r; }
  else { az-=dx*0.005; el=Math.max(-1.5,Math.min(1.5,el+dy*0.005)); }
  drag=[e.clientX,e.clientY,drag[2]]; view=-1; dirty=true; };
img.onwheel = e=>{ r*=Math.exp(e.deltaY*0.001); view=-1; dirty=true;
  e.preventDefault(); };
document.getElementById('mode').onchange=()=>{dirty=true;};
document.getElementById('markers').onchange=()=>{dirty=true;};
document.getElementById('goto').onclick=()=>{
  view=parseInt(document.getElementById('view').value)||0; dirty=true;};
document.getElementById('orbit').onclick=()=>{view=-1; dirty=true;};
tick();
</script></body></html>"""


def _orbit_c2w(az: float, el: float, radius: float, center) -> np.ndarray:
    """OpenGL c2w looking at `center` from spherical (az, el, r)."""
    pos = np.array(center) + radius * np.array([
        np.cos(el) * np.sin(az), np.sin(el), np.cos(el) * np.cos(az)])
    fwd = (np.array(center) - pos)
    fwd /= np.linalg.norm(fwd)
    right = np.cross(fwd, [0.0, 1.0, 0.0])
    n = np.linalg.norm(right)
    right = right / n if n > 1e-6 else np.array([1.0, 0.0, 0.0])
    up = np.cross(right, fwd)
    return np.stack([right, up, -fwd, pos], axis=1).astype(np.float32)


class ViewerServer:
    """Serves `scene` (a `GaussianScene`, rendered where its tensors are) at
    `width`×`height`; `cameras` (optional) gives markers and view jumps.
    `host` is the address the server binds."""

    def __init__(self, scene, width: int = 512, height: int = 512,
                 focal: float | None = None, port: int = 7007, cameras=None,
                 host: str = "0.0.0.0"):
        from gaussctrl_tpu_torch.splat.render import render_rgbd

        self.scene = scene
        self.cameras = cameras        # optional Cameras for markers / jumps
        self.width, self.height = width, height
        self.focal = focal or 1.1 * max(width, height)
        self.port = port
        self.host = host
        self._render = render_rgbd

    def _cam_for(self, q):
        """(c2w, fx, fy) for the request: a train view or the orbit camera."""
        v = int(q.get("view", -1))
        if self.cameras is not None and 0 <= v < len(self.cameras):
            c = self.cameras
            sx = self.width / float(c.width)
            sy = self.height / float(c.height)
            return (c.c2w[v].cpu().numpy().astype(np.float32),
                    float(c.fx[v]) * sx, float(c.fy[v]) * sy)
        return (_orbit_c2w(q["az"], q["el"], q["r"], q["center"]),
                self.focal, self.focal)

    def _draw_markers(self, arr: np.ndarray, c2w: np.ndarray, fx, fy):
        """Project the train-camera centres into the viewport (green
        squares)."""
        if self.cameras is None:
            return arr
        centers = self.cameras.c2w[:, :, 3].cpu().numpy()          # [V, 3]
        R, t = c2w[:, :3], c2w[:, 3]
        pc = (centers - t) @ R                                     # world->cam
        z = -pc[:, 2]                                              # OpenGL fwd
        ok = z > 1e-3
        u = (fx * pc[:, 0] / np.maximum(z, 1e-3) + self.width / 2).astype(int)
        v = (-fy * pc[:, 1] / np.maximum(z, 1e-3) + self.height / 2).astype(int)
        for i in np.nonzero(ok)[0]:
            x, y = u[i], v[i]
            if 1 <= x < self.width - 1 and 1 <= y < self.height - 1:
                arr[y - 1: y + 2, x - 1: x + 2] = (0, 255, 90)
        return arr

    def _frame_array(self, q) -> np.ndarray:
        """The request's frame, [height, width, 3] uint8."""
        c2w_np, fx, fy = self._cam_for(q)
        dev = self.scene.means.device
        with torch.no_grad():
            out = self._render(self.scene, torch.as_tensor(c2w_np, device=dev),
                               fx, fy, self.width / 2, self.height / 2,
                               self.width, self.height,
                               torch.zeros(3, device=dev))
        mode = q.get("mode", "depth" if q.get("depth") else "rgb")
        if mode == "depth":
            d = out["depth"][..., 0].cpu().numpy()
            lo, hi = np.percentile(d[d < 999], [2, 98]) if (d < 999).any() else (0, 1)
            arr = np.clip((d - lo) / max(hi - lo, 1e-6), 0, 1)
            arr = (np.stack([arr] * 3, -1) * 255).astype(np.uint8)
        elif mode == "alpha":
            a = np.clip(out["accumulation"][..., 0].cpu().numpy(), 0, 1)
            arr = (np.stack([a] * 3, -1) * 255).astype(np.uint8)
        else:
            arr = (torch.clamp(out["rgb"], 0, 1) * 255).cpu().numpy().astype(
                np.uint8)
        if q.get("markers"):
            arr = self._draw_markers(arr.copy(), c2w_np, fx, fy)
        return arr

    @staticmethod
    def _jpeg(arr: np.ndarray) -> bytes:
        from PIL import Image
        buf = io.BytesIO()
        Image.fromarray(arr).save(buf, "JPEG", quality=90)
        return buf.getvalue()

    def _frame(self, q) -> bytes:
        """The request's frame as a JPEG (quality 90)."""
        return self._jpeg(self._frame_array(q))

    def serve(self, blocking: bool = True):
        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_GET(self):
                if self.path.startswith("/info"):
                    body = json.dumps({
                        "num_views": len(viewer.cameras)
                        if viewer.cameras is not None else 0,
                        "num_gaussians": int(viewer.scene.num_gaussians),
                    }).encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                    self.end_headers()
                    self.wfile.write(body)
                    return
                page = (_PAGE.replace("%WIDTH%", str(viewer.width))
                        .replace("%HEIGHT%", str(viewer.height)))
                self.send_response(200)
                self.send_header("Content-Type", "text/html")
                self.end_headers()
                self.wfile.write(page.encode())

            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                q = json.loads(self.rfile.read(n))
                jpeg = viewer._frame(q)
                self.send_response(200)
                self.send_header("Content-Type", "image/jpeg")
                self.end_headers()
                self.wfile.write(jpeg)

        self.httpd = ThreadingHTTPServer((self.host, self.port), Handler)
        self.port = self.httpd.server_address[1]
        print(f"[viewer] http://localhost:{self.port}", flush=True)
        if blocking:
            self.httpd.serve_forever()
        else:
            t = threading.Thread(target=self.httpd.serve_forever, daemon=True)
            t.start()
            return t

    def shutdown(self):
        if hasattr(self, "httpd"):
            self.httpd.shutdown()
            self.httpd.server_close()
