"""Windowed meter panel — the JuicyPluginEditor GUI analog, over HTTP.
A copy of juicy_tpu/ui/web.py for the PyTorch port (the page, the
server and its same-origin rule are JAX's, byte for byte).

The reference editor is a real windowed UI: auto-generated parameter
sliders (JuicyPluginEditor.cpp:104-131, one juce::Slider per
non-readonly parameter), painted PRE/POST juiciness meters and feature
bars (JuicyMeterPanel.cpp:122-198), repainted by a 20 Hz juce::Timer
polling getLatestMetrics (JuicyPluginEditor.cpp:36,85-90), with a
per-plugin accent colour hashed from the title (cpp:3-9).

This module is that editor for the runtime: a self-contained HTML
panel (no external assets, stdlib http.server) whose meters are driven
by the SAME `ui.meters.MeterPanel` numeric model the terminal uses
(asymmetric 0.28/0.12 smoothing, running min/max/avg ghost stats) — the
browser only paints. Sliders POST parameter edits back; the processing
loop applies them between blocks, exactly the APVTS-atomics thread
bridge of the reference (PluginProcessor.cpp reads its atomics at the
top of processBlock). Mouse on sliders + painted meters == the windowed
editor, with the render loop on the card instead of a DAW callback.
"""

from __future__ import annotations

import html as _html
import json
import math
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Tuple

from juicy_tpu_torch.ui.meters import (BAR_COLOURS, FEATURE_BARS,
                                       TRIANGLE_BARS, MeterPanel,
                                       accent_hue_from_title)


def _xterm256_to_hex(idx: int) -> str:
    """The meter bar colours are spec'd as xterm-256 cube indices
    (ui.meters.BAR_COLOURS); the browser needs CSS hex."""
    if 16 <= idx <= 231:
        c = idx - 16
        levels = [0, 95, 135, 175, 215, 255]
        r, g, b = levels[c // 36], levels[(c // 6) % 6], levels[c % 6]
    elif idx >= 232:                                   # grayscale ramp
        v = 8 + (idx - 232) * 10
        r = g = b = v
    else:                                              # 16 base colours
        base = [(0, 0, 0), (205, 0, 0), (0, 205, 0), (205, 205, 0),
                (0, 0, 238), (205, 0, 205), (0, 205, 205), (229, 229, 229),
                (127, 127, 127), (255, 0, 0), (0, 255, 0), (255, 255, 0),
                (92, 92, 255), (255, 0, 255), (0, 255, 255), (255, 255, 255)]
        r, g, b = base[idx]
    return f"#{r:02x}{g:02x}{b:02x}"


_PAGE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>{title} — juicy_tpu</title>
<style>
 body {{ background:#14161a; color:#d8dce2; font:14px/1.5 -apple-system,
        'Segoe UI', sans-serif; margin:0; padding:24px; }}
 .panel {{ max-width:720px; margin:0 auto; background:#1b1e24;
          border-radius:10px; padding:20px 24px;
          border-top:3px solid hsl({accent_deg},70%,55%); }}
 h1 {{ font-size:17px; margin:0 0 2px; color:hsl({accent_deg},70%,70%); }}
 .sub {{ font-size:11px; letter-spacing:.14em; color:#7a8290;
        margin-bottom:14px; }}
 .score {{ margin:6px 0; }}
 .score .lbl {{ display:inline-block; width:44px; color:#9aa3b2;
               font-size:12px; }}
 .score .val {{ float:right; font-variant-numeric:tabular-nums; }}
 .rail {{ position:relative; height:16px; background:#0e1013;
         border-radius:4px; overflow:hidden; }}
 .rail .fill {{ position:absolute; inset:0 auto 0 0; width:0%;
               background:hsl({accent_deg},70%,52%);
               transition:width 60ms linear; }}
 .rail .tick {{ position:absolute; top:0; bottom:0; width:1px;
               background:#3a4150; }}
 .bar {{ margin:7px 0; }}
 .bar .lbl {{ display:inline-block; width:110px; color:#9aa3b2;
             font-size:12px; }}
 .bar .val {{ float:right; font-variant-numeric:tabular-nums;
             font-size:12px; }}
 .bar .rail .ghost {{ position:absolute; top:0; bottom:0;
                     background:rgba(255,255,255,.09); }}
 .bar .rail .avg {{ position:absolute; top:0; bottom:0; width:2px;
                   background:rgba(255,255,255,.55); }}
 .params {{ margin-top:18px; border-top:1px solid #2a2f38;
           padding-top:12px; }}
 .param {{ display:flex; align-items:center; gap:10px; margin:4px 0; }}
 .param label {{ width:110px; color:#9aa3b2; font-size:12px; }}
 .param input[type=range] {{ flex:1; accent-color:hsl({accent_deg},70%,55%); }}
 .param .pv {{ width:64px; text-align:right;
              font-variant-numeric:tabular-nums; font-size:12px; }}
 .foot {{ margin-top:14px; font-size:11px; color:#5d6572; }}
</style></head><body><div class="panel">
<h1>{title}</h1><div class="sub">JUICINESS INDEX — LIVE</div>
<div class="score"><span class="lbl">PRE</span><span class="val"
 id="prev">0.0</span><div class="rail" id="pre">{ticks}<div class="fill"
 id="pref"></div></div></div>
<div class="score"><span class="lbl">POST</span><span class="val"
 id="postv">0.0</span><div class="rail" id="post">{ticks}<div
 class="fill" id="postf"></div></div></div>
<div id="bars">{bars}</div>
<div class="params" id="params">{params}</div>
<div class="foot">20 Hz metric poll · sliders apply between blocks
 (the APVTS thread-bridge analog) · juicy_tpu web editor<span id="dot">
 </span> · <a href="#" id="stop" style="color:#7a8290">stop render</a>
</div>
</div><script>
const poll = async () => {{
  try {{
    const s = await (await fetch('state')).json();
    document.getElementById('pref').style.width = s.pre_score + '%';
    document.getElementById('postf').style.width = s.post_score + '%';
    document.getElementById('prev').textContent = s.pre_score.toFixed(1);
    document.getElementById('postv').textContent = s.post_score.toFixed(1);
    for (const [k, b] of Object.entries(s.bars)) {{
      const f = document.getElementById('f_' + k);
      if (!f) continue;
      f.style.width = (100 * b.value) + '%';
      document.getElementById('v_' + k).textContent =
        (100 * b.value).toFixed(1) + '%';
      const g = document.getElementById('g_' + k);
      if (g && b.count > 2) {{
        g.style.left = (100 * b.min) + '%';
        g.style.width = (100 * (b.max - b.min)) + '%';
        const a = document.getElementById('a_' + k);
        a.style.left = (100 * b.avg) + '%'; a.style.display = 'block';
      }}
    }}
    for (const [k, v] of Object.entries(s.params)) {{
      const el = document.getElementById('p_' + k);
      if (el && document.activeElement !== el) {{
        el.value = v;
        document.getElementById('pv_' + k).textContent =
          Number(v).toFixed(2);
      }}
    }}
    document.getElementById('dot') &&
      (document.getElementById('dot').textContent = s.running ? '' : ' (done)');
  }} catch (e) {{}}
}};
setInterval(poll, 50); poll();
document.getElementById('stop').addEventListener('click', (e) => {{
  e.preventDefault(); fetch('stop', {{ method: 'POST' }});
}});
for (const el of document.querySelectorAll('input[type=range]')) {{
  el.addEventListener('input', () => {{
    document.getElementById('pv_' + el.dataset.pid).textContent =
      Number(el.value).toFixed(2);
    fetch('param', {{ method: 'POST', headers:
      {{'Content-Type': 'application/json'}}, body: JSON.stringify(
      {{ id: el.dataset.pid, value: Number(el.value) }}) }});
  }});
}}
</script></body></html>
"""


def panel_html(title: str, param_specs: List[Tuple[str, float, float, float]],
               show_ghost_stats: bool = False,
               show_triangle_metrics: bool = False) -> str:
    """Render the self-contained editor page. `param_specs`: (id, lo, hi,
    value) for each NON-readonly parameter (the createControls skip-list,
    JuicyPluginEditor.cpp:104-113)."""
    accent_deg = round(accent_hue_from_title(title) * 360.0, 1)
    title = _html.escape(title)
    ticks = "".join(f'<div class="tick" style="left:{20 * i}%"></div>'
                    for i in range(1, 5))
    bars_src = TRIANGLE_BARS if show_triangle_metrics else FEATURE_BARS
    bars = []
    for key, label in bars_src:
        colour = _xterm256_to_hex(BAR_COLOURS[key])
        ghost = (f'<div class="ghost" id="g_{key}"></div>'
                 f'<div class="avg" id="a_{key}" style="display:none">'
                 '</div>') if show_ghost_stats else ""
        bars.append(
            f'<div class="bar"><span class="lbl">{label}</span>'
            f'<span class="val" id="v_{key}">0.0%</span>'
            f'<div class="rail">{ghost}<div class="fill" id="f_{key}" '
            f'style="background:{colour}"></div></div></div>')
    params = []
    for pid, lo, hi, value in param_specs:
        step = (hi - lo) / 200.0 or 1.0
        pid = _html.escape(str(pid), quote=True)
        params.append(
            f'<div class="param"><label>{pid}</label>'
            f'<input type="range" id="p_{pid}" data-pid="{pid}" '
            f'min="{lo}" max="{hi}" step="{step}" value="{value}">'
            f'<span class="pv" id="pv_{pid}">{value:.2f}</span></div>')
    return _PAGE.format(title=title, accent_deg=accent_deg, ticks=ticks,
                        bars="\n".join(bars), params="\n".join(params))


class MeterWebServer:
    """The editor process: owns the SAME MeterPanel model the terminal
    renderer uses, serves the page + 20 Hz /state JSON, and queues slider
    edits for the processing loop to apply between blocks.

    Thread bridge contract (mirrors the reference's APVTS atomics): the
    render loop calls `set_metrics()` after each block and
    `pop_param_edits()` before each block; the HTTP threads only touch
    the shared snapshot/queue under the lock. `set_params_view()` tells
    the page what the loop's current values are (sliders follow, unless
    the mouse is on them)."""

    def __init__(self, title: str,
                 param_specs: List[Tuple[str, float, float, float]],
                 show_ghost_stats: bool = False,
                 show_triangle_metrics: bool = False,
                 host: str = "127.0.0.1", port: int = 0):
        self.panel = MeterPanel(title, show_ghost_stats=show_ghost_stats,
                                show_triangle_metrics=show_triangle_metrics)
        self._specs = {pid: (lo, hi) for pid, lo, hi, _ in param_specs}
        self._html = panel_html(title, param_specs,
                                show_ghost_stats=show_ghost_stats,
                                show_triangle_metrics=show_triangle_metrics)
        self._lock = threading.Lock()
        self._stop = False
        self._edits: Dict[str, float] = {}
        self._params_view = {pid: v for pid, _, _, v in param_specs}
        self._state = {"pre_score": 0.0, "post_score": 0.0, "bars": {},
                       "params": dict(self._params_view), "running": True}
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):      # quiet
                pass

            def _send(self, code: int, body: bytes, ctype: str):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path.rstrip("/") in ("", "/index.html"):
                    self._send(200, server._html.encode(),
                               "text/html; charset=utf-8")
                elif self.path.lstrip("/") == "state":
                    with server._lock:
                        body = json.dumps(server._state).encode()
                    self._send(200, body, "application/json")
                else:
                    self._send(404, b"not found", "text/plain")

            def _same_origin(self) -> bool:
                """Reject cross-origin 'simple' POSTs (DNS-rebinding/CSRF
                against the loopback editor): the Host header must be the
                bound address, and an Origin header, when the browser sends
                one, must point back at it."""
                bound = "%s:%d" % self.server.server_address[:2]
                host = (self.headers.get("Host") or "").strip()
                if host not in (bound, bound.replace("127.0.0.1",
                                                     "localhost")):
                    return False
                origin = (self.headers.get("Origin") or "").strip()
                if origin and origin not in (f"http://{bound}",
                                             "http://" + bound.replace(
                                                 "127.0.0.1", "localhost")):
                    return False
                return True

            def do_POST(self):
                if not self._same_origin():
                    self._send(403, b"cross-origin rejected", "text/plain")
                    return
                if self.path.lstrip("/") == "stop":
                    with server._lock:
                        server._stop = True
                    self._send(200, b"ok", "text/plain")
                    return
                if self.path.lstrip("/") != "param":
                    self._send(404, b"not found", "text/plain")
                    return
                n = int(self.headers.get("Content-Length", 0))
                try:
                    msg = json.loads(self.rfile.read(n))
                    pid, value = str(msg["id"]), float(msg["value"])
                    lo, hi = server._specs[pid]
                except (KeyError, TypeError, ValueError,
                        json.JSONDecodeError):
                    # TypeError covers {"value": null} / non-dict bodies
                    self._send(400, b"bad edit", "text/plain")
                    return
                with server._lock:
                    server._edits[pid] = min(hi, max(lo, value))
                self._send(200, b"ok", "text/plain")

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()

    @property
    def url(self) -> str:
        host, port = self._httpd.server_address[:2]
        return f"http://{host}:{port}/"

    # -- called from the processing loop ---------------------------------

    def set_metrics(self, metrics: Dict[str, float]) -> None:
        """Feed one snapshot through the shared numeric model and publish
        the smoothed view (== the 20 Hz timer tick)."""

        def fin(x):
            # a NaN/Inf metric (degenerate audio) would emit bare NaN —
            # invalid JSON, which silently stalls the browser's poll loop
            x = float(x)
            return x if math.isfinite(x) else 0.0

        self.panel.set_metrics(metrics)
        bars = {}
        for key, _ in FEATURE_BARS + TRIANGLE_BARS:
            st = self.panel.stats.get(key)
            bars[key] = {
                "value": fin(self.panel.smoothed.get(key, 0.0)),
                "min": fin(st.min) if st else 0.0,
                "max": fin(st.max) if st else 0.0,
                "avg": fin(st.avg) if st else 0.0,
                "count": st.count if st else 0,
            }
        with self._lock:
            self._state["pre_score"] = fin(
                self.panel.smoothed.get("pre_score", 0.0))
            self._state["post_score"] = fin(
                self.panel.smoothed.get("post_score", 0.0))
            self._state["bars"] = bars
            self._state["params"] = dict(self._params_view)

    def set_params_view(self, params: Dict[str, float]) -> None:
        with self._lock:
            self._params_view = {k: float(v) for k, v in params.items()
                                 if k in self._specs}

    @property
    def stop_requested(self) -> bool:
        """True once the page's "stop render" control was clicked."""
        with self._lock:
            return self._stop

    def pop_param_edits(self) -> Dict[str, float]:
        """Drain queued slider edits (range-clamped). The loop applies
        them before the next block — the processBlock-top atomics read."""
        with self._lock:
            edits, self._edits = self._edits, {}
        return edits

    def mark_done(self) -> None:
        with self._lock:
            self._state["running"] = False

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
