"""PyTorch port vs JAX: the meter panel and the web editor (ui/meters.py,
ui/web.py, copied into the port).

``MeterPanel.render()`` gives the same strings as JAX's over the same
metric sequence, in every mode; ``panel_html`` is the same page; the web
server round trip (GET the page and the state, POST an edit, the
cross-origin guard, stop) behaves as tests/test_ui_web.py has JAX's, and
the two servers answer the same requests with the same bodies. JAX's
``_same_origin`` refuses every POST when the server binds a wildcard
address; the port keeps that behaviour (ROADMAP.md Queue 3).
"""

import json
import urllib.error
import urllib.request

import numpy as np
import pytest

from juicy_tpu.ui import meters as jmeters
from juicy_tpu.ui import web as jweb
from juicy_tpu_torch.ui import meters as tmeters
from juicy_tpu_torch.ui import web as tweb

SPECS = [("punch", 0.0, 1.0, 0.5), ("clip", 0.0, 1.0, 0.25),
         ("mix", 0.0, 100.0, 42.0)]


def _metric_rows(n, seed):
    rng = np.random.default_rng(seed)
    keys = [k for k, _ in jmeters.FEATURE_BARS + jmeters.TRIANGLE_BARS]
    rows = []
    for _ in range(n):
        row = {k: float(rng.uniform(-0.2, 1.2)) for k in keys}
        row.update(pre_score=float(rng.uniform(0, 100)),
                   post_score=float(rng.uniform(0, 100)),
                   score=float(rng.uniform(0, 100)))
        if rng.uniform() < 0.2:
            row["pre_score"] = 0.0          # falls back to score
        rows.append(row)
    return rows


@pytest.mark.parametrize("ghost", [False, True])
@pytest.mark.parametrize("triangle", [False, True])
def test_torch_meter_panel_renders_as_jax(ghost, triangle):
    jp = jmeters.MeterPanel("Juicy Infer", show_ghost_stats=ghost,
                            show_triangle_metrics=triangle)
    tp = tmeters.MeterPanel("Juicy Infer", show_ghost_stats=ghost,
                            show_triangle_metrics=triangle)
    assert tp.render() == jp.render()
    for row in _metric_rows(12, 1 + ghost + 2 * triangle):
        jp.set_metrics(row)
        tp.set_metrics(row)
        assert tp.render() == jp.render()
    assert tmeters.accent_hue_from_title("Juicy Infer") == \
        jmeters.accent_hue_from_title("Juicy Infer")


@pytest.mark.parametrize("title", ["JuicyPunch", "Juicy <Infer> & co"])
@pytest.mark.parametrize("ghost,triangle", [(False, False), (True, True)])
def test_torch_panel_html_as_jax(title, ghost, triangle):
    assert tweb.panel_html(title, SPECS, show_ghost_stats=ghost,
                           show_triangle_metrics=triangle) == \
        jweb.panel_html(title, SPECS, show_ghost_stats=ghost,
                        show_triangle_metrics=triangle)
    for idx in (0, 9, 16, 100, 196, 231, 232, 255):
        assert tweb._xterm256_to_hex(idx) == jweb._xterm256_to_hex(idx)


def _request(url, body=None, headers=()):
    req = urllib.request.Request(url, data=body,
                                 method="GET" if body is None else "POST")
    for k, v in headers:
        req.add_header(k, v)
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _script(srv):
    """One editor session; every answer the server gives, in order."""
    seen = [_request(srv.url)]
    for row in _metric_rows(4, 7):
        srv.set_metrics(row)
    seen.append(_request(srv.url + "state"))
    seen.append(_request(srv.url + "param", json.dumps(
        {"id": "punch", "value": 7.5}).encode()))
    seen.append(srv.pop_param_edits())
    seen.append(srv.pop_param_edits())
    for body in (json.dumps({"id": "nope", "value": 1}).encode(),
                 b"{not json", json.dumps({"id": "mix",
                                           "value": None}).encode()):
        seen.append(_request(srv.url + "param", body))
    srv.set_params_view({"punch": 0.8, "clip": 0.1, "ignored": 9.0})
    srv.set_metrics({"pre_score": float("nan"), "post_score": float("inf")})
    seen.append(_request(srv.url + "state"))
    seen.append(_request(srv.url + "stop", b"",
                         headers=[("Host", "evil.example:80")])[0])
    seen.append(_request(srv.url + "stop", b"",
                         headers=[("Origin", "http://evil.example")])[0])
    seen.append(srv.stop_requested)
    seen.append(_request(srv.url + "stop", b"")[0])
    seen.append(srv.stop_requested)
    seen.append(_request(srv.url + "nowhere"))
    srv.mark_done()
    seen.append(json.loads(_request(srv.url + "state")[1])["running"])
    return seen


def test_torch_web_server_round_trip():
    servers = [mod.MeterWebServer("JuicyPunch", SPECS, show_ghost_stats=True)
               for mod in (jweb, tweb)]
    try:
        jseen, tseen = (_script(s) for s in servers)
    finally:
        for s in servers:
            s.close()
    assert tseen == jseen
    status, body = tseen[0]
    assert status == 200 and b"JUICINESS INDEX" in body
    state = json.loads(tseen[1][1])
    ref = tmeters.MeterPanel("JuicyPunch", show_ghost_stats=True)
    for row in _metric_rows(4, 7):
        ref.set_metrics(row)
    assert state["pre_score"] == pytest.approx(ref.smoothed["pre_score"])
    assert tseen[3] == {"punch": 1.0} and tseen[4] == {}
    assert [s for s, _ in tseen[5:8]] == [400, 400, 400]
    last = json.loads(tseen[8][1])
    assert last["pre_score"] == 0.0
    assert last["params"] == {"punch": 0.8, "clip": 0.1}
    assert tseen[9:15] == [403, 403, False, 200, True, (404, b"not found")]
    assert tseen[15] is False


def test_torch_web_server_wildcard_bind_refuses_posts():
    """Bound to every interface, both editors refuse a same-host POST: the
    Host header never equals the wildcard address (JAX's behaviour, kept)."""
    for mod in (jweb, tweb):
        srv = mod.MeterWebServer("JuicyPunch", SPECS, host="0.0.0.0")
        try:
            port = srv._httpd.server_address[1]
            status, _ = _request(f"http://127.0.0.1:{port}/param", json.dumps(
                {"id": "punch", "value": 0.3}).encode())
            assert status == 403
            assert srv.pop_param_edits() == {}
        finally:
            srv.close()
