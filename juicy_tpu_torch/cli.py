"""CLI: the Standalone-host analog (offline, batch-first). PyTorch port of
juicy_tpu/cli.py: the same sub-commands, flags, output text and files,
plus ``--device``.

  python -m juicy_tpu_torch list
  python -m juicy_tpu_torch process in.wav out.wav --plugin saturator \\
      --preset "Amber Heat" --set drive=12 --meters --metrics-jsonl m.jsonl
  python -m juicy_tpu_torch chain in.wav out.wav --stages punch,saturator,width
  python -m juicy_tpu_torch score in.wav            # JuicyInfer-style analysis
  python -m juicy_tpu_torch corpus a.wav b.wav --stages ... --checkpoint ck.json
  python -m juicy_tpu_torch serve a.wav b.wav --stages ...

Every command runs on the CUDA card, and raises without one; ``--device
cpu`` runs the plain PyTorch route. ``process`` and ``score`` step block
by block through the plugin's stage kernel where it has one
(runtime/host_bridge.py ``StreamStep``); ``chain`` and ``corpus`` go
through ``run_corpus_chain`` (the canonical chain on the chain kernel);
``serve`` through ``StreamServer``.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch


def _build_plugin(args, sr, channels):
    from juicy_tpu_torch.runtime.plugin import Plugin
    plug = Plugin(args.plugin, sr, channels, args.block)
    params = plug.preset(args.preset) if args.preset is not None \
        else plug.default_params()
    for kv in args.set or []:
        k, v = kv.split("=", 1)
        if k in plug.defn.static_params:
            plug._static[k] = int(float(v))
        else:
            params[k] = torch.tensor(np.float32(float(v)))
    return plug, params


def cmd_list(args):
    from juicy_tpu_torch.models.base import registry
    import juicy_tpu_torch.models  # noqa: F401
    for name, defn in sorted(registry.items()):
        presets = ", ".join(defn.preset_names()) or "—"
        print(f"{name:10s} [{defn.code}] {defn.title}")
        for p in defn.params:
            ro = " (read-only)" if p.readonly else ""
            kind = f" choices={list(p.choices)}" if p.choices else \
                (" bool" if p.boolean else f" range=[{p.lo}, {p.hi}]")
            print(f"    {p.id:12s} default={p.default}{kind}{ro}")
        print(f"    presets: {presets}")


def _blocks(plug, audio, device):
    """(the [C, T] clip zero-padded to whole blocks as [1, C, T'] on
    `device`, T, the block count)."""
    from juicy_tpu_torch.runtime.stream import pad_to_blocks

    padded, t = pad_to_blocks(torch.as_tensor(audio), plug.block_size)
    padded = padded.to(torch.float32)[None].to(device)
    return padded, t, padded.shape[-1] // plug.block_size


def _stream(plug, params, audio, sr, meters=False, jsonl=None,
            triangle=False, ghost=False, device=None):
    from juicy_tpu_torch.runtime.host_bridge import StreamStep
    from juicy_tpu_torch.runtime.stream import metrics_to_rows
    from juicy_tpu_torch.ui.meters import MeterPanel

    stepper = StreamStep(plug, 1, device)
    padded, t, nb = _blocks(plug, audio, stepper.device)
    n = plug.block_size
    outs, metrics = [], []
    for k in range(nb):
        out, m = stepper.step(params, padded[..., k * n:(k + 1) * n])
        outs.append(out[0])
        metrics.append({key: v[0] for key, v in m.items()})
    out = torch.cat(outs, dim=-1).cpu().numpy()[..., :t]
    rows = metrics_to_rows({key: torch.stack([m[key] for m in metrics])
                            for key in metrics[0]})
    if jsonl:
        with open(jsonl, "w") as f:
            for row in rows:
                f.write(json.dumps(row) + "\n")
    if meters:
        panel = MeterPanel(plug.defn.title, show_ghost_stats=ghost,
                           show_triangle_metrics=triangle)
        for row in rows:
            panel.set_metrics(row)
        print(panel.render())
    return out, rows


def _parse_automation(specs, num_blocks):
    """--automate punch=0.2,1.4 -> per-block linear curves (the host-writes-
    APVTS-between-blocks analog, JuicyPunch/PluginProcessor.cpp:74-80)."""
    from juicy_tpu_torch.runtime.stream import automation_curve
    auto = {}
    for spec in specs or []:
        k, v = spec.split("=", 1)
        vals = [float(x) for x in v.split(",")]
        auto[k] = automation_curve(vals, num_blocks)
    return auto


class _KeyReader:
    """Non-blocking single-key reader (cbreak mode); inert without a tty."""

    def __init__(self):
        import sys
        self.enabled = sys.stdin.isatty()
        self._old = None

    def __enter__(self):
        if self.enabled:
            import sys
            import termios
            import tty
            self._fd = sys.stdin.fileno()
            self._old = termios.tcgetattr(self._fd)
            tty.setcbreak(self._fd)
        return self

    def __exit__(self, *exc):
        if self._old is not None:
            import termios
            termios.tcsetattr(self._fd, termios.TCSADRAIN, self._old)

    def poll(self):
        if not self.enabled:
            return None
        import select
        import sys
        if select.select([sys.stdin], [], [], 0)[0]:
            ch = sys.stdin.read(1)
            if ch == "\x1b":      # arrow keys: ESC [ A/B/C/D
                if select.select([sys.stdin], [], [], 0.01)[0]:
                    seq = sys.stdin.read(2)
                    return {"[A": "up", "[B": "down", "[C": "right",
                            "[D": "left"}.get(seq)
                return "esc"
            return ch
    # keys: up/down select param, left/right nudge +-2% of range,
    # shift via </> for 10%, q quits


def _stream_live(plug, params, audio, sr, refresh_hz=20.0, realtime=False,
                 automation=None, title=None, interactive=False,
                 web_port=None, loops=1, device=None):
    """Block-by-block render with a live-updating meter panel.

    The reference UX: a 20 Hz juce::Timer polls getLatestMetrics and
    repaints the meter (JuicyPluginEditor.cpp:36,85-90) over auto-generated
    parameter sliders (createControls, :104-131); here the panel repaints
    in place (ANSI cursor control) while blocks stream, with parameter
    automation applied mid-run and, with `interactive` on a tty, keyboard
    param editing (up/down select, left/right nudge). `realtime` paces the
    loop to the audio clock (1x); otherwise it renders as fast as the card
    goes. Each block steps through the plugin's stage kernel where it has
    one (``StreamStep``).

    `web_port` also serves the windowed editor (ui/web.py: painted meters
    and mouse sliders over HTTP, the same numeric model); slider edits are
    applied between blocks like the reference's APVTS atomics. `loops`
    replays the input N times (0 = forever) so the web editor stays live;
    the written output is the first pass.
    """
    import sys
    import time
    from juicy_tpu_torch.runtime.host_bridge import StreamStep
    from juicy_tpu_torch.ui.meters import MeterPanel

    stepper = StreamStep(plug, 1, device)
    padded, t, nb = _blocks(plug, audio, stepper.device)
    automation = automation or {}
    panel = MeterPanel(title or plug.defn.title,
                       show_ghost_stats=plug.defn.show_ghost_stats,
                       show_triangle_metrics=plug.defn.show_triangle_metrics)
    params = dict(params)
    editable = [pid for pid in params if not plug.defn.param(pid).readonly]
    web = None
    if web_port is not None:
        from juicy_tpu_torch.ui.web import MeterWebServer
        specs = [(pid, float(plug.defn.param(pid).lo),
                  float(plug.defn.param(pid).hi), float(params[pid]))
                 for pid in editable]
        web = MeterWebServer(title or plug.defn.title, specs,
                             show_ghost_stats=plug.defn.show_ghost_stats,
                             show_triangle_metrics=(
                                 plug.defn.show_triangle_metrics),
                             port=web_port)
        print(f"web editor: {web.url}")
    sel = 0
    outs = []
    block_s = plug.block_size / sr
    last_paint = 0.0
    painted_lines = 0
    stop = False
    rep = 0
    done_blocks = 0
    start = time.perf_counter()
    with _KeyReader() as keys:
        while not stop and (loops == 0 or rep < loops):
            for k in range(nb):
                if stop:
                    break
                if interactive:
                    key = keys.poll()
                    while key is not None:
                        if key == "q":
                            stop = True   # finish this block, then stop
                        elif key == "up":
                            sel = (sel - 1) % max(1, len(editable))
                        elif key == "down":
                            sel = (sel + 1) % max(1, len(editable))
                        elif key in ("left", "right", "<", ">") and editable:
                            pid = editable[sel]
                            spec = plug.defn.param(pid)
                            pct = 0.10 if key in ("<", ">") else 0.02
                            sign = 1.0 if key in ("right", ">") else -1.0
                            v = float(params[pid]) + sign * pct * (
                                spec.hi - spec.lo)
                            params[pid] = torch.tensor(
                                np.float32(min(spec.hi, max(spec.lo, v))))
                        key = keys.poll()
                if web is not None:
                    if web.stop_requested:
                        stop = True
                    for pid, v in web.pop_param_edits().items():
                        params[pid] = torch.tensor(np.float32(v))
                blk = padded[..., k * plug.block_size:
                             (k + 1) * plug.block_size]
                p = dict(params)
                for key2, curve in automation.items():
                    p[key2] = curve[k]
                out, metrics = stepper.step(p, blk)
                if rep == 0:
                    outs.append(out[0].cpu().numpy())
                done_blocks += 1
                now = time.perf_counter()
                if now - last_paint >= 1.0 / refresh_hz or k == nb - 1:
                    snap = {key2: float(v[0]) for key2, v in metrics.items()}
                    panel.set_metrics(snap)
                    if web is not None:
                        web.set_metrics(snap)
                        web.set_params_view({pid: float(params[pid])
                                             for pid in editable})
                    frame = panel.render()
                    if interactive and editable:
                        rows = []
                        for i, pid in enumerate(editable):
                            spec = plug.defn.param(pid)
                            v = float(params[pid])
                            frac = (v - spec.lo) / (spec.hi - spec.lo or 1.0)
                            bar = "█" * int(round(24 * frac))
                            cur = "▶" if i == sel else " "
                            rows.append(f"  {cur} {pid:12s} [{bar:<24s}] "
                                        f"{v:7.2f}")
                        frame += "\n" + "\n".join(rows) + \
                            "\n  ↑/↓ select · ←/→ nudge · </> coarse · q stop"
                    if painted_lines:
                        sys.stdout.write(f"\x1b[{painted_lines}F\x1b[J")
                    sys.stdout.write(frame + "\n")
                    sys.stdout.flush()
                    painted_lines = frame.count("\n") + 1
                    last_paint = now
                if realtime:
                    target = start + done_blocks * block_s
                    delay = target - time.perf_counter()
                    if delay > 0:
                        time.sleep(delay)
            rep += 1
    if web is not None:
        web.mark_done()
        web.close()
    return np.concatenate(outs, axis=-1)[..., :t]


def cmd_process(args):
    from juicy_tpu_torch.runtime.wav import read_wav, write_wav
    audio, sr = read_wav(args.input)
    plug, params = _build_plugin(args, sr, audio.shape[0])
    if getattr(args, "live", False):
        nb = (audio.shape[-1] + args.block - 1) // args.block
        auto = _parse_automation(args.automate, nb)
        out = _stream_live(plug, params, audio, sr,
                           realtime=getattr(args, "realtime", False),
                           automation=auto,
                           interactive=getattr(args, "interactive", False),
                           web_port=getattr(args, "web", None),
                           loops=getattr(args, "loop", 1),
                           device=args.device)
        rows = []
    else:
        out, rows = _stream(plug, params, audio, sr, meters=args.meters,
                            jsonl=args.metrics_jsonl,
                            triangle=plug.defn.show_triangle_metrics,
                            ghost=plug.defn.show_ghost_stats,
                            device=args.device)
    write_wav(args.output, out, sr)
    last = rows[-1] if rows else {}
    if rows:
        print(f"wrote {args.output}  juiciness={last.get('score', 0.0):.1f} "
              f"(pre {last.get('pre_score', 0.0):.1f})")
    else:
        print(f"wrote {args.output}")


def _parse_stages(spec):
    """'punch,saturator' or 'punch:Solar Snap,width:Prism Arc' -> stage
    list with optional per-stage presets."""
    stages = []
    for part in spec.split(","):
        name, _, preset = part.partition(":")
        stages.append((name.strip(), preset.strip() or None))
    return stages


def cmd_chain(args):
    """Chain render through ``run_corpus_chain`` on a corpus of one clip:
    the canonical seven-stage stereo chain on the chain kernel, any other
    chain through the block-major executor (``fused_chain_stream``)."""
    import time
    from juicy_tpu_torch.parallel.corpus import run_corpus_chain
    from juicy_tpu_torch.runtime.device import resolve_device
    from juicy_tpu_torch.runtime.plugin import Chain
    from juicy_tpu_torch.runtime.stream import pad_to_blocks
    from juicy_tpu_torch.runtime.wav import read_wav, write_wav

    audio, sr = read_wav(args.input)
    stages = _parse_stages(args.stages)
    chain = Chain(stages, sr=sr, channels=audio.shape[0],
                  block_size=args.block)
    padded, t = pad_to_blocks(torch.from_numpy(audio), args.block)
    device = resolve_device(args.device)
    t0 = time.perf_counter()
    out, metrics, _agg = run_corpus_chain(chain, padded[None],
                                          metrics=args.metrics, device=device)
    out = out[0].cpu().numpy()
    wall = time.perf_counter() - t0
    write_wav(args.output, out[..., :t], sr)
    x_rt = (t / sr) / max(wall, 1e-9)
    if metrics is None:
        print(f"wrote {args.output}  ({x_rt:.1f}x realtime incl. compile)")
        return
    if args.metrics == "final":
        scores = [float(m["score"][0]) for m in metrics]
    else:
        scores = [float(m["score"][-1, 0]) for m in metrics]
    print(f"wrote {args.output}  stage scores: " +
          " → ".join(f"{s:.1f}" for s in scores) +
          f"  ({x_rt:.1f}x realtime incl. compile)")


def cmd_score(args):
    from juicy_tpu_torch.runtime.wav import read_wav
    args.plugin = "infer"
    args.preset = None
    args.set = args.set or []
    audio, sr = read_wav(args.input)
    plug, params = _build_plugin(args, sr, audio.shape[0])
    _, rows = _stream(plug, params, audio, sr, meters=args.meters,
                      jsonl=args.metrics_jsonl, triangle=True, ghost=True,
                      device=args.device)
    agg = {k: float(np.mean([r[k] for r in rows])) for k in rows[0]}
    print(json.dumps(agg, indent=2))


def _materials(spec, n_clips, stages):
    from juicy_tpu_torch.models.texture import PARAMS as _TEX_PARAMS
    names = [c.lower() for c in _TEX_PARAMS[0].choices]

    def mat_index(tok):
        tok = tok.strip()
        try:
            return int(float(tok))
        except ValueError:
            low = tok.lower()
            for i, nm in enumerate(names):
                if nm.startswith(low):
                    return i
            raise SystemExit(f"unknown material {tok!r}; "
                             f"choices: {_TEX_PARAMS[0].choices}")
    toks = spec.split(",")
    if len(toks) == 1:
        toks = toks * n_clips
    if len(toks) != n_clips:
        raise SystemExit(f"--materials needs 1 or {n_clips} values, "
                         f"got {len(toks)}")
    mats = np.array([mat_index(t) for t in toks])
    if not any(s[0] == "texture" for s in stages):
        raise SystemExit("--materials needs a texture stage in --stages")
    return mats


def cmd_corpus(args):
    """Batch a corpus of WAVs through ``run_corpus_chain`` in macro batches
    with a resumable cursor checkpoint: an interrupted run restarts at the
    last completed batch."""
    import os
    import time
    from juicy_tpu_torch.parallel.corpus import run_corpus_chain
    from juicy_tpu_torch.parallel.mesh import make_mesh
    from juicy_tpu_torch.runtime.device import resolve_device
    from juicy_tpu_torch.runtime.plugin import Chain
    from juicy_tpu_torch.runtime.wav import read_wav, write_wav

    # no --device: every visible card, the clips split over them
    mesh = make_mesh() if args.device is None else None
    device = None if mesh is not None else resolve_device(args.device)
    ndev = 1 if mesh is None else mesh.size
    os.makedirs(args.out_dir, exist_ok=True)
    stages = _parse_stages(args.stages)
    clips, srs = [], []
    for path in args.inputs:
        audio, sr = read_wav(path)
        clips.append(audio)
        srs.append(sr)
    if any(s != srs[0] for s in srs):
        raise SystemExit(f"sample rates differ across inputs: {sorted(set(srs))}")
    channels = clips[0].shape[0]
    if any(c.shape[0] != channels for c in clips):
        raise SystemExit("channel counts differ across inputs")
    sr = srs[0]
    lengths = [c.shape[-1] for c in clips]
    t = max(lengths)
    t = ((t + args.block - 1) // args.block) * args.block
    corpus = np.zeros((len(clips), channels, t), np.float32)
    for i, c in enumerate(clips):
        corpus[i, :, :c.shape[-1]] = c

    chain = Chain(stages, sr=sr, channels=channels, block_size=args.block)
    score_only = bool(getattr(args, "score_only", False))
    mats = None
    if getattr(args, "materials", None):
        mats = _materials(args.materials, len(clips), stages)

    done = 0
    if args.checkpoint and os.path.exists(args.checkpoint):
        with open(args.checkpoint) as f:
            ck = json.load(f)
        if ck.get("total") == len(clips) and ck.get("stages") == args.stages:
            done = int(ck.get("done", 0))
            print(f"resuming at clip {done}/{len(clips)}")

    # macro batches of --batch clips rounded up to the device count, so
    # that the split over the cards divides; the last batch is padded with
    # silent clips to a multiple of the device count (clips are
    # independent), and their results are dropped
    macro = max(1, (args.batch + ndev - 1) // ndev) * ndev
    t0 = time.perf_counter()
    scores = []
    while done < len(clips):
        end = min(len(clips), done + macro)
        chunk = corpus[done:end]
        chunk_mats = None if mats is None else mats[done:end]
        pad = -chunk.shape[0] % ndev
        if pad:
            chunk = np.concatenate([chunk, np.zeros(
                (pad,) + chunk.shape[1:], np.float32)])
            if chunk_mats is not None:
                chunk_mats = np.concatenate(
                    [chunk_mats, np.full(pad, chunk_mats[0])])
        out, ms, _agg = run_corpus_chain(
            chain, torch.from_numpy(chunk), metrics="final",
            materials=chunk_mats, return_audio=not score_only,
            device=device, mesh=mesh)
        if not score_only:
            out = out.cpu().numpy()
            for i in range(done, end):
                dest = os.path.join(
                    args.out_dir, os.path.basename(args.inputs[i]))
                write_wav(dest, out[i - done][..., :lengths[i]], sr)
        final = ms[-1]["score"].cpu().numpy()
        scores.extend(float(v) for v in final[:end - done])
        done = end
        if args.checkpoint:
            with open(args.checkpoint, "w") as f:
                json.dump({"done": done, "total": len(clips),
                           "stages": args.stages}, f)
        print(f"batch done: {done}/{len(clips)} clips")
    wall = time.perf_counter() - t0
    audio_sec = sum(lengths) / sr
    print(f"corpus: {len(clips)} clips, mean juiciness "
          f"{float(np.mean(scores)):.1f}, {audio_sec:.1f} audio-sec in "
          f"{wall:.2f}s ({audio_sec / wall:.0f}x realtime incl. compile)")


def cmd_serve(args):
    """Multi-stream serving demo: process several WAVs as concurrent
    realtime streams through one batched chain (runtime/serve.py)."""
    import time
    from juicy_tpu_torch.runtime.plugin import Chain
    from juicy_tpu_torch.runtime.serve import StreamServer
    from juicy_tpu_torch.runtime.stream import pad_to_blocks
    from juicy_tpu_torch.runtime.wav import read_wav, write_wav

    stages = _parse_stages(args.stages)
    inputs = args.inputs
    clips, srs = [], []
    for path in inputs:
        audio, sr = read_wav(path)
        clips.append(audio)
        srs.append(sr)
    sr = srs[0]
    if any(s != sr for s in srs):
        raise SystemExit(
            f"all inputs must share one sample rate; got {sorted(set(srs))}")
    if any(c.shape[0] != clips[0].shape[0] for c in clips):
        raise SystemExit("all inputs must share one channel count; got " +
                         str(sorted({c.shape[0] for c in clips})))
    chain = Chain(stages, sr=sr, channels=clips[0].shape[0],
                  block_size=args.block)
    server = StreamServer(chain, max_streams=max(4, len(inputs)),
                          wire=args.wire, audio_out=not args.meter_only,
                          device=args.device)
    sids = [server.open_stream() for _ in inputs]
    padded = [pad_to_blocks(torch.from_numpy(c), args.block)[0].numpy()
              for c in clips]
    n_blocks = [p.shape[-1] // args.block for p in padded]
    outs = {sid: [] for sid in sids}
    scores = {sid: 0.0 for sid in sids}
    t0 = time.perf_counter()
    ticks = 0
    for k in range(max(n_blocks)):
        for sid, pad, nb in zip(sids, padded, n_blocks):
            if k < nb:
                server.submit(sid, pad[..., k * args.block:
                                       (k + 1) * args.block])
        for sid, res in server.tick().items():
            if "audio" in res:
                outs[sid].append(res["audio"])
            scores[sid] = res.get("score", 0.0)
        ticks += 1
    wall = time.perf_counter() - t0
    for i, (sid, path) in enumerate(zip(sids, inputs)):
        if args.meter_only:
            print(f"stream {i}: {path}  score {scores[sid]:.1f}")
            continue
        out = np.concatenate(outs[sid], axis=-1)[..., :clips[i].shape[-1]]
        if args.wire == "i16":
            out = out.astype(np.float32) / 32768.0
        dest = args.out_prefix + f"{i}.wav"
        write_wav(dest, out, sr)
        print(f"stream {i}: {path} -> {dest}")
    audio_sec = sum(c.shape[-1] for c in clips) / sr
    print(f"served {len(inputs)} streams, {audio_sec:.1f} audio-sec in "
          f"{wall:.2f}s ({audio_sec / wall:.1f}x realtime aggregate, "
          f"{ticks} ticks)")


def _device_arg(p):
    p.add_argument("--device",
                   help="torch device to run on (default: the CUDA card, "
                        "which must exist; cpu runs the plain PyTorch "
                        "route)")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="juicy_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    sub.add_parser("list", help="list processors, params, presets")

    for name in ("process", "score"):
        p = sub.add_parser(name)
        p.add_argument("input")
        if name == "process":
            p.add_argument("output")
            p.add_argument("--plugin", required=True)
            p.add_argument("--preset")
        p.add_argument("--block", type=int, default=512)
        p.add_argument("--set", action="append", metavar="PARAM=VALUE")
        p.add_argument("--meters", action="store_true")
        p.add_argument("--metrics-jsonl")
        _device_arg(p)
        if name == "process":
            p.add_argument("--live", action="store_true",
                           help="repaint the meter panel at ~20 Hz while "
                                "rendering (JuicyPluginEditor analog)")
            p.add_argument("--realtime", action="store_true",
                           help="pace --live at 1x audio rate")
            p.add_argument("--automate", action="append",
                           metavar="PARAM=V0,V1,...",
                           help="linear per-block automation curve applied "
                                "mid-run (repeatable)")
            p.add_argument("--interactive", action="store_true",
                           help="with --live on a tty: keyboard param "
                                "editing while rendering (up/down select, "
                                "left/right nudge — the auto-generated "
                                "slider surface analog)")
            p.add_argument("--web", type=int, metavar="PORT",
                           help="with --live: also serve the WINDOWED "
                                "editor (painted meters + mouse sliders, "
                                "ui/web.py) at http://127.0.0.1:PORT "
                                "(0 = any free port)")
            p.add_argument("--loop", type=int, default=1, metavar="N",
                           help="with --live: replay the input N times "
                                "(0 = forever) so the editor stays live")

    p = sub.add_parser("chain")
    p.add_argument("input")
    p.add_argument("output")
    p.add_argument("--stages", required=True,
                   help="comma-separated processor names, each optionally "
                        "name:preset")
    p.add_argument("--block", type=int, default=512)
    p.add_argument("--metrics", choices=("blocks", "final", "none"),
                   default="blocks",
                   help="per-block metrics (default), final block only, or "
                        "skip analyzers entirely (fastest, not "
                        "reference-faithful)")
    _device_arg(p)

    p = sub.add_parser("corpus", help="batch a directory of WAVs through a "
                                      "chain with resumable checkpoints")
    p.add_argument("inputs", nargs="+", help="input WAV files")
    p.add_argument("--stages", required=True)
    p.add_argument("--block", type=int, default=512)
    p.add_argument("--out-dir", default="corpus_out")
    p.add_argument("--checkpoint", help="resume checkpoint path; the run "
                                        "restarts from the last completed "
                                        "batch after an interruption")
    p.add_argument("--batch", type=int, default=64,
                   help="clips per device batch")
    p.add_argument("--score-only", action="store_true",
                   help="metrics only: the processed audio is never "
                        "written back (fastest scoring mode)")
    p.add_argument("--materials",
                   help="per-clip texture material (comma-separated names "
                        "or indices, one per input or a single value): on "
                        "the chain kernel each CTA of 32 clips runs one "
                        "material, the corpus sorted by material once")
    _device_arg(p)

    p = sub.add_parser("serve", help="batched multi-stream serving demo")
    p.add_argument("inputs", nargs="+")
    p.add_argument("--stages", default="punch,saturator,infer")
    p.add_argument("--block", type=int, default=512)
    p.add_argument("--out-prefix", default="served_")
    p.add_argument("--wire", choices=("f32", "i16"), default="f32",
                   help="host<->device transport: i16 halves the bytes "
                        "(PCM16 wire, f32 processing on device)")
    p.add_argument("--meter-only", action="store_true",
                   help="metering rail: report scores, skip the audio "
                        "readback/render entirely (audio_out=False)")
    _device_arg(p)

    args = ap.parse_args(argv)
    {"list": cmd_list, "process": cmd_process, "chain": cmd_chain,
     "score": cmd_score, "serve": cmd_serve,
     "corpus": cmd_corpus}[args.cmd](args)


if __name__ == "__main__":
    main()
