"""PyTorch port vs JAX: WAV and native I/O, the host bridge and the
pipelined stream (runtime/wav.py, runtime/native.py,
runtime/host_bridge.py), on the CPU.

- ``write_wav`` writes files byte-identical to JAX's (float32 and PCM16),
  and ``read_wav`` reads JAX's files (and 24-bit PCM) to the same arrays.
- ``native.wav_info``, ``load_corpus`` (padding, truncation, mono) and
  ``RingBuffer`` against JAX's, over the same ``native/libjuicyio.so``;
  skipped, as JAX's tests are, when the library cannot be built.
- ``HostBridge`` on the saturator: the blocks come back in order, none
  lost, bit-equal to ``run_corpus(plug, params, clip[None],
  device="cpu")`` (the stage kernel step's plain version), its metrics the
  last block's; through the native host shim as well; infer steps through
  ``Plugin.step``.
- ``PipelinedStream``: against synchronous stepping at depth 2; a plugin
  at depth 0; the kernel path on the canonical chain (its plain version
  here) bit-equal to ``chain_kernel_step_plain`` block by block, latency
  depth · k · N, one block or two a tick; ``use_kernel=True`` on a short
  chain raises. Against JAX's ``PipelinedStream`` (its jitted step, in one
  process without FMA contraction, tests/torch_jax_ref.py): a plugin at
  depth 0, a short chain (the port's stage-by-stage route) and the
  canonical chain (the port's kernel path), two blocks a tick; audio within
  -100 dBFS, the metrics' keys JAX's and their values within 1e-5 of
  max(1, |value|).
"""

import struct
import threading

import numpy as np
import pytest
import torch

from juicy_tpu.runtime import native as jnative
from juicy_tpu.runtime import wav as jwav
from juicy_tpu_torch.kernels import chain_kernel as ck
from juicy_tpu_torch.parallel.corpus import run_corpus
from juicy_tpu_torch.runtime import native as tnative
from juicy_tpu_torch.runtime import wav as twav
from juicy_tpu_torch.runtime.host_bridge import (HostBridge, PipelinedStream,
                                                 StreamStep)
from juicy_tpu_torch.runtime.plugin import Chain, Plugin
from tests.conftest import make_clip
from tests.torch_jax_ref import no_fma_reference

SR = 48000.0
N = 64
CHAIN = [("punch", "Solar Snap"), ("saturator", "Amber Heat"),
         ("texture", None), ("motion", None), ("width", "Prism Arc"),
         ("cohere", None), ("infer", "Reference Lens")]


@pytest.fixture
def native_lib():
    """The native library (built at first use), or a skip without a
    toolchain, as JAX's native tests skip."""
    if not tnative.available():
        pytest.skip("native toolchain unavailable")


def _clip(seed, channels, t):
    return make_clip(np.random.default_rng(seed), channels, t)


@pytest.mark.parametrize("float32", [True, False])
@pytest.mark.parametrize("channels", [1, 2])
def test_torch_wav_bytes_equal_jax(tmp_path, float32, channels):
    clip = _clip(1, channels, 1001) * 1.2      # past full scale: the clip
    a, b = tmp_path / "jax.wav", tmp_path / "port.wav"
    jwav.write_wav(str(a), clip, 44100, float32=float32)
    twav.write_wav(str(b), clip, 44100, float32=float32)
    assert a.read_bytes() == b.read_bytes()
    got, sr_t = twav.read_wav(str(a))
    want, sr_j = jwav.read_wav(str(a))
    assert sr_t == sr_j == 44100
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("bits", [24, 32])
def test_torch_wav_reads_pcm_as_jax(tmp_path, bits):
    rng = np.random.default_rng(bits)
    frames = rng.integers(-(1 << (bits - 1)), 1 << (bits - 1), (300, 2))
    if bits == 24:
        raw = np.stack([(frames >> s) & 0xFF for s in (0, 8, 16)], -1)
        data = raw.astype(np.uint8).tobytes()
    else:
        data = frames.astype("<i4").tobytes()
    fmt = struct.pack("<HHIIHH", 1, 2, 48000, 48000 * 2 * bits // 8,
                      2 * bits // 8, bits)
    path = tmp_path / "pcm.wav"
    path.write_bytes(b"RIFF" + struct.pack("<I", 4 + 8 + 16 + 8 + len(data))
                     + b"WAVEfmt " + struct.pack("<I", 16) + fmt + b"data"
                     + struct.pack("<I", len(data)) + data)
    got, _ = twav.read_wav(str(path))
    want, _ = jwav.read_wav(str(path))
    np.testing.assert_array_equal(got, want)


def test_torch_native_wav_info_and_corpus(tmp_path, native_lib):
    long_mono = _clip(2, 1, 5000)
    short = _clip(3, 2, 1000)
    paths = []
    clips = (("a", short), ("b", long_mono), ("c", _clip(4, 2, 3000)))
    for name, clip in clips:
        p = str(tmp_path / f"{name}.wav")
        jwav.write_wav(p, clip, 48000)
        paths.append(p)
        assert tnative.wav_info(p) == jnative.wav_info(p)
    for threads in (1, 0):
        got = tnative.load_corpus(paths, frames=3000, channels=2,
                                  threads=threads)
        want = jnative.load_corpus(paths, frames=3000, channels=2,
                                   threads=threads)
        assert got.dtype == want.dtype and got.shape == (3, 2, 3000)
        np.testing.assert_array_equal(got, want)


def test_torch_native_ring_buffer(native_lib):
    for mod in (tnative, jnative):
        ring = mod.RingBuffer(8)
        assert ring.push(np.arange(5, dtype=np.float32))
        assert not ring.push(np.arange(5, dtype=np.float32))    # full
        assert ring.readable() == 5
        np.testing.assert_array_equal(ring.pop(3), [0, 1, 2])
        assert ring.pop(4) is None
        np.testing.assert_array_equal(ring.pop(2), [3, 4])
        ring.close()


def test_torch_host_bridge_saturator_equals_run_corpus(native_lib):
    nb = 5
    clip = _clip(5, 2, N * nb)
    plug = Plugin("saturator", SR, 2, N)
    params = plug.preset("Amber Heat")
    bridge = HostBridge(plug, params, device="cpu")
    assert bridge.stream.kstep is not None          # the stage kernel step
    got = []
    for k in range(nb):
        assert bridge.push_block(clip[:, k * N:(k + 1) * N])
        assert bridge.process_available() == 1
        got.append(bridge.pop_block())
    assert bridge.pop_block() is None               # nothing extra
    metrics = bridge.latest_metrics()
    bridge.stop()
    want, last, _agg = run_corpus(plug, params, clip[None], device="cpu")
    np.testing.assert_array_equal(np.concatenate(got, axis=-1),
                                  want[0].numpy())
    assert set(metrics) == set(last)
    for k, v in last.items():
        assert metrics[k] == float(v[0]), k


def test_torch_host_bridge_waits_for_output_room(native_lib):
    """With the output ring full, the port's bridge leaves the next input
    block in its ring until the consumer pops, so every block comes back in
    order. JAX's bridge steps the block and drops its output (the output
    ring's push fails), so two of four blocks are lost."""
    from juicy_tpu.runtime.host_bridge import HostBridge as JBridge
    from juicy_tpu.runtime.plugin import Plugin as JPlugin

    clip = _clip(12, 2, 4 * N)
    blocks = [clip[:, k * N:(k + 1) * N] for k in range(4)]
    tb = HostBridge(Plugin("saturator", SR, 2, N), ring_blocks=2,
                    device="cpu")
    jb = JBridge(JPlugin("saturator", SR, 2, N), ring_blocks=2)
    got = {"port": [], "jax": []}
    for key, bridge in (("port", tb), ("jax", jb)):
        for blk in blocks[:2]:
            assert bridge.push_block(blk)
        bridge.process_available()
        for blk in blocks[2:]:
            assert bridge.push_block(blk)
        bridge.process_available()          # the output ring is full
        for _ in range(2):
            got[key].append(bridge.pop_block())
        bridge.process_available()
        while (out := bridge.pop_block()) is not None:
            got[key].append(out)
        bridge.stop()
    assert len(got["port"]) == 4 and len(got["jax"]) == 2
    want, _l, _a = run_corpus(Plugin("saturator", SR, 2, N),
                              Plugin("saturator", SR, 2, N).default_params(),
                              clip[None], device="cpu")
    np.testing.assert_array_equal(np.concatenate(got["port"], -1),
                                  want[0].numpy())


def test_torch_host_bridge_pump_and_infer(native_lib):
    import time

    plug = Plugin("infer", SR, 2, N)
    bridge = HostBridge(plug, device="cpu")
    assert bridge.stream.kstep is None              # Plugin.step
    bridge.start(poll_s=0.001)
    for k in range(3):
        assert bridge.push_block(_clip(10 + k, 2, N))
    deadline, got = time.time() + 60.0, 0
    while got < 3 and time.time() < deadline:
        if bridge.pop_block() is not None:
            got += 1
        else:
            time.sleep(0.005)
    bridge.stop()
    assert got == 3
    m = bridge.latest_metrics()
    assert 0.0 <= m["score"] <= 100.0 and "emphasis" in m


def test_torch_host_bridge_native_shim(tmp_path, native_lib):
    """The native host shim streams a WAV through the rings from its own
    thread while the bridge pumps; the rendered WAV equals the same blocks
    through run_corpus."""
    nb = 6
    clip = _clip(6, 2, N * nb)
    src, dst = str(tmp_path / "in.wav"), str(tmp_path / "out.wav")
    twav.write_wav(src, clip, int(SR))
    plug = Plugin("saturator", SR, 2, N)
    bridge = HostBridge(plug, ring_blocks=4, device="cpu")
    bridge.start()
    result = {}

    def run_host():
        result["stats"] = tnative.host_stream(
            bridge.in_ring, bridge.out_ring, src, dst, 2, N, int(SR),
            realtime=False, timeout_s=120.0)

    t = threading.Thread(target=run_host)
    t.start()
    t.join(timeout=180.0)
    bridge.stop()
    assert not t.is_alive()
    assert result["stats"]["blocks_pushed"] == nb
    assert result["stats"]["blocks_popped"] == nb
    got, _ = twav.read_wav(dst)
    want, _l, _a = run_corpus(plug, plug.default_params(), clip[None],
                              device="cpu")
    np.testing.assert_array_equal(got, want[0].numpy())


def test_torch_stream_step_texture_keeps_plugin_form():
    """Texture's stage kernel keeps its state in kernel form; the stepper
    gives it back in the Plugin's form, equal to run_corpus's route."""
    plug = Plugin("texture", SR, 2, N).with_static(material=2)
    st = StreamStep(plug, 1, "cpu")
    clip = torch.from_numpy(_clip(7, 2, 2 * N))[None]
    outs = [st.step(plug.default_params(), clip[..., k * N:(k + 1) * N])[0]
            for k in range(2)]
    want, _l, _a = run_corpus(plug, plug.default_params(), clip,
                              device="cpu")
    assert torch.equal(torch.cat(outs, -1), want)
    state = st.state
    assert state["dsp"]["rng"].dtype == torch.int64
    assert tuple(state["dsp"]["waveguide"].shape[:2]) == (1, 2)


@pytest.mark.parametrize("channels", [1, 2])
def test_torch_stream_step_texture_state_is_its_own(channels):
    """The state a texture stepper starts from and the state it gives back
    hold rings of their own: later blocks, which update the kernel-form
    ring in place, leave them as they were. One mono stream is the case
    where the kernel form [L, C, B] has the Plugin form's layout."""
    plug = Plugin("texture", SR, channels, N).with_static(material=2)
    st = StreamStep(plug, 1, "cpu")
    start = st.state["dsp"]["waveguide"]
    clip = torch.from_numpy(_clip(13, channels, 3 * N))[None]
    st.step(plug.default_params(), clip[..., :N])
    given = st.state["dsp"]["waveguide"]
    kept = given.clone()
    for k in (1, 2):
        st.step(plug.default_params(), clip[..., k * N:(k + 1) * N])
    assert not torch.any(start)
    assert torch.equal(given, kept)
    assert not torch.equal(st.state["dsp"]["waveguide"], kept)


def test_torch_pipelined_stream_matches_sync():
    depth, nb = 2, 6
    chain = Chain([("punch", "Solar Snap"), ("saturator", None)], SR, 2, N)
    clip = _clip(8, 2, N * nb)
    stages = [StreamStep(p, 1, "cpu") for p in chain.plugins]
    want = []
    for k in range(nb):
        blk = torch.from_numpy(clip[None, :, k * N:(k + 1) * N])
        for st, p in zip(stages, chain.params):
            blk, m = st.step(p, blk)
        want.append(blk[0].numpy())
    ps = PipelinedStream(chain, depth=depth, device="cpu")
    assert not ps.kernel_path
    assert ps.latency_samples == depth * N
    got = []
    for k in range(nb):
        res = ps.tick(clip[:, k * N:(k + 1) * N])
        if k < depth:
            assert res is None
        else:
            got.append(res[0])
            assert 0.0 <= res[1]["score"] <= 100.0
    got.extend(a for a, _ in ps.flush())
    np.testing.assert_array_equal(np.concatenate(got, -1),
                                  np.concatenate(want, -1))


def test_torch_pipelined_stream_plugin_depth0():
    plug = Plugin("saturator", SR, 2, N)
    clip = _clip(9, 2, N)
    ps = PipelinedStream(plug, depth=0, device="cpu")
    audio, metrics = ps.tick(clip)
    want, last, _a = run_corpus(plug, plug.default_params(), clip[None],
                                device="cpu")
    np.testing.assert_array_equal(audio, want[0].numpy())
    assert metrics["score"] == float(last["score"][0])


@pytest.mark.parametrize("k", [1, 2])
def test_torch_pipelined_stream_kernel_path(k):
    depth, ticks = 1, 3
    chain = Chain(CHAIN, SR, 2, N)
    clip = _clip(11, 2, N * k * ticks)
    ps = PipelinedStream(chain, depth=depth, blocks_per_tick=k,
                         use_kernel=True, device="cpu")
    assert ps.kernel_path and ps.latency_samples == depth * k * N
    got = []
    for j in range(ticks):
        res = ps.tick(clip[:, j * k * N:(j + 1) * k * N])
        if res is not None:
            got.append(res)
    got.extend(ps.flush())
    states = chain.init_state((1,), "cpu")
    want, last = [], None
    for b in range(k * ticks):
        out, states, ms = ck.chain_kernel_step_plain(
            chain, states, torch.from_numpy(clip[None, :, b * N:(b + 1) * N]))
        want.append(out[0].numpy())
        if b % k == k - 1:
            last = {key: float(v[0]) for key, v in ms[-1].items()}
            assert got[b // k][1] == last
    np.testing.assert_array_equal(np.concatenate([a for a, _ in got], -1),
                                  np.concatenate(want, -1))


def test_torch_pipelined_stream_kernel_flag_rejects_short_chain():
    chain = Chain([("punch", None), ("saturator", None)], SR, 2, N)
    with pytest.raises(ValueError):
        PipelinedStream(chain, use_kernel=True, device="cpu")
    ps = PipelinedStream(chain, depth=0, use_kernel="auto", device="cpu")
    assert not ps.kernel_path
    # a canonical chain given params steps stage by stage
    canon = Chain(CHAIN, SR, 2, N)
    assert not PipelinedStream(canon, params=canon.params,
                               device="cpu").kernel_path


def test_torch_pipelined_stream_needs_a_device_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PipelinedStream(Plugin("saturator", SR, 2, N))


# (name, target, depth, blocks per tick) of the streams held to JAX's
_JAX_STREAMS = (("plugin", "saturator:Amber Heat", 0, 1),
                ("short", "punch:Solar Snap,saturator:Amber Heat", 2, 2),
                ("canonical", "canonical", 1, 2))
_JAX_TICKS = 3


def _stream_target(spec, chain_cls, plugin_cls):
    if spec == "canonical":
        return chain_cls(CHAIN, SR, 2, N)
    stages = [(name, preset or None) for name, _, preset in
              (st.partition(":") for st in spec.split(","))]
    if len(stages) == 1:
        plug = plugin_cls(stages[0][0], SR, 2, N)
        return plug, plug.preset(stages[0][1])
    return chain_cls(stages, SR, 2, N)


def _run_stream(ps, clip, k):
    """Tick `clip` through `ps` k blocks at a time and flush: (audio [C, T],
    metric keys, metrics [ticks, keys])."""
    res = []
    for j in range(_JAX_TICKS):
        r = ps.tick(clip[:, j * k * N:(j + 1) * k * N])
        if r is not None:
            res.append(r)
    res.extend(ps.flush())
    keys = sorted(res[0][1])
    return (np.concatenate([a for a, _ in res], -1), keys,
            np.array([[m[key] for key in keys] for _, m in res]))


def _jax_streams():
    """In the no-FMA process: each of _JAX_STREAMS through JAX's
    PipelinedStream (its jitted step on the CPU)."""
    from juicy_tpu.runtime.host_bridge import PipelinedStream as JStream
    from juicy_tpu.runtime.plugin import Chain as JChain
    from juicy_tpu.runtime.plugin import Plugin as JPlugin

    out = {}
    for i, (name, spec, depth, k) in enumerate(_JAX_STREAMS):
        target = _stream_target(spec, JChain, JPlugin)
        params = None
        if isinstance(target, tuple):
            target, params = target
        ps = JStream(target, params=params, depth=depth, blocks_per_tick=k)
        assert not ps.kernel_path
        audio, keys, ms = _run_stream(ps, _clip(30 + i, 2,
                                                _JAX_TICKS * k * N), k)
        out.update({f"{name}/audio": audio, f"{name}/keys": np.array(keys),
                    f"{name}/metrics": ms})
    return out


@pytest.fixture(scope="module")
def jax_streams(tmp_path_factory):
    return no_fma_reference("tests.test_torch_host", "_jax_streams",
                            tmp_path_factory.mktemp("streams"))


@pytest.mark.parametrize("case", range(len(_JAX_STREAMS)))
def test_torch_pipelined_stream_matches_jax(case, jax_streams):
    name, spec, depth, k = _JAX_STREAMS[case]
    target = _stream_target(spec, Chain, Plugin)
    params = None
    if isinstance(target, tuple):
        target, params = target
    ps = PipelinedStream(target, params=params, depth=depth,
                         blocks_per_tick=k, device="cpu")
    assert ps.kernel_path == (spec == "canonical")
    audio, keys, ms = _run_stream(ps, _clip(30 + case, 2,
                                            _JAX_TICKS * k * N), k)
    want = jax_streams[f"{name}/audio"]
    assert audio.shape == want.shape
    diff = np.max(np.abs(audio.astype(np.float64) - want))
    assert diff == 0 or 20 * np.log10(diff) <= -100.0
    assert keys == [str(key) for key in jax_streams[f"{name}/keys"]]
    want_m = jax_streams[f"{name}/metrics"]
    assert np.all(np.abs(ms - want_m) <= 1e-5 * np.maximum(1.0,
                                                           np.abs(want_m)))
