"""Device meshes in the port (juicy_tpu_torch/parallel/mesh.py and
timeshard.py, ``mesh=`` on the corpus runners and ``StreamServer``), on
the CPU: a mesh of K ``cpu`` entries (K = 2 and 4) exercises the split and
the gather, and every sharded result is held bit-equal to the unsharded
one. A batch that does not divide raises ValueError where JAX's does.

Against JAX, in a subprocess without FMA on the conftest's 8 virtual
devices (tests/torch_jax_ref.py): the sharded server plays JAX's
``test_stream_server_mesh_sharded`` script (audio within 2e-6 and scores
within 1e-3, JAX's own tolerances against its solo server), and
``sequence_parallel_linear_scan`` over K = 2, 4, 8 shards, bit-equal
expected.
"""

import numpy as np
import pytest
import torch

from tests.conftest import make_clip
from tests.torch_jax_ref import no_fma_reference

from juicy_tpu_torch.parallel.corpus import (run_corpus, run_corpus_chain,
                                             run_corpus_resumable)
from juicy_tpu_torch.parallel.mesh import make_mesh, shard_clips
from juicy_tpu_torch.parallel.timeshard import sequence_parallel_linear_scan
from juicy_tpu_torch.runtime.plugin import Chain
from juicy_tpu_torch.runtime.plugin import Plugin as TPlugin
from juicy_tpu_torch.runtime.serve import StreamServer

SR = 48000.0
BLOCK = 512
N7 = 64
STAGES = [("punch", "Solar Snap"), ("saturator", "Amber Heat"),
          ("infer", None)]
CHAIN7 = [("punch", None), ("saturator", None), ("texture", None),
          ("motion", None), ("width", None), ("cohere", None),
          ("infer", None)]
SEQ_T = 8 * 96


def _mesh(k):
    return make_mesh(devices=["cpu"] * k)


def _clips(b, t, seed=0):
    local = np.random.default_rng(seed)
    return np.stack([make_clip(local, 2, t) for _ in range(b)])


def _scan_inputs():
    rng = np.random.default_rng(9)
    a = rng.uniform(0.9, 1.0, (3, SEQ_T)).astype(np.float32)
    b = rng.standard_normal((3, SEQ_T)).astype(np.float32)
    init = rng.standard_normal(3).astype(np.float32)
    return a, b, init


def _server_script(server):
    """JAX's test_stream_server_mesh_sharded on `server`: three streams,
    a per-slot edit on the second, two ticks. Returns the ticks' audio and
    scores per stream, flat."""
    clip = make_clip(np.random.default_rng(0x5E7), 2, BLOCK * 2)
    sids = [server.open_stream() for _ in range(3)]
    server.set_params(sids[1], "saturator", drive=13.5)
    rec = {}
    for k in range(2):
        blk = clip[:, k * BLOCK:(k + 1) * BLOCK]
        for sid in sids:
            server.submit(sid, blk * (1.0 + 0.1 * sid))
        res = server.tick()
        for i, sid in enumerate(sids):
            rec[f"{k}/{i}/audio"] = np.asarray(res[sid]["audio"])
            rec[f"{k}/{i}/score"] = np.asarray(res[sid]["score"])
    return rec


def _jax_mesh_refs():
    """JAX's sharded server and sequence-parallel scan (run without FMA,
    on 8 virtual devices)."""
    import jax
    from juicy_tpu.parallel.mesh import make_mesh as jmesh
    from juicy_tpu.parallel.timeshard import \
        sequence_parallel_linear_scan as jscan
    from juicy_tpu.runtime.plugin import Chain as JChain
    from juicy_tpu.runtime.serve import StreamServer as JServer

    assert jax.device_count() == 8
    server = JServer(JChain(STAGES, sr=SR, channels=2, block_size=BLOCK),
                     max_streams=8, mesh=jmesh())
    out = {f"serve/{k}": v for k, v in _server_script(server).items()}
    a, b, init = _scan_inputs()
    for k in (2, 4, 8):
        mesh = jmesh((k,), ("seq",), devices=jax.devices()[:k])
        out[f"scan/{k}"] = np.asarray(jscan(mesh, a, b, init))
    return out


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    return no_fma_reference("tests.test_torch_mesh", "_jax_mesh_refs",
                            tmp_path_factory.mktemp("mesh"))


def _assert_tree_equal(got, want):
    if isinstance(want, dict):
        assert got.keys() == want.keys()
        for k in want:
            _assert_tree_equal(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_tree_equal(g, w)
    elif want is None:
        assert got is None
    else:
        assert got.shape == want.shape and got.dtype == want.dtype
        assert got.device == want.device
        assert torch.equal(got, want) or np.array_equal(
            got.numpy(), want.numpy(), equal_nan=True)


def test_torch_make_mesh_shapes():
    """("data",) and ("data", "seq") layouts, the axis devices, the clip
    split; without CUDA the default mesh (every visible card) raises."""
    mesh = _mesh(4)
    assert mesh.axis_names == ("data",) and mesh.shape == {"data": 4}
    assert mesh.size == 4 and mesh.devices.shape == (4,)
    two = make_mesh((2, 2), ("data", "seq"), devices=["cpu"] * 4)
    assert two.shape == {"data": 2, "seq": 2}
    assert len(two.axis_devices("data")) == 2
    assert len(two.axis_devices("seq")) == 2
    assert make_mesh(axis_names=("data", "seq"),
                     devices=["cpu"] * 4).shape == {"data": 4, "seq": 1}
    with pytest.raises(ValueError):
        two.axis_devices("model")
    chunks = shard_clips(mesh, torch.arange(8.0))
    assert [c.tolist() for c in chunks] == [[0, 1], [2, 3], [4, 5], [6, 7]]
    with pytest.raises(ValueError, match="does not divide"):
        shard_clips(mesh, torch.arange(6.0))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh()
        plug = TPlugin("saturator", SR, 2, N7)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run_corpus(plug, plug.default_params(),
                       np.zeros((2, 2, N7), np.float32))


@pytest.mark.parametrize("k", [2, 4])
def test_torch_run_corpus_mesh_matches_unsharded(k):
    """The stage-kernel route (its plain version here) for the saturator
    and for texture with a material per clip, and batched_run for width:
    every output bit-equal to the unsharded corpus."""
    clips = _clips(8, 2 * N7)
    cases = [(TPlugin("saturator", SR, 2, N7), {}),
             (TPlugin("texture", SR, 2, N7).with_traced("material"),
              {"material": torch.tensor([0., 1., 4., 2., 3., 0., 1., 4.])}),
             (TPlugin("width", SR, 2, N7), {})]
    for plug, extra in cases:
        params = dict(plug.default_params(), **extra)
        want = run_corpus(plug, params, clips, device="cpu")
        got = run_corpus(plug, params, clips, mesh=_mesh(k))
        _assert_tree_equal(got, want)


CHAIN_CASES = [("blocks", {}), ("blocks", {"materials": [0, 1, 2, 3, 4, 0,
                                                           1, 2]}),
               ("final", {"return_audio": False}),
               ("final", {"use_kernel": "never"}), ("none", {})]


@pytest.mark.parametrize("metrics,kw", CHAIN_CASES,
                         ids=["blocks", "materials", "scores", "never",
                              "none"])
@pytest.mark.parametrize("k", [2, 4])
def test_torch_run_corpus_chain_mesh_matches_unsharded(k, metrics, kw):
    """The chain-kernel route (its plain version here), with per-clip
    materials and without audio, and the executor route: bit-equal."""
    chain = Chain(CHAIN7, SR, 2, N7)
    clips = _clips(8, 2 * N7, seed=1)
    want = run_corpus_chain(chain, clips, metrics=metrics, device="cpu", **kw)
    got = run_corpus_chain(chain, clips, metrics=metrics, mesh=_mesh(k), **kw)
    _assert_tree_equal(got, want)


def test_torch_run_corpus_resumable_mesh_matches_unsharded(tmp_path):
    """Macro batches of 3 over 2 and 4 devices (padded with silent clips
    where they do not divide): the scores of the unsharded run."""
    plug = TPlugin("punch", SR, 2, N7)
    clips = _clips(7, 2 * N7, seed=2)
    want = run_corpus_resumable(plug, plug.default_params(), clips,
                                str(tmp_path / "one.ckpt"), macro_batch=3,
                                device="cpu")
    for k in (2, 4):
        got = run_corpus_resumable(plug, plug.default_params(), clips,
                                   str(tmp_path / f"mesh{k}.ckpt"),
                                   macro_batch=3, mesh=_mesh(k))
        np.testing.assert_array_equal(got, want)


def test_torch_mesh_batch_must_divide():
    """JAX's runners put the batch on the mesh with a batch sharding,
    which raises ValueError when it does not divide; so do the port's."""
    plug = TPlugin("saturator", SR, 2, N7)
    clips = _clips(5, N7)
    with pytest.raises(ValueError, match="does not divide"):
        run_corpus(plug, plug.default_params(), clips, mesh=_mesh(2))
    with pytest.raises(ValueError, match="does not divide"):
        run_corpus_chain(Chain(CHAIN7, SR, 2, N7), clips, mesh=_mesh(2))
    with pytest.raises(ValueError, match="not both"):
        run_corpus_chain(Chain(CHAIN7, SR, 2, N7), clips, mesh=_mesh(2),
                         device="cpu")
    with pytest.raises(ValueError, match="multiple"):
        StreamServer(Chain(STAGES, SR, 2, BLOCK), 9, mesh=_mesh(4))


def test_torch_stream_server_mesh_sharded(jax_ref):
    """JAX's script on a server sharded over 2 and 4 entries: bit-equal to
    the solo server, and within JAX's tolerances of JAX's server sharded
    over its 8 virtual devices."""
    solo = _server_script(StreamServer(Chain(STAGES, SR, 2, BLOCK), 8,
                                       device="cpu"))
    for k in (2, 4):
        got = _server_script(StreamServer(Chain(STAGES, SR, 2, BLOCK), 8,
                                          mesh=_mesh(k)))
        assert got.keys() == solo.keys()
        for key in solo:
            np.testing.assert_array_equal(got[key], solo[key])
            want = jax_ref[f"serve/{key}"]
            tol = 2e-6 if key.endswith("audio") else 1e-3
            np.testing.assert_allclose(got[key], want, rtol=0, atol=tol)


def test_torch_stream_server_mesh_kernel_tick():
    """The canonical chain ticks on the chain kernel (its plain version
    here) in each pool, with a per-slot edit in each pool's constant rows
    and streams opened, closed and reopened: bit-equal to the solo
    server."""
    clip = _clips(1, 3 * N7, seed=3)[0]

    def play(server):
        assert server._kernel_tick
        sids = [server.open_stream() for _ in range(8)]
        server.set_params(sids[1], "punch", punch=0.3)
        server.set_params(sids[6], "width", haasMs=3.0)
        rec = []
        for k in range(3):
            if k == 2:
                server.close_stream(sids[2])
                sids[2] = server.open_stream()
            blk = clip[:, k * N7:(k + 1) * N7]
            for sid in sids:
                server.submit(sid, blk * (1.0 - 0.05 * sid))
            rec.append(server.tick_arrays())
        return rec

    want = play(StreamServer(Chain(CHAIN7, SR, 2, N7), 8, device="cpu"))
    got = play(StreamServer(Chain(CHAIN7, SR, 2, N7), 8, mesh=_mesh(2)))
    for g, w in zip(got, want):
        for gv, wv in zip(g, w):
            np.testing.assert_array_equal(gv, wv)


@pytest.mark.parametrize("k", [2, 4, 8])
def test_torch_sequence_parallel_scan_matches_jax(k, jax_ref):
    """Time split over K shards of a ("seq",) mesh, and over the seq axis
    of a ("data", "seq") mesh: bit-equal to JAX's on its virtual mesh."""
    a, b, init = (torch.from_numpy(v) for v in _scan_inputs())
    got = sequence_parallel_linear_scan(
        make_mesh((k,), ("seq",), devices=["cpu"] * k), a, b, init)
    np.testing.assert_array_equal(got.numpy(), jax_ref[f"scan/{k}"])
    assert np.array_equal(got.numpy().view(np.int32),
                          jax_ref[f"scan/{k}"].view(np.int32))
    dp_sp = make_mesh((2, k), ("data", "seq"), devices=["cpu"] * (2 * k))
    np.testing.assert_array_equal(
        sequence_parallel_linear_scan(dp_sp, a, b, init).numpy(),
        got.numpy())
    with pytest.raises(ValueError, match="does not divide"):
        sequence_parallel_linear_scan(dp_sp, a[..., :-1], b[..., :-1], init)


def test_torch_cli_corpus_over_mesh(tmp_path, monkeypatch):
    """The CLI's corpus command without --device splits each macro batch
    over every visible card (two cpu entries stand in for them here): its
    batch of 3 rounds up to 4, the last batch is padded with a silent
    clip, and the files are those of --device cpu, bit for bit."""
    from juicy_tpu_torch.cli import main
    from juicy_tpu_torch.parallel import mesh as pm
    from juicy_tpu_torch.runtime.wav import read_wav, write_wav

    clips = _clips(5, 2 * N7, seed=4)
    paths = []
    for i, c in enumerate(clips):
        paths.append(str(tmp_path / f"c{i}.wav"))
        write_wav(paths[-1], c, int(SR))
    args = ["corpus", *paths, "--stages", "punch,saturator,infer",
            "--block", str(N7), "--batch", "3"]
    main(args + ["--out-dir", str(tmp_path / "one"), "--device", "cpu"])
    monkeypatch.setattr(pm, "visible_devices",
                        lambda: [torch.device("cpu")] * 2)
    main(args + ["--out-dir", str(tmp_path / "mesh")])
    for p in paths:
        name = p.rsplit("/", 1)[-1]
        one, _ = read_wav(str(tmp_path / "one" / name))
        mesh, _ = read_wav(str(tmp_path / "mesh" / name))
        np.testing.assert_array_equal(mesh, one)
