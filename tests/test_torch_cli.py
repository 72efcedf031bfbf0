"""PyTorch port vs JAX: the CLI (``python -m juicy_tpu_torch``), with
``--device cpu`` (the plain route) and small blocks.

- ``list`` prints byte for byte what JAX's prints.
- ``process`` (saturator "Amber Heat", ``--set drive=12``, ``--meters``,
  ``--metrics-jsonl``) writes a WAV bit-equal to the port's own
  stage-step loop (``StreamStep``), within -100 dBFS of JAX's CLI output,
  its jsonl rows within 1e-5 of JAX's and its printed panel JAX's; ``score``
  prints JAX's aggregate within 1e-5. JAX's CLI runs in one process
  without FMA contraction (tests/torch_jax_ref.py).
- ``chain``: the canonical chain equals ``run_corpus_chain`` on the clip;
  a short chain with ``--metrics none`` equals
  ``fused_chain_stream(metrics="none")``; both WAVs within -100 dBFS of
  JAX's CLI output, the printed stage scores JAX's.
- ``corpus``: batches through ``run_corpus_chain``, interrupted (the cursor
  rewound) and resumed, outputs equal to one uninterrupted run;
  ``--score-only`` writes nothing; ``--materials`` on the canonical chain
  equals ``run_corpus_chain(materials=)``. The WAVs of both corpora are
  within -100 dBFS of JAX's CLI output and the printed mean juiciness is
  JAX's.
- ``serve``: mismatched inputs rejected; the written streams equal a
  direct ``StreamServer``.
- Without ``--device`` and without a card, a command raises.
"""

import json
import os
import re
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from juicy_tpu_torch.cli import main
from juicy_tpu_torch.parallel.corpus import run_corpus_chain
from juicy_tpu_torch.runtime.chain_fused import fused_chain_stream
from juicy_tpu_torch.runtime.host_bridge import StreamStep
from juicy_tpu_torch.runtime.plugin import Chain, Plugin
from juicy_tpu_torch.runtime.serve import StreamServer
from juicy_tpu_torch.runtime.stream import pad_to_blocks
from juicy_tpu_torch.runtime.wav import read_wav, write_wav
from tests.conftest import make_clip
from tests.torch_jax_ref import no_fma_reference

SR = 48000
N = 64
CANON = ("punch:Solar Snap,saturator:Amber Heat,texture,motion,"
         "width:Prism Arc,cohere,infer:Reference Lens")
PROCESS = ["--plugin", "saturator", "--preset", "Amber Heat", "--set",
           "drive=12", "--meters", "--block", str(N)]


def _clip(seed, t, gain=1.0):
    return make_clip(np.random.default_rng(seed), 2, t) * gain


def _jax_corpus(name):
    """In a no-FMA process: JAX's CLI ``corpus`` on _CORPORA[name] (the
    WAVs and the printed text)."""
    import contextlib
    import io
    import tempfile
    from pathlib import Path

    from juicy_tpu.cli import main as jmain

    n, args = _CORPORA[name]
    folder = Path(tempfile.mkdtemp())
    srcs = _corpus(folder, n)
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        jmain(["corpus", *srcs, *args, "--out-dir", str(folder / "out")])
    out = {f"corpus/{name}/text": np.array(text.getvalue())}
    for i in range(n):
        out[f"corpus/{name}/{i}"] = read_wav(
            str(folder / "out" / f"clip{i}.wav"))[0]
    return out


def _jax_cli_materials():
    """In a no-FMA process: the corpus with a material per clip (a compile
    per material, so it runs beside _jax_cli_refs)."""
    return _jax_corpus("materials")


def _jax_cli_refs():
    """In the no-FMA process: JAX's CLI ``process`` (the WAV, the jsonl,
    the printed text), ``score`` (its JSON), ``chain`` and the corpus
    without materials (the WAVs and the printed text)."""
    import contextlib
    import io
    import tempfile

    from juicy_tpu.cli import main as jmain

    tmp = tempfile.mkdtemp()
    src, dst = os.path.join(tmp, "in.wav"), os.path.join(tmp, "out.wav")
    jsonl = os.path.join(tmp, "m.jsonl")
    write_wav(src, _clip(1, 1000), SR)
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        jmain(["process", src, dst, *PROCESS, "--metrics-jsonl", jsonl])
    score = io.StringIO()
    with contextlib.redirect_stdout(score):
        jmain(["score", src, "--block", str(N)])
    with open(jsonl) as f:
        rows = [json.loads(line) for line in f]
    keys = sorted(rows[0])
    out = {"out": read_wav(dst)[0],
           "text": np.array(text.getvalue().replace(dst, "OUT")),
           "keys": np.array(keys),
           "rows": np.array([[r[k] for k in keys] for r in rows]),
           "score": np.array(score.getvalue())}
    src = os.path.join(tmp, "chain_in.wav")
    write_wav(src, _clip(2, 2 * N + 17, 0.8), SR)
    for name, args in _CHAINS.items():
        dst = os.path.join(tmp, f"{name}.wav")
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            jmain(["chain", src, dst, *args])
        out[f"chain/{name}"] = read_wav(dst)[0]
        out[f"chain/{name}/text"] = np.array(text.getvalue())
    out.update(_jax_corpus("resumed"))
    return out


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    with ThreadPoolExecutor(2) as pool:
        runs = [pool.submit(no_fma_reference, "tests.test_torch_cli", func,
                            tmp_path_factory.mktemp("cli"))
                for func in ("_jax_cli_refs", "_jax_cli_materials")]
        return {k: v for run in runs for k, v in run.result().items()}


def test_torch_cli_list_as_jax(capsys):
    from juicy_tpu.cli import main as jmain

    jmain(["list"])
    want = capsys.readouterr().out
    main(["list"])
    assert capsys.readouterr().out == want


def test_torch_cli_process(tmp_path, capsys, jax_ref):
    src, dst = str(tmp_path / "in.wav"), str(tmp_path / "out.wav")
    jsonl = str(tmp_path / "m.jsonl")
    clip = _clip(1, 1000)
    write_wav(src, clip, SR)
    main(["process", src, dst, *PROCESS, "--metrics-jsonl", jsonl,
          "--device", "cpu"])
    text = capsys.readouterr().out
    assert text.replace(dst, "OUT") == str(jax_ref["text"])
    out, sr = read_wav(dst)
    assert sr == SR and out.shape == (2, 1000)

    # the port's own stage-step loop
    audio, _ = read_wav(src)
    plug = Plugin("saturator", float(SR), 2, N)
    params = plug.preset("Amber Heat")
    params["drive"] = torch.tensor(np.float32(12.0))
    step = StreamStep(plug, 1, "cpu")
    assert step.kstep is not None
    padded, t = pad_to_blocks(torch.from_numpy(audio), N)
    want = torch.cat([step.step(params, padded[None, :, k:k + N])[0][0]
                      for k in range(0, padded.shape[-1], N)], -1)
    np.testing.assert_array_equal(out, want[..., :t].numpy())

    diff = np.max(np.abs(out.astype(np.float64) - jax_ref["out"]))
    assert diff == 0 or 20 * np.log10(diff) <= -100.0
    with open(jsonl) as f:
        rows = [json.loads(line) for line in f]
    keys = [str(k) for k in jax_ref["keys"]]
    assert sorted(rows[0]) == keys
    got = np.array([[r[k] for k in keys] for r in rows])
    want_rows = jax_ref["rows"]
    assert np.all(np.abs(got - want_rows)
                  <= 1e-5 * np.maximum(1.0, np.abs(want_rows)))


def test_torch_cli_score(tmp_path, capsys, jax_ref):
    src = str(tmp_path / "in.wav")
    write_wav(src, _clip(1, 1000), SR)
    main(["score", src, "--block", str(N), "--device", "cpu"])
    text = capsys.readouterr().out
    got = json.loads(text[text.index("{"):])
    want_text = str(jax_ref["score"])
    want = json.loads(want_text[want_text.index("{"):])
    assert list(got) == list(want)
    for k, v in want.items():
        assert abs(got[k] - v) <= 1e-5 * max(1.0, abs(v)), k


#: the chain commands, by name: their arguments after the two paths
_CHAINS = {"canon": ["--stages", CANON, "--block", str(N), "--metrics",
                     "final"],
           "short": ["--stages", "punch:Crater Impact,width", "--block",
                     str(N), "--metrics", "none"]}
#: the corpus commands, by name: (clips, arguments but the paths)
_CORPORA = {"resumed": (5, ["--stages", "punch:Solar Snap,saturator,infer",
                            "--block", str(N), "--batch", "2"]),
            "materials": (3, ["--stages", CANON, "--block", str(N),
                              "--batch", "3", "--materials", "wood,metal,0"])}


def _assert_near_jax(got, want):
    """A WAV within -100 dBFS of JAX's."""
    assert got.shape == want.shape
    diff = np.max(np.abs(got.astype(np.float64) - want))
    assert diff == 0 or 20 * np.log10(diff) <= -100.0


def _stage_scores(text):
    return text[text.index("stage scores: "):text.rindex("  (")]


def _mean_juiciness(text):
    return re.search(r"mean juiciness (\S+),", text).group(1)


def test_torch_cli_chain(tmp_path, capsys, jax_ref):
    src = str(tmp_path / "in.wav")
    clip = _clip(2, 2 * N + 17, 0.8)
    write_wav(src, clip, SR)
    audio, _ = read_wav(src)
    padded, t = pad_to_blocks(torch.from_numpy(audio), N)

    dst = str(tmp_path / "canon.wav")
    main(["chain", src, dst, *_CHAINS["canon"], "--device", "cpu"])
    text = capsys.readouterr().out
    assert "stage scores" in text and text.count("→") == 6
    chain = Chain([(s.partition(":")[0], s.partition(":")[2] or None)
                   for s in CANON.split(",")], float(SR), 2, N)
    want, ms, _a = run_corpus_chain(chain, padded[None], device="cpu")
    np.testing.assert_array_equal(read_wav(dst)[0], want[0, :, :t].numpy())
    assert f"{float(ms[-1]['score'][0]):.1f}  (" in text
    _assert_near_jax(read_wav(dst)[0], jax_ref["chain/canon"])
    assert _stage_scores(text) == _stage_scores(str(
        jax_ref["chain/canon/text"]))

    dst = str(tmp_path / "short.wav")
    main(["chain", src, dst, *_CHAINS["short"], "--device", "cpu"])
    assert "stage scores" not in capsys.readouterr().out
    short = Chain([("punch", "Crater Impact"), ("width", None)], float(SR),
                  2, N)
    want, _st, m = fused_chain_stream(short, short.init_state((1,), "cpu"),
                                      padded[None], metrics="none")
    assert m is None
    np.testing.assert_array_equal(read_wav(dst)[0], want[0, :, :t].numpy())
    _assert_near_jax(read_wav(dst)[0], jax_ref["chain/short"])


def _corpus(tmp_path, n):
    srcs = []
    for i in range(n):
        p = str(tmp_path / f"clip{i}.wav")
        write_wav(p, _clip(10 + i, N * (2 + i % 2) - 5 * i, 0.5 + 0.1 * i),
                  SR)
        srcs.append(p)
    return srcs


def test_torch_cli_corpus_resumes(tmp_path, capsys, jax_ref):
    srcs = _corpus(tmp_path, 5)
    args = ["corpus", *srcs, *_CORPORA["resumed"][1], "--device", "cpu"]
    full_dir, ck = str(tmp_path / "full"), str(tmp_path / "ck.json")
    main([*args, "--out-dir", full_dir])
    assert _mean_juiciness(capsys.readouterr().out) == _mean_juiciness(
        str(jax_ref["corpus/resumed/text"]))
    part_dir = str(tmp_path / "part")
    main([*args, "--out-dir", part_dir, "--checkpoint", ck])
    capsys.readouterr()
    assert json.load(open(ck))["done"] == 5
    # an interruption after the first batch: the cursor at 2, the rest gone
    with open(ck, "w") as f:
        json.dump({"done": 2, "total": 5,
                   "stages": "punch:Solar Snap,saturator,infer"}, f)
    for i in range(2, 5):
        os.remove(os.path.join(part_dir, f"clip{i}.wav"))
    main([*args, "--out-dir", part_dir, "--checkpoint", ck])
    text = capsys.readouterr().out
    assert "resuming at clip 2/5" in text
    assert text.count("batch done") == 2
    for i in range(5):
        name = f"clip{i}.wav"
        a, _ = read_wav(os.path.join(full_dir, name))
        b, _ = read_wav(os.path.join(part_dir, name))
        assert a.shape == read_wav(srcs[i])[0].shape
        np.testing.assert_array_equal(a, b)
        _assert_near_jax(a, jax_ref[f"corpus/resumed/{i}"])


def test_torch_cli_corpus_materials_and_score_only(tmp_path, capsys,
                                                  jax_ref):
    srcs = _corpus(tmp_path, 3)
    out_dir = str(tmp_path / "out")
    main(["corpus", *srcs, *_CORPORA["materials"][1], "--out-dir", out_dir,
          "--device", "cpu"])
    assert _mean_juiciness(capsys.readouterr().out) == _mean_juiciness(
        str(jax_ref["corpus/materials/text"]))
    clips = [read_wav(p)[0] for p in srcs]
    t = -(-max(c.shape[-1] for c in clips) // N) * N
    corpus = np.zeros((3, 2, t), np.float32)
    for i, c in enumerate(clips):
        corpus[i, :, :c.shape[-1]] = c
    chain = Chain([(s.partition(":")[0], s.partition(":")[2] or None)
                   for s in CANON.split(",")], float(SR), 2, N)
    want, _ms, _a = run_corpus_chain(chain, corpus, materials=[2, 1, 0],
                                     device="cpu")
    for i, c in enumerate(clips):
        got, _ = read_wav(os.path.join(out_dir, f"clip{i}.wav"))
        np.testing.assert_array_equal(got, want[i, :, :c.shape[-1]].numpy())
        _assert_near_jax(got, jax_ref[f"corpus/materials/{i}"])

    so_dir = str(tmp_path / "so")
    main(["corpus", *srcs, "--stages", "punch,texture,infer", "--block",
          str(N), "--out-dir", so_dir, "--score-only", "--materials",
          "gel", "--device", "cpu"])
    assert "mean juiciness" in capsys.readouterr().out
    assert os.listdir(so_dir) == []
    with pytest.raises(SystemExit):
        main(["corpus", *srcs, "--stages", "punch", "--block", str(N),
              "--materials", "gel,metal", "--device", "cpu"])


def test_torch_cli_serve(tmp_path, capsys):
    srcs = _corpus(tmp_path, 3)
    prefix = str(tmp_path / "served_")
    main(["serve", *srcs, "--stages", "punch,saturator", "--block", str(N),
          "--out-prefix", prefix, "--device", "cpu"])
    assert "served 3 streams" in capsys.readouterr().out
    clips = [read_wav(p)[0] for p in srcs]
    chain = Chain([("punch", None), ("saturator", None)], float(SR), 2, N)
    srv = StreamServer(chain, max_streams=4, device="cpu")
    sids = [srv.open_stream() for _ in clips]
    padded = [pad_to_blocks(torch.from_numpy(c), N)[0].numpy() for c in clips]
    outs = {sid: [] for sid in sids}
    for k in range(max(p.shape[-1] // N for p in padded)):
        for sid, p in zip(sids, padded):
            if k < p.shape[-1] // N:
                srv.submit(sid, p[..., k * N:(k + 1) * N])
        for sid, res in srv.tick().items():
            outs[sid].append(res["audio"])
    for i, sid in enumerate(sids):
        got, _ = read_wav(f"{prefix}{i}.wav")
        want = np.concatenate(outs[sid], -1)[..., :clips[i].shape[-1]]
        np.testing.assert_array_equal(got, want)

    write_wav(str(tmp_path / "other.wav"), _clip(3, N), 44100)
    with pytest.raises(SystemExit):
        main(["serve", srcs[0], str(tmp_path / "other.wav"), "--block",
              str(N), "--out-prefix", prefix, "--device", "cpu"])


def test_torch_cli_needs_the_card_without_device(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    src = str(tmp_path / "in.wav")
    write_wav(src, _clip(4, N), SR)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["process", src, str(tmp_path / "o.wav"), "--plugin",
              "saturator", "--block", str(N)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["chain", src, str(tmp_path / "o.wav"), "--stages", "punch",
              "--block", str(N)])
