"""Corpus-scale batch runner, PyTorch port of juicy_tpu/parallel/corpus.py
(``run_corpus``, ``run_corpus_chain`` and ``corpus_metrics``).

A corpus [B, C, T] streams block by block through one plugin, or through a
``Chain``, on the card (or on the device the caller names); the result is
the audio, the metrics and their corpus mean/min/max. With a mesh
(parallel/mesh.py; by default every visible card when the caller names no
device) the clips are split over its ``data`` axis: each device runs its
shard on the single-device path, and the outputs are gathered on the
mesh's first device, where the corpus aggregates are taken. One device
runs the single-device path alone. The 1024-clip tile alignment does not
apply: the kernels mask the ragged edge of the batch. A corpus with a texture
material per clip is sorted by material into runs of 32 clips (the mixed
kernels' CTAs) once, and put back in corpus order once. Automation
curves give every block its own constants on either route.
"""

from __future__ import annotations

import copy
from typing import Dict

import numpy as np
import torch

from juicy_tpu_torch.parallel.mesh import gather, make_mesh, shard_clips
from juicy_tpu_torch.runtime.device import on_device, resolve_device
from juicy_tpu_torch.runtime.observe import span
from juicy_tpu_torch.runtime.plugin import (Plugin, automation_curves,
                                            params_at)


def corpus_metrics(per_clip_metrics: Dict[str, torch.Tensor]
                   ) -> Dict[str, Dict[str, torch.Tensor]]:
    """Corpus aggregation of per-clip metric arrays: mean/min/max."""
    return {k: {"mean": torch.mean(v), "min": torch.min(v), "max": torch.max(v)}
            for k, v in per_clip_metrics.items()}


def _corpus_on(clips, device):
    """A [B, C, T] float32 corpus (a tensor or a numpy array) on `device`
    (None is the card, which must exist)."""
    if isinstance(clips, np.ndarray):
        clips = torch.from_numpy(clips)
    if clips.dtype != torch.float32 or clips.ndim != 3:
        raise ValueError(f"expected float32 clips [B, C, T], got "
                         f"{clips.dtype} {tuple(clips.shape)}")
    return clips.to(resolve_device(device))


def corpus_mesh(mesh=None, device=None):
    """The mesh whose ``data`` axis a corpus runner splits its clips over:
    `mesh`; with neither a mesh nor a device, every visible card (JAX's
    ``mesh=None``: ``make_mesh()``); None for an explicit `device` alone."""
    if mesh is not None and device is not None:
        raise ValueError("pass a mesh or a device, not both")
    if mesh is None and device is None:
        mesh = make_mesh()
    return mesh


def _split_rows(tree, b: int, k: int):
    """`k` copies of a dict of params whose [B]-leading leaves (one value
    per clip) are split into the k shards' rows; other leaves are shared."""
    def part(v, i):
        if isinstance(v, (torch.Tensor, np.ndarray)) and v.ndim \
                and v.shape[0] == b:
            return v[i * (b // k):(i + 1) * (b // k)]
        return v
    return [{key: part(v, i) for key, v in tree.items()} for i in range(k)]


def _stage_kernel_step(plugin: Plugin):
    """The plugin's full-stage kernel step, or None when it has none.

    Punch, the saturator, texture and motion have one.
    The JAX runner sends punch and motion to XLA's stage instead
    (``juicy_tpu/parallel/corpus.py`` ``_WINNING_STAGE_KERNELS``) only
    because their Pallas kernels were no faster on a TPU: a speed choice
    between two routes that compute the same function. Here the other route
    is the plain per-sample loop, so every stage kernel is taken."""
    from juicy_tpu_torch.kernels import stage_kernels as sk

    return {"punch": sk.punch_stage_step,
            "saturator": sk.saturator_stage_step,
            "texture": sk.texture_stage_step,
            "motion": sk.motion_stage_step}.get(plugin.defn.name)


def run_corpus(plugin: Plugin, params, clips, use_kernel: str = "auto",
               automation=None, device=None, mesh=None):
    """Process a [B, C, T] float32 corpus (a tensor or a numpy array) on
    `device`: the card when None, which must then exist; ``"cpu"`` runs the
    plain PyTorch route. With a `mesh` (parallel/mesh.py), or with neither
    a mesh nor a device and more than one visible card, the clips are split
    over the mesh's ``data`` axis (B must divide by it: ValueError), each
    shard runs as below on its device, and the results are gathered on the
    first.

    `use_kernel`: "auto" runs the plugin's full-stage kernel step when it has
    one (punch, the saturator, texture, motion), which launches the CUDA
    kernel for a CUDA corpus and runs its plain version for a CPU corpus;
    "never" runs ``Plugin.batched_run``; "always" raises unless the CUDA
    kernel can run. Width, cohere and infer have no stage kernel and take
    ``batched_run`` under every setting but "always". Texture with a
    material per clip (``params["material"]`` [B], on a
    ``with_traced("material")`` plugin) sorts the corpus by material once
    (``stage_kernels.material_order``: runs padded to the kernels' 32 clips
    per CTA), takes the stage kernel's material per CTA, and puts the
    results back in corpus order once.

    `automation` ({param: [nb] curve}, one value per block for every clip)
    runs each block with that block's values on either route: the stage
    kernels take their constants at every launch. Texture's material
    selects the stage kernel's code path for the whole corpus and cannot be
    automated there.

    Returns (out [B, C, T], per-clip final-block metrics, corpus aggregates).
    """
    from juicy_tpu_torch.kernels import stage_kernels as sk
    from juicy_tpu_torch.models import texture as _tex

    if use_kernel not in ("auto", "never", "always"):
        raise ValueError(f"use_kernel must be auto, never or always; got "
                         f"{use_kernel!r}")
    mesh = corpus_mesh(mesh, device)
    if mesh is not None:
        devices = mesh.axis_devices("data")
        if len(devices) > 1:
            rows = _split_rows(params, clips.shape[0], len(devices))
            res = []
            for chunk, p, dev in zip(shard_clips(mesh, clips), rows,
                                     devices):
                with on_device(dev):
                    res.append(run_corpus(plugin, p, chunk, use_kernel,
                                          automation, device=dev))
            last = {k: gather([r[1][k] for r in res]) for k in res[0][1]}
            return gather([r[0] for r in res]), last, corpus_metrics(last)
        device = devices[0]
    clips = _corpus_on(clips, device)
    b = clips.shape[0]
    kstep = None if use_kernel == "never" else _stage_kernel_step(plugin)
    if use_kernel == "always" and (kstep is None or not clips.is_cuda):
        raise ValueError(
            f"no stage-kernel path for {plugin.defn.name!r} on "
            f"{clips.device}: the kernels run on CUDA tensors only")
    p = plugin.full_params(params)
    mode = _tex.material_mode(p) if plugin.defn.name == "texture" else None
    if mode is not None and not isinstance(mode, int) \
            and tuple(mode.shape) != (b,):
        raise ValueError(f"materials of shape {tuple(mode.shape)} for a "
                         f"corpus of {b} clips")
    if kstep is None:
        states = plugin.init_state((b,), clips.device)
        out, _states, metrics = plugin.batched_run(params, states, clips,
                                                   automation=automation)
        last = {k: v[-1] for k, v in metrics.items()}
        return out, last, corpus_metrics(last)

    nb = plugin.num_blocks(clips)
    curves = automation_curves(p, automation, nb)
    if "material" in curves:
        raise ValueError("texture's material selects the stage kernel's "
                         "code path for the whole corpus and cannot be "
                         "automated there")
    order = None if mode is None else sk.material_order(mode)
    if order is not None:
        clips, p, mode = order.clips(clips), order.tree(p, b), order.mode
    states = plugin.init_state((clips.shape[0],), clips.device)
    if mode is not None:
        # the ring goes to kernel form once per corpus, not once per block
        states["dsp"] = sk.texture_kernel_state(states["dsp"], mode)
    n = plugin.block_size
    out = torch.empty_like(clips)
    for i in range(nb):
        sl = slice(i * n, (i + 1) * n)
        out[..., sl], states, last = kstep(params_at(p, curves, i), states,
                                           clips[..., sl], plugin.sr)
    if order is not None:
        out = order.scatter(out)
        last = {k: order.scatter(v) for k, v in last.items()}
    return out, last, corpus_metrics(last)


def run_corpus_resumable(plugin: Plugin, params, clips, checkpoint_path: str,
                         macro_batch: int = 256, mesh=None,
                         save_every: int = 1, device=None):
    """Corpus scoring with a checkpoint after every `save_every` macro
    batches, so that an interrupted job resumes where it stopped.

    The [B, C, T] clips go through ``run_corpus`` in macro batches of
    `macro_batch` clips on `device` (the card when None; the stage kernel
    for punch, the saturator, texture and motion there, the plain route
    for ``"cpu"``). The checkpoint (runtime/state.py) holds the cursor
    ``{"done": int32}`` as its params, the per-clip scores
    ``{"scores": float32 [B]}`` as its state and ``total`` in its meta, as
    JAX's does: a job that either package interrupted resumes in the
    other. A `mesh` (or, with neither a mesh nor a device, every visible
    card) splits each macro batch over its ``data`` axis through
    ``run_corpus``; a batch that does not divide is padded with silent
    clips, whose scores are dropped (clips are independent: the scores are
    the unsharded run's). Without a split the last batch is not padded.
    Returns the per-clip final-block scores, numpy float32 [B]."""
    import os

    from juicy_tpu_torch.runtime.state import load_state, save_state

    mesh = corpus_mesh(mesh, device)
    k = 1 if mesh is None else len(mesh.axis_devices("data"))
    b = clips.shape[0]
    scores = np.zeros((b,), np.float32)
    cursor = {"done": torch.tensor(0, dtype=torch.int32)}
    if os.path.exists(checkpoint_path):
        cursor, saved, _meta = load_state(checkpoint_path, cursor,
                                          {"scores": scores}, device="cpu")
        scores = saved["scores"].numpy().copy()
    done = int(cursor["done"])
    since_save = 0
    while done < b:
        end = min(b, done + macro_batch)
        chunk = torch.as_tensor(clips[done:end])
        pad = -chunk.shape[0] % k
        if pad:
            chunk = torch.cat([chunk, chunk.new_zeros((pad, *chunk.shape[1:]))])
        _out, last, _agg = run_corpus(plugin, params, chunk, device=device,
                                      mesh=mesh)
        scores[done:end] = last["score"].cpu().numpy()[:end - done]
        done = end
        since_save += 1
        if since_save >= save_every or done >= b:
            save_state(checkpoint_path,
                       {"done": torch.tensor(done, dtype=torch.int32)},
                       {"scores": torch.from_numpy(scores)},
                       meta={"total": b})
            since_save = 0
    return scores


def _texture_stage(chain) -> int:
    for i, plug in enumerate(chain.plugins):
        if plug.defn.name == "texture":
            return i
    raise ValueError("chain has no texture stage to set materials for")


def with_materials(chain, materials):
    """A shallow copy of `chain` whose texture stage runs `materials`
    (one per clip, [B]): bound as a static material when they are all one
    (that material's own code path), else a per-clip row on a
    ``with_traced("material")`` plugin."""
    i = _texture_stage(chain)
    values = _tex_materials(materials)
    new = copy.copy(chain)
    new.plugins, new.params = list(chain.plugins), list(chain.params)
    plug = chain.plugins[i]
    static = {k: v for k, v in plug._static.items() if k != "material"}
    params = {k: v for k, v in chain.params[i].items() if k != "material"}
    uniq = torch.unique(values)
    if len(uniq) == 1:
        new.plugins[i] = Plugin(plug.defn, plug.sr, plug.channels,
                                plug.block_size,
                                static=dict(static, material=int(uniq[0])))
    else:
        new.plugins[i] = Plugin(plug.defn, plug.sr, plug.channels,
                                plug.block_size, static=static
                                ).with_traced("material")
        params["material"] = values.to(torch.float32)
    new.params[i] = params
    return new


def _tex_materials(materials) -> torch.Tensor:
    from juicy_tpu_torch.models import texture as _tex

    return _tex.clip_materials({"material": materials}).reshape(-1)


def run_corpus_chain(chain, clips, metrics: str = "final",
                     use_kernel: str = "auto", automation=None,
                     materials=None, return_audio: bool = True, device=None,
                     mesh=None):
    """Full-chain corpus scoring: a [B, C, T] float32 corpus (a tensor or a
    numpy array) through `chain` on `device` (the card when None, which must
    then exist; ``"cpu"`` runs the plain PyTorch routes). With a `mesh`, or
    with neither a mesh nor a device and more than one visible card, the
    clips (and `materials`) are split over the mesh's ``data`` axis (B must
    divide by it: ValueError, as JAX's batch sharding raises), each shard
    runs as below on its device (one chain-kernel launch per block per
    device), and the audio and metrics are gathered on the first device.

    `use_kernel`: "auto" takes ``chain_kernel_stream`` when
    ``supports_chain_kernel(chain)`` holds (the canonical seven-stage
    stereo chain; its texture material static or one per clip), which
    launches the chain kernel once per block for a CUDA corpus and runs its
    plain version for a CPU corpus, and ``fused_chain_stream`` otherwise;
    "never" always takes ``fused_chain_stream``; "always" raises
    ``ChainKernelUnsupported`` unless the CUDA kernel can run. No route
    gives way to another on a failure.
    `metrics` is "final", "blocks" or "none" (see fused_chain_stream);
    without `return_audio` the audio is not kept and `out` is None.

    `automation`: {stage index: {param: [nb] curve}} applied per block,
    corpus-wide, on either route (the kernel reads a constant row per
    block; texture's material cannot be automated there).

    `materials`: one texture material per clip [B] (each DAW track picks
    its own, JuicyTexture/PluginProcessor.cpp:325-337). One material binds
    it statically; several run the chain kernel's material per CTA: the
    clips sorted by material once per corpus (runs padded to 32 with silent
    copies), one launch per block over the whole corpus, the outputs and
    metrics put back in corpus order once after the stream; on "never" the
    executor runs texture's traced model clip by clip.

    Returns (out [B, C, T] or None, per-stage metrics, corpus aggregates of
    the last stage's metrics, or None under "none"). Each device's call is
    the span ``juicy.corpus_chain`` under a profiler (observe.span)."""
    from juicy_tpu_torch.kernels import chain_kernel as ck
    from juicy_tpu_torch.runtime.chain_fused import fused_chain_stream

    if use_kernel not in ("auto", "never", "always"):
        raise ValueError(f"use_kernel must be auto, never or always; got "
                         f"{use_kernel!r}")
    mesh = corpus_mesh(mesh, device)
    if mesh is not None:
        if len(mesh.axis_devices("data")) > 1:
            return _chain_sharded(chain, clips, mesh, metrics, use_kernel,
                                  automation, materials, return_audio)
        device = mesh.axis_devices("data")[0]
    with span("juicy.corpus_chain"):
        clips = _corpus_on(clips, device)
        if materials is not None:
            values = _tex_materials(materials)
            if values.shape[0] != clips.shape[0]:
                raise ValueError(f"materials must have one entry per "
                                 f"clip: {values.shape[0]} vs batch "
                                 f"{clips.shape[0]}")
            chain = with_materials(chain, values)
        kernel = use_kernel != "never" and ck.supports_chain_kernel(chain)
        if use_kernel == "always" and not (kernel and clips.is_cuda):
            raise ck.ChainKernelUnsupported(
                f"no chain-kernel path for this chain on {clips.device}: the "
                f"kernel takes the canonical stereo chain with a static or "
                f"per-clip texture material, on CUDA tensors")
        states = chain.init_state((clips.shape[0],), clips.device)
        stream = ck.chain_kernel_stream if kernel else fused_chain_stream
        out, _states, ms = stream(chain, states, clips, metrics=metrics,
                                  return_audio=return_audio,
                                  automation=automation)
        agg = None if ms is None else corpus_metrics(ms[-1])
        return out, ms, agg


def _chain_sharded(chain, clips, mesh, metrics, use_kernel, automation,
                   materials, return_audio):
    """run_corpus_chain over the shards of `mesh`'s data axis, gathered."""
    devices = mesh.axis_devices("data")
    parts = shard_clips(mesh, clips)
    mats = None
    if materials is not None:
        values = _tex_materials(materials)
        if values.shape[0] != clips.shape[0]:
            raise ValueError(f"materials must have one entry per clip: "
                             f"{values.shape[0]} vs batch {clips.shape[0]}")
        mats = torch.chunk(values, len(devices))
    res = []
    for i, (chunk, dev) in enumerate(zip(parts, devices)):
        with on_device(dev):
            res.append(run_corpus_chain(
                chain, chunk, metrics=metrics, use_kernel=use_kernel,
                automation=automation,
                materials=None if mats is None else mats[i],
                return_audio=return_audio, device=dev))
    out = gather([r[0] for r in res]) if return_audio else None
    if res[0][1] is None:
        return out, None, None
    dim = 1 if metrics == "blocks" else 0
    ms = [{k: gather([r[1][s][k] for r in res], dim) for k in stage}
          for s, stage in enumerate(res[0][1])]
    return out, ms, corpus_metrics(ms[-1])
