"""Corpus-scale batch runner, PyTorch port of juicy_tpu/parallel/corpus.py
(``run_corpus``, ``run_corpus_chain`` and ``corpus_metrics``).

A corpus [B, C, T] streams block by block through one plugin, or through a
``Chain``, on the card (or on the device the caller names); the result is
the audio, the metrics and their corpus mean/min/max. The JAX runner's mesh has
no counterpart on one GPU, and the 1024-clip tile alignment does not apply:
the kernels mask the ragged edge of the batch.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from juicy_tpu_torch.runtime.device import resolve_device
from juicy_tpu_torch.runtime.plugin import Plugin


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


def _stage_kernel_step(plugin: Plugin):
    """The plugin's full-stage kernel step, or None when it has none.

    Punch, the saturator, texture (static material) and motion have one.
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
               automation=None, device=None):
    """Process a [B, C, T] float32 corpus (a tensor or a numpy array) on
    `device`: the card when None, which must then exist; ``"cpu"`` runs the
    plain PyTorch route.

    `use_kernel`: "auto" runs the plugin's full-stage kernel step when it has
    one (punch, the saturator, texture with a static material, motion),
    which launches the CUDA kernel for a CUDA corpus and runs its plain
    version for a CPU corpus; "never" runs ``Plugin.batched_run``; "always"
    raises unless the CUDA kernel can run. Width, cohere and infer have no
    stage kernel and take ``batched_run`` under every setting but "always".
    Texture with a per-clip material raises NotImplementedError (its traced
    path is not ported).

    Returns (out [B, C, T], per-clip final-block metrics, corpus aggregates).
    """
    from juicy_tpu_torch.kernels import stage_kernels as sk
    from juicy_tpu_torch.models import texture as _tex

    if use_kernel not in ("auto", "never", "always"):
        raise ValueError(f"use_kernel must be auto, never or always; got "
                         f"{use_kernel!r}")
    if automation is not None:
        raise NotImplementedError(
            "run_corpus(automation=) is not ported yet (ROADMAP.md, Queue 1 "
            "item 2: automation)")
    clips = _corpus_on(clips, device)
    is_texture = plugin.defn.name == "texture"
    mode = _tex.require_static(plugin.full_params(params)) if is_texture \
        else None
    kstep = None if use_kernel == "never" else _stage_kernel_step(plugin)
    if use_kernel == "always" and (kstep is None or not clips.is_cuda):
        raise ValueError(
            f"no stage-kernel path for {plugin.defn.name!r} on "
            f"{clips.device}: the kernels run on CUDA tensors only")

    states = plugin.init_state((clips.shape[0],), clips.device)
    if kstep is None:
        out, _states, metrics = plugin.batched_run(params, states, clips)
        last = {k: v[-1] for k, v in metrics.items()}
        return out, last, corpus_metrics(last)

    p = plugin.full_params(params)
    if is_texture:
        # the ring goes to kernel form once per corpus, not once per block
        states["dsp"] = sk.texture_kernel_state(states["dsp"], mode)
    n = plugin.block_size
    nb = plugin.num_blocks(clips)
    out = torch.empty_like(clips)
    for i in range(nb):
        sl = slice(i * n, (i + 1) * n)
        out[..., sl], states, last = kstep(p, states, clips[..., sl],
                                           plugin.sr)
    return out, last, corpus_metrics(last)


def run_corpus_chain(chain, clips, metrics: str = "final",
                     use_kernel: str = "auto", automation=None,
                     materials=None, return_audio: bool = True, device=None):
    """Full-chain corpus scoring: a [B, C, T] float32 corpus (a tensor or a
    numpy array) through `chain` on `device` (the card when None, which must
    then exist; ``"cpu"`` runs the plain PyTorch routes).

    `use_kernel`: "auto" takes ``chain_kernel_stream`` when
    ``supports_chain_kernel(chain)`` holds (the canonical seven-stage
    stereo chain with a static texture material), which launches the chain
    kernel once per block for a CUDA corpus and runs its plain version for a
    CPU corpus, and ``fused_chain_stream`` otherwise; "never" always takes
    ``fused_chain_stream``; "always" raises ``ChainKernelUnsupported`` unless
    the CUDA kernel can run. No route gives way to another on a failure.
    `metrics` is "final", "blocks" or "none" (see fused_chain_stream);
    without `return_audio` the audio is not kept and `out` is None.
    `automation` and per-clip `materials` are not ported yet and raise
    NotImplementedError.

    Returns (out [B, C, T] or None, per-stage metrics, corpus aggregates of
    the last stage's metrics, or None under "none")."""
    from juicy_tpu_torch.kernels import chain_kernel as ck
    from juicy_tpu_torch.runtime.chain_fused import fused_chain_stream

    if use_kernel not in ("auto", "never", "always"):
        raise ValueError(f"use_kernel must be auto, never or always; got "
                         f"{use_kernel!r}")
    if automation is not None:
        raise NotImplementedError(
            "run_corpus_chain(automation=) is not ported yet (ROADMAP.md, "
            "Queue 1 item 2: automation)")
    if materials is not None:
        raise NotImplementedError(
            "run_corpus_chain(materials=) is not ported yet (ROADMAP.md, "
            "Queue 1 item 3: per-clip materials)")
    clips = _corpus_on(clips, device)
    kernel = use_kernel != "never" and ck.supports_chain_kernel(chain)
    if use_kernel == "always" and not (kernel and clips.is_cuda):
        raise ck.ChainKernelUnsupported(
            f"no chain-kernel path for this chain on {clips.device}: the "
            f"kernel takes the canonical stereo chain with a static texture "
            f"material, on CUDA tensors")
    states = chain.init_state((clips.shape[0],), clips.device)
    stream = ck.chain_kernel_stream if kernel else fused_chain_stream
    out, _states, ms = stream(chain, states, clips, metrics=metrics,
                              return_audio=return_audio)
    agg = None if ms is None else corpus_metrics(ms[-1])
    return out, ms, agg
