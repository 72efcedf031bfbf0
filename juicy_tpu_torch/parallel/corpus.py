"""Corpus-scale batch runner, PyTorch port of juicy_tpu/parallel/corpus.py
(``run_corpus`` and ``corpus_metrics``).

A corpus [B, C, T] streams block by block through one plugin on the card
(or on the device the caller names); the result is the audio, each clip's
final-block metrics and their corpus mean/min/max. The JAX runner's mesh has
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
            "item 9: run_corpus(automation=))")
    device = resolve_device(device)
    if isinstance(clips, np.ndarray):
        clips = torch.from_numpy(clips)
    if clips.dtype != torch.float32 or clips.ndim != 3:
        raise ValueError(f"expected float32 clips [B, C, T], got "
                         f"{clips.dtype} {tuple(clips.shape)}")
    clips = clips.to(device)
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
