"""Heterogeneous-config batching: group clips by static code path. PyTorch
port of juicy_tpu/parallel/grouping.py (``run_grouped``).

A corpus whose clips take different values of a static param (texture's
material) runs as one sub-batch per value, each bound with
``Plugin.with_static`` and vectorized over its clips, and the results go
back into corpus order. All sub-batches run on one device; this is not a
multi-device module.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Sequence

import numpy as np
import torch

from juicy_tpu_torch.parallel.corpus import _corpus_on


def run_grouped(plugin, params: Dict[str, Any], clips,
                static_values: Sequence[int], static_param: str = "material",
                runner: Callable = None, device=None):
    """Process [B, C, T] clips (a tensor or a numpy array, on `device`: the
    card when None) where clip i uses static_values[i] for `static_param`.
    Returns (out [B, C, T], per-clip final scores [B]) on that device.

    `runner(plugin, params, sub_clips) -> (out, scores)` defaults to a fresh
    streaming run of each group through ``Plugin.batched_run``."""
    clips = _corpus_on(clips, device)
    values = np.asarray(static_values)
    if values.shape[0] != clips.shape[0]:
        raise ValueError("static_values must have one entry per clip")

    if runner is None:
        def runner(plug, p, sub):
            states = plug.init_state((sub.shape[0],), sub.device)
            out, _, metrics = plug.batched_run(p, states, sub)
            return out, metrics["score"][-1]

    out = torch.zeros_like(clips)
    scores = torch.zeros(clips.shape[0], dtype=torch.float32,
                         device=clips.device)
    for v in np.unique(values):
        idx = torch.from_numpy(np.nonzero(values == v)[0]).to(clips.device)
        sub_plugin = plugin.with_static(**{static_param: int(v)})
        sub_out, sub_scores = runner(sub_plugin, params, clips[idx])
        out[idx] = sub_out
        scores[idx] = sub_scores
    return out, scores
