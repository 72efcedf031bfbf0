"""Block-major chain executor: PyTorch port of juicy_tpu/runtime/chain_fused.py
(``fused_chain_step`` and ``fused_chain_stream``).

Each block runs through every stage in chain order, each stage through the
port's ``Plugin.step`` (pre-analyze → DSP → post-analyze), with every
stage's state carried to the next block: the result of ``Chain.step`` /
``Chain.batched_run``, block-major. It is the executor of chains the chain
kernel does not take (``run_corpus_chain(use_kernel="never")``, reordered,
mono or batched-param chains) on any device.

JAX's module schedules the per-sample bodies of several stages into a few
shared ``lax.scan``s per block (its ``_Executor``), to cut the number of
scans on a TPU. The bodies and the results are those of the stages run one
by one, and eager PyTorch has no scan to merge, so that scheduler is not
ported (ROADMAP.md, "Do not port").

Metrics modes, as in JAX: "blocks" (per-block metrics of every stage),
"final" (the analyzers advance every block, only the last block's metrics
are returned) and "none" (no analyzer runs, its state is left as it was).
``fused_chain_stream(automation=)`` runs each block with its own values of
the automated params (``chain_automation``, ``block_params``, which the
chain kernel's stream shares).
"""

from __future__ import annotations

from typing import Any, Dict, Sequence

import torch

from juicy_tpu_torch.runtime.plugin import automation_curves

_METRICS = ("blocks", "final", "none")


def fused_chain_step(chain, states: Sequence[Dict[str, Any]], block,
                     metrics: str = "blocks", params: Sequence = None):
    """One block [..., C, N] through the whole chain. Returns (out,
    new states, per-stage metrics list; each None under "none").

    `params` overrides ``chain.params`` (the same per-stage structure)."""
    if metrics not in _METRICS:
        raise ValueError(f"metrics must be one of {_METRICS}; got "
                         f"{metrics!r}")
    params = chain.params if params is None else params
    out = block
    new_states, metric_list = [], []
    for plug, p, st in zip(chain.plugins, params, states, strict=True):
        if metrics == "none":
            out, dsp = plug.defn.process(plug.full_params(p), st["dsp"], out,
                                         plug.sr)
            st, m = {"analyzer": st["analyzer"], "dsp": dsp}, None
        else:
            out, st, m = plug.step(p, st, out)
        new_states.append(st)
        metric_list.append(m)
    return out, new_states, metric_list


def chain_automation(chain, automation, nb: int):
    """`automation` ({stage index: {param: curve}}, one value per block)
    checked against each stage's full params and the block count:
    {(stage, param): float32 curve [nb] on the CPU}."""
    curves = {}
    for stage, params in (automation or {}).items():
        i = int(stage)
        full = chain.plugins[i].full_params(chain.params[i])
        curves.update({(i, key): v for key, v in
                       automation_curves(full, params, nb).items()})
    return curves


def block_params(chain, curves, i: int):
    """Each stage's params with the automation curves' values at block
    `i`."""
    out = [dict(p) for p in chain.params]
    for (stage, key), v in curves.items():
        out[stage][key] = v[i]
    return out


def fused_chain_stream(chain, states, clips, metrics: str = "blocks",
                       params: Sequence = None, return_audio: bool = True,
                       automation=None):
    """Stream a [..., C, T] corpus through the chain block-major. Returns
    (out [..., C, T], or None without `return_audio`; final states;
    per-stage metrics with leaves [nb, ...] under "blocks", the last
    block's under "final", or None under "none").

    `automation`: {stage index: {param: curve}} with one value per block
    ([nb]): each block runs with those values in place of the chain's (the
    host automating any instance, JuicyPunch/PluginProcessor.cpp:74-80).
    Not together with `params`."""
    if automation is not None and params is not None:
        raise ValueError("pass either params or automation, not both")
    if metrics not in _METRICS:
        raise ValueError(f"metrics must be one of {_METRICS}; got "
                         f"{metrics!r}")
    t = clips.shape[-1]
    n = chain.block_size
    if t == 0 or t % n:
        raise ValueError(f"clip length {t} is not a positive multiple of "
                         f"block size {n}")
    curves = chain_automation(chain, automation, t // n)
    out = torch.empty_like(clips) if return_audio else None
    per_block = []
    for i in range(t // n):
        sl = slice(i * n, (i + 1) * n)
        if curves:
            params = block_params(chain, curves, i)
        y, states, ms = fused_chain_step(chain, states, clips[..., sl],
                                         metrics=metrics, params=params)
        if return_audio:
            out[..., sl] = y
        if metrics == "blocks":
            per_block.append(ms)
        elif metrics == "final":
            per_block = [ms]
    if metrics == "blocks":
        ms = [{k: torch.stack([blk[s][k] for blk in per_block])
               for k in per_block[0][s]} for s in range(len(chain.plugins))]
    elif metrics == "final":
        ms = per_block[0]
    else:
        ms = None
    return out, states, ms
