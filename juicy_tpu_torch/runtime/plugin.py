"""Plugin runtime: the JUCE processor lifecycle as plain functions on
tensors. PyTorch port of juicy_tpu/runtime/plugin.py (``Plugin`` and
``Chain``).

  =====================  =======================================
  JUCE (reference)        juicy_tpu_torch
  =====================  =======================================
  createPluginFilter()    ``Plugin(name, sr, channels, block)``
  prepareToPlay           ``plugin.init_state(batch_shape, device)``
  (static params)         ``plugin.with_static(material=2)``
  (a per-clip material)   ``plugin.with_traced("material")``
  processBlock            ``plugin.step(params, state, block)``
  setCurrentProgram       ``plugin.preset(name_or_index)``
  get/setStateInformation ``runtime.state.save_plugin_state`` / ``load_``
  a channel strip         ``Chain([(name, preset), ...], sr, ...)``
  =====================  =======================================

``step`` runs the reference's three passes per block: pre-analyze, DSP,
post-analyze, with the analyzer state threaded pre → post, and the metrics
go through the plugin's ``finalize_metrics`` where it has one. Every
function is rank-polymorphic over leading batch dims, so ``batch_step`` is
``step`` on a [B, C, N] block with [B]-leading state; ``run`` and
``batched_run`` loop over blocks of ``block_size`` samples, with optional
per-block parameter values (automation).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple, Union

import torch

from juicy_tpu_torch.analyzer import analyze, analyzer_init
from juicy_tpu_torch.models.base import ProcessorDef, get_processor
from juicy_tpu_torch.runtime.device import resolve_device


def _default_finalize(params, pre, post, carry=None):
    del params, carry
    m = dict(post)
    m["pre_score"] = pre["score"]
    m["post_score"] = post["score"]
    m["score"] = post["score"]
    return m


class Plugin:
    """One processor instance bound to (sample rate, channels, block size)."""

    def __init__(self, defn: Union[str, ProcessorDef], sr: float = 48000.0,
                 channels: int = 2, block_size: int = 512,
                 static: Optional[Dict[str, int]] = None):
        if isinstance(defn, str):
            defn = get_processor(defn)
        self.defn = defn
        self.sr = float(sr)
        self.channels = int(channels)
        self.block_size = int(block_size)
        # static (code-path-selecting) params, e.g. texture's material
        self._static: Dict[str, int] = dict(static or {})

    #: static params that stay in the params dict (with_traced)
    _traced: frozenset = frozenset()

    def with_static(self, **static) -> "Plugin":
        """A new Plugin bound to updated static params, e.g.
        ``plug.with_static(material=2)``."""
        merged = dict(self._static)
        merged.update({k: int(v) for k, v in static.items()})
        plug = Plugin(self.defn, self.sr, self.channels, self.block_size,
                      static=merged)
        plug._traced = self._traced
        return plug

    def with_traced(self, *names: str) -> "Plugin":
        """A new Plugin whose listed static params stay in the params dict,
        where a batched caller may give them per clip: e.g.
        ``Plugin("texture").with_traced("material")`` picks the material
        clip by clip (models/texture.py::process_traced)."""
        plug = Plugin(self.defn, self.sr, self.channels, self.block_size,
                      static={k: v for k, v in self._static.items()
                              if k not in names})
        plug._traced = self._traced | frozenset(names)
        return plug

    def init_state(self, batch_shape=(), device=None) -> Dict[str, Any]:
        """Fresh analyzer and DSP state, each leaf [*batch_shape, ...] on
        `device` (None is the card, runtime/device.py)."""
        device = resolve_device(device)
        return {
            "analyzer": analyzer_init(batch_shape, device),
            "dsp": self.defn.init(self.sr, self.channels, batch_shape, device),
        }

    def default_params(self) -> Dict[str, torch.Tensor]:
        return self._split_static(self.defn.default_params())[0]

    def preset(self, preset) -> Dict[str, torch.Tensor]:
        params = self._split_static(self.defn.preset_params(preset))[0]
        # the current program, as setCurrentProgram keeps it
        if self.defn.presets:
            if isinstance(preset, str):
                self._current_program = self.defn.preset_names().index(preset)
            else:
                self._current_program = max(
                    0, min(len(self.defn.presets) - 1, int(preset)))
        return params

    # -- the program API (JuicyPunch/PluginProcessor.cpp:147-187) ----------

    @property
    def num_programs(self) -> int:
        """getNumPrograms: the preset count, at least 1."""
        return max(1, len(self.defn.presets))

    @property
    def current_program(self) -> int:
        """getCurrentProgram: the index last applied by preset() or
        set_program()."""
        return getattr(self, "_current_program", 0)

    def set_program(self, index: int) -> Dict[str, torch.Tensor]:
        """setCurrentProgram: clamps the index, returns the preset's
        params."""
        return self.preset(int(index))

    def program_name(self, index: int) -> str:
        """getProgramName, the index clamped."""
        names = self._names()
        return names[max(0, min(len(names) - 1, int(index)))]

    def change_program_name(self, index: int, name: str) -> None:
        """changeProgramName: renames a program in this instance's table
        (kept by save_plugin_state); an index out of range does nothing."""
        names = list(self._names())
        if 0 <= int(index) < len(names):
            names[int(index)] = str(name)
            self._program_names = names

    def _names(self):
        return getattr(self, "_program_names", None) or \
            list(self.defn.preset_names()) or [self.defn.title]

    def _split_static(self, params):
        """(params without the static ones, the static ones as ints); traced
        ones (with_traced) stay in the params. Pure: the split is not bound
        to this instance (use with_static)."""
        rest = dict(params)
        static = {key: int(rest.pop(key)) for key in self.defn.static_params
                  if key in rest and key not in self._traced}
        return rest, static

    def full_params(self, params):
        """The params the DSP reads: `params` plus the static ones."""
        merged = dict(params)
        merged.update({k: v for k, v in self._static.items()
                       if k not in self._traced})
        return merged

    def step(self, params, state, block):
        """One processBlock: pre-analyze → DSP → post-analyze → metrics."""
        p = self.full_params(params)
        pre_state, pre = analyze(state["analyzer"], block, self.sr)
        out, dsp = self.defn.process(p, state["dsp"], block, self.sr)
        post_state, post = analyze(pre_state, out, self.sr)
        finalize = self.defn.finalize_metrics or _default_finalize
        return out, {"analyzer": post_state, "dsp": dsp}, \
            finalize(p, pre, post, dsp)

    def batch_step(self, params, state, blocks, params_batched: bool = False):
        """`step` over a leading clips axis of `blocks` [B, C, N] and of every
        state leaf. `params` leaves are shared 0-dim tensors unless
        `params_batched`, in which case each carries a leading [B]; a static
        param that is not bound (with_traced, texture's material) may carry
        [B] either way."""
        if blocks.ndim != 3:
            raise ValueError(f"expected blocks [B, C, N], got {tuple(blocks.shape)}")
        _check_params(params, blocks.shape[0], params_batched,
                      set(self.defn.static_params) - set(self._static))
        return self.step(params, state, blocks)

    def run(self, params, state, audio,
            automation: Optional[Dict[str, Any]] = None):
        """Stream a [..., C, T] clip through `step` in block_size chunks.

        `automation` maps param ids to per-block values [T // block_size].
        Returns (out [..., C, T], final state, metrics stacked [nb, ...])."""
        nb = self.num_blocks(audio)
        n = self.block_size
        curves = automation_curves(self.full_params(params), automation, nb)
        outs, metrics = [], []
        for i in range(nb):
            out, state, m = self.step(params_at(params, curves, i), state,
                                      audio[..., i * n:(i + 1) * n])
            outs.append(out)
            metrics.append(m)
        return torch.cat(outs, dim=-1), state, _stack(metrics)

    def batched_run(self, params, states, clips, params_batched: bool = False,
                    automation: Optional[Dict[str, Any]] = None):
        """Stream a [B, C, T] corpus block by block through `batch_step`.
        `automation` maps param ids to per-block values [T // block_size],
        each block's value shared by every clip. Returns (out [B, C, T],
        final states, metrics stacked [nb, B])."""
        if clips.ndim != 3:
            raise ValueError(f"expected clips [B, C, T], got {tuple(clips.shape)}")
        nb = self.num_blocks(clips)
        n = self.block_size
        b = clips.shape[0]
        curves = automation_curves(self.full_params(params), automation, nb)
        out = torch.empty_like(clips)
        metrics = []
        for i in range(nb):
            sl = slice(i * n, (i + 1) * n)
            p = params_at(params, curves, i)
            if params_batched:      # a block's value for every clip
                p.update({k: torch.broadcast_to(p[k], (b,)) for k in curves})
            out[..., sl], states, m = self.batch_step(
                p, states, clips[..., sl], params_batched=params_batched)
            metrics.append(m)
        return out, states, _stack(metrics)

    def num_blocks(self, audio) -> int:
        """Blocks in `audio` [..., T]; T must be a positive multiple of
        block_size."""
        t = audio.shape[-1]
        if t == 0 or t % self.block_size:
            raise ValueError(f"clip length {t} is not a positive multiple of "
                             f"block size {self.block_size}: pad first")
        return t // self.block_size


class Chain:
    """A serial insert chain of plugins (a DAW channel strip). Each stage
    keeps its own analyzer and DSP state and reports its own metrics, as
    when the reference plugins are stacked on one track.

    `stages` is a sequence of (processor name or definition, preset), the
    preset a name or index, None for the defaults, or a dict of param values
    over the defaults; static params in a dict (texture's ``material``) bind
    the stage's plugin with ``with_static``."""

    def __init__(self, stages: Sequence[Tuple[Union[str, ProcessorDef], Any]],
                 sr: float = 48000.0, channels: int = 2, block_size: int = 512):
        self.plugins = []
        self.params = []
        for defn, preset in stages:
            plug = Plugin(defn, sr, channels, block_size)
            if isinstance(preset, dict):
                p, static = plug._split_static(
                    dict(plug.defn.default_params(), **preset))
                if static:
                    plug = plug.with_static(**static)
                self.params.append(p)
            elif preset is None:
                self.params.append(plug.default_params())
            else:
                self.params.append(plug.preset(preset))
            self.plugins.append(plug)
        self.sr = float(sr)
        self.channels = int(channels)
        self.block_size = int(block_size)

    def init_state(self, batch_shape=(), device=None):
        """One state per stage, each leaf [*batch_shape, ...] on `device`
        (None is the card)."""
        return [p.init_state(batch_shape, device) for p in self.plugins]

    def step(self, params_list, states, block):
        """One block through every stage in order: (out, states', a metrics
        dict per stage)."""
        out = block
        new_states, metrics = [], []
        for plug, params, st in zip(self.plugins, params_list, states,
                                    strict=True):
            out, st, m = plug.step(params, st, out)
            new_states.append(st)
            metrics.append(m)
        return out, new_states, metrics

    def run(self, states, audio):
        """Stream [..., C, T] block by block through the chain with its
        bound params. Returns (out, final states, per-stage metrics stacked
        [nb, ...])."""
        nb = self.plugins[0].num_blocks(audio)
        n = self.block_size
        outs, metrics = [], []
        for i in range(nb):
            out, states, m = self.step(self.params, states,
                                       audio[..., i * n:(i + 1) * n])
            outs.append(out)
            metrics.append(m)
        return (torch.cat(outs, dim=-1), states,
                [_stack([m[k] for m in metrics]) for k in range(len(states))])

    def batched_run(self, states, clips):
        """A [B, C, T] corpus, stage-major: each stage streams the whole
        corpus through its own ``batched_run`` before the next starts (the
        same result as interleaving: stages talk only through the audio).
        Returns (out, final states, per-stage metrics stacked [nb, B])."""
        out = clips
        new_states, metrics = [], []
        for plug, params, st in zip(self.plugins, self.params, states,
                                    strict=True):
            out, st, m = plug.batched_run(params, st, out)
            new_states.append(st)
            metrics.append(m)
        return out, new_states, metrics


def automation_curves(params, automation, nb: int):
    """`automation` ({param id: curve}) checked against `params` and the
    block count: each curve a float32 tensor [nb] on the CPU."""
    curves = {}
    for key, v in (automation or {}).items():
        if key not in params:
            raise KeyError(f"no parameter {key!r} to automate")
        v = torch.as_tensor(v, dtype=torch.float32).detach().cpu()
        if tuple(v.shape) != (nb,):
            raise ValueError(f"automation curve for {key!r} must have one "
                             f"value per block, shape ({nb},), got "
                             f"{tuple(v.shape)}")
        curves[key] = v
    return curves


def params_at(params, curves, i: int):
    """`params` with the automation curves' values at block `i`."""
    p = dict(params)
    p.update({k: v[i] for k, v in curves.items()})
    return p


def _check_params(params, batch: int, batched: bool, traced=()):
    for k, v in params.items():
        shape = tuple(torch.as_tensor(v).shape)
        want = {(batch,)} if batched else {(), (batch,)} if k in traced \
            else {()}
        if shape not in want:
            raise ValueError(f"param {k!r} has shape {shape}, expected "
                             f"{' or '.join(map(str, sorted(want)))}")


def _stack(metrics):
    return {k: torch.stack([m[k] for m in metrics]) for k in metrics[0]}
