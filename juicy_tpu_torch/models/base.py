"""Processor registry and parameter specs, PyTorch port of
juicy_tpu/models/base.py.

A processor registers a :class:`ProcessorDef` with
  * ``init(sr, channels, batch_shape, device) -> carry`` (prepareToPlay);
  * ``process(params, carry, block, sr) -> (out, carry')``, the DSP of
    processBlock without the analyzer passes, which the runtime adds;
  * optionally ``finalize_metrics(params, pre, post, carry) -> metrics``
    for a plugin's own metric quirks (infer's sensitivity and slot remap,
    cohere's context fit).
Params are dicts of float32 tensors: 0-dim for one setting, or a leading
batch dim for per-clip settings.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from juicy_tpu_torch.ops.precise import F32, as_f32, div_const, f32


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """One host-visible parameter (JUCE RangedAudioParameter analog)."""
    id: str
    name: str
    lo: float
    hi: float
    default: float
    readonly: bool = False          # read-only metric outputs (skip in UIs)
    choices: Tuple[str, ...] = ()   # non-empty => AudioParameterChoice analog
    boolean: bool = False           # AudioParameterBool analog

    def to_normalized(self, value):
        return div_const(as_f32(value) - f32(self.lo), self.hi - self.lo)

    def from_normalized(self, norm):
        return f32(self.lo) + as_f32(norm) * f32(self.hi - self.lo)

    def clamp(self, value):
        return torch.clamp(as_f32(value), f32(self.lo), f32(self.hi))


@dataclasses.dataclass(frozen=True)
class ProcessorDef:
    """A registered processor (juce::AudioProcessor subclass analog)."""
    name: str                       # registry key, e.g. "saturator"
    title: str                      # display title, e.g. "Juicy Saturator"
    code: str                       # 4-char plugin code
    params: Tuple[ParamSpec, ...]
    presets: Tuple[Tuple[str, Dict[str, float]], ...]
    init: Callable[..., Any]        # (sr, channels, batch_shape, device) -> carry
    process: Callable[..., Any]     # (params, carry, block, sr) -> (out, carry)
    finalize_metrics: Optional[Callable[..., Any]] = None
    show_ghost_stats: bool = False          # the meter panel's options
    show_triangle_metrics: bool = False
    # Parameters that select code paths (texture's material index); the
    # Plugin holds them as Python ints (Plugin.with_static), not tensors.
    static_params: Tuple[str, ...] = ()

    def param(self, pid: str) -> ParamSpec:
        for p in self.params:
            if p.id == pid:
                return p
        raise KeyError(f"{self.name}: no parameter {pid!r}")

    def preset_names(self) -> Tuple[str, ...]:
        return tuple(nm for nm, _ in self.presets)

    def default_params(self) -> Dict[str, torch.Tensor]:
        """Defaults, then preset 0 applied on top (the reference
        constructors call setCurrentProgram(0))."""
        out = {p.id: _scalar(p.default) for p in self.params if not p.readonly}
        if self.presets:
            out.update({k: _scalar(v) for k, v in self.presets[0][1].items()})
        return out

    def preset_params(self, preset) -> Dict[str, torch.Tensor]:
        """Params for a preset by index (clamped) or name."""
        if not self.presets:
            return self.default_params()
        if isinstance(preset, str):
            for nm, values in self.presets:
                if nm == preset:
                    break
            else:
                raise KeyError(f"{self.name}: no preset {preset!r}")
        else:
            idx = max(0, min(len(self.presets) - 1, int(preset)))
            values = self.presets[idx][1]
        out = self.default_params()
        out.update({k: _scalar(v) for k, v in values.items()})
        return out


def bcast_param(v, like: torch.Tensor, dims: int) -> torch.Tensor:
    """A param (0-dim, or batched with a leading [B]) as a float32 tensor on
    `like`'s device, a batched one with `dims` trailing axes added so that
    it broadcasts against audio of `dims` more axes. On the audio's device:
    on CUDA, a CPU scalar divisor runs as a reciprocal multiply."""
    v = as_f32(v).to(like.device)
    return v if v.ndim == 0 else v.reshape(*v.shape, *([1] * dims))


def _scalar(v) -> torch.Tensor:
    return torch.tensor(f32(v), dtype=F32)


registry: Dict[str, ProcessorDef] = {}


def register(defn: ProcessorDef) -> ProcessorDef:
    registry[defn.name] = defn
    return defn


def get_processor(name: str) -> ProcessorDef:
    import juicy_tpu_torch.models  # noqa: F401  (populates the registry)
    if name not in registry:
        raise KeyError(f"unknown processor {name!r}; have {sorted(registry)}")
    return registry[name]


def mix_param(default: float = 1.0) -> ParamSpec:
    return ParamSpec("mix", "Mix", 0.0, 1.0, default)


def output_param(lo: float, hi: float, default: float) -> ParamSpec:
    return ParamSpec("output", "Output (dB)", lo, hi, default)


def juiciness_param() -> ParamSpec:
    return ParamSpec("juiciness", "Juiciness Score", 0.0, 100.0, 0.0,
                     readonly=True)
