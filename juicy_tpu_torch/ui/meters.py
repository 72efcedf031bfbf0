"""Terminal meter panel — the JuicyMeterPanel / JuicyPluginEditor analog.
A copy of juicy_tpu/ui/meters.py for the PyTorch port (plain Python).

Reproduces the reference meter *behavior* (src/shared/JuicyMeterPanel.cpp) in
a host-agnostic form: asymmetric smoothing (α=0.28 rising / 0.12 falling,
cpp:3-7), running min/max/incremental-average stats per metric (cpp:54-71),
PRE/POST juiciness score meters with 5 gridline ticks (cpp:122-163), the five
feature bars — Punch/Richness/Clarity/Width/MonoSafety, or in triangle mode
Emphasis/Coherence/Synesthesia/FatigueRisk/Repetition (cpp:175-198) — and the
optional ghost min–max band with average marker (cpp:86-98).

Rendering targets a terminal (ANSI) instead of a JUCE Graphics context; the
numeric model (smoothing, stats) is identical, so a future native host shim
can drive real meters from the same state. The per-plugin accent colour is
hashed from the title like the reference editor (JuicyPluginEditor.cpp:3-9).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

# Fixed per-bar colours (JuicyMeterPanel.cpp:177-197), as xterm-256 indices.
BAR_COLOURS = {
    "punch": 208, "richness": 220, "clarity": 41, "width": 39,
    "mono_safety": 134, "emphasis": 214, "coherence": 49,
    "synesthesia": 81, "fatigue_risk": 203, "repetition_density": 141,
}
FEATURE_BARS = (("punch", "Punch"), ("richness", "Richness"),
                ("clarity", "Clarity"), ("width", "Width"),
                ("mono_safety", "Mono Safety"))
TRIANGLE_BARS = (("emphasis", "Emphasis"), ("coherence", "Coherence"),
                 ("synesthesia", "Synesthesia"), ("fatigue_risk", "Fatigue Risk"),
                 ("repetition_density", "Repetition"))


def accent_hue_from_title(title: str) -> float:
    """Deterministic accent from the plugin title (editor cpp:3-9 analog:
    hash → hue in [0.54, 0.60])."""
    h = 0
    for ch in title:        # 31-based string hash (JUCE String::hashCode)
        h = (31 * h + ord(ch)) & 0xFFFFFFFF
    t = (h % 1000) / 1000.0
    return 0.54 + t * (0.60 - 0.54)


@dataclasses.dataclass
class MetricStats:
    """Running min/max/incremental-avg (JuicyMeterPanel.cpp:54-71)."""
    min: float = 0.0
    max: float = 0.0
    avg: float = 0.0
    count: int = 0

    def update(self, value: float):
        v = min(1.0, max(0.0, value))
        if self.count == 0:
            self.min = self.max = self.avg = v
            self.count = 1
            return
        self.min = min(self.min, v)
        self.max = max(self.max, v)
        self.count += 1
        self.avg += (v - self.avg) / self.count


class MeterPanel:
    """Stateful meter model + ANSI renderer."""

    SMOOTH_UP = 0.28     # cpp:5
    SMOOTH_DOWN = 0.12

    def __init__(self, title: str = "Juicy", show_ghost_stats: bool = False,
                 show_triangle_metrics: bool = False, width: int = 58):
        self.title = title
        self.show_ghost_stats = show_ghost_stats
        self.show_triangle_metrics = show_triangle_metrics
        self.width = width
        self.smoothed: Dict[str, float] = {}
        self.stats: Dict[str, MetricStats] = {}

    def _smooth(self, key: str, target: float) -> float:
        cur = self.smoothed.get(key, 0.0)
        alpha = self.SMOOTH_UP if target > cur else self.SMOOTH_DOWN
        cur = cur + (target - cur) * alpha
        self.smoothed[key] = cur
        return cur

    def set_metrics(self, m: Dict[str, float]):
        """Feed one metrics snapshot (== 20 Hz timer poll, editor cpp:85-90)."""
        pre = m.get("pre_score", 0.0) or m.get("score", 0.0)
        post = m.get("post_score", 0.0) or m.get("score", 0.0)
        self._smooth("pre_score", float(pre))
        self._smooth("post_score", float(post))
        for key, _ in FEATURE_BARS + TRIANGLE_BARS:
            v = float(m.get(key, 0.0))
            self.stats.setdefault(key, MetricStats()).update(v)
            self._smooth(key, v)

    # -- rendering -----------------------------------------------------

    def _bar(self, label: str, value: float, colour: int,
             stats: Optional[MetricStats]) -> str:
        w = self.width
        fill = max(0, min(w, round(value * w)))
        cells = [" "] * w
        for i in range(fill):
            cells[i] = "█"
        if self.show_ghost_stats and stats and stats.count > 2:
            lo = min(w - 1, round(stats.min * w))
            hi = min(w - 1, round(stats.max * w))
            for i in range(lo, hi + 1):
                if cells[i] == " ":
                    cells[i] = "░"
            avg = min(w - 1, round(stats.avg * w))
            cells[avg] = "│"
        bar = "".join(cells)
        return (f"  {label:<13s} \x1b[38;5;{colour}m{bar}\x1b[0m "
                f"{value * 100.0:5.1f}%")

    def _score_meter(self, label: str, score: float) -> str:
        w = self.width
        norm = max(0.0, min(1.0, score / 100.0))
        fill = round(norm * w)
        cells = []
        for i in range(w):
            if i and i % (w // 5) == 0:
                cells.append("┊" if i >= fill else "▓")
            else:
                cells.append("█" if i < fill else " ")
        return f"  {label:<5s} [{''.join(cells)}] {score:5.1f}"

    def render(self) -> str:
        lines = [f"  {self.title} — JUICINESS INDEX"]
        lines.append(self._score_meter("PRE", self.smoothed.get("pre_score", 0.0)))
        lines.append(self._score_meter("POST", self.smoothed.get("post_score", 0.0)))
        bars = TRIANGLE_BARS if self.show_triangle_metrics else FEATURE_BARS
        for key, label in bars:
            lines.append(self._bar(label, self.smoothed.get(key, 0.0),
                                   BAR_COLOURS[key], self.stats.get(key)))
        if self.show_ghost_stats:
            lines.append(f"  {'':13s} ghost: min-max range | avg marker")
        return "\n".join(lines)
