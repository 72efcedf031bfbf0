"""JuicyInfer, the analysis hub: PyTorch port of juicy_tpu/models/infer.py.

The audio path is a trim gain (reference PluginProcessor.cpp:74-79). The
post score is scaled by `sensitivity` and clamped to 0..100 (cpp:80-81),
and the reference's five feature slots carry the triangle metrics
(emphasis, coherence, synesthesia, fatigue, repetition; cpp:85-89,
164-181): :func:`finalize_metrics` remaps them as getLatestMetrics does.
"""

from __future__ import annotations

from juicy_tpu_torch.models import base
from juicy_tpu_torch.ops.precise import as_f32
from juicy_tpu_torch.utils.convert import db_to_gain, jlimit

PARAMS = (
    base.ParamSpec("trim", "Output Trim (dB)", -18.0, 18.0, 0.0),
    base.ParamSpec("sensitivity", "Sensitivity", 0.5, 2.0, 1.0),
    base.juiciness_param(),
    base.ParamSpec("emphasis", "Emphasis", 0.0, 1.0, 0.0, readonly=True),
    base.ParamSpec("coherence", "Coherence", 0.0, 1.0, 0.0, readonly=True),
    base.ParamSpec("synesthesia", "Synesthesia", 0.0, 1.0, 0.0, readonly=True),
    base.ParamSpec("fatigue", "Fatigue Risk", 0.0, 1.0, 0.0, readonly=True),
    base.ParamSpec("repetition", "Repetition Density", 0.0, 1.0, 0.0, readonly=True),
)

# Reference cpp:14-20.
PRESETS = (
    ("Reference Lens",  dict(trim=0.0,  sensitivity=1.0)),
    ("Detail Hunter",   dict(trim=0.0,  sensitivity=1.45)),
    ("Macro Meter",     dict(trim=-6.0, sensitivity=1.7)),
    ("Subtle Scout",    dict(trim=0.0,  sensitivity=0.75)),
    ("Overdrive Audit", dict(trim=-9.0, sensitivity=2.0)),
)


def init(sr: float, channels: int, batch_shape=(), device=None):
    """Infer keeps no DSP state."""
    del sr, channels, batch_shape, device
    return {}


def process(params, carry, block, sr: float):
    del sr
    block = as_f32(block)
    return block * base.bcast_param(db_to_gain(params["trim"]), block, 2), \
        carry


def finalize_metrics(params, pre, post, carry=None):
    """score = clamp(post.score · sensitivity); the feature slots carry the
    triangle metrics (cpp:81, 85-89, 175-179)."""
    del carry
    m = dict(post)
    score = jlimit(0.0, 100.0, post["score"] * base.bcast_param(
        params["sensitivity"], post["score"], 0))
    m["score"] = score
    m["pre_score"] = pre["score"]
    m["post_score"] = score
    # getLatestMetrics: punch <- emphasis, richness <- coherence,
    # clarity <- synesthesia, width <- fatigueRisk, monoSafety <-
    # repetitionDensity
    m["punch"] = post["emphasis"]
    m["richness"] = post["coherence"]
    m["clarity"] = post["synesthesia"]
    m["width"] = post["fatigue_risk"]
    m["mono_safety"] = post["repetition_density"]
    return m


base.register(base.ProcessorDef(
    name="infer",
    title="Juicy Infer",
    code="JINF",
    params=PARAMS,
    presets=PRESETS,
    init=init,
    process=process,
    finalize_metrics=finalize_metrics,
    show_ghost_stats=True,
    show_triangle_metrics=True,
))
