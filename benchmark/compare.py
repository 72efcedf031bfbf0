"""The comparison that decides `correct`: what the timed path produced
against the plain reference (benchmark/reference), number by number, each
against its limit.

- ``audio_err``: the largest |program - reference| over every sample of
  the compared clips' output audio (full scale is 1.0).
- ``metric_err``: the largest |program - reference| / max(1, |reference|)
  over every stage's final-block metrics (scores 0-100, sub-metrics 0-1,
  cohere's context fit 0-100) of the compared clips.

A value that is not finite on the program's side reads as infinite.
The limits, and the readings they were set from, are in PERF.md.
"""

from __future__ import annotations

import math

import numpy as np

LIMITS = {"audio_err": 1e-6, "metric_err": 1e-5}


def _finite_max(values):
    m = 0.0
    for v in values:
        v = float(v)
        m = math.inf if not math.isfinite(v) else max(m, v)
    return m


def audio_err(out, ref):
    out = np.asarray(out, np.float64)
    ref = np.asarray(ref, np.float64)
    if not np.isfinite(out).all():
        return math.inf
    return float(np.max(np.abs(out - ref))) if out.size else 0.0


def metric_err(ms, ref_ms):
    """`ms`, `ref_ms`: per stage, {name: [K]}; the reference's names are
    the ones compared, and each must be in the program's."""
    errs = []
    for m, r in zip(ms, ref_ms, strict=True):
        for key, rv in r.items():
            if key not in m:
                return math.inf
            pv = np.asarray(m[key], np.float64)
            rv = np.asarray(rv, np.float64)
            if not np.isfinite(pv).all():
                return math.inf
            errs.append(np.max(np.abs(pv - rv) / np.maximum(1.0, np.abs(rv))))
    return _finite_max(errs)


def readings(out, ms, ref_out, ref_ms):
    """{number: reading}: audio_err where audio was returned, metric_err."""
    got = {"metric_err": metric_err(ms, ref_ms)}
    if out is not None:
        got["audio_err"] = audio_err(out, ref_out)
    return got


def checks(got):
    """{number: {"value", "limit"}} and whether every number is within."""
    table = {k: {"value": v, "limit": LIMITS[k]} for k, v in got.items()}
    return table, all(v["value"] <= v["limit"] for v in table.values())
