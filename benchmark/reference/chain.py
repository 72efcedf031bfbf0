"""The whole chain as plain NumPy: seven stages block by block, a pre and
a post analyzer pass around each (the JuicinessAnalyzer of the plugins,
``src/shared/JuicinessAnalyzer.cpp``), and the 0-100 score formulas with
the repetition and fatigue averages carried across blocks.

``run_chain(config, clips, materials)`` works everything out anew from the
clips: fresh states, the params of the configuration file, one texture
material per clip (or the configuration's). It returns the output audio
and every stage's metrics after the last block, [K] arrays by name.
"""

from __future__ import annotations

import numpy as np

from benchmark.reference import stages as S
from benchmark.reference.bf16 import hold, round_bf16
from benchmark.reference.ops import F, clamp, onepole_coeff, tau_coeff

ORDER = ("punch", "saturator", "texture", "motion", "width", "cohere",
         "infer")
_INIT = {"punch": S.punch_init, "saturator": S.saturator_init,
         "motion": S.motion_init, "cohere": S.cohere_init}
_RUN = {"punch": S.punch, "saturator": S.saturator, "motion": S.motion,
        "width": S.width, "cohere": S.cohere, "infer": S.infer}


def stage_params(config):
    """Each stage's params as float32 scalars, in chain order."""
    names = tuple(name for name, _p in config["stages"])
    if names != ORDER:
        raise ValueError(f"the reference runs the chain {ORDER}, not {names}")
    return [{k: F(v) for k, v in p.items()} for _name, p in config["stages"]]


# ------------------------------------------------------------- analyzer

def _lane_consts(sr):
    return (tau_coeff(0.003, sr), tau_coeff(0.030, sr), tau_coeff(0.050, sr),
            tau_coeff(0.300, sr), onepole_coeff(250.0, sr),
            onepole_coeff(2500.0, sr), F(int(sr * 0.035)))


def _ar(x, atk, rel, env):
    def step(e, xt):
        c = np.where(xt > e, atk, rel)
        e = (1.0 - c) * xt + c * e
        return e, e
    return S._serial(step, env, x)[1]


def _last_sum(v):
    """A serial float32 sum over the last axis, from zero."""
    return np.add.accumulate(v, axis=-1)[..., -1]


def lanes(sig, fin0, sr):
    """One analyzer pass over `sig` [S, K, 2, N] from the carried values
    `fin0` [S, 5, K] (short and long envelope, low and high band state,
    onset cooldown): (fin [S, 5, K], acc [S, 10, K]), acc being the
    transient sum, onset count, low and high band energy, mid energy, peak,
    side energy, L*R, L*L and R*R."""
    atk_s, rel_s, atk_l, rel_l, low_c, high_c, cd = _lane_consts(sr)
    left, right = sig[:, :, 0], sig[:, :, 1]
    mono = 0.5 * (left + right)
    x = np.abs(mono)
    pair = np.stack([x, x])                      # short, long envelope
    s_env, l_env = _ar(pair, np.array([atk_s, atk_l])[:, None, None],
                       np.array([rel_s, rel_l])[:, None, None],
                       np.stack([fin0[:, 0], fin0[:, 1]]))
    transient = np.maximum(s_env - l_env, F(0.0))
    hot = transient > F(0.045)

    def detect(cr, h):
        cooldown, count = cr
        cooldown = np.maximum(cooldown - 1.0, F(0.0))
        onset = h & (cooldown <= F(0.0))
        return (np.where(onset, cd, cooldown),
                count + onset.astype(np.float32)), cooldown

    (cooldown, count), _cd = S._serial(
        detect, (fin0[:, 4], np.zeros_like(fin0[:, 4])), hot)
    lo, hi = S._serial_onepole(np.stack([mono, mono]),
                               np.array([low_c, high_c])[:, None, None, None],
                               np.stack([fin0[:, 2], fin0[:, 3]]))
    high_v = mono - hi
    side = 0.5 * (left - right)
    fin = np.stack([s_env[..., -1], l_env[..., -1], lo[..., -1], hi[..., -1],
                    cooldown], axis=1)
    acc = np.stack([_last_sum(transient), count, _last_sum(lo * lo),
                    _last_sum(high_v * high_v), _last_sum(mono * mono),
                    np.maximum(np.maximum.accumulate(x, axis=-1)[..., -1],
                               F(0.0)),
                    _last_sum(side * side), _last_sum(left * right),
                    _last_sum(left * left), _last_sum(right * right)], axis=1)
    return fin, acc


def _stateless(fin, acc, n, sr):
    """The score formulas of one block's lanes (leaves [..., K]): (metrics
    without the two averages, the averages' inputs)."""
    inv_n = F(1.0 / n)
    t_acc, count, lo_acc, hi_acc, rms_acc, peak, side_acc, corr_acc = \
        (acc[..., j, :] for j in range(8))
    l_energy = np.sqrt(acc[..., 8, :] * inv_n)
    r_energy = np.sqrt(acc[..., 9, :] * inv_n)
    rms = np.sqrt(rms_acc * inv_n + F(1.0e-12))
    crest = peak / (rms + F(1.0e-6))
    low_energy = lo_acc * inv_n
    high_energy = hi_acc * inv_n
    lhr = low_energy / (high_energy + F(1.0e-8))
    width_ratio = side_acc / (rms_acc + side_acc + F(1.0e-8))
    corr = clamp(corr_acc * inv_n / (l_energy * r_energy + F(1.0e-6)),
                 -1.0, 1.0)
    tmean = t_acc * inv_n
    punch = clamp(6.0 * tmean / (rms + F(1.0e-5)), 0.0, 1.0)
    richness = clamp((F(2.3) - crest) * F(0.65) + rms * 2.0, 0.0, 1.0)
    clarity = 1.0 - np.where(lhr > F(2.5),
                             clamp((lhr - 2.5) * F(0.15), 0.0, 0.6), F(0.0))
    clarity = clarity - np.where(
        high_energy > F(0.03), clamp((high_energy - F(0.03)) * 8.0, 0.0, 0.5),
        F(0.0))
    clarity = clamp(clarity, 0.0, 1.0)
    width = clamp(width_ratio * 2.0, 0.0, 1.0)
    mono_safety = clamp(0.5 * (corr + 1.0), 0.0, 1.0)
    onset_rate = count / F(n / sr)
    emphasis = clamp(F(0.62) * punch
                     + F(0.38) * clamp(tmean * 8.5, 0.0, 1.0), 0.0, 1.0)
    coherence = clamp(0.50 * clarity + F(0.30) * mono_safety
                      + F(0.20) * (1.0 - np.abs(width - F(0.45))), 0.0, 1.0)
    synesthesia = clamp(F(0.45) * richness
                        + F(0.30) * clamp(lhr / F(3.5), 0.0, 1.0)
                        + 0.25 * clamp(tmean * 5.0, 0.0, 1.0), 0.0, 1.0)
    score = 100.0 * (F(0.30) * punch + 0.25 * richness + 0.25 * clarity
                     + F(0.20) * width)
    score = clamp(score * (F(0.6) + F(0.4) * mono_safety), 0.0, 100.0)
    metrics = dict(score=score, emphasis=emphasis, coherence=coherence,
                   synesthesia=synesthesia, punch=punch, richness=richness,
                   clarity=clarity, width=width, mono_safety=mono_safety)
    ema_in = (onset_rate, clamp((F(1.8) - crest) * F(1.1), 0.0, 1.0),
              clamp(high_energy * 12.0, 0.0, 1.0))
    return metrics, ema_in


def final_metrics(params, fin, acc, fit, n, sr):
    """Every stage's metrics after the last block, from every block's lanes
    (fin [nb, 14, 5, K], acc [nb, 14, 10, K]) and cohere's context fit
    after the last block [K]."""
    mets, (rate, crest_p, harsh_p) = _stateless(fin, acc, n, sr)
    k = fin.shape[-1]
    rep, fat = np.zeros((7, k), np.float32), np.zeros((7, k), np.float32)
    for blk in range(fin.shape[0]):
        for half in (0, 1):                 # the pre passes, then the post
            rep = rep + (rate[blk, half::2] - rep) * F(0.08)
            density = clamp(rep / F(12.0), 0.0, 1.0)
            instant = clamp(F(0.35) * crest_p[blk, half::2]
                            + F(0.35) * harsh_p[blk, half::2]
                            + F(0.30) * density, 0.0, 1.0)
            fat = fat + (instant - fat) * F(0.06)
    risk = clamp(fat, 0.0, 1.0)
    out = []
    for i, name in enumerate(ORDER):
        pre = {key: v[-1, 2 * i] for key, v in mets.items()}
        post = {key: v[-1, 2 * i + 1] for key, v in mets.items()}
        post["repetition_density"], post["fatigue_risk"] = density[i], risk[i]
        m = dict(post, pre_score=pre["score"], post_score=post["score"])
        if name == "cohere":
            m["context_fit"] = fit
        if name == "infer":
            score = clamp(post["score"] * params[i]["sensitivity"], 0.0, 100.0)
            m.update(score=score, post_score=score,
                     punch=post["emphasis"], richness=post["coherence"],
                     clarity=post["synesthesia"], width=post["fatigue_risk"],
                     mono_safety=post["repetition_density"])
        out.append(m)
    return out


# ---------------------------------------------------------------- chain

def run_chain(config, clips, materials=None, precision="float32"):
    """`clips` [K, 2, T] float32 (T a multiple of the block size) through
    the configuration's chain; `materials` [K] a texture material per clip,
    else the configuration's. Returns (out [K, 2, T], [per-stage metrics]).
    `precision` "bfloat16" holds the audio and the state in bfloat16 (the
    control, bf16.py)."""
    sr, n = float(config["sample_rate"]), int(config["block_size"])
    params = stage_params(config)
    k, c, t = clips.shape
    if c != 2 or t % n:
        raise ValueError(f"clips {clips.shape}: stereo, whole blocks of {n}")
    nb = t // n
    mats = np.full(k, int(params[2]["material"]), np.int64) \
        if materials is None else np.asarray(materials, np.int64)
    states = {name: _INIT[name](k, c) for name in _INIT}
    states["width"] = S.width_init(k, c, sr)
    states["infer"] = {}
    if precision not in ("float32", "bfloat16"):
        raise ValueError(f"precision float32 or bfloat16, not {precision!r}")
    low = precision == "bfloat16"
    if low:
        clips = round_bf16(clips)
    states["texture"] = S.texture_init(k, c, sr)
    out = np.empty_like(clips)
    fins = np.empty((nb, 14, 5, k), np.float32)
    accs = np.empty((nb, 14, 10, k), np.float32)
    post_fin = np.zeros((7, 5, k), np.float32)
    for b in range(nb):
        x = clips[..., b * n:(b + 1) * n]
        sig = []
        for i, name in enumerate(ORDER):
            if name == "texture":
                y, states[name] = S.texture(params[i], states[name], x, sr,
                                            mats)
            else:
                y, states[name] = _RUN[name](params[i], states[name], x, sr)
            if low:
                y, states[name] = round_bf16(y), hold(states[name])
            sig.append((x, y))
            x = y
        out[..., b * n:(b + 1) * n] = x
        pre_fin, pre_acc = lanes(np.stack([s[0] for s in sig]), post_fin, sr)
        carried = pre_fin.copy()
        post_fin, post_acc = lanes(np.stack([s[1] for s in sig]), carried, sr)
        if low:
            pre_fin, pre_acc, post_fin, post_acc = (round_bf16(v) for v in (
                pre_fin, pre_acc, post_fin, post_acc))
        fins[b, 0::2], fins[b, 1::2] = pre_fin, post_fin
        accs[b, 0::2], accs[b, 1::2] = pre_acc, post_acc
    return out, final_metrics(params, fins, accs, states["cohere"]["fit"], n,
                              sr)
