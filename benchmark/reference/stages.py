"""The seven stages of the chain as plain NumPy: one block [K, C, N] of K
clips at a time, state carried in a dict of arrays.

Each stage is the published plugin's per-sample loop (the JUCE sources of
juicy-audio-plugins, ``src/plugins/*/PluginProcessor.cpp``) in float32 and
in that loop's operation order. Only the true recurrences run sample by
sample; every value that depends on them alone is worked out afterwards
over the whole block at once, which rounds the same way.
"""

from __future__ import annotations

import math

import numpy as np

from benchmark.reference.ops import (F, TWO_PI, clamp, cos32, db_to_gain,
                                     exp32, gain_to_db, jmap, jmap5,
                                     lcg_sequence, lcg_step,
                                     onepole_coeff, onepole_coeff_narrow,
                                     pow32, sin32, tanh32, tau_coeff)

if int(np.__version__.split(".")[0]) < 2:
    raise ImportError("the reference needs NumPy >= 2 (float32 arithmetic "
                      "with weak Python scalars, NEP 50)")


def _zeros(*shape):
    return np.zeros(shape, np.float32)


def _tm(a):
    """A time-major copy of [..., N]: [N, ...], each sample contiguous (of
    `a`'s array type)."""
    return np.moveaxis(a, -1, 0).copy(order="C")


def _serial(step, carry, *seqs):
    """carry = step(carry, *samples) along the last axis of every sequence
    in `seqs`; step returns (carry', value). Returns (carry, the values
    [..., N])."""
    cols = [_tm(q) for q in seqs]
    out = None
    for t in range(cols[0].shape[0]):
        carry, v = step(carry, *(col[t] for col in cols))
        if out is None:
            out = np.empty((cols[0].shape[0], *np.shape(v)), np.float32)
            if isinstance(v, np.ndarray):
                out = out.view(type(v))
        out[t] = v
    return carry, np.moveaxis(out, 0, -1)


def _serial_onepole(x, coeff, y):
    """y[t] = y[t-1] + coeff * (x[t] - y[t-1]) over the last axis; `coeff`
    a scalar or one per sample (x's shape)."""
    if np.shape(coeff)[-1:] == x.shape[-1:]:
        return _serial(lambda y, xt, ct: (y + ct * (xt - y),) * 2, y, x,
                       coeff)[1]
    coeff = np.asarray(coeff)[..., 0] if np.ndim(coeff) else coeff
    return _serial(lambda y, xt: (y + coeff * (xt - y),) * 2, y, x)[1]


def _shift_in(first, x):
    """[first, x[..., :-1]]: each sample's predecessor along the last axis."""
    return np.concatenate([first[..., None], x[..., :-1]], axis=-1)


# ---------------------------------------------------------------- punch

def punch_init(k, c):
    return {"fast": _zeros(k, c), "slow": _zeros(k, c)}


def punch(p, st, x, sr):
    fast_c, slow_c = tau_coeff(0.0015, sr), tau_coeff(0.110, sr)
    one_f = F(1.0 - float(fast_c))
    one_s = F(1.0 - float(slow_c))
    a = np.abs(x)
    one, cc = (np.array(v, np.float32)[:, None, None] for v in
               ((one_f, one_s), (fast_c, slow_c)))
    (fast, slow), (f_env, s_env) = _serial(
        lambda e, at: (one * at + cc * e,) * 2,
        np.stack([st["fast"], st["slow"]]), np.stack([a, a]))
    slam, clip = p["slam"], p["clip"]
    drive = 1.0 + clip * 8.0 + slam * 4.0
    curve = jmap(slam, 0.95, 0.55)
    punch_k = p["punch"] * 12.0 + slam * 22.0
    sustain_k = p["sustain"] * 4.0 + slam * F(1.5)
    transient = np.maximum(f_env - s_env, F(0.0))
    punch_gain = 1.0 + punch_k * pow32(transient, curve)
    sustain_gain = 1.0 + sustain_k * np.maximum(s_env - transient * F(0.6),
                                                F(0.0))
    wet = x * punch_gain * sustain_gain
    soft = tanh32(wet * drive) / tanh32(drive)
    hard = clamp(wet * (1.0 + clip * 2.0), -0.95, 0.95)
    wet = soft + clip * (hard - soft)
    out = (x + p["mix"] * (wet - x)) * db_to_gain(p["output"])
    return out, {"fast": fast, "slow": slow}


# ------------------------------------------------------------ saturator

def saturator_init(k, c):
    return {"tone": _zeros(k, c)}


def saturator(p, st, x, sr):
    driven = x * db_to_gain(p["drive"])
    soft = tanh32(driven + p["asymmetry"] * driven * driven)
    coeff = onepole_coeff(jmap(p["tone"], 2500.0, 16000.0), sr)
    toned = _serial_onepole(soft, coeff, st["tone"])
    wet = toned * db_to_gain(p["output"])
    return x + p["mix"] * (wet - x), {"tone": toned[..., -1]}


# -------------------------------------------------------------- texture

MATERIAL_INPUT_TRIM = (1.0, 0.58, 0.62, 0.60, 1.0)
MATERIAL_TRIM = (1.0, 0.62, 0.54, 0.62, 1.0)
_LOG_0001 = float(np.log(np.float32(0.001)))


def waveguide_size(sr):
    return max(2048, int(sr * 0.08))


def texture_init(k, c, sr):
    st = {name: _zeros(k, c) for name in (
        "env", "lp", "hp", "noise_hp", "tail", "wet_env", "dc_in", "dc_out",
        "pos", "vel", "pa", "va", "pb", "vb", "prev_wave")}
    st["pg"] = np.ones((k, c), np.float32)
    st["y1"] = _zeros(k, c, 4)
    st["y2"] = _zeros(k, c, 4)
    st["ring"] = _zeros(k, c, waveguide_size(sr))
    st["widx"] = np.zeros((k, c), np.int32)
    st["rng"] = np.full(k, 0x12345678, np.uint32)
    return st


def _theta_scale(sr):
    return F(F(2.0 * math.pi) / F(sr))


def _pole_radius(t, sr):
    return exp32(F(_LOG_0001) / (t * F(sr)))


def _modal(freqs, t60s, sr):
    f = clamp(freqs, 20.0, 0.45 * sr)
    r = _pole_radius(np.maximum(t60s, F(0.02)), sr)
    return (2.0 * r) * cos32(f * _theta_scale(sr)), -r * r


def _mode_sum(y):
    return ((y[..., 0] + y[..., 1]) + y[..., 2]) + y[..., 3]


def _f32s(values):
    return np.array(values, np.float32)


def _wave_consts(mode, q, L, sr):
    """Wood's (2) or plastic's (3) waveguide and modal constants."""
    tex, tail, damp_amt = q["texture"], q["tailshape"], q["damping_amt"]
    if mode == 2:
        cavity = 92.0 + 95.0 * (0.5 * q["weight"] + 0.5 * tex)
        delay = clamp(F(sr) / cavity, 16.0, float(L - 2))
        damp = jmap(tail, 0.26, 0.90) * jmap(damp_amt, 1.0, 0.72)
        t_scale = jmap(tail, 0.18, 0.62) * q["damping_mul"] \
            * jmap(damp_amt, 1.0, 0.64)
        freqs = _f32s([155.0, 355.0, 690.0, 1130.0])
        t60s = _f32s([0.40, 0.27, 0.16, 0.10]) * t_scale
        return dict(delay=delay, damp=damp, wg=(0.62, 0.38), exc=(0.10, 0.34),
                    exc_b=(0.09, 0.04), gains=_f32s([0.32, 0.18, 0.10, 0.06]),
                    out=(0.56, 0.24, 0.30, 0.74, 0.08),
                    ab=_modal(freqs, t60s, sr))
    tube = 210.0 + 340.0 * tex
    delay = clamp(F(sr) / tube, 8.0, float(L - 2))
    damp = jmap(tail, 0.22, 0.91) * jmap(damp_amt, 1.0, 0.82)
    t_scale = jmap(tail, 0.16, 0.72) * q["damping_mul"]
    freqs = _f32s([280.0, 690.0, 1320.0, 2360.0])
    t60s = _f32s([0.28, 0.18, 0.11, 0.07]) * t_scale
    return dict(delay=delay, damp=damp, wg=(0.76, 0.24), exc=(0.20, 0.60),
                exc_b=(0.14, 0.0), gains=_f32s([0.34, 0.22, 0.16, 0.11]),
                out=(0.52, 0.36, 0.40, 0.80, 0.10),
                ab=_modal(freqs, t60s, sr))


def _texture_q(p):
    """Texture's params as the material models read them."""
    damping_amt = clamp(p["damping"], 0.0, 1.0)
    return dict(texture=p["texture"], tailshape=p["tailshape"],
                damping_amt=damping_amt,
                damping_mul=jmap(damping_amt, 1.35, 0.40), weight=p["weight"])


def waveguide_delay(p, mode, sr):
    """The waveguide's delay in samples of wave material `mode` (wood 2,
    plastic 3) under texture's params `p`."""
    return _wave_consts(mode, _texture_q(p), waveguide_size(sr), sr)["delay"]


def _ring_taps(widx, delay, L):
    """The interpolated read behind each row's write index: (i0, i1, frac).
    Index arithmetic, in float32 whatever the audio's precision."""
    pos = np.asarray(widx).astype(np.float32) - np.float32(np.asarray(delay))
    pos = np.where(pos < F(0.0), pos + F(L), pos)
    i0 = pos.astype(np.int32)
    frac = pos - i0.astype(np.float32)
    i0 = np.where(i0 >= L, i0 - L, i0)
    i1 = np.where(i0 + 1 >= L, i0 + 1 - L, i0 + 1)
    return i0, i1, frac


def _material(mode, q, st, core, impact, body, trail, hp, sr):
    """The material model over the block: (shaped [K, C, N], state')."""
    tex = q["texture"]
    n = core.shape[-1]
    if mode == 0:                                        # gel
        omega = (TWO_PI * (42.0 + tex * 88.0)) / F(sr)
        k = omega * omega
        cdamp = 2.0 * jmap(trail, 0.62, 1.45) * omega
        force = core * (0.52 + 0.62 * body)
        def spring(c, f, cd):
            pos, vel = c
            vel = vel + (k * (f - pos) - cd * vel)
            return (pos + vel, vel), pos + vel

        (pos, vel), pos_seq = _serial(spring, (st["pos"], st["vel"]), force,
                                      cdamp)
        shaped = tanh32((0.48 * core + 1.85 * pos_seq) * (0.96 + 0.28 * tex))
        return shaped, dict(pos=pos, vel=vel)
    if mode == 1:                                        # metal
        f0 = 320.0 + 140.0 * tex
        t_scale = jmap(q["tailshape"], 0.18, 0.72) * q["damping_mul"] \
            * jmap(q["damping_amt"], 1.0, 0.55)
        freqs = f0 * _f32s([1.00, 2.31, 4.18, 6.87])
        r = _pole_radius(np.maximum(_f32s([0.56, 0.40, 0.26, 0.17]) * t_scale,
                                    F(0.02)), sr)
        two_r, a2 = 2.0 * r, -r * r
        gains = _f32s([0.34, 0.20, 0.13, 0.09])
        exc = core * (0.19 + 0.52 * impact)
        bend = 1.0 + 0.09 * impact
        f = clamp(freqs * bend[..., None], 20.0, 0.45 * sr)
        a1 = two_r * cos32(f * _theta_scale(sr))            # [K, C, N, 4]
        drive = np.moveaxis(exc[..., None] * gains, -1, 0)  # [4, K, C, N]
        a1 = np.moveaxis(a1, -1, 0)

        def bank(c, dr, a1t):
            y1, y2 = c
            y = dr + a1t * y1 + a2[:, None, None] * y2
            return (y, y1), _mode_sum(np.moveaxis(y, 0, -1))

        (y1, y2), modes = _serial(bank, (np.moveaxis(st["y1"], -1, 0),
                                         np.moveaxis(st["y2"], -1, 0)),
                                  drive, a1)
        y1, y2 = np.moveaxis(y1, 0, -1), np.moveaxis(y2, 0, -1)
        bright = 0.03 * impact * (core - hp)
        shaped = (0.44 * core + 0.42 * modes + bright) * (0.78 + 0.10 * tex)
        return shaped, dict(y1=y1, y2=y2)
    if mode in (2, 3):                                   # wood, plastic
        L = st["ring"].shape[-1]
        w = _wave_consts(mode, q, L, sr)
        a1, a2 = w["ab"]
        exc = core * (w["exc"][0] + w["exc"][1] * impact)
        inject = exc * (w["exc_b"][0] + w["exc_b"][1] * body)
        drive = np.moveaxis(exc[..., None] * w["gains"], -1, 0)
        ring = st["ring"].copy()
        rows = np.indices(st["widx"].shape)
        damp, (m0, m1) = w["damp"], w["wg"]
        a1c, a2c = a1[:, None, None], a2[:, None, None]

        def guide(c, inj, dr):
            widx, y1, y2, prev = c
            i0, i1, frac = _ring_taps(widx, w["delay"], L)
            v0 = ring[rows[0], rows[1], i0]
            delayed = v0 + frac * (ring[rows[0], rows[1], i1] - v0)
            ring[rows[0], rows[1], widx] = damp * (m0 * delayed + m1 * prev) \
                + inj
            widx = widx + 1
            widx = np.where(widx >= L, widx - L, widx)
            y = dr + a1c * y1 + a2c * y2
            return (widx, y, y1, delayed), np.stack(
                [delayed, _mode_sum(np.moveaxis(y, 0, -1))])

        (widx, y1, y2, prev), seq = _serial(
            guide, (st["widx"], np.moveaxis(st["y1"], -1, 0),
                    np.moveaxis(st["y2"], -1, 0), st["prev_wave"]),
            inject, drive)
        o0, o1, o2, o3, o4 = w["out"]
        shaped = (o0 * core + o1 * seq[0] + o2 * seq[1]) * (o3 + o4 * tex)
        return shaped, dict(ring=ring, widx=widx, y1=np.moveaxis(y1, 0, -1),
                            y2=np.moveaxis(y2, 0, -1), prev_wave=prev)
    # flesh
    w_a = (TWO_PI * (38.0 + 52.0 * tex)) / F(sr)
    w_b = (TWO_PI * (88.0 + 72.0 * tex)) / F(sr)
    k_a, k_b = w_a * w_a, w_b * w_b
    c_a = 2.0 * jmap(q["tailshape"], 0.56, 1.18) * w_a
    c_b = 2.0 * jmap(q["tailshape"], 0.70, 1.34) * w_b
    k_couple = 0.14 + 0.24 * tex
    force = core * (0.55 + 0.65 * body)

    def masses(c, f):
        pa, va, pb, vb = c
        acc_a = k_a * (f - pa) - c_a * va - k_couple * (pa - pb)
        acc_b = k_b * (pa - pb) - c_b * vb
        va = va + acc_a
        vb = vb + acc_b
        pa = pa + va
        pb = pb + vb
        return (pa, va, pb, vb), np.stack([pa, pb])

    (pa, va, pb, vb), seq = _serial(masses, (st["pa"], st["va"], st["pb"],
                                             st["vb"]), force)
    tissue = 0.92 * seq[0] + 0.58 * seq[1]
    nl = tissue - 0.19 * tissue * tissue * tissue
    shaped = tanh32((0.50 * core + 1.34 * nl) * (0.98 + 0.16 * tex))
    return shaped, dict(pa=pa, va=va, pb=pb, vb=vb)


def _ar_step(atk, rel):
    """An attack/release follower's step: env' = (1-c) x + c env with c the
    attack where x > env, else the release."""
    def step(env, xt):
        c = np.where(xt > env, atk, rel)
        env = c * env + (1.0 - c) * xt
        return env, env
    return step


def texture(p, st, x, sr, mats):
    """Texture with the material mats[k] for clip k (one material each)."""
    k, c, n = x.shape
    tail_shape, tex, mix = p["tailshape"], p["texture"], p["mix"]
    q = _texture_q(p)
    damping_amt = q["damping_amt"]
    decay = jmap(tail_shape, 0.30, 0.985) * jmap(damping_amt, 1.0, 0.80)
    env_atk, env_rel = tau_coeff(0.0025, sr), tau_coeff(0.080, sr)
    wet_atk, wet_rel = tau_coeff(0.005, sr), tau_coeff(0.090, sr)

    states = lcg_sequence(st["rng"], c * n).reshape(k, c, n)
    white = ((states >> 8) & 0xFFFF).astype(np.float32) \
        * F(1.0 / 32768.0) - F(1.0)

    driven = x * _f32s(MATERIAL_INPUT_TRIM)[mats][:, None, None]
    adry = np.abs(x)
    env, env_seq = _serial(_ar_step(env_atk, env_rel), st["env"], adry)
    impact = clamp(np.maximum(adry - env_seq, F(0.0)) * 10.0, 0.0, 1.0)
    body = clamp(env_seq * 3.2, 0.0, 1.0)
    trail = clamp(1.0 - impact, 0.0, 1.0) * tail_shape

    split = np.array([onepole_coeff(140.0, sr), onepole_coeff(2600.0, sr)]
                     )[:, None, None, None]
    lp, hp = _serial_onepole(np.stack([driven, driven]), split,
                             np.stack([st["lp"], st["hp"]]))
    high = driven - hp
    core = lp * (1.0 + p["weight"]) + (driven - lp - high) \
        + high * (0.9 + tex * 1.3)

    new = dict(st)
    shaped = np.empty_like(x)
    for mode in np.unique(mats):
        idx = np.nonzero(mats == mode)[0]
        sub = {key: v[idx] for key, v in st.items()}
        shaped[idx], mat = _material(int(mode), q, sub, core[idx],
                                     impact[idx], body[idx], trail[idx],
                                     hp[idx], sr)
        for key, v in mat.items():
            new[key] = new[key].copy() if new[key] is st[key] else new[key]
            new[key][idx] = v

    noise_hp = _serial_onepole(white, F(0.08), st["noise_hp"])
    shaped = shaped + (white - noise_hp) * (0.004 + 0.022 * tex) \
        * (0.14 + 0.64 * impact)
    shaped = shaped * (1.0 + impact * (0.18 + tex * 0.12) + body * 0.06) \
        * _f32s(MATERIAL_TRIM)[mats][:, None, None]

    tail_in = clamp(shaped, -2.0, 2.0) * (0.45 + 0.55 * trail)
    tail, tail_seq = _serial(lambda tl, ti: (ti + tl * decay,) * 2,
                             st["tail"], tail_in)
    wet = shaped + tail_seq * (0.30 + 0.45 * trail)

    wet_env, wenv_seq = _serial(_ar_step(wet_atk, wet_rel), st["wet_env"],
                                np.abs(wet))
    auto = jmap(tex, 0.78, 0.54) / (1.0 + 1.8 * wenv_seq)
    wet = wet * clamp(auto, 0.18, 1.0)

    pre_dc = (x + mix * (wet - x)) * db_to_gain(p["output"])
    dc_out, dc_seq = _serial(lambda d, s: (s + F(0.995) * d,) * 2,
                             st["dc_out"],
                             pre_dc - _shift_in(st["dc_in"], pre_dc))

    peak = np.abs(dc_seq)
    with np.errstate(divide="ignore"):
        cap = (F(0.88) / peak) * 0.98
    pg, pg_seq = _serial(
        lambda g, pk, cp: (np.where(pk > F(0.88), np.minimum(g, cp),
                                    g + (1.0 - g) * F(0.0028)),) * 2,
        st["pg"], peak, cap)
    out = clamp(dc_seq * clamp(pg_seq, 0.2, 1.0), -0.98, 0.98)

    new.update(env=env, lp=lp[..., -1], hp=hp[..., -1],
               noise_hp=noise_hp[..., -1], tail=tail, wet_env=wet_env,
               dc_in=pre_dc[..., -1], dc_out=dc_out, pg=pg,
               rng=states[:, -1, -1])
    return out, new


# --------------------------------------------------------------- motion

MOTION_MONO = ("env", "repetition", "budget_env", "vt", "vtr", "vtl",
               "vt_t", "vtr_t", "vtl_t", "phase")


def motion_init(k, c):
    st = {name: _zeros(k) for name in MOTION_MONO}
    st["cooldown"] = np.zeros(k, np.int32)
    st["rng"] = np.full(k, 0x93AB12F0, np.uint32)
    st.update({name: _zeros(k, c) for name in ("lp", "tail", "prev")})
    return st


def _draw(r, shift):
    return ((r >> shift) & 0x7FFF).astype(np.float32) * F(1.0 / 16384.0) \
        - F(1.0)


def motion(p, st, x, sr):
    k, c, n = x.shape
    mv = p["microvar"]
    env_c = tau_coeff(0.015, sr)
    one_env = F(F(1.0) - env_c)
    cd = np.int32(int(sr * 0.04))

    # pass 1 (mono): the detector envelope, the onsets and their draws
    a = np.abs(0.5 * (x[:, 0] + x[:, min(1, c - 1)]))
    env, cooldown, rep = st["env"], st["cooldown"], st["repetition"]
    rng, vt_t, vtr_t, vtl_t = st["rng"], st["vt_t"], st["vtr_t"], st["vtl_t"]
    for t in range(n):
        env = env_c * env + one_env * a[:, t]
        cooldown = np.maximum(cooldown - 1, 0).astype(np.int32)
        onset = (a[:, t] > env * F(1.35) + F(0.02)) & (cooldown <= 0)
        if onset.any():
            cooldown = np.where(onset, cd, cooldown).astype(np.int32)
            rep = np.where(onset, rep + 1.0, rep)
            r1 = lcg_step(rng)
            r2 = lcg_step(r1)
            r3 = lcg_step(r2)
            vt_t = np.where(onset, _draw(r1, 7) * mv * F(0.9), vt_t)
            vtr_t = np.where(onset, _draw(r2, 9) * mv * F(0.8), vtr_t)
            vtl_t = np.where(onset, _draw(r3, 11) * mv * F(0.8), vtl_t)
            rng = np.where(onset, r3, rng).astype(np.uint32)
        rep = rep * F(0.997)
    rc = p["repeatctrl"]
    rep_norm = clamp(rep * F(0.08), 0.0, 1.0)
    rep_scale = 1.0 - rc * rep_norm * F(0.65)
    recovery = 1.0 + rc * (1.0 - rep_norm) * 0.25

    # pass 2, channel 0 then 1, the slews, phase and budget shared
    depth = clamp(p["motiondepth"], 0.0, 2.0)
    rate = jmap(mv, 0.25, 2.0) * jmap5(depth, 0.0, 2.0, 0.75, 1.6)
    slew = tau_coeff(0.020, sr)
    one_slew = F(F(1.0) - slew)
    inc = (TWO_PI * rate) / F(sr)
    lfo_depth = (250.0 + 550.0 * mv) * (0.5 + F(0.9) * depth)
    fb0 = jmap(p["repeatctrl"], 0.15, 0.88)
    bc = tau_coeff(0.080, sr)
    one_bc = F(F(1.0) - bc)
    target = jmap(p["budget"], 0.8, 0.25)
    cut_depth = F(0.6) + F(0.6) * depth
    boost_depth = F(0.6) + F(0.7) * depth
    lfo_mv = F(0.35) * mv
    lfo_depth2 = F(0.6) + F(0.8) * depth
    tone_depth = F(0.55) + F(0.7) * depth
    trans_mv = F(0.12) + F(0.30) * mv
    trans_depth = 0.5 + F(0.8) * depth
    tail_mix = (F(0.26) + F(0.24) * mv) * (F(0.6) + F(0.7) * depth)
    wet_boost = 1.0 + F(0.9) * mv * (F(0.55) + F(0.9) * depth)
    gain = db_to_gain(p["output"])
    four_pi = F(4.0 * 3.14159265358979323846)

    def slews(cr):
        vt, vtr, vtl, phase = cr
        vt = slew * vt + one_slew * vt_t
        vtr = slew * vtr + one_slew * vtr_t
        vtl = slew * vtl + one_slew * vtl_t
        phase = phase + inc
        phase = np.where(phase > TWO_PI, phase - four_pi, phase)
        return (vt, vtr, vtl, phase), np.stack([vt, vtr, vtl, phase])

    shared = (st["vt"], st["vtr"], st["vtl"], st["phase"])
    be = st["budget_env"]
    out = np.empty_like(x)
    lp_f, tail_f = np.empty((k, c), np.float32), np.empty((k, c), np.float32)
    clock = np.zeros((k, n), np.float32)      # the slews' steps take no input
    for ch in range(c):
        d = x[:, ch]
        shared, (vt_s, vtr_s, vtl_s, ph_s) = _serial(
            lambda cr, _t: slews(cr), shared, clock)
        lfo = sin32(ph_s + F(0.0 if ch == 0 else 0.85))
        cutoff = clamp(900.0 + vt_s * 1100.0 * cut_depth + lfo * lfo_depth,
                       120.0, 4200.0)
        lp_seq = _serial_onepole(d, onepole_coeff_narrow(cutoff, sr),
                                 st["lp"][:, ch])
        transient = d - _shift_in(st["prev"][:, ch], d)
        boost = 1.0 + vtr_s * F(1.2) * boost_depth + lfo_mv * lfo * lfo_depth2
        tone = lp_seq * (1.0 + vt_s * F(0.65) * tone_depth) \
            + (d - lp_seq) * boost + transient * trans_mv * trans_depth
        fb = clamp(fb0 + vtl_s * F(0.06), 0.0, 0.93)
        tail, tail_seq = _serial(lambda tl, tn, f: (tn + tl * f,) * 2,
                                 st["tail"][:, ch], tone, fb)
        wet = tone * rep_scale[:, None] * recovery[:, None] \
            + tail_mix * tail_seq
        be, be_seq = _serial(lambda e, wa: (bc * e + one_bc * wa,) * 2, be,
                             np.abs(wet))
        limit = np.where(be_seq > target, target / (be_seq + F(1.0e-5)),
                         F(1.0))
        wet = wet * limit
        out[:, ch] = (d + p["mix"] * (wet * wet_boost - d)) * gain
        lp_f[:, ch], tail_f[:, ch] = lp_seq[:, -1], tail
    vt, vtr, vtl, phase = shared
    new = dict(env=env, repetition=rep, budget_env=be, vt=vt, vtr=vtr,
               vtl=vtl, vt_t=vt_t, vtr_t=vtr_t, vtl_t=vtl_t, phase=phase,
               cooldown=cooldown, rng=rng, lp=lp_f, tail=tail_f,
               prev=x[..., -1].copy())
    return out, new


# ---------------------------------------------------------------- width

def haas_window(sr):
    d = int(sr * 0.035) + 16
    return max(8, (d + 7) // 8 * 8)


def haas_delay(p, sr):
    """Width's Haas delay in whole samples."""
    return int((F(sr) * (p["haasMs"] * F(0.001))).astype(np.int32))


def width_init(k, c, sr):
    return {"window": _zeros(k, haas_window(sr))}


def width(p, st, x, sr):
    left, right = x[:, 0], x[:, 1]
    n = x.shape[-1]
    dips = clamp(left * right * 12.0, -1.0, 1.0) < F(-0.1)
    limit = jmap(p["monoSafe"], 1.0, 0.35)
    w0 = np.broadcast_to(p["width"], left.shape[:1]).astype(np.float32)
    _w, w_seq = _serial(lambda w, dip: (np.where(dip, w * limit, w),) * 2,
                        w0, dips)
    mid, side = 0.5 * (left + right), 0.5 * (left - right)
    spread = side * (1.0 + w_seq)
    wet_l, wet_r_pre = mid + spread, mid - spread
    delay = haas_delay(p, sr)
    window = st["window"]
    d_len = window.shape[-1]
    ext = np.concatenate([window, wet_r_pre], axis=-1)
    wet_r = ext[:, d_len - delay:d_len - delay + n]
    mix, gain = p["mix"], db_to_gain(p["output"])
    out = np.stack([(left + mix * (wet_l - left)) * gain,
                    (right + mix * (wet_r - right)) * gain], axis=1)
    return out, {"window": ext[:, ext.shape[-1] - d_len:].copy()}


# --------------------------------------------------------------- cohere

def cohere_init(k, c):
    return {"t_low": np.full(k, F(0.2)), "t_mid": np.full(k, F(0.2)),
            "t_high": np.full(k, F(0.2)), "a_low": _zeros(k),
            "a_high": _zeros(k), "tail": _zeros(k, c), "fit": _zeros(k)}


def cohere(p, st, x, sr):
    k, c, n = x.shape
    low_c, high_c = onepole_coeff(220.0, sr), onepole_coeff(2400.0, sr)
    mono = 0.5 * (x[:, 0] + x[:, min(1, c - 1)])
    lo = _serial_onepole(mono, low_c, st["a_low"])
    hi = _serial_onepole(mono, high_c, st["a_high"])
    high_v = mono - hi
    mid_v = mono - lo - high_v
    inv_n = F(1.0 / max(1, n))
    low_e = np.add.accumulate(lo * lo, axis=-1)[:, -1] * inv_n
    mid_e = np.add.accumulate(mid_v * mid_v, axis=-1)[:, -1] * inv_n
    high_e = np.add.accumulate(high_v * high_v, axis=-1)[:, -1] * inv_n

    learn = p["learn"] > F(0.5)
    eps = F(1.0e-6)

    def ema(t, e):
        return np.where(learn, t + (e - t) * F(0.02), t)

    t_low, t_mid, t_high = (ema(st["t_low"], low_e), ema(st["t_mid"], mid_e),
                            ema(st["t_high"], high_e))

    def err(e, t):
        return np.abs(gain_to_db((e + eps) / (t + eps)))

    deviation = (err(low_e, t_low) + err(mid_e, t_mid)
                 + err(high_e, t_high)) / F(3.0)
    fit = clamp(100.0 - deviation * 10.0, 0.0, 100.0)
    expo = 0.25 * p["match"]

    def comp(t, e):
        return clamp(pow32((t + eps) / (e + eps), expo), 0.5, 1.8)

    g_low, g_mid, g_high = (comp(t_low, low_e)[:, None],
                            comp(t_mid, mid_e)[:, None],
                            comp(t_high, high_e)[:, None])
    fb = clamp(p["decay"], 0.0, 0.93)
    tail_k = p["tail"] * F(0.35)
    zero = _zeros(k, c)
    lp_a = _serial_onepole(x, low_c, zero)
    lp_b = _serial_onepole(x, high_c, zero)
    matched = lp_a * g_low[..., None] \
        + (x - lp_a - (x - lp_b)) * g_mid[..., None] \
        + (x - lp_b) * g_high[..., None]
    tail, tail_seq = _serial(lambda tl, m: (m + tl * fb,) * 2, st["tail"],
                             matched)
    wet = matched + tail_k * tail_seq
    out = (x + p["mix"] * (wet - x)) * db_to_gain(p["output"])
    return out, {"t_low": t_low, "t_mid": t_mid, "t_high": t_high,
                 "a_low": lo[:, -1], "a_high": hi[:, -1], "tail": tail,
                 "fit": fit}


# ---------------------------------------------------------------- infer

def infer(p, st, x, sr):
    return x * db_to_gain(p["trim"]), st
