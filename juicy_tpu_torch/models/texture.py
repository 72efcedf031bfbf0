"""JuicyTexture, the material resonator: PyTorch port of
juicy_tpu/models/texture.py.

Per channel, per sample (reference PluginProcessor.cpp:114-277): band split
140/2600 Hz → impact/body/trail envelopes → one of five material models
(0 gel mass-spring, 1 metal inharmonic modal bank, 2 wood waveguide cavity +
modes, 3 plastic tube + modes, 4 flesh coupled masses) → LCG roughness noise
→ dynamics → tail integrator → wet auto-gain → DC blocker → peak limiter →
clamp ±0.98.

One u32 LCG (seed 0x12345678) is shared across channels and advanced inside
the channel loop, so in stereo channel 0 takes draws 1..N of the block and
channel 1 draws N+1..2N (cpp:239); :func:`block_noise` makes them in
parallel, bit-exact (ops/noise.py).

:func:`process` runs the C++ inner loop serially over the block on
[..., C] tensors, in the C++ op order, which is also the op order of the
CUDA stage kernel (csrc/texture.cuh). Constants that come from params stay
float32 tensors (0-dim, or [..., 1] for per-clip values against the
[..., C] lanes) so that every operation rounds in float32.
``material`` is static (``Plugin.with_static(material=m)``) or one value per
clip (``Plugin.with_traced("material")``): :func:`process_traced` runs each
clip's own material, bit-equal to that material's static path.
"""

from __future__ import annotations

import numpy as np
import torch

from juicy_tpu_torch.models import base
from juicy_tpu_torch.ops.noise import lcg_advance, lcg_sequence, white_from_bits
from juicy_tpu_torch.ops.precise import (F32, as_f32, cos32, div_const, exp32,
                                         f32, rdiv_const, tanh32)
from juicy_tpu_torch.runtime.device import resolve_device
from juicy_tpu_torch.utils.convert import (db_to_gain, jlimit, jmap,
                                           onepole_coeff, tau_coeff)

PARAMS = (
    base.ParamSpec("material", "Material", 0.0, 4.0, 0.0,
                   choices=("Gel", "Metal", "Wood", "Plastic", "Flesh-like")),
    base.ParamSpec("tailshape", "Tail Shape", 0.0, 1.0, 0.55),
    base.ParamSpec("damping", "Damping", 0.0, 1.0, 0.5),
    base.ParamSpec("weight", "Low-end Weight", 0.0, 1.0, 0.45),
    base.ParamSpec("texture", "Texture Layer", 0.0, 1.0, 0.5),
    base.mix_param(1.0),
    base.output_param(-18.0, 18.0, -2.0),
    base.juiciness_param(),
)

PRESETS = ()  # single program (PluginProcessor.h:28-32)

RNG_SEED = 0x12345678  # PluginProcessor.h:81

PI = 3.14159265358979323846
MATERIAL_INPUT_TRIM = (1.0, 0.58, 0.62, 0.60, 1.0)   # cpp:117
MATERIAL_TRIM = (1.0, 0.62, 0.54, 0.62, 1.0)          # cpp:167,190,211
#: materials whose model reads the waveguide ring
WAVE_MODES = (2, 3)
NMODES = 4
_TWO_PI = f32(2.0 * PI)
_LOG_0001 = float(np.log(np.float32(0.001)))


def waveguide_size(sr: float) -> int:
    """max(2048, sr·0.08) samples (cpp:18)."""
    return max(2048, int(sr * 0.08))


def init(sr: float, channels: int, batch_shape=(), device=None):
    """Fresh state, leaves [*batch_shape, C] (modal banks [..., C, 4], the
    ring [..., C, L]), ``rng`` one u32 carrier per clip; `device` None is
    the card."""
    dev = resolve_device(device)
    shape = (*batch_shape, channels)

    def zeros(*extra):
        return torch.zeros((*shape, *extra), dtype=F32, device=dev)

    st = {k: zeros() for k in (
        "tail", "lp", "hp", "env", "wet_env", "noise_hp", "dc_in", "dc_out",
        "spring_pos", "spring_vel", "flesh_pos_a", "flesh_vel_a",
        "flesh_pos_b", "flesh_vel_b", "prev_wave")}
    st["protect_gain"] = torch.ones(shape, dtype=F32, device=dev)
    st["modal_y1"] = zeros(NMODES)
    st["modal_y2"] = zeros(NMODES)
    st["waveguide"] = zeros(waveguide_size(sr))
    st["wave_idx"] = torch.zeros(shape, dtype=torch.int32, device=dev)
    st["rng"] = torch.full(batch_shape, RNG_SEED, dtype=torch.int64,
                           device=dev)
    return st


def theta_scale(sr) -> float:
    """2π/sr as one f32 constant, rounded once. The modal angle is
    ``f * theta_scale(sr)`` on every path (the JAX package's reason: one
    ulp of theta between two paths costs ~−90 dBFS on metal)."""
    return float(np.float32(np.float32(2.0 * PI) / np.float32(sr)))


def _f32s(values):
    return torch.tensor(values, dtype=F32)


def _modes(values, scale):
    """The four modes' `values` times `scale` (0-dim, or per clip [..., 1]
    -> [..., 1, 4] against the modal state [..., C, 4])."""
    return _f32s(values) * torch.as_tensor(scale)[..., None]


def _per_clip(v):
    """A param as float32: 0-dim as it is, per-clip [...] as [..., 1] so
    that it broadcasts against the [..., C] sample lanes."""
    v = as_f32(v)
    return v[..., None] if v.ndim else v


def _modal_coeffs(freq_hz, t60, sr):
    """2-pole modal resonator coefficients (cpp:77-89) through the pinned
    exp32/cos32: (a1, a2)."""
    f = jlimit(20.0, 0.45 * sr, freq_hz)
    t = torch.clamp(as_f32(t60), min=f32(0.02))
    r = _pole_radius(t, sr)
    theta = f * theta_scale(sr)
    a1 = 2.0 * r * cos32(theta)
    a2 = -r * r
    return a1, a2


def _pole_radius(t, sr):
    """exp(log(0.001) / (t·sr)), the pole radius of a t-second T60."""
    return exp32(rdiv_const(_LOG_0001, t * f32(sr)))


def _serial_mode_sum(y):
    """m0+m1+m2+m3 in the C++'s serial add order (the waveguide feedback
    amplifies any reassociation)."""
    return ((y[..., 0] + y[..., 1]) + y[..., 2]) + y[..., 3]


def material_consts(mode: int, p, sr: float, L: int):
    """Numeric constants of the material models (cpp:135-237), shared by
    :func:`_material_substep` and the stage kernel's constants
    (kernels/stage_kernels.py::tex_param_list)."""
    texture = p["texture"]
    tail_shape = p["tailshape"]
    damping_amt = p["damping_amt"]
    damping_mul = p["damping_mul"]
    weight = p["weight"]

    if mode == 0:   # Gel (cpp:137-151)
        f0 = 42.0 + texture * 88.0
        omega = div_const(_TWO_PI * f0, sr)
        return dict(omega=omega, k=omega * omega)

    if mode == 1:   # Metal (cpp:152-169)
        f0 = 320.0 + 140.0 * texture
        metal_damp = jmap(damping_amt, 1.0, 0.55)
        t_scale = jmap(tail_shape, 0.18, 0.72) * damping_mul * metal_damp
        return dict(
            f0=f0, ratios=_f32s([1.00, 2.31, 4.18, 6.87]),
            t60s=_modes([0.56, 0.40, 0.26, 0.17], t_scale),
            gains=_f32s([0.34, 0.20, 0.13, 0.09]))

    if mode in WAVE_MODES:   # Wood (cpp:170-192) / Plastic (cpp:193-212)
        if mode == 2:
            cavity_hz = 92.0 + 95.0 * (0.5 * weight + 0.5 * texture)
            delay_samp = jlimit(16.0, float(L - 2), rdiv_const(sr, cavity_hz))
            damp = jmap(tail_shape, 0.26, 0.90) * jmap(damping_amt, 1.0, 0.72)
            wg_mix = (0.62, 0.38)
            exc_scale = (0.10, 0.34)
            body_damp = jmap(damping_amt, 1.0, 0.64)
            t_scale = jmap(tail_shape, 0.18, 0.62) * damping_mul * body_damp
            freqs = _f32s([155.0, 355.0, 690.0, 1130.0])
            t60s = _modes([0.40, 0.27, 0.16, 0.10], t_scale)
            gains = _f32s([0.32, 0.18, 0.10, 0.06])
            out_mix = (0.56, 0.24, 0.30, 0.74, 0.08)
            # the injection exc * (b0 + b1 * body) (cpp:180)
            exc_b = (0.09, 0.04)
        else:
            tube_hz = 210.0 + 340.0 * texture
            delay_samp = jlimit(8.0, float(L - 2), rdiv_const(sr, tube_hz))
            damp = jmap(tail_shape, 0.22, 0.91) * jmap(damping_amt, 1.0, 0.82)
            wg_mix = (0.76, 0.24)
            exc_scale = (0.20, 0.60)
            t_scale = jmap(tail_shape, 0.16, 0.72) * damping_mul
            freqs = _f32s([280.0, 690.0, 1320.0, 2360.0])
            t60s = _modes([0.28, 0.18, 0.11, 0.07], t_scale)
            gains = _f32s([0.34, 0.22, 0.16, 0.11])
            out_mix = (0.52, 0.36, 0.40, 0.80, 0.10)
            # plastic injects 0.14 * exc (cpp:196); as exc * (0.14 + 0 *
            # body) it is the same float (body >= 0, so 0 * body = +0) and
            # shares wood's form, as the kernel does
            exc_b = (0.14, 0.0)
        a1, a2 = _modal_coeffs(freqs, t60s, sr)
        return dict(delay_samp=delay_samp, damp=damp, wg_mix=wg_mix,
                    exc_scale=exc_scale, exc_b=exc_b, freqs=freqs, t60s=t60s,
                    gains=gains, out_mix=out_mix, a1=a1, a2=a2)

    # mode 4: Flesh-like (cpp:214-236)
    w_a = div_const(_TWO_PI * (38.0 + 52.0 * texture), sr)
    w_b = div_const(_TWO_PI * (88.0 + 72.0 * texture), sr)
    return dict(
        w_a=w_a, w_b=w_b, k_a=w_a * w_a, k_b=w_b * w_b,
        c_a=2.0 * jmap(tail_shape, 0.56, 1.18) * w_a,
        c_b=2.0 * jmap(tail_shape, 0.70, 1.34) * w_b,
        k_couple=0.14 + 0.24 * texture)


def ring_tap(widx: torch.Tensor, delay, L: int):
    """The interpolated circular read behind write index `widx` (cpp:91-105),
    in the JAX scan path's exact float math: (i0, i1, frac).

    One guard the reference lacks: when ``f32(widx) − delay`` lies within
    half an ulp of L below 0, ``pos + L`` rounds to L and i0 would read one
    past the ring (JAX's gather would return NaN there); i0 wraps to 0."""
    pos = widx.to(F32) - delay
    pos = torch.where(pos < 0.0, pos + float(L), pos)
    i0 = pos.to(torch.int32)
    frac = pos - i0.to(F32)
    i0 = torch.where(i0 >= L, i0 - L, i0)
    i1 = torch.where(i0 + 1 >= L, i0 + 1 - L, i0 + 1)
    return i0, i1, frac


class StateRing:
    """The waveguide in the state's form: ``wg`` [..., C, L] with one write
    index per row, ``widx`` [..., C] int32. Works on copies of both."""

    def __init__(self, wg: torch.Tensor, widx: torch.Tensor):
        self.wg = wg.clone()
        self.widx = widx.clone()
        self.L = wg.shape[-1]

    def read(self, delay):
        i0, i1, frac = ring_tap(self.widx, delay, self.L)
        v0 = torch.gather(self.wg, -1, i0.long()[..., None])[..., 0]
        v1 = torch.gather(self.wg, -1, i1.long()[..., None])[..., 0]
        return v0 + frac * (v1 - v0)

    def write(self, value: torch.Tensor, mask=None):
        """Write `value` at each row's index and advance it; with `mask`
        only the rows where it holds (the others keep their value and
        index)."""
        idx = self.widx.long()[..., None]
        if mask is not None:
            value = torch.where(mask, value, torch.gather(self.wg, -1, idx)[..., 0])
        self.wg.scatter_(-1, idx, value[..., None])
        self.widx = advance_index(self.widx, self.L, mask)


def advance_index(widx, L: int, mask=None):
    """A ring write index one step on, wrapped at L; with `mask` only where
    it holds."""
    nxt = widx + 1
    nxt = torch.where(nxt >= L, nxt - L, nxt)
    return nxt if mask is None else torch.where(mask, nxt, widx)


def _on(tree, device):
    """Tensors of a dict of constants moved to `device`."""
    return {k: v.to(device) if isinstance(v, torch.Tensor) else v
            for k, v in tree.items()}


def metal_poles(mc, sr):
    """Metal's mode frequencies f0·ratios and pole radii (constant per
    block: only the angle bends per sample)."""
    return (torch.as_tensor(mc["f0"])[..., None] * mc["ratios"],
            _pole_radius(torch.clamp(mc["t60s"], min=f32(0.02)), sr))


def _material_substep(mode: int, p, sr: float, L: int, device,
                      ring=StateRing):
    """Per-sample material update for static `mode` (cpp:135-237).

    Returns (extract, step, pack): extract(carry_dict) -> material state
    tuple; step(mat, core, impact, body, trail, hp_state) -> (shaped, mat');
    pack(mat) -> the state dict entries. The wave materials' state holds a
    ring object (:class:`StateRing` here, the kernel-form ring in the stage
    step's plain version, made by `ring(wg, widx)`) with ``read(delay)``
    and ``write(value)``. The constants are worked out on the CPU and used
    on `device`."""
    texture = p["texture"].to(device)
    mc = material_consts(mode, p, sr, L)
    if mode == 1:
        freqs, r = metal_poles(mc, sr)
        mc.update(freqs=freqs, two_r=2.0 * r, a2=-r * r)
    mc = _on(mc, device)

    if mode == 0:   # Gel (cpp:137-151)
        omega, k = mc["omega"], mc["k"]

        def step(mat, core, impact, body, trail, hp_state):
            pos, vel = mat
            zeta = jmap(trail, 0.62, 1.45)
            cdamp = 2.0 * zeta * omega
            force = core * (0.52 + 0.62 * body)
            acc = k * (force - pos) - cdamp * vel
            vel = vel + acc
            pos = pos + vel
            shaped = 0.48 * core + 1.85 * pos
            shaped = tanh32(shaped * (0.96 + 0.28 * texture))
            return shaped, (pos, vel)

        return (lambda c: (c["spring_pos"], c["spring_vel"]), step,
                lambda m: {"spring_pos": m[0], "spring_vel": m[1]})

    if mode == 1:   # Metal (cpp:152-169): only theta varies per sample
        freqs, two_r, a2, gains = mc["freqs"], mc["two_r"], mc["a2"], mc["gains"]
        th_scale = theta_scale(sr)

        def step(mat, core, impact, body, trail, hp_state):
            y1, y2 = mat
            exc = core * (0.19 + 0.52 * impact)
            bend = 1.0 + 0.09 * impact
            f = jlimit(20.0, 0.45 * sr, freqs * bend[..., None])
            a1 = two_r * cos32(f * th_scale)
            y = exc[..., None] * gains + a1 * y1 + a2 * y2
            modes = _serial_mode_sum(y)
            bright = 0.03 * impact * (core - hp_state)
            shaped = (0.44 * core + 0.42 * modes + bright) \
                * (0.78 + 0.10 * texture)
            return shaped, (y, y1)

        return (lambda c: (c["modal_y1"], c["modal_y2"]), step,
                lambda m: {"modal_y1": m[0], "modal_y2": m[1]})

    if mode in WAVE_MODES:   # Wood (cpp:170-192) / Plastic (cpp:193-212)
        step = _wave_step(mc, texture)

        def extract(c):
            return (c["modal_y1"], c["modal_y2"],
                    ring(c["waveguide"], c["wave_idx"]), c["prev_wave"])

        return (extract, step,
                lambda m: {"modal_y1": m[0], "modal_y2": m[1],
                           "waveguide": m[2].wg, "wave_idx": m[2].widx,
                           "prev_wave": m[3]})

    # mode 4: Flesh-like (cpp:214-236)
    k_a, k_b, c_a, c_b = mc["k_a"], mc["k_b"], mc["c_a"], mc["c_b"]
    k_couple = mc["k_couple"]

    def step(mat, core, impact, body, trail, hp_state):
        pa, va, pb, vb = mat
        force = core * (0.55 + 0.65 * body)
        acc_a = k_a * (force - pa) - c_a * va - k_couple * (pa - pb)
        acc_b = k_b * (pa - pb) - c_b * vb
        va = va + acc_a
        vb = vb + acc_b
        pa = pa + va
        pb = pb + vb
        tissue = 0.92 * pa + 0.58 * pb
        nl = tissue - 0.19 * tissue * tissue * tissue
        shaped = tanh32((0.50 * core + 1.34 * nl) * (0.98 + 0.16 * texture))
        return shaped, (pa, va, pb, vb)

    return (lambda c: (c["flesh_pos_a"], c["flesh_vel_a"],
                       c["flesh_pos_b"], c["flesh_vel_b"]), step,
            lambda m: {"flesh_pos_a": m[0], "flesh_vel_a": m[1],
                       "flesh_pos_b": m[2], "flesh_vel_b": m[3]})


def _wave_step(mc, texture, mask=None):
    """Wood's or plastic's per-sample step (cpp:170-212) from its constants
    `mc` (material_consts; per clip when the traced path picks wood's or
    plastic's constants clip by clip). With `mask` only those rows write
    the ring and move its index."""
    delay, damp = mc["delay_samp"], mc["damp"]
    (wg_m0, wg_m1), (exc_s0, exc_s1) = mc["wg_mix"], mc["exc_scale"]
    exc_b0, exc_b1 = mc["exc_b"]
    gains, a1, a2 = mc["gains"], mc["a1"], mc["a2"]
    om0, om1, om2, om3, om4 = mc["out_mix"]

    def step(mat, core, impact, body, trail, hp_state):
        y1, y2, ring, prev_wave = mat
        exc = core * (exc_s0 + exc_s1 * impact)
        delayed = ring.read(delay)
        new_wave = damp * (wg_m0 * delayed + wg_m1 * prev_wave) \
            + exc * (exc_b0 + exc_b1 * body)
        if mask is None:
            ring.write(new_wave)
        else:
            ring.write(new_wave, mask)
        y = exc[..., None] * gains + a1 * y1 + a2 * y2
        modes = _serial_mode_sum(y)
        shaped = (om0 * core + om1 * delayed + om2 * modes) \
            * (om3 + om4 * texture)
        return shaped, (y, y1, ring, delayed)

    return step


def make_sample_step(consts, mat_step):
    """The complete C++ inner loop (cpp:107-277) as one per-sample body,
    ``step(c, d, w) -> (c', y)``: `c` = (env, lp, hp, noise_hp, tail,
    wet_env, dc_in, dc_out, pg, mat), `d` the dry sample and `w` the white
    draw, each [..., C]. Shared by :func:`process` and the stage kernel's
    plain version, in the op order of csrc/texture.cuh."""
    k = consts
    texture, tail_shape = k["texture"], k["tail_shape"]
    hi_gain = 0.9 + texture * 1.3
    rough_gain = 0.004 + 0.022 * texture
    dyn_gain = 0.18 + texture * 0.12

    def step(c, d, w):
        env, lp, hp, noise_hp, tail, wet_env, dc_in, dc_out, pg, mat = c

        driven = d * k["in_trim"]
        adry = torch.abs(d)
        env_c = torch.where(adry > env, k["env_atk"], k["env_rel"])
        env = env_c * env + (1.0 - env_c) * adry
        impact = jlimit(0.0, 1.0, torch.clamp(adry - env, min=0.0) * 10.0)
        body = jlimit(0.0, 1.0, env * 3.2)
        trail = jlimit(0.0, 1.0, 1.0 - impact) * tail_shape

        lp = lp + k["split_low"] * (driven - lp)
        hp = hp + k["split_high"] * (driven - hp)
        low = lp * k["low_boost"]
        high = driven - hp
        mid = driven - lp - high
        core = low + mid + high * hi_gain

        shaped, mat = mat_step(mat, core, impact, body, trail, hp)

        # roughness noise (cpp:239-243)
        noise_hp = noise_hp + 0.08 * (w - noise_hp)
        rough = w - noise_hp
        shaped = shaped + rough * rough_gain * (0.14 + 0.64 * impact)

        dynamics = 1.0 + impact * dyn_gain + body * 0.06
        shaped = shaped * dynamics * k["mat_trim"]

        # tail integrator (cpp:248-250)
        tail_input = jlimit(-2.0, 2.0, shaped) * (0.45 + 0.55 * trail)
        tail = tail_input + tail * k["decay"]
        wet = shaped + tail * (0.30 + 0.45 * trail)

        # wet auto-gain (cpp:252-257)
        wet_abs = torch.abs(wet)
        wet_c = torch.where(wet_abs > wet_env, k["wet_atk"], k["wet_rel"])
        wet_env = wet_c * wet_env + (1.0 - wet_c) * wet_abs
        auto_comp = torch.div(k["auto_gain_base"], 1.0 + 1.8 * wet_env)
        wet = wet * jlimit(0.18, 1.0, auto_comp)

        mixed = d + k["mix"] * (wet - d)
        pre_dc = mixed * k["out_gain"]

        # DC blocker (cpp:263-265)
        dc = pre_dc - dc_in + k["dc_r"] * dc_out
        dc_in = pre_dc
        dc_out = dc

        # protect limiter (cpp:267-275)
        peak = torch.abs(dc)
        pg = torch.where(peak > f32(0.88),
                         torch.minimum(pg, rdiv_const(0.88, peak) * 0.98),
                         pg + (1.0 - pg) * 0.0028)
        o = dc * jlimit(0.2, 1.0, pg)
        y = jlimit(-0.98, 0.98, o)
        return (env, lp, hp, noise_hp, tail, wet_env, dc_in, dc_out, pg,
                mat), y

    return step


def extract_scan_carry(carry, extract):
    """Per-sample carry tuple from the state dict."""
    return (carry["env"], carry["lp"], carry["hp"], carry["noise_hp"],
            carry["tail"], carry["wet_env"], carry["dc_in"],
            carry["dc_out"], carry["protect_gain"], extract(carry))


def pack_scan_carry(c, carry, pack):
    """State dict updated from the final per-sample carry."""
    env, lp, hp, noise_hp, tail, wet_env, dc_in, dc_out, pg, mat = c
    new_carry = dict(carry)
    new_carry.update(pack(mat))
    new_carry.update({
        "env": env, "lp": lp, "hp": hp, "noise_hp": noise_hp, "tail": tail,
        "wet_env": wet_env, "dc_in": dc_in, "dc_out": dc_out,
        "protect_gain": pg,
    })
    return new_carry


def static_material(params):
    """The material index when it is one value for the whole call (a
    Python number or a one-element tensor), else None (per-clip materials:
    :func:`process_traced`)."""
    m = params.get("material", 0)
    if isinstance(m, (int, float, np.integer, np.floating)):
        return int(m)
    m = torch.as_tensor(m)
    return int(m) if m.numel() == 1 else None


def clip_materials(params) -> torch.Tensor:
    """The per-clip material indices, truncated to integers and clamped to
    0..4 as JAX's traced path does: an int64 tensor on the CPU."""
    m = torch.as_tensor(params["material"]).detach().cpu()
    return torch.clamp(m.to(torch.int64), 0, 4)


def common_consts(params, sr: float, mode=None):
    """The material-independent constants (on the CPU, float32: 0-dim, or
    [..., 1] for per-clip values) and the params the material models read:
    (consts, material params). `mode` is the static material, or per-clip
    materials [...] (the trims then go per clip)."""

    def get(key):
        return _per_clip(torch.as_tensor(params[key]).detach().cpu())

    tail_shape, damping, weight = get("tailshape"), get("damping"), get("weight")
    texture, mix = get("texture"), get("mix")
    out_gain = db_to_gain(get("output"))

    damping_amt = jlimit(0.0, 1.0, damping)
    damping_mul = jmap(damping_amt, 1.35, 0.40)                     # cpp:65
    decay = jmap(tail_shape, 0.30, 0.985) * jmap(damping_amt, 1.0, 0.80)

    consts = dict(
        tail_shape=tail_shape, texture=texture, mix=mix, out_gain=out_gain,
        decay=decay, low_boost=1.0 + weight,                        # cpp:67
        split_low=onepole_coeff(140.0, sr),
        split_high=onepole_coeff(2600.0, sr),
        env_atk=tau_coeff(0.0025, sr), env_rel=tau_coeff(0.080, sr),
        wet_atk=tau_coeff(0.005, sr), wet_rel=tau_coeff(0.090, sr),
        dc_r=torch.tensor(f32(0.995), dtype=F32),
        auto_gain_base=jmap(texture, 0.78, 0.54),                   # cpp:75
        in_trim=_trim(MATERIAL_INPUT_TRIM, mode),
        mat_trim=_trim(MATERIAL_TRIM, mode))

    return consts, dict(texture=texture, tailshape=tail_shape,
                        damping_amt=damping_amt, damping_mul=damping_mul,
                        weight=weight)


def _trim(table, mode):
    """A material's trim: one float32 value for a static `mode`, [..., 1]
    for per-clip materials [...]."""
    if isinstance(mode, int):
        return torch.tensor(f32(table[mode]), dtype=F32)
    return _f32s(table)[mode][..., None]


def block_consts(params, sr: float, mode: int, L: int, device=None,
                 ring=StateRing):
    """All per-block constants and the material substep for a static
    `mode`: (consts, extract, mat_step, pack). Params are 0-dim float32
    tensors or numbers. The constants are worked out on the CPU and come
    back as 0-dim float32 tensors on `device` (the CPU when None); `ring`
    makes the wave materials' ring object from (waveguide, wave_idx)."""
    device = torch.device("cpu") if device is None else device
    consts, mp = common_consts(params, sr, mode)
    extract, mat_step, pack = _material_substep(mode, mp, sr, L, device, ring)
    return _on(consts, device), extract, mat_step, pack


def block_noise(rng, channels: int, n: int):
    """The block's LCG roughness draws (cpp:239-243), closed form.
    Returns (white [..., C, n], rng')."""
    states = lcg_sequence(rng, channels * n).reshape(*rng.shape, channels, n)
    return white_from_bits(states), lcg_advance(rng, channels * n)


def require_static(params) -> int:
    """The clamped static material; ValueError for per-clip materials."""
    mode = static_material(params)
    if mode is None:
        raise ValueError("one texture material per call is needed here; "
                         "per-clip materials take process_traced")
    return max(0, min(4, mode))


def material_mode(params):
    """The clamped static material (an int), or the per-clip materials
    (``clip_materials``)."""
    mode = static_material(params)
    return clip_materials(params) if mode is None else max(0, min(4, mode))


def process(params, carry, block, sr: float):
    """block [..., C, N] → (out, carry'), every state leaf with the block's
    leading batch shape. The constants are worked out on the CPU and moved
    to the audio's device. A per-clip material runs
    :func:`process_traced`; per-clip values of the other params are
    allowed either way."""
    block = as_f32(block)
    channels, n = block.shape[-2:]
    mode = static_material(params)
    if mode is None:
        return process_traced(params, carry, block, sr)
    mode = max(0, min(4, mode))
    white, new_rng = block_noise(carry["rng"], channels, n)
    consts, extract, mat_step, pack = block_consts(
        params, sr, mode, carry["waveguide"].shape[-1], block.device)
    step = make_sample_step(consts, mat_step)
    c = extract_scan_carry(carry, extract)
    out = torch.empty_like(block)
    for t in range(n):
        c, out[..., t] = step(c, block[..., t], white[..., t])
    new_carry = pack_scan_carry(c, carry, pack)
    new_carry["rng"] = new_rng
    return out, new_carry


#: material_consts entries that hold one value per mode ([4] or [..., 1, 4])
_MODE_KEYS = ("freqs", "t60s", "gains", "a1", "a2")


def _pick(mask, a, b, modes: bool):
    """Per clip, `a` where `mask` [..., 1] holds, else `b`; tuples element
    by element, mode vectors against mask[..., None]."""
    if isinstance(a, tuple):
        return tuple(_pick(mask, x, y, False) for x, y in zip(a, b))
    return torch.where(mask[..., None] if modes else mask,
                       torch.as_tensor(a), torch.as_tensor(b))


def _material_substep_traced(p, sr: float, L: int, material, device,
                             ring=StateRing):
    """The material update with a material per clip (`material` [...] int,
    on the CPU): every material present runs its static step on every lane
    and each clip keeps its own material's output and state, so a selected
    value is bit-identical to that material's static path. Wood and plastic
    share one ring step with each clip's own constants, and only their
    clips write the ring and move its index.

    Returns (extract, step, pack) over every material's leaves: spring
    pos/vel, modal y1/y2, the ring (None without a wave material), the
    previous wave sample, and flesh's four."""
    mm = material.to(device)[..., None]
    present = sorted(set(material.flatten().tolist()))
    steps = {m: _material_substep(m, p, sr, L, device, ring)[1]
             for m in present if m not in WAVE_MODES}
    wave = [m for m in present if m in WAVE_MODES]
    is_wg = (mm == 2) | (mm == 3)
    wave_step = None
    if wave:
        mcs = {m: _on(material_consts(m, p, sr, L), device) for m in wave}
        mc = mcs[wave[0]] if len(wave) == 1 else {
            k: _pick(mm == 2, mcs[2][k], mcs[3][k], k in _MODE_KEYS)
            for k in mcs[2]}
        wave_step = _wave_step(mc, p["texture"].to(device), mask=is_wg)

    def extract(c):
        wg = ring(c["waveguide"], c["wave_idx"]) if wave else None
        return (c["spring_pos"], c["spring_vel"], c["modal_y1"],
                c["modal_y2"], wg, c["prev_wave"], c["flesh_pos_a"],
                c["flesh_vel_a"], c["flesh_pos_b"], c["flesh_vel_b"])

    def pack(m):
        d = dict(zip(("spring_pos", "spring_vel", "modal_y1", "modal_y2"),
                     m[:4]))
        d.update(zip(("prev_wave", "flesh_pos_a", "flesh_vel_a",
                      "flesh_pos_b", "flesh_vel_b"), m[5:]))
        if m[4] is not None:
            d.update(waveguide=m[4].wg, wave_idx=m[4].widx)
        return d

    def step(mat, core, impact, body, trail, hp_state):
        pos, vel, y1, y2, wg, prev_wave, pa, va, pb, vb = mat
        drive = (core, impact, body, trail, hp_state)
        shaped = torch.zeros_like(core)
        y1_new = y1
        if 0 in steps:
            sel = mm == 0
            s0, (pos0, vel0) = steps[0]((pos, vel), *drive)
            shaped = torch.where(sel, s0, shaped)
            pos, vel = torch.where(sel, pos0, pos), torch.where(sel, vel0, vel)
        if 1 in steps:
            sel = mm == 1
            s1, (y_m, _y1) = steps[1]((y1, y2), *drive)
            shaped = torch.where(sel, s1, shaped)
            y1_new = torch.where(sel[..., None], y_m, y1_new)
        if wave_step is not None:
            sw, (y_w, _y1, wg, delayed) = wave_step((y1, y2, wg, prev_wave),
                                                    *drive)
            shaped = torch.where(is_wg, sw, shaped)
            y1_new = torch.where(is_wg[..., None], y_w, y1_new)
            prev_wave = torch.where(is_wg, delayed, prev_wave)
        if 4 in steps:
            sel = mm == 4
            s4, flesh = steps[4]((pa, va, pb, vb), *drive)
            shaped = torch.where(sel, s4, shaped)
            pa, va, pb, vb = (torch.where(sel, new, old) for new, old in
                              zip(flesh, (pa, va, pb, vb)))
        modal = ((mm == 1) | is_wg)[..., None]
        y2 = torch.where(modal, y1, y2)
        return shaped, (pos, vel, y1_new, y2, wg, prev_wave, pa, va, pb, vb)

    return extract, step, pack


def traced_block_consts(params, sr: float, L: int, device=None,
                        ring=StateRing):
    """:func:`block_consts` for per-clip materials (``params["material"]``
    [...], one per clip): (consts, extract, mat_step, pack), the trims per
    clip [..., 1]; the other params may be shared or per clip."""
    device = torch.device("cpu") if device is None else device
    material = clip_materials(params)
    consts, mp = common_consts(params, sr, material)
    extract, mat_step, pack = _material_substep_traced(
        mp, sr, L, material, device, ring)
    return _on(consts, device), extract, mat_step, pack


def process_traced(params, carry, block, sr: float):
    """Texture with a material per clip: block [..., C, N] with
    ``params["material"]`` [...] -> (out, carry'). Every clip runs its own
    material, bit-equal to that material's static :func:`process`; the
    carry holds every material's leaves (init makes them all, the ring
    sized for wood's longest delay) and a clip's other materials' leaves
    stay as they were."""
    block = as_f32(block)
    channels, n = block.shape[-2:]
    white, new_rng = block_noise(carry["rng"], channels, n)
    consts, extract, mat_step, pack = traced_block_consts(
        params, sr, carry["waveguide"].shape[-1], block.device)
    step = make_sample_step(consts, mat_step)
    c = extract_scan_carry(carry, extract)
    out = torch.empty_like(block)
    for t in range(n):
        c, out[..., t] = step(c, block[..., t], white[..., t])
    new_carry = pack_scan_carry(c, carry, pack)
    new_carry["rng"] = new_rng
    return out, new_carry


base.register(base.ProcessorDef(
    name="texture",
    title="Juicy Texture",
    code="JTXT",
    params=PARAMS,
    presets=PRESETS,
    init=init,
    process=process,
    static_params=("material",),
))
