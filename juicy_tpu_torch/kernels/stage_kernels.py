"""Full-stage kernels: pre-analyze + DSP + post-analyze of one block in one
launch. PyTorch port of juicy_tpu/kernels/stage_kernels.py (the analyzer
lane and the punch, saturator, texture and motion stage steps).

``punch_stage_step(params, state, block, sr)``, ``saturator_stage_step``,
``texture_stage_step`` and ``motion_stage_step`` keep the JAX contract:
``block`` [B, C, N] float32, state leaves with a leading [B], returns
``(out [B, C, N], state', metrics)``. For a CUDA tensor each launches its
hand-written kernel (``csrc/punch_stage.cu``, ``csrc/saturator_stage.cu``,
``csrc/texture_stage.cu``, ``csrc/motion_stage.cu``); for a CPU tensor it
runs its ``*_plain`` version, the same computation as serial per-sample
loops over [B] / [B, C] tensors in the kernel's op order. Any other device
raises; none falls back from one route to the other.

Inside the block, per clip: the pre-lane (15 analyzer variables) and the
saturator run in one sample loop; the pre-lane's values are stored; the lane
is reset (envelopes, cooldown and band states carried, accumulators zeroed);
the post-lane runs over the output. The lanes come out as ``fin`` [5, B]
(s_env, l_env, low, high, cooldown) and ``acc`` [10, B] (transient sum, onset
count, low/high energy, rms, peak, side, corr, L², R²), and the score formulas
run on them in plain torch (``finalize_lane``), once per block.
"""

from __future__ import annotations

import functools
from typing import Dict

import numpy as np
import torch

from juicy_tpu_torch import analyzer as _an
from juicy_tpu_torch.models import motion as _motion
from juicy_tpu_torch.models import punch as _punch
from juicy_tpu_torch.models import saturator as _sat
from juicy_tpu_torch.models import texture as _tex
from juicy_tpu_torch.ops import noise as _noise
from juicy_tpu_torch.ops.precise import F32, f32, onepole_narrow, tanh32
from juicy_tpu_torch.runtime.observe import check_kernel_outputs

# lane variables kept across the pre → post reset, in ``fin`` row order
_LANE_FIN = (0, 1, 5, 6, 2)     # s_env, l_env, low, high, cooldown
# accumulators, in ``acc`` row order
_LANE_ACC = (3, 4, 7, 8, 9, 10, 11, 12, 13, 14)
# the kernels' lane output buffers
_LANE_BUFS = ("pre_fin", "pre_acc", "post_fin", "post_acc")


@functools.lru_cache(maxsize=16)
def _lane_consts(sr: float):
    """The analyzer's seven lane constants, the cooldown as a float."""
    k = _an.lane_consts(sr)
    return k[:6] + (f32(k[6]),)


def _lane_step(lane, l, r, k):
    """One analyzer sample on [B] tensors: the op order of the kernel's
    ``lane_step`` (csrc/lane.cuh). The cooldown is a float here."""
    atk_s, rel_s, atk_l, rel_l, low_c, high_c, cd_samples = k
    (s_env, l_env, cooldown, t_acc, count, lo, hi, lo_acc, hi_acc,
     rms_acc, peak, side_acc, corr_acc, l_acc, r_acc) = lane
    mono = 0.5 * (l + r)
    x = torch.abs(mono)
    cs = torch.where(x > s_env, atk_s, rel_s)
    s_env = (1.0 - cs) * x + cs * s_env
    cl = torch.where(x > l_env, atk_l, rel_l)
    l_env = (1.0 - cl) * x + cl * l_env
    transient = torch.clamp(s_env - l_env, min=0.0)
    t_acc = t_acc + transient
    cooldown = torch.clamp(cooldown - 1.0, min=0.0)
    onset = (transient > f32(0.045)) & (cooldown <= 0.0)
    count = count + onset.to(F32)
    cooldown = torch.where(onset, cd_samples, cooldown)
    rms_acc = rms_acc + mono * mono
    peak = torch.maximum(peak, x)
    lo = lo + low_c * (mono - lo)
    hi = hi + high_c * (mono - hi)
    high_v = mono - hi
    lo_acc = lo_acc + lo * lo
    hi_acc = hi_acc + high_v * high_v
    side = 0.5 * (l - r)
    side_acc = side_acc + side * side
    corr_acc = corr_acc + l * r
    l_acc = l_acc + l * l
    r_acc = r_acc + r * r
    return [s_env, l_env, cooldown, t_acc, count, lo, hi, lo_acc, hi_acc,
            rms_acc, peak, side_acc, corr_acc, l_acc, r_acc]


def pack_lane(state: Dict[str, torch.Tensor], b: int) -> torch.Tensor:
    """Analyzer state -> ``fin`` [5, B] lane input (cooldown as f32)."""
    rows = [torch.broadcast_to(state[k], (b,))
            for k in ("short_env", "long_env", "low_state", "high_state")]
    rows.append(torch.broadcast_to(state["onset_cooldown"].to(F32), (b,)))
    return torch.stack(rows)


def _lane_from_fin(fin: torch.Tensor):
    """``fin`` [5, B] -> the 15 lane variables, accumulators zeroed."""
    z = torch.zeros_like(fin[0])
    return [fin[0], fin[1], fin[4], z, z, fin[2], fin[3],
            z, z, z, z, z, z, z, z]


def _lane_reset(lane):
    """Fresh accumulators, persistent state carried (pre -> post lane)."""
    z = torch.zeros_like(lane[0])
    return [lane[0], lane[1], lane[2], z, z, lane[5], lane[6],
            z, z, z, z, z, z, z, z]


def _store_lane(lane):
    return (torch.stack([lane[j] for j in _LANE_FIN]),
            torch.stack([lane[j] for j in _LANE_ACC]))


def finalize_lane(fin, acc, state, n: int, sr: float):
    """Lane outputs ``fin`` [5, B] / ``acc`` [10, B] -> (analyzer state',
    metrics) through the analyzer's score formulas."""
    inv_n = f32(1.0 / n)
    stats = {
        "rms_accum": acc[4], "peak": acc[5], "side_accum": acc[6],
        "corr_accum": acc[7],
        "l_energy": torch.sqrt(acc[8] * inv_n),
        "r_energy": torch.sqrt(acc[9] * inv_n),
    }
    carry = (fin[0], fin[1], fin[4].to(torch.int32), acc[0],
             acc[1].to(torch.int32), fin[2], fin[3], acc[2], acc[3])
    return _an.lane_finalize(carry, state, stats, n, sr)


def metrics_from_lanes(pre_fin, pre_acc, post_fin, post_acc, an_state,
                       n: int, sr: float):
    """Both lanes -> (analyzer state', metrics, pre-lane metrics). The post
    lane's EMA continues from the pre lane's state."""
    pre_state, pre_m = finalize_lane(pre_fin, pre_acc, an_state, n, sr)
    post_state, post_m = finalize_lane(post_fin, post_acc, pre_state, n, sr)
    m = dict(post_m)
    m["pre_score"] = pre_m["score"]
    m["post_score"] = post_m["score"]
    m["score"] = post_m["score"]
    return post_state, m, pre_m


# ---------------------------------------------------------------------------
# Saturator full-stage step
# ---------------------------------------------------------------------------

def _sat_scalars(params, sr: float):
    """The kernel's scalar arguments: 7 lane constants, then in_gain, asym,
    tone_coeff, out_gain, mix, all float32 values computed on the host."""
    for key, v in params.items():
        if torch.as_tensor(v).ndim:
            raise ValueError(f"the stage kernel takes one setting per call; "
                             f"param {key!r} is batched")
    k = _sat.sat_consts(params, sr)
    return _lane_consts(sr) + tuple(
        float(k[key]) for key in ("in_gain", "asym", "tone_coeff",
                                  "out_gain", "mix"))


def _sat_lanes_plain(x, tone0, lane0, scalars):
    """Plain PyTorch version of the kernel. x [B, C, N], tone0 [B, C],
    lane0 [5, B] -> (out [B, C, N], tone [B, C], pre fin, pre acc, post fin,
    post acc)."""
    lane_k = scalars[:7]
    in_gain, asym, tone_c, out_gain, mix = scalars[7:]
    c = x.shape[1]
    n = x.shape[2]
    out = torch.empty_like(x)
    tone = tone0
    lane = _lane_from_fin(lane0)
    for t in range(n):
        d = x[:, :, t]
        lane = _lane_step(lane, d[:, 0], d[:, c - 1], lane_k)
        driven = d * in_gain
        skewed = driven + asym * driven * driven
        soft = tanh32(skewed)
        tone = tone + tone_c * (soft - tone)
        wet = tone * out_gain
        out[:, :, t] = d + mix * (wet - d)
    pre_fin, pre_acc = _store_lane(lane)
    lane = _lane_reset(lane)
    for t in range(n):
        lane = _lane_step(lane, out[:, 0, t], out[:, c - 1, t], lane_k)
    post_fin, post_acc = _store_lane(lane)
    return out, tone, pre_fin, pre_acc, post_fin, post_acc


def sat_cuda_buffers(x, tone0, lane0):
    """The saturator kernel's inputs in its layout and its freshly allocated
    outputs, as a dict of tensors (the layout permutes of one block)."""
    bufs = dict(x=x.permute(2, 1, 0).contiguous(),                # [N, C, B]
                tone_in=tone0.t().contiguous(),                   # [C, B]
                lane_in=lane0.contiguous())
    bufs.update(out=torch.empty_like(bufs["x"]),
                tone_out=torch.empty_like(bufs["tone_in"]),
                **_lane_outputs(x.shape[0], x.device))
    return bufs


_SAT_ARGS = ("x", "tone_in", "lane_in", "out", "tone_out", "pre_fin",
             "pre_acc", "post_fin", "post_acc")


def sat_cuda_launch(bufs, scalars):
    """One launch of ``juicy_saturator_stage`` (csrc/saturator_stage.cu) on
    prepared buffers, on the current stream of their device, uncounted: its
    callers count it (saturator_stage_step, and saturator_step_fused in
    kernels/saturator_kernel.py). Raises on a refused launch."""
    from juicy_tpu_torch.kernels import _build

    lib = _build.load_library()
    n, c, b = bufs["x"].shape
    device = bufs["x"].device
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.juicy_saturator_stage(
            *(bufs[k].data_ptr() for k in _SAT_ARGS), b, c, n, *scalars,
            stream)
    if err != 0:
        raise RuntimeError(f"juicy_saturator_stage launch failed: CUDA error "
                           f"{err} ({_build.error_string(lib, err)})")
    check_kernel_outputs("juicy_saturator_stage",
                         (bufs[k] for k in ("out", "tone_out", *_LANE_BUFS)))


def sat_lanes_cuda(step, x, tone0, lane0, scalars):
    """The kernel route: layout, one launch counted in ``step.launches``,
    unpack. Same contract as _sat_lanes_plain."""
    bufs = sat_cuda_buffers(x, tone0, lane0)
    sat_cuda_launch(bufs, scalars)
    step.launches += 1
    return (bufs["out"].permute(2, 1, 0), bufs["tone_out"].t(),
            bufs["pre_fin"], bufs["pre_acc"], bufs["post_fin"],
            bufs["post_acc"])


def _sat_lanes_cuda(x, tone0, lane0, scalars):
    """The kernel route of saturator_stage_step."""
    return sat_lanes_cuda(saturator_stage_step, x, tone0, lane0, scalars)


def _sat_stage(lanes_fn, params, state, block, sr: float):
    if block.dtype != F32 or block.ndim != 3:
        raise ValueError(f"expected float32 block [B, C, N], got "
                         f"{block.dtype} {tuple(block.shape)}")
    b, c, n = block.shape
    if c not in (1, 2) or n == 0 or b == 0:
        raise ValueError(f"unsupported block shape {tuple(block.shape)}")
    tone0 = state["dsp"]["tone_state"]
    if tuple(tone0.shape) != (b, c):
        raise ValueError(f"tone_state is {tuple(tone0.shape)}, expected {(b, c)}")
    lane0 = pack_lane(state["analyzer"], b)
    for t in (tone0, lane0):
        if t.device != block.device or t.dtype != F32:
            raise ValueError("state must be float32 on the block's device")
    out, tone, pre_fin, pre_acc, post_fin, post_acc = lanes_fn(
        block, tone0, lane0, _sat_scalars(params, sr))
    post_state, m, _pre = metrics_from_lanes(pre_fin, pre_acc, post_fin,
                                             post_acc, state["analyzer"], n, sr)
    return out, {"analyzer": post_state, "dsp": {"tone_state": tone}}, m


def saturator_stage_step_plain(params, state, block, sr: float):
    """The saturator stage step as plain PyTorch, on any device."""
    return _sat_stage(_sat_lanes_plain, params, state, block, sr)


def saturator_stage_step(params, state, block, sr: float):
    """Full saturator step (pre-analyze → DSP → post-analyze) in one kernel
    launch for a CUDA `block`; the plain version for a CPU `block`."""
    if block.device.type == "cuda":
        return _sat_stage(_sat_lanes_cuda, params, state, block, sr)
    if block.device.type == "cpu":
        return saturator_stage_step_plain(params, state, block, sr)
    raise ValueError(f"no saturator stage kernel for device {block.device}")


#: kernel launches made by saturator_stage_step (CUDA tensors only)
saturator_stage_step.launches = 0


# ---------------------------------------------------------------------------
# Texture full-stage step
#
# The texture state enters the step in *kernel form* (texture_kernel_state):
# the waveguide ring of wood and plastic time-major [L, C, B], updated in
# place block after block, and the LCG state as int32 bits. Convert once per
# corpus, not per block (the ring is 126 MB at B = 4096); texture_ring_state
# converts back. The other leaves keep the state form.
# ---------------------------------------------------------------------------

_TEX_COMMON = ("tail_shape", "texture", "mix", "out_gain", "decay",
               "low_boost", "split_low", "split_high", "env_atk", "env_rel",
               "wet_atk", "wet_rel", "dc_r", "auto_gain_base", "in_trim",
               "mat_trim")
_TEX_DSP_KEYS = ("env", "lp", "hp", "noise_hp", "tail", "wet_env",
                 "dc_in", "dc_out", "protect_gain")
_NM = _tex.NMODES


def tex_param_list(params, sr: float, mode: int):
    """The texture kernel's constants after the 7 lane constants, as f32
    Python floats in the order csrc/texture.cuh reads them: _TEX_COMMON,
    then the material's (gel: omega, kspring; metal: freqs, pole radii, a2,
    gains, the 0.45·sr cap, theta_scale; wood/plastic: a1, a2, gains,
    delay, damp, waveguide mix, excitation scales, injection (b0, b1), five
    output mixes; flesh: k_a, k_b, c_a, c_b, k_couple). Unlike the TPU
    kernel's list it holds no write index: the kernel reads each clip's."""
    L = _tex.waveguide_size(sr)
    kc, mp = _tex.common_consts(params, sr, mode)
    mc = _tex.material_consts(mode, mp, sr, L)
    pv = [kc[key] for key in _TEX_COMMON]
    if mode == 0:
        pv += [mc["omega"], mc["k"]]
    elif mode == 1:
        freqs, rs = _tex.metal_poles(mc, sr)
        pv += [*freqs, *rs, *(-rs * rs), *mc["gains"], f32(0.45 * sr),
               _tex.theta_scale(sr)]
    elif mode in _tex.WAVE_MODES:
        pv += [*mc["a1"], *mc["a2"], *mc["gains"], mc["delay_samp"],
               mc["damp"], *mc["wg_mix"], *mc["exc_scale"], *mc["exc_b"],
               *mc["out_mix"]]
    else:
        pv += [mc["k_a"], mc["k_b"], mc["c_a"], mc["c_b"], mc["k_couple"]]
    return [f32(v) for v in pv]


def tex_modes(mode):
    """The materials of a static `mode` (an int) or of per-clip materials
    (an int64 tensor [B] on the CPU, models/texture.py::clip_materials)."""
    return [mode] if isinstance(mode, int) else list(_modes_of(_key(mode)))


def _key(mode) -> bytes:
    return mode.numpy().tobytes()


@functools.lru_cache(maxsize=16)
def _modes_of(key: bytes):
    return tuple(sorted(set(np.frombuffer(key, np.int64).tolist())))


@functools.lru_cache(maxsize=16)
def _modes_on(key: bytes, device: str) -> torch.Tensor:
    """Per-clip materials on `device`, copied there once (each block of a
    corpus asks again)."""
    return torch.from_numpy(np.frombuffer(key, np.int64).copy()).to(device)


def tex_has_wave(mode) -> bool:
    """Whether wood or plastic is among `mode`'s materials."""
    return any(m in _tex.WAVE_MODES for m in tex_modes(mode))


def _clip_mask(mode, m: int, like: torch.Tensor, axis: int = 0):
    """[B] mask of material `m`'s clips, shaped to broadcast against `like`
    whose clip axis is `axis`."""
    sel = _modes_on(_key(mode), str(like.device)) == m
    return sel.reshape(sel.shape + (1,) * (like.ndim - axis - 1))


def tex_mat_stack(dsp, mode) -> torch.Tensor:
    """The material state in the kernels' form [NMAT, B, C]: a static
    material's leaves (tex_mat_leaves), or with per-clip materials each
    clip's own material's leaves first, NMAT the largest of the materials
    present (the other rows zero)."""
    if isinstance(mode, int):
        return torch.stack(tex_mat_leaves(dsp, mode))
    stacks = {m: torch.stack(tex_mat_leaves(dsp, m)) for m in tex_modes(mode)}
    out = torch.zeros((max(len(v) for v in stacks.values()),
                       *dsp["env"].shape), dtype=F32, device=dsp["env"].device)
    for m, v in stacks.items():
        out[:len(v)] = torch.where(_clip_mask(mode, m, v, 1), v, out[:len(v)])
    return out


def tex_mat_unstack(dsp, mat: torch.Tensor, mode):
    """The state entries of the kernels' material state `mat` (the inverse
    of tex_mat_stack): with per-clip materials each clip's own material's
    leaves from `mat`, its other materials' leaves from `dsp`."""
    if isinstance(mode, int):
        return _tex_mat_dict(mat.unbind(0), mode)
    new = {}
    for m in tex_modes(mode):
        nmat = len(tex_mat_leaves(dsp, m))
        for key, v in _tex_mat_dict(mat[:nmat].unbind(0), m).items():
            new[key] = torch.where(_clip_mask(mode, m, v),
                                   v, new.get(key, dsp[key]))
    return new


def tex_mat_leaves(dsp, mode: int):
    """Material-state leaves ([B, C] each) in the kernel's order."""
    if mode == 0:
        return [dsp["spring_pos"], dsp["spring_vel"]]
    if mode == 4:
        return [dsp["flesh_pos_a"], dsp["flesh_vel_a"],
                dsp["flesh_pos_b"], dsp["flesh_vel_b"]]
    leaves = [dsp["modal_y1"][..., k] for k in range(_NM)] + \
             [dsp["modal_y2"][..., k] for k in range(_NM)]
    if mode in _tex.WAVE_MODES:
        leaves.append(dsp["prev_wave"])
    return leaves


def _tex_mat_dict(leaves, mode: int):
    """The inverse of tex_mat_leaves: state dict entries."""
    if mode == 0:
        return {"spring_pos": leaves[0], "spring_vel": leaves[1]}
    if mode == 4:
        return dict(zip(("flesh_pos_a", "flesh_vel_a", "flesh_pos_b",
                         "flesh_vel_b"), leaves))
    d = {"modal_y1": torch.stack(leaves[:_NM], dim=-1),
         "modal_y2": torch.stack(leaves[_NM:2 * _NM], dim=-1)}
    if mode in _tex.WAVE_MODES:
        d["prev_wave"] = leaves[2 * _NM]
    return d


def wave_index(dsp, mode) -> int:
    """The ring write index of the wave clips (every clip's for a static
    wood or plastic; with per-clip materials, wood's and plastic's clips'),
    which must be one value inside the ring; raises otherwise."""
    widx, L = dsp["wave_idx"], dsp["waveguide"].shape[-1]
    if not isinstance(mode, int):
        widx = widx[((mode == 2) | (mode == 3)).to(widx.device)]
    w0 = int(widx.reshape(-1)[0])
    if not (0 <= w0 < L and bool(torch.all(widx == w0))):
        raise ValueError("texture kernel: wave_idx differs between the wave "
                         "clips or channels, or lies outside the ring; the "
                         "kernels take one ring write index for the batch")
    return w0


def texture_kernel_state(dsp, mode):
    """Texture state (as from ``Plugin.init_state``) -> kernel form: ``rng``
    as int32 bits and, when wood or plastic is among `mode`'s materials (a
    static int, or per-clip materials [B]), the ring [B, C, L] as a new
    time-major [L, C, B] tensor. The TPU kernel reads one write index for
    the whole batch (``wave_idx.reshape(-1)[0]``); that precondition, over
    the wave clips, is checked here, once per corpus, and a state that
    breaks it raises."""
    st = dict(dsp)
    st["rng"] = _noise.u32_to_i32_bits(dsp["rng"])
    if tex_has_wave(mode):
        wave_index(dsp, mode)
        st["waveguide"] = _ring_copy(dsp["waveguide"])
    return st


def _ring_copy(ring):
    """The ring with its first and last axes swapped, in a tensor of its
    own: ``contiguous()`` would hand back the same storage where the swap
    leaves it contiguous (one mono clip), and the kernel's in-place
    updates would then reach the caller's state."""
    return ring.permute(2, 1, 0).clone(memory_format=torch.contiguous_format)


def texture_ring_state(dsp, mode):
    """Kernel form -> texture state: the inverse of texture_kernel_state,
    exact, with the ring in a new tensor."""
    st = dict(dsp)
    st["rng"] = _noise.i32_bits_to_u32(dsp["rng"])
    if tex_has_wave(mode):
        st["waveguide"] = _ring_copy(dsp["waveguide"])
    return st


class KernelRing:
    """The kernel-form ring [L, C, B] with the clips' write indices
    [B, C], read and written in place as the kernel does (same interface as
    models/texture.py::StateRing)."""

    def __init__(self, ring: torch.Tensor, widx: torch.Tensor):
        self.wg, self.widx, self.L = ring, widx, ring.shape[0]
        b, c = widx.shape
        self._c = torch.arange(c, device=ring.device)[None, :]
        self._b = torch.arange(b, device=ring.device)[:, None]

    def read(self, delay):
        i0, i1, frac = _tex.ring_tap(self.widx, delay, self.L)
        v0 = self.wg[i0.long(), self._c, self._b]
        v1 = self.wg[i1.long(), self._c, self._b]
        return v0 + frac * (v1 - v0)

    def write(self, value: torch.Tensor, mask=None):
        """As StateRing.write: with `mask` only those rows write and move
        their index."""
        idx = (self.widx.long(), self._c, self._b)
        if mask is not None:
            value = torch.where(mask, value, self.wg[idx])
        self.wg[idx] = value
        self.widx = _tex.advance_index(self.widx, self.L, mask)


def _tex_lanes_plain(x, dsp, lane0, params, sr: float, mode):
    """Plain PyTorch version of the kernel: the per-sample body of
    models/texture.py on [B, C] tensors (its traced path for per-clip
    materials `mode` [B]), the LCG stepped per sample as the kernel steps
    it. x [B, C, N], dsp in kernel form (the ring updated in place), lane0
    [5, B] -> (out [B, C, N], dsp', pre fin, pre acc, post fin, post
    acc)."""
    c, n = x.shape[1], x.shape[2]
    L = _tex.waveguide_size(sr)
    if isinstance(mode, int):
        consts, extract, mat_step, pack = _tex.block_consts(
            params, sr, mode, L, x.device, ring=KernelRing)
    else:
        consts, extract, mat_step, pack = _tex.traced_block_consts(
            params, sr, L, x.device, ring=KernelRing)
    step = _tex.make_sample_step(consts, mat_step)
    carry = _tex.extract_scan_carry(dsp, extract)
    rng = _noise.i32_bits_to_u32(dsp["rng"])
    draws = [rng, _noise.lcg_advance(rng, n)][:c]
    lane_k = _lane_consts(sr)
    lane = _lane_from_fin(lane0)
    out = torch.empty_like(x)
    for t in range(n):
        d = x[:, :, t]
        lane = _lane_step(lane, d[:, 0], d[:, c - 1], lane_k)
        draws = [_noise.lcg_step(r) for r in draws]
        w = torch.stack([_noise.white_from_bits(r) for r in draws], dim=1)
        carry, out[:, :, t] = step(carry, d, w)
    pre_fin, pre_acc = _store_lane(lane)
    lane = _lane_reset(lane)
    for t in range(n):
        lane = _lane_step(lane, out[:, 0, t], out[:, c - 1, t], lane_k)
    post_fin, post_acc = _store_lane(lane)
    new_dsp = _tex.pack_scan_carry(carry, dsp, pack)
    new_dsp["rng"] = _noise.u32_to_i32_bits(draws[-1])
    return out, new_dsp, pre_fin, pre_acc, post_fin, post_acc


def tex_cuda_buffers(x, dsp, lane0, mode):
    """The kernel's inputs in its layout and its freshly allocated outputs,
    as a dict of tensors (the layout permutes of one block)."""
    b = x.shape[0]
    wave = tex_has_wave(mode)
    bufs = dict(
        x=x.permute(2, 1, 0).contiguous(),                  # [N, C, B]
        dsp_in=torch.stack([dsp[k] for k in _TEX_DSP_KEYS]),  # [9, B, C]
        mat_in=tex_mat_stack(dsp, mode),                      # [M, B, C]
        rng_in=dsp["rng"].contiguous(),
        widx_in=dsp["wave_idx"].contiguous(),
        lane_in=lane0.contiguous(),
        ring=dsp["waveguide"] if wave else None)
    bufs.update(
        out=torch.empty_like(bufs["x"]),
        dsp_out=torch.empty_like(bufs["dsp_in"]),
        mat_out=torch.empty_like(bufs["mat_in"]),
        rng_out=torch.empty_like(bufs["rng_in"]),
        # the wave clips write their index; with per-clip materials the
        # others keep theirs
        widx_out=(bufs["widx_in"] if not wave
                  else torch.empty_like(bufs["widx_in"]) if isinstance(mode, int)
                  else bufs["widx_in"].clone()),
        **{name: torch.empty((rows, b), dtype=F32, device=x.device)
           for name, rows in (("pre_fin", 5), ("pre_acc", 10),
                              ("post_fin", 5), ("post_acc", 10))})
    return bufs


_TEX_ARGS = ("x", "dsp_in", "mat_in", "rng_in", "widx_in", "lane_in", "ring",
             "out", "dsp_out", "mat_out", "rng_out", "widx_out", "pre_fin",
             "pre_acc", "post_fin", "post_acc")


#: floats in a texture kernel's constant row: the lane's, then texture's
#: (csrc/texture.cuh TexConsts)
TEX_ROW = 7 + len(_TEX_COMMON) + 25


def cta_modes(mode, b: int, device):
    """Per-clip materials `mode` [B] as the mixed kernels read them: one
    material per CTA of 32 clips (the lanes past B run on the last clip),
    an int32 tensor on `device`, and the mask of the materials present.
    Raises unless the clips of every CTA share their material."""
    if mode.numel() != b:
        raise ValueError(f"{mode.numel()} materials for a batch of {b}")
    runs = _cta_runs(mode)
    if not bool(torch.all(runs == runs[:, :1])):
        raise ValueError("the clips of a CTA (32 in a row) hold different "
                         "texture materials: sort the batch by material "
                         "into runs of 32 (MaterialOrder)")
    return _cta_on(runs[:, 0].to(torch.int32).numpy().tobytes(),
                   str(torch.device(device)))


def _cta_runs(mode) -> torch.Tensor:
    """Per-clip materials [B] as [CTAs, 32], the lanes past B on the last
    clip (as the kernels run them)."""
    m = mode.reshape(-1)
    return torch.cat([m, m[-1:].expand((-len(m)) % 32)]).reshape(-1, 32)


def cta_uniform(mode) -> bool:
    """Whether the 32 clips of every CTA share their material."""
    runs = _cta_runs(mode)
    return bool(torch.all(runs == runs[:, :1]))


def material_order(mode):
    """The ``MaterialOrder`` a batch with texture materials `mode` needs
    for the mixed kernels: None for a static material, or where the 32
    clips of every CTA already share theirs."""
    if isinstance(mode, int) or cta_uniform(mode):
        return None
    return MaterialOrder(mode)


class MaterialOrder:
    """A batch with per-clip materials `mode` [B] in the mixed kernels'
    order: sorted by material (stable), each material's run padded to a
    multiple of 32 with silent copies of its first clip, so that the 32
    clips of every CTA share their material; and the CTAs laid out so that
    CTA j and CTA j + ceil(n / 2) share theirs wherever the counts allow
    (``_paired``). ``take`` [Bp] is the batch's clip in each slot, ``pad``
    [Bp] marks the padding slots, ``pos`` [B] each clip's slot and
    ``mode`` [Bp] the slots' materials."""

    def __init__(self, mode):
        m = mode.reshape(-1).numpy()
        order = np.argsort(m, kind="stable")
        chunks = {}
        for v in np.unique(m):
            idx = order[m[order] == v]
            extra = (-len(idx)) % 32
            take = np.concatenate([idx, np.full(extra, idx[0])])
            pad = np.concatenate([np.zeros(len(idx), bool),
                                  np.ones(extra, bool)])
            chunks[int(v)] = list(zip(take.reshape(-1, 32),
                                      pad.reshape(-1, 32)))[::-1]
        seq = _paired([v for v, c in chunks.items() for _ in c])
        parts = [chunks[v].pop() for v in seq]
        take = np.concatenate([t for t, _p in parts])
        pad = np.concatenate([q for _t, q in parts])
        pos = np.empty(len(m), np.int64)
        pos[take[~pad]] = np.nonzero(~pad)[0]
        self.take, self.pad, self.pos = (torch.from_numpy(a)
                                         for a in (take, pad, pos))
        self.mode = torch.from_numpy(m[take])
        self._on = {}

    def _index(self, name: str, device) -> torch.Tensor:
        """An index on `device`, copied there once."""
        key = (name, str(device))
        if key not in self._on:
            self._on[key] = getattr(self, name).to(device)
        return self._on[key]

    def gather(self, t: torch.Tensor, axis: int = 0) -> torch.Tensor:
        """`t`'s clips (along `axis`) in slot order."""
        return t.index_select(axis, self._index("take", t.device))

    def scatter(self, t: torch.Tensor, axis: int = 0) -> torch.Tensor:
        """Slot-ordered `t` back in the batch's order, padding dropped."""
        return t.index_select(axis, self._index("pos", t.device))

    def clips(self, x: torch.Tensor) -> torch.Tensor:
        """Audio [B, ...] in slot order, the padding slots silent."""
        y = self.gather(x)
        y[self._index("pad", y.device)] = 0.0
        return y

    def tree(self, tree, b: int, scatter: bool = False):
        """A dict of tensors (or numbers) as tensors, every leaf whose
        leading axis runs over `b` clips gathered into slot order (or
        scattered back)."""
        fn = self.scatter if scatter else self.gather
        tree = {k: torch.as_tensor(v) for k, v in tree.items()}
        return {k: fn(v) if v.ndim and v.shape[0] == b else v
                for k, v in tree.items()}


def _paired(ctas):
    """The CTAs' materials (sorted runs) reordered so that CTA j and CTA
    j + len // 2 share a material for as many j as the counts allow, the
    odd ones left over in between. Two CTAs share an SM; when their
    materials differ, their texture roles' code competes for the SM's
    instruction cache: on the H100 at B = 8192 this order took the mixed
    chain kernel from 1.24 to 1.17-1.20 ms and the mixed texture kernel
    from 0.332 to 0.293 ms (PERF.md)."""
    first, left = [], []
    for v in dict.fromkeys(ctas):
        c = ctas.count(v)
        first += [v] * (c // 2)
        left += [v] * (c % 2)
    cut = len(ctas) // 2 - len(first)
    return first + left[:cut] + first + left[cut:]


@functools.lru_cache(maxsize=64)
def _cta_on(modes: bytes, device: str):
    cta = np.frombuffer(modes, np.int32)
    return (torch.from_numpy(cta.copy()).to(device),
            int(np.bitwise_or.reduce(1 << cta)))


def _tex_consts_table(params, sr: float):
    """Five rows of TEX_ROW floats, row m material m's stage_scalars: the
    mixed launch's host constants (every row filled: the roles that all
    materials share read row 0)."""
    table = np.zeros((5, TEX_ROW), np.float32)
    for m in range(5):
        row = stage_scalars("texture", dict(params, material=m), sr)
        table[m, :row.size] = row
    return table


def tex_cuda_launch(bufs, params, sr: float, mode):
    """Launch ``juicy_texture_stage`` (csrc/texture_stage.cu) on prepared
    buffers, on the current stream of their device; for per-clip materials
    `mode` [B] (CTA-uniform, cta_modes) ``juicy_texture_stage_mixed``.
    Raises on a refused launch."""
    from juicy_tpu_torch.kernels import _build

    lib = _build.load_library()
    n, c, b = bufs["x"].shape
    jump_a, jump_b = _noise.jump(n)
    ptrs = [None if bufs[k] is None else bufs[k].data_ptr() for k in _TEX_ARGS]
    device = bufs["x"].device
    L = _tex.waveguide_size(sr)
    if isinstance(mode, int):
        consts = stage_scalars("texture", params, sr)
    else:
        cta, mask = cta_modes(mode, b, device)
        consts = _tex_consts_table(params, sr)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        if isinstance(mode, int):
            err = lib.juicy_texture_stage(
                *ptrs, b, c, n, L, mode, jump_a, jump_b,
                consts.ctypes.data, consts.size, stream)
        else:
            err = lib.juicy_texture_stage_mixed(
                *ptrs, b, c, n, L, cta.data_ptr(), mask, jump_a, jump_b,
                consts.ctypes.data, TEX_ROW, stream)
    if err != 0:
        raise RuntimeError(f"juicy_texture_stage launch failed: CUDA error "
                           f"{err} ({_build.error_string(lib, err)})")
    texture_stage_step.launches += 1
    check_kernel_outputs("juicy_texture_stage", (bufs[k] for k in (
        "out", "dsp_out", "mat_out", "ring", *_LANE_BUFS)))


def _tex_lanes_cuda(x, dsp, lane0, params, sr: float, mode):
    """The kernel route: layout, launch, unpack. Same contract as
    _tex_lanes_plain."""
    bufs = tex_cuda_buffers(x, dsp, lane0, mode)
    tex_cuda_launch(bufs, params, sr, mode)
    new_dsp = dict(dsp)
    new_dsp.update(zip(_TEX_DSP_KEYS, bufs["dsp_out"].unbind(0)))
    new_dsp.update(tex_mat_unstack(dsp, bufs["mat_out"], mode))
    new_dsp["rng"] = bufs["rng_out"]
    new_dsp["wave_idx"] = bufs["widx_out"]
    return (bufs["out"].permute(2, 1, 0), new_dsp, bufs["pre_fin"],
            bufs["pre_acc"], bufs["post_fin"], bufs["post_acc"])


def _tex_stage(lanes_fn, params, state, block, sr: float):
    if block.dtype != F32 or block.ndim != 3:
        raise ValueError(f"expected float32 block [B, C, N], got "
                         f"{block.dtype} {tuple(block.shape)}")
    b, c, n = block.shape
    if c not in (1, 2) or n == 0 or b == 0:
        raise ValueError(f"unsupported block shape {tuple(block.shape)}")
    mode = _tex.material_mode(params)
    if not isinstance(mode, int) and tuple(mode.shape) != (b,):
        raise ValueError(f"materials of shape {tuple(mode.shape)} for a "
                         f"batch of {b}")
    for key, v in params.items():
        if key != "material" and torch.as_tensor(v).ndim:
            raise ValueError(f"the stage kernel takes one setting per call; "
                             f"param {key!r} is batched")
    dsp = state["dsp"]
    if dsp["rng"].dtype != torch.int32:
        raise ValueError("texture state is not in kernel form: convert it "
                         "once with texture_kernel_state")
    L = _tex.waveguide_size(sr)
    wave = tex_has_wave(mode)
    ring = dsp["waveguide"]
    want_ring = (L, c, b) if wave else (b, c, L)
    if tuple(ring.shape) != want_ring or (wave and not (
            ring.is_contiguous() and ring.dtype == F32
            and ring.device == block.device)):
        raise ValueError(f"waveguide is {ring.dtype} {tuple(ring.shape)}, "
                         f"expected contiguous float32 {want_ring} on the "
                         f"block's device (kernel form)")
    leaves = {k: dsp[k] for k in _TEX_DSP_KEYS}
    for m in tex_modes(mode):
        leaves.update(enumerate(tex_mat_leaves(dsp, m), start=10 * m))
    for key, t in leaves.items():
        if tuple(t.shape) != (b, c) or t.dtype != F32 or t.device != block.device:
            raise ValueError(f"texture state {key!r} must be float32 [B, C] "
                             f"on the block's device")
    for key, shape in (("rng", (b,)), ("wave_idx", (b, c))):
        t = dsp[key]
        if (tuple(t.shape) != shape or t.dtype != torch.int32
                or t.device != block.device):
            raise ValueError(f"texture state {key!r} must be int32 {shape} "
                             f"on the block's device")
    lane0 = pack_lane(state["analyzer"], b)
    if lane0.device != block.device:
        raise ValueError("analyzer state must be on the block's device")
    out, new_dsp, pre_fin, pre_acc, post_fin, post_acc = lanes_fn(
        block, dsp, lane0, params, sr, mode)
    post_state, m, _pre = metrics_from_lanes(pre_fin, pre_acc, post_fin,
                                             post_acc, state["analyzer"], n, sr)
    return out, {"analyzer": post_state, "dsp": new_dsp}, m


def texture_stage_step_plain(params, state, block, sr: float):
    """The texture stage step as plain PyTorch, on any device."""
    return _tex_stage(_tex_lanes_plain, params, state, block, sr)


def texture_stage_step(params, state, block, sr: float):
    """Full texture step (pre-analyze → DSP → post-analyze) in one kernel
    launch for a CUDA `block`; the plain version for a CPU `block`.
    `params` hold a static ``material``, or one per clip [B], in which case
    the clips of each CTA (32 in a row) must share theirs (cta_modes) and
    the launch takes a material per CTA; the texture state is in kernel
    form (texture_kernel_state) and its ring is updated in place."""
    if block.device.type == "cuda":
        return _tex_stage(_tex_lanes_cuda, params, state, block, sr)
    if block.device.type == "cpu":
        return texture_stage_step_plain(params, state, block, sr)
    raise ValueError(f"no texture stage kernel for device {block.device}")


#: kernel launches made by texture_stage_step (CUDA tensors only)
texture_stage_step.launches = 0


# ---------------------------------------------------------------------------
# Punch and motion full-stage steps
#
# Their plain versions are the models' own process (models/punch.py,
# models/motion.py) between the two analyzer lanes: the kernels run the same
# per-sample bodies in the same op order (csrc/punch.cuh, csrc/motion.cuh).
# The state keeps the Plugin's form; motion's LCG state crosses to the kernel
# as int32 bits and back per block.
# ---------------------------------------------------------------------------

_PUNCH_SHAPE = ("curve_exp", "punch_k", "sustain_k", "drive", "tanh_drive",
                "clip", "hard_k", "mix", "out_gain")
_MOTION_P2 = ("var_slew", "one_slew", "motion_inc", "lfo_depth", "cut_depth",
              "boost_depth", "lfo_mv", "lfo_depth2", "tone_depth", "trans_mv",
              "trans_depth", "tail_feedback", "tail_mix", "budget_coeff",
              "one_budget", "budget_target", "wet_boost", "mix", "out_gain")


def punch_param_list(params, sr: float):
    """The punch kernel's constants after the 7 lane constants, as f32
    Python floats in csrc/punch.cuh's PunchConsts order."""
    fast_c, slow_c = _punch.env_coeffs(sr)
    k = _punch.shape_consts(params)
    return [f32(1.0 - fast_c), fast_c, f32(1.0 - slow_c), slow_c] + \
        [float(k[key]) for key in _PUNCH_SHAPE]


def motion_param_list(params, sr: float):
    """The motion kernel's constants after the 7 lane constants, as f32
    Python floats in csrc/motion.cuh's MotionConsts order."""
    k = _motion.p2_consts(params, sr)
    k.update(_motion.p2_factors(k))
    vals = [*_motion.p1_consts(sr), params["microvar"], params["repeatctrl"],
            *(k[key] for key in _MOTION_P2), sr]
    return [f32(v) for v in vals]


_PARAM_LISTS = {
    "punch": punch_param_list, "motion": motion_param_list,
    "texture": lambda p, sr: tex_param_list(p, sr, _tex.require_static(p))}


@functools.lru_cache(maxsize=64)
def _stage_scalars_cached(name: str, key, sr: float):
    params = {k: torch.tensor(f32(v), dtype=F32) for k, v in key}
    vals = list(_lane_consts(sr)) + _PARAM_LISTS[name](params, sr)
    arr = np.asarray(vals, dtype=np.float32)
    arr.setflags(write=False)
    return arr


def stage_scalars(name: str, params, sr: float) -> np.ndarray:
    """A stage kernel's lane and stage constants as one float32 array,
    worked out once per (stage, params, sr) and cached: only the audio
    changes per block. Texture's params hold its static material."""
    key = tuple(sorted((k, float(v)) for k, v in params.items()))
    return _stage_scalars_cached(name, key, float(sr))


def _lanes_around(x, out, lane0, sr: float):
    """The pre lane over the input and the post lane over the output:
    (pre fin, pre acc, post fin, post acc)."""
    c = x.shape[1]
    lane_k = _lane_consts(sr)
    lane = _lane_from_fin(lane0)
    for t in range(x.shape[2]):
        lane = _lane_step(lane, x[:, 0, t], x[:, c - 1, t], lane_k)
    pre_fin, pre_acc = _store_lane(lane)
    lane = _lane_reset(lane)
    for t in range(x.shape[2]):
        lane = _lane_step(lane, out[:, 0, t], out[:, c - 1, t], lane_k)
    return (pre_fin, pre_acc, *_store_lane(lane))


def _model_lanes_plain(process):
    """Plain version of a punch or motion kernel: the model's process
    between the two lanes. (x, dsp, lane0, params, sr) -> (out, dsp', pre
    fin, pre acc, post fin, post acc)."""
    def lanes(x, dsp, lane0, params, sr: float):
        out, new_dsp = process(params, dsp, x, sr)
        return (out, new_dsp, *_lanes_around(x, out, lane0, sr))
    return lanes


_punch_lanes_plain = _model_lanes_plain(_punch.process)
_motion_lanes_plain = _model_lanes_plain(_motion.process)


def _lane_outputs(b: int, device):
    return {name: torch.empty((rows, b), dtype=F32, device=device)
            for name, rows in (("pre_fin", 5), ("pre_acc", 10),
                               ("post_fin", 5), ("post_acc", 10))}


def punch_cuda_buffers(x, dsp, lane0):
    """The punch kernel's inputs in its layout and its outputs, as a dict
    of tensors (the layout permutes of one block)."""
    bufs = dict(x=x.permute(2, 1, 0).contiguous(),                # [N, C, B]
                env_in=torch.stack([dsp["fast_env"], dsp["slow_env"]]),
                lane_in=lane0.contiguous())
    bufs.update(out=torch.empty_like(bufs["x"]),
                env_out=torch.empty_like(bufs["env_in"]),
                **_lane_outputs(x.shape[0], x.device))
    return bufs


_PUNCH_ARGS = ("x", "env_in", "lane_in", "out", "env_out", "pre_fin",
               "pre_acc", "post_fin", "post_acc")


def punch_cuda_launch(bufs, params, sr: float):
    """Launch ``juicy_punch_stage`` (csrc/punch_stage.cu) on prepared
    buffers, on the current stream of their device; raises on a refused
    launch."""
    from juicy_tpu_torch.kernels import _build

    lib = _build.load_library()
    n, c, b = bufs["x"].shape
    consts = stage_scalars("punch", params, sr)
    device = bufs["x"].device
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.juicy_punch_stage(
            *(bufs[k].data_ptr() for k in _PUNCH_ARGS), b, c, n,
            consts.ctypes.data, consts.size, stream)
    if err != 0:
        raise RuntimeError(f"juicy_punch_stage launch failed: CUDA error "
                           f"{err} ({_build.error_string(lib, err)})")
    punch_stage_step.launches += 1
    check_kernel_outputs("juicy_punch_stage",
                         (bufs[k] for k in ("out", "env_out", *_LANE_BUFS)))


def _punch_lanes_cuda(x, dsp, lane0, params, sr: float):
    """The kernel route: layout, launch, unpack. Same contract as
    _punch_lanes_plain."""
    bufs = punch_cuda_buffers(x, dsp, lane0)
    punch_cuda_launch(bufs, params, sr)
    fast, slow = bufs["env_out"].unbind(0)
    return (bufs["out"].permute(2, 1, 0), {"fast_env": fast, "slow_env": slow},
            bufs["pre_fin"], bufs["pre_acc"], bufs["post_fin"],
            bufs["post_acc"])


def motion_cuda_buffers(x, dsp, lane0):
    """The motion kernel's inputs in its layout (``rng`` as int32 bits) and
    its outputs, as a dict of tensors."""
    bufs = dict(x=x.permute(2, 1, 0).contiguous(),                # [N, C, B]
                mono_in=torch.stack([dsp[k] for k in _motion.MONO_KEYS]),
                cd_in=dsp["onset_cooldown"].contiguous(),
                rng_in=_noise.u32_to_i32_bits(dsp["rng"]),
                chan_in=torch.stack([dsp[k] for k in _motion.CHAN_KEYS]),
                lane_in=lane0.contiguous())
    bufs.update({k + "_out": torch.empty_like(bufs[k + "_in"])
                 for k in ("mono", "cd", "rng", "chan")},
                out=torch.empty_like(bufs["x"]),
                **_lane_outputs(x.shape[0], x.device))
    return bufs


_MOTION_ARGS = ("x", "mono_in", "cd_in", "rng_in", "chan_in", "lane_in",
                "out", "mono_out", "cd_out", "rng_out", "chan_out", "pre_fin",
                "pre_acc", "post_fin", "post_acc")


def motion_cuda_launch(bufs, params, sr: float):
    """Launch ``juicy_motion_stage`` (csrc/motion_stage.cu) on prepared
    buffers, on the current stream of their device; raises on a refused
    launch."""
    from juicy_tpu_torch.kernels import _build

    lib = _build.load_library()
    n, c, b = bufs["x"].shape
    consts = stage_scalars("motion", params, sr)
    narrow = int(onepole_narrow(_motion.MAX_CUTOFF_HZ, sr))
    device = bufs["x"].device
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.juicy_motion_stage(
            *(bufs[k].data_ptr() for k in _MOTION_ARGS), b, c, n,
            _motion.cooldown_samples(sr), narrow, consts.ctypes.data,
            consts.size, stream)
    if err != 0:
        raise RuntimeError(f"juicy_motion_stage launch failed: CUDA error "
                           f"{err} ({_build.error_string(lib, err)})")
    motion_stage_step.launches += 1
    check_kernel_outputs("juicy_motion_stage", (bufs[k] for k in (
        "out", "mono_out", "chan_out", *_LANE_BUFS)))


def _motion_lanes_cuda(x, dsp, lane0, params, sr: float):
    """The kernel route: layout, launch, unpack. Same contract as
    _motion_lanes_plain."""
    bufs = motion_cuda_buffers(x, dsp, lane0)
    motion_cuda_launch(bufs, params, sr)
    new_dsp = dict(zip(_motion.MONO_KEYS, bufs["mono_out"].unbind(0)))
    new_dsp.update(zip(_motion.CHAN_KEYS, bufs["chan_out"].unbind(0)))
    new_dsp["onset_cooldown"] = bufs["cd_out"]
    new_dsp["rng"] = _noise.i32_bits_to_u32(bufs["rng_out"])
    return (bufs["out"].permute(2, 1, 0), new_dsp, bufs["pre_fin"],
            bufs["pre_acc"], bufs["post_fin"], bufs["post_acc"])


# state leaf -> (dtype, per-channel)
_STATE_SPECS = {
    "punch": {"fast_env": (F32, True), "slow_env": (F32, True)},
    "motion": {**{k: (F32, False) for k in _motion.MONO_KEYS},
               "onset_cooldown": (torch.int32, False),
               "rng": (torch.int64, False),
               **{k: (F32, True) for k in _motion.CHAN_KEYS}},
}


def _model_stage(name, lanes_fn, params, state, block, sr: float):
    """Check the block, the params and the state, run `lanes_fn`, finalize
    the two lanes."""
    if block.dtype != F32 or block.ndim != 3:
        raise ValueError(f"expected float32 block [B, C, N], got "
                         f"{block.dtype} {tuple(block.shape)}")
    b, c, n = block.shape
    if c not in (1, 2) or n == 0 or b == 0:
        raise ValueError(f"unsupported block shape {tuple(block.shape)}")
    for key, v in params.items():
        if torch.as_tensor(v).ndim:
            raise ValueError(f"the stage kernel takes one setting per call; "
                             f"param {key!r} is batched")
    dsp = state["dsp"]
    for key, (dtype, per_chan) in _STATE_SPECS[name].items():
        t, shape = dsp[key], ((b, c) if per_chan else (b,))
        if tuple(t.shape) != shape or t.dtype != dtype or t.device != block.device:
            raise ValueError(f"{name} state {key!r} must be {dtype} {shape} "
                             f"on the block's device")
    lane0 = pack_lane(state["analyzer"], b)
    if lane0.device != block.device:
        raise ValueError("analyzer state must be on the block's device")
    out, new_dsp, pre_fin, pre_acc, post_fin, post_acc = lanes_fn(
        block, dsp, lane0, params, sr)
    post_state, m, _pre = metrics_from_lanes(pre_fin, pre_acc, post_fin,
                                             post_acc, state["analyzer"], n, sr)
    return out, {"analyzer": post_state, "dsp": new_dsp}, m


def punch_stage_step_plain(params, state, block, sr: float):
    """The punch stage step as plain PyTorch, on any device."""
    return _model_stage("punch", _punch_lanes_plain, params, state, block, sr)


def punch_stage_step(params, state, block, sr: float):
    """Full punch step (pre-analyze → DSP → post-analyze) in one kernel
    launch for a CUDA `block`; the plain version for a CPU `block`."""
    if block.device.type == "cuda":
        return _model_stage("punch", _punch_lanes_cuda, params, state, block,
                            sr)
    if block.device.type == "cpu":
        return punch_stage_step_plain(params, state, block, sr)
    raise ValueError(f"no punch stage kernel for device {block.device}")


#: kernel launches made by punch_stage_step (CUDA tensors only)
punch_stage_step.launches = 0


def motion_stage_step_plain(params, state, block, sr: float):
    """The motion stage step as plain PyTorch, on any device."""
    return _model_stage("motion", _motion_lanes_plain, params, state, block,
                        sr)


def motion_stage_step(params, state, block, sr: float):
    """Full motion step (pre-analyze → pass 1 → pass 2 on channel 0 then
    channel 1 → post-analyze) in one kernel launch for a CUDA `block`; the
    plain version for a CPU `block`."""
    if block.device.type == "cuda":
        return _model_stage("motion", _motion_lanes_cuda, params, state,
                            block, sr)
    if block.device.type == "cpu":
        return motion_stage_step_plain(params, state, block, sr)
    raise ValueError(f"no motion stage kernel for device {block.device}")


#: kernel launches made by motion_stage_step (CUDA tensors only)
motion_stage_step.launches = 0


# ---------------------------------------------------------------------------
# Launch geometry of the warp-role kernels, read off the card
# ---------------------------------------------------------------------------

#: the fields a geometry entry (juicy_*_geometry) writes, in its order
GEOMETRY_KEYS = ("clips_per_cta", "warps_per_cta", "threads_per_cta",
                 "smem_bytes_per_cta", "ctas_per_sm", "registers_per_thread",
                 "local_bytes_per_thread", "chunk_samples")


def read_geometry(entry: str, *args: int, device=None) -> Dict[str, int]:
    """Call the geometry entry `entry` of the kernel library with `args`:
    clips and warps per CTA, its shared memory, the CTAs resident per SM
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``), and the registers
    and local (spill) bytes per thread (``cudaFuncGetAttributes``)."""
    import ctypes

    from juicy_tpu_torch.kernels import _build

    lib = _build.load_library()
    g = (ctypes.c_int * len(GEOMETRY_KEYS))()
    with torch.cuda.device(device):
        err = getattr(lib, entry)(*(int(v) for v in args), g)
    if err != 0:
        raise RuntimeError(f"{entry} failed: CUDA error {err} "
                           f"({_build.error_string(lib, err)})")
    return dict(zip(GEOMETRY_KEYS, g))


def saturator_geometry(n: int, channels: int = 2,
                       device=None) -> Dict[str, int]:
    """The saturator stage kernel's geometry for block size `n`."""
    return read_geometry("juicy_saturator_geometry", channels, n,
                         device=device)


def motion_geometry(n: int, channels: int = 2, device=None) -> Dict[str, int]:
    """The motion stage kernel's geometry for block size `n`."""
    return read_geometry("juicy_motion_geometry", channels, n, device=device)


def punch_geometry(n: int, channels: int = 2, device=None) -> Dict[str, int]:
    """The punch stage kernel's geometry for block size `n`."""
    return read_geometry("juicy_punch_geometry", channels, n, device=device)


def texture_geometry(mode: int, n: int, channels: int = 2,
                     device=None) -> Dict[str, int]:
    """The texture stage kernel's geometry for material `mode` and block
    size `n`."""
    return read_geometry("juicy_texture_geometry", mode, channels, n,
                         device=device)


def texture_mixed_geometry(modes, n: int, channels: int = 2,
                           device=None) -> Dict[str, int]:
    """The mixed texture kernel's geometry for a launch holding the
    materials `modes` and block size `n`: its registers are the largest of
    the five bodies', its shared memory the largest of `modes`'."""
    mask = sum(1 << m for m in set(modes))
    return read_geometry("juicy_texture_mixed_geometry", mask, channels, n,
                         device=device)
