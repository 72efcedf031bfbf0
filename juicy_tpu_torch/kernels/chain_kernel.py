"""The seven-stage chain in one kernel launch per block: PyTorch port of
juicy_tpu/kernels/chain_kernel.py (``chain_kernel_step``,
``chain_kernel_stream``, ``_finalize_block``, ``_finalize_stream``).

The chain is the canonical one, punch → saturator → texture → motion →
width → cohere → infer (``CHAIN_ORDER``), stereo, with one static texture
material or a material per clip; ``supports_chain_kernel`` says whether a
``Chain`` is such a chain.
``chain_kernel_step(chain, states, block)`` and ``chain_kernel_stream(chain,
states, clips, metrics, return_audio)`` keep the JAX contracts: per-stage
states in the ``Chain`` form in and out, ``(out, new_states, per-stage
metrics)`` with metrics leaves ``[B]`` (step) or ``[nb, B]`` (stream, or
the last block only under ``metrics="final"``, or None under ``"none"``).

For CUDA tensors each block is one launch of ``csrc/chain.cu``
(``KernelChain``; 32 clips per CTA, each clip's chain across twelve warps
with their own roles, ``chain_geometry``): the state goes to kernel form once per call (texture's
ring time-major ``[L, C, B]``, the LCG states as int32 bits, the Haas window
as a ring ``[D, B]``, the analyzer states as the post-lane rows the first
block's pre lanes start from), stays on the card and is updated in place,
and comes back once. The stream permutes the corpus to ``[T, C, B]`` once and
back once, and writes each block's 14 lanes (7 analyzers × pre/post) into
stacked ``fin [nb, 14, 5, B]`` / ``acc [nb, 14, 10, B]``. For CPU tensors the
plain version runs (``chain_block_plain``): each model's ``process`` between a
serial pre lane and a serial post lane, in chain order, on the ``Chain``
state form: the kernel's function in the kernel's lane order. Any other
device raises, and neither route gives way to the other.

Then the score formulas: ``finalize_stream`` once over all 14 lanes × nb
blocks (the step's too, over nb = 1), with the repetition/fatigue EMA pair
run serially over 2·nb steps for all seven analyzers at once (``ema_scan``:
one launch of ``csrc/finalize.cu`` for CUDA lanes, the plain walk for CPU
lanes), so that the stream's metrics are bit-equal to ``finalize_block``
applied block by block.
(JAX's stream path reassociates that EMA with an associative scan, about
1e-6 from the serial order.)

Per-clip parameters (``chain_kernel_step(params_rows=)``, the serving
pool's per-slot knobs): ``ParamRows`` turns one dict per stage with [B]
leaves into a [B, N_CONSTS] constant table of cached ``chain_constants``
rows, edited one row at a time, and the kernel reads clip b's row at
``b * N_CONSTS``. No
edit is structural: the Haas and waveguide delays are per-thread values,
checked row by row. The plain version runs once per distinct row, on that
row's clips, and scatters back; the finalize takes each clip's params.

Per-clip texture materials (a texture stage ``with_traced("material")``
whose ``material`` is a [B] row): the launch takes a material per CTA of
32 clips (``juicy_chain_block_mixed``), each clip reading its own constant
row (a ``ParamRows`` of the chain's params), so the stream first sorts the
clips by material into runs padded to 32 and puts the results back after
(``_ordered``, ``stage_kernels.material_order``). Per-block automation
(``chain_kernel_stream(automation=)``) makes a table of constant rows, one
per block (``block_tables``), and points each launch at its block's.
"""

from __future__ import annotations

import copy
import functools
from typing import Dict, List, Sequence

import numpy as np
import torch

from juicy_tpu_torch import analyzer as _an
from juicy_tpu_torch.kernels import stage_kernels as sk
from juicy_tpu_torch.models import cohere as _cohere
from juicy_tpu_torch.models import motion as _motion
from juicy_tpu_torch.models import texture as _tex
from juicy_tpu_torch.models import width as _width
from juicy_tpu_torch.ops import noise as _noise
from juicy_tpu_torch.ops.precise import F32, f32, onepole_narrow
from juicy_tpu_torch.runtime.chain_fused import block_params, chain_automation
from juicy_tpu_torch.runtime.observe import check_kernel_outputs, span
from juicy_tpu_torch.runtime.plugin import _default_finalize
from juicy_tpu_torch.utils.convert import db_to_gain, jmap

CHAIN_ORDER = ("punch", "saturator", "texture", "motion", "width",
               "cohere", "infer")
#: analyzer lanes per block: stage i's pre lane is slot 2i, its post 2i + 1
N_LANES = 2 * len(CHAIN_ORDER)
#: floats per stage in a constant row (csrc/chain.cu's offsets)
_TEX_CONSTS = 16 + 25
_OFF_TEX = 7 + 13 + 5
_OFF_WIDTH = _OFF_TEX + _TEX_CONSTS + 24
N_CONSTS = _OFF_WIDTH + 15
#: a row's Haas delay in whole samples, and wood's and plastic's waveguide
#: delay (tex_param_list: 16 common, a1, a2 and gains of the four modes)
_HAAS_DELAY = _OFF_WIDTH + 4
_WAVE_DELAY = _OFF_TEX + 16 + 12


class ChainKernelUnsupported(ValueError):
    """Raised when a chain cannot run on the chain kernel."""


def _check_chain(chain):
    """The chain's texture material: a static int, or the per-clip
    materials [B] (int64, on the CPU) of a texture stage whose `material`
    is a row (``Plugin.with_traced("material")``); ChainKernelUnsupported
    when the chain is not the kernel's."""
    names = tuple(p.defn.name for p in chain.plugins)
    if names != CHAIN_ORDER:
        raise ChainKernelUnsupported(f"stage order {names} != {CHAIN_ORDER}")
    if chain.channels != 2:
        raise ChainKernelUnsupported("the chain kernel is stereo-only")
    for i, (plug, params) in enumerate(zip(chain.plugins, chain.params)):
        for key, v in params.items():
            ndim = torch.as_tensor(v).ndim
            if ndim and not (i == 2 and key == "material" and ndim == 1):
                raise ChainKernelUnsupported(
                    f"{plug.defn.name} param {key!r} is batched: the chain "
                    f"kernel takes one setting per stage (and per-clip "
                    f"texture materials)")
    return _tex.material_mode(chain.plugins[2].full_params(chain.params[2]))


def supports_chain_kernel(chain) -> bool:
    try:
        _check_chain(chain)
        return True
    except ChainKernelUnsupported:
        return False


# ---------------------------------------------------------------------------
# Constants: one float32 row, every stage's in chain order (csrc/chain.cu)
# ---------------------------------------------------------------------------

def back_param_list(params, sr: float, n: int):
    """The back half's constants as f32 Python floats, in JAX's
    ``_back_pvec`` order (after its lane constants): width, the mono-safety
    limit, mix, output gain, the Haas delay in whole samples; cohere's
    220/2400 Hz coefficients, match, learn, decay, tail, mix, output gain;
    infer's trim gain; 1/n. `params` are the seven stages' full params."""
    w, co, inf = params[4], params[5], params[6]
    vals = [w["width"], jmap(w["monoSafe"], 1.0, 0.35), w["mix"],
            db_to_gain(w["output"]), _width.delay_samples(w["haasMs"], sr),
            *_cohere.band_coeffs(sr), co["match"], co["learn"], co["decay"],
            co["tail"], co["mix"], db_to_gain(co["output"]),
            db_to_gain(inf["trim"]), 1.0 / max(1, n)]
    return [f32(float(v)) for v in vals]


def _full_params(chain, params=None):
    params = chain.params if params is None else params
    return [p.full_params(pr) for p, pr in zip(chain.plugins, params)]


def _chain_key(chain, params=None):
    return tuple(tuple(sorted((k, float(v)) for k, v in full.items()))
                 for full in _full_params(chain, params))


@functools.lru_cache(maxsize=4096)      # a serving pool's distinct settings
def _constants_cached(key, sr: float, n: int) -> np.ndarray:
    params = [{k: torch.tensor(f32(v), dtype=F32) for k, v in stage}
              for stage in key]
    mode = max(0, min(4, _tex.static_material(params[2])))
    tex = sk.tex_param_list(params[2], sr, mode)
    vals = (list(sk._lane_consts(sr)) + sk.punch_param_list(params[0], sr)
            + list(sk._sat_scalars(params[1], sr)[7:])
            + tex + [0.0] * (_TEX_CONSTS - len(tex))
            + sk.motion_param_list(params[3], sr)
            + back_param_list(params, sr, n))
    if len(vals) != N_CONSTS:
        raise AssertionError(f"{len(vals)} chain constants, expected "
                             f"{N_CONSTS}")
    arr = np.asarray(vals, dtype=np.float32)
    arr.setflags(write=False)
    return arr


def chain_constants(chain) -> np.ndarray:
    """Every stage's constants as one float32 array in csrc/chain.cu's
    order: the 7 lane constants, punch's (``punch_param_list``), the
    saturator's (``_sat_scalars``), texture's (``tex_param_list``, padded to
    41), motion's (``motion_param_list``), then ``back_param_list``. Worked
    out once per (params, sr, block size) and cached."""
    return _constants_cached(_chain_key(chain), chain.sr, chain.block_size)


@functools.lru_cache(maxsize=32)
def _constants_on(key, sr: float, n: int, device: str) -> torch.Tensor:
    return torch.tensor(_constants_cached(key, sr, n), device=device)


def check_rows(rows: np.ndarray, D: int, L: int, wave):
    """Raise ChainKernelUnsupported unless every constant row [R, N_CONSTS]
    keeps its delays inside the kernel's rings: 0 <= Haas delay < D (the
    ring is read `delay` behind its head after the write) and, for wood and
    plastic, 0 <= waveguide delay <= L - 2 (the model's own clamp). `wave`:
    whether the rows are wood's or plastic's, or a mask [R] of those that
    are."""
    rows = rows.reshape(-1, N_CONSTS)
    haas = rows[:, _HAAS_DELAY]
    bad = (haas < 0) | (haas >= D)
    if bad.any():
        raise ChainKernelUnsupported(
            f"Haas delay of {int(haas[bad][0])} samples outside the window "
            f"of {D}")
    wave = np.resize(np.asarray(wave, bool), len(rows))
    if wave.any():
        delay = rows[wave, _WAVE_DELAY]
        bad = (delay < 0) | (delay > L - 2)
        if bad.any():
            raise ChainKernelUnsupported(
                f"waveguide delay of {float(delay[bad][0])} samples outside "
                f"the ring of {L}")


def _unique_rows(mat: np.ndarray):
    """``np.unique(mat, axis=0, return_index=True, return_inverse=True)``
    of a float32 table [B, K] in some order, the rows compared as bytes over
    the columns that vary: one sort of B keys (the row-wise sort takes
    ~0.1 s for a few thousand rows)."""
    vary = np.flatnonzero((mat != mat[:1]).any(axis=0))
    if not len(vary):
        return mat[:1], np.zeros(1, np.int64), np.zeros(len(mat), np.int64)
    keys = np.ascontiguousarray(mat[:, vary]).view(
        np.dtype((np.void, mat.itemsize * len(vary)))).reshape(-1)
    _keys, first, inverse = np.unique(keys, return_index=True,
                                      return_inverse=True)
    return mat[first], first, inverse.reshape(-1)


class ParamRows:
    """Per-clip parameters in the chain kernel's form. `params_rows` holds
    one dict per stage with the keys of ``chain.params``, each leaf [B] or a
    scalar (broadcast): the shape of a serving pool's per-slot rows.

    - ``consts`` [B, N_CONSTS]: each clip's ``chain_constants`` row, from
      the same cache, so a row equal to the chain's shared setting is that
      row bit for bit; ``table(device)`` is it on a device;
    - ``set_row(j, values)``: one clip's edit, its row worked out alone and
      written in place into the host table and every device copy (a
      serving pool's knob turn costs one row, whatever the pool holds);
    - ``groups``: (the per-stage params of one setting, its clip indices),
      for the plain version, worked out when asked;
    - ``full_on(device)``: each stage's full params with [B] leaves, for
      the score formulas (infer's sensitivity)."""

    def __init__(self, chain, params_rows, b: int):
        if len(params_rows) != len(chain.plugins):
            raise ValueError(f"{len(params_rows)} stages of params rows for "
                             f"a chain of {len(chain.plugins)}")
        self.b = b
        self._chain = chain
        cols, self._names = [], []
        for i, (shared, rows) in enumerate(zip(chain.params, params_rows)):
            if set(rows) != set(shared):
                raise ValueError(f"stage {i} rows have keys {sorted(rows)}, "
                                 f"expected {sorted(shared)}")
            for key in sorted(rows):
                v = torch.as_tensor(rows[key], dtype=F32).detach().cpu()
                if v.ndim > 1 or (v.ndim == 1 and v.shape[0] != b):
                    raise ValueError(f"stage {i} param {key!r} has shape "
                                     f"{tuple(v.shape)}, expected () or "
                                     f"({b},)")
                cols.append(np.broadcast_to(v.numpy(), (b,)))
                self._names.append((i, key))
        self._col = {name: j for j, name in enumerate(self._names)}
        self._mat = np.stack(cols, axis=1)                 # [B, K] float32
        uniq, _first, inverse = _unique_rows(self._mat)
        self.consts = np.stack([self._row_consts(row)
                                for row in uniq])[inverse]
        self._groups = None
        self._on = {}

    def _stage_params(self, row):
        params = [{} for _ in self._chain.plugins]
        for (i, key), v in zip(self._names, row):
            params[i][key] = float(v)
        return params

    def _row_consts(self, row) -> np.ndarray:
        key = tuple(tuple(sorted((k, float(v))
                                 for k, v in plug.full_params(p).items()))
                    for plug, p in zip(self._chain.plugins,
                                       self._stage_params(row)))
        return _constants_cached(key, self._chain.sr, self._chain.block_size)

    def set_row(self, j: int, values) -> None:
        """Clip `j`'s params: `values` holds one dict per stage of the keys
        to set (the others keep theirs). Its constant row is worked out
        alone and written in place, behind the launches already made on the
        card's stream."""
        row = self._mat[j].copy()
        for i, upd in enumerate(values):
            for key, v in upd.items():
                if (i, key) not in self._col:
                    raise KeyError(f"stage {i} has no parameter {key!r}")
                row[self._col[(i, key)]] = v
        consts = self._row_consts(row)
        self._mat[j], self.consts[j] = row, consts
        for dev, (table, mat, _full) in self._on.items():
            for dst, src in ((table, consts), (mat, row)):
                src = torch.tensor(src)
                if dst.device.type == "cuda":
                    dst[j].copy_(src.pin_memory(), non_blocking=True)
                else:
                    dst[j] = src
        self._groups = None

    @property
    def groups(self):
        if self._groups is None:
            uniq, _first, inverse = _unique_rows(self._mat)
            order = np.argsort(inverse, kind="stable")
            split = np.cumsum(np.bincount(inverse, minlength=len(uniq)))[:-1]
            self._groups = [
                ([{k: torch.tensor(v, dtype=F32) for k, v in p.items()}
                  for p in self._stage_params(row)], torch.from_numpy(idx))
                for row, idx in zip(uniq, np.split(order, split))]
        return self._groups

    def column(self, stage: int, key: str) -> np.ndarray:
        """The rows' values of one stage's param, [B]."""
        return self._mat[:, self._col[(stage, key)]]

    def block_consts(self, curves, nb: int):
        """Per-block automation of these rows: (consts [nb, U, N_CONSTS],
        block i's U distinct rows with every curve's value at i in place of
        their own, each worked out once through the constants cache; the
        distinct row of each clip [B]; a clip of each distinct row [U]).
        `curves`: {(stage, key): [nb]} (chain_automation)."""
        uniq, first, inverse = _unique_rows(self._mat)
        cols = [(self._col[name], v) for name, v in curves.items()]
        consts = np.empty((nb, len(uniq), N_CONSTS), np.float32)
        for i in range(nb):
            rows = uniq.copy()
            for j, v in cols:
                rows[:, j] = float(v[i])
            consts[i] = [self._row_consts(row) for row in rows]
        return consts, inverse.reshape(-1), first

    def take(self, idx) -> "ParamRows":
        """These rows in the order of the clip indices `idx` (repeats
        allowed): a table of len(idx) clips."""
        rows = copy.copy(self)
        idx = np.asarray(idx)
        rows.b = len(idx)
        rows._mat, rows.consts = self._mat[idx], self.consts[idx]
        rows._groups, rows._on = None, {}
        return rows

    def _cached(self, device):
        dev = str(torch.device(device))
        if dev not in self._on:
            mat = torch.tensor(self._mat, device=dev)
            self._on[dev] = (torch.tensor(self.consts, device=dev), mat, [
                plug.full_params({key: mat[:, j] for j, (i, key)
                                  in enumerate(self._names) if i == s})
                for s, plug in enumerate(self._chain.plugins)])
        return self._on[dev]

    def table(self, device) -> torch.Tensor:
        return self._cached(device)[0]

    def full_on(self, device):
        return self._cached(device)[2]


def _as_rows(chain, params_rows, b: int):
    if params_rows is None or isinstance(params_rows, ParamRows):
        if params_rows is not None and params_rows.b != b:
            raise ValueError(f"params rows for {params_rows.b} clips, "
                             f"block of {b}")
        return params_rows
    return ParamRows(chain, params_rows, b)


# ---------------------------------------------------------------------------
# Kernel form of the chain state and the launch
# ---------------------------------------------------------------------------

def _leaf(t, shape, dtype, device, name):
    """A private contiguous copy of a state leaf, checked."""
    t = torch.as_tensor(t)
    if tuple(t.shape) != shape or t.dtype != dtype or t.device != device:
        raise ValueError(f"chain state {name!r} must be {dtype} {shape} on "
                         f"{device}, got {t.dtype} {tuple(t.shape)} on "
                         f"{t.device}")
    return t.clone(memory_format=torch.contiguous_format)


def lane_seed(an_states, b: int, device) -> torch.Tensor:
    """The lanes a first block's pre lanes start from, ``[14, 5, B]``: each
    analyzer state's carry rows (``pack_lane``) at its post-lane slot."""
    seed = torch.zeros((N_LANES, 5, b), dtype=F32, device=device)
    for i, st in enumerate(an_states):
        seed[2 * i + 1] = sk.pack_lane(st, b).to(device)
    return seed


#: KernelChain's state tensors and the axis of each that runs over clips
_CLIP_AXIS = {"punch_env": 1, "sat_tone": 0, "tex_dsp": 1, "tex_mat": 1,
              "tex_rng": 0, "tex_ring": 2, "mot_mono": 1, "mot_cd": 0,
              "mot_rng": 0, "mot_chan": 1, "haas": 1, "co_mono": 1,
              "co_tail": 0}


def kernel_mode(chain, rows: ParamRows = None):
    """The texture material the chain kernel runs: the chain's (_check_chain)
    or, for a texture stage whose material is a param (with_traced) and
    per-clip `rows`, the rows' materials [B]."""
    mode = _check_chain(chain)
    if rows is not None and "material" in chain.params[2]:
        return _tex.clip_materials({"material": rows.column(2, "material")})
    return mode


class KernelChain:
    """The chain's state in kernel form on the card, packed once per call,
    and the launch of ``juicy_chain_block`` (csrc/chain.cu) for one block.
    The state tensors are the wrapper's own copies, updated in place block
    after block; texture's ring write index and the Haas ring's write head
    are block-uniform host integers that advance by N per launch. Every
    clip reads the chain's one constant row, or its own row of a
    ``ParamRows`` table (``set_rows``).

    Per-clip texture materials (``kernel_mode``) launch
    ``juicy_chain_block_mixed``: a material per CTA of 32 clips, so the
    clips of each CTA must share theirs (``stage_kernels.cta_modes``), and
    each clip reads its own constant row (a ``ParamRows`` of the chain's
    params when no rows are given). The material state is the largest of
    the materials present, each clip's own leaves first
    (``stage_kernels.tex_mat_stack``); only the wave clips use the ring."""

    def __init__(self, chain, states: Sequence[Dict], b: int, device,
                 rows: ParamRows = None):
        self.mode = mode = kernel_mode(chain, rows)
        self.mixed = not isinstance(mode, int)
        self.n, self.sr, self.b = chain.block_size, chain.sr, b
        dev = torch.device(device)
        dsp = [st["dsp"] for st in states]
        bc, bb = (b, 2), (b,)
        pu, sa, mo, wi, co = dsp[0], dsp[1], dsp[3], dsp[4], dsp[5]
        self.punch_env = torch.stack([_leaf(pu[k], bc, F32, dev, k)
                                      for k in ("fast_env", "slow_env")])
        self.sat_tone = _leaf(sa["tone_state"], bc, F32, dev, "tone_state")
        # texture_kernel_state, stack and the leaves' copies leave the
        # caller's state untouched by the in-place updates
        tex = sk.texture_kernel_state(dsp[2], mode)
        self.tex_dsp = torch.stack([_leaf(tex[k], bc, F32, dev, k)
                                    for k in sk._TEX_DSP_KEYS])
        self.tex_mat = sk.tex_mat_stack(tex, mode)
        if (tuple(self.tex_mat.shape[1:]) != bc or self.tex_mat.dtype != F32
                or self.tex_mat.device != dev):
            raise ValueError(f"texture material state must be float32 "
                             f"{bc} on {dev}")
        self.tex_rng = _leaf(tex["rng"], bb, torch.int32, dev, "rng")
        self.L = _tex.waveguide_size(self.sr)
        self.wave = sk.tex_has_wave(mode)
        self.tex_ring = tex["waveguide"] if self.wave else None
        if self.wave and (tuple(self.tex_ring.shape) != (self.L, 2, b)
                          or self.tex_ring.dtype != F32
                          or self.tex_ring.device != dev):
            raise ValueError(f"texture ring must be float32 [B, 2, {self.L}] "
                             f"on {dev}")
        self.tex_widx = sk.wave_index(dsp[2], mode) if self.wave else 0
        # which clips' rows hold wood's or plastic's constants
        self.wave_clips = self.wave if not self.mixed else \
            ((mode == 2) | (mode == 3)).numpy()
        if self.mixed:
            self.cta, self.mask = sk.cta_modes(mode, b, dev)
            if rows is None:
                rows = ParamRows(chain, chain.params, b)
            self._own_rows = rows
        self.mot_mono = torch.stack([_leaf(mo[k], bb, F32, dev, k)
                                     for k in _motion.MONO_KEYS])
        self.mot_cd = _leaf(mo["onset_cooldown"], bb, torch.int32, dev,
                            "onset_cooldown")
        self.mot_rng = _noise.u32_to_i32_bits(
            _leaf(mo["rng"], bb, torch.int64, dev, "rng"))
        self.mot_chan = torch.stack([_leaf(mo[k], bc, F32, dev, k)
                                     for k in _motion.CHAN_KEYS])
        window = wi["haas_window"]
        self.D = window.shape[-1]
        self.haas = _leaf(window, (b, self.D), F32, dev, "haas_window").t() \
            .clone(memory_format=torch.contiguous_format)      # [D, B]
        self.haas_pos = 0
        self.co_mono = torch.stack([_leaf(co[k], bb, F32, dev, k) for k in (
            "analysis_low", "analysis_high", "target_low", "target_mid",
            "target_high")])
        self.co_tail = _leaf(co["tail"], bc, F32, dev, "tail")
        # the kernel's scratch: the six streams between the stages, each
        # [N, 2, B] and kept whole for the block (the post lanes read them
        # after their pre lanes), three in each buffer
        self.s0, self.s1 = (torch.empty((3, self.n, 2, b), dtype=F32,
                                        device=dev) for _ in range(2))
        self.jump = _noise.jump(self.n)
        self.cooldown = _motion.cooldown_samples(self.sr)
        self.narrow = int(onepole_narrow(_motion.MAX_CUTOFF_HZ, self.sr))
        self._key = None if self.mixed else _chain_key(chain)
        self.set_rows(rows)

    def set_rows(self, rows: ParamRows = None):
        """Every clip reads the chain's row (`rows` None: a clip stride of
        0; per-clip materials: the rows built from the chain), or clip b
        row b of `rows`' table (stride N_CONSTS). Every row's delays are
        checked (check_rows)."""
        dev = str(self.s0.device)
        if rows is None and self.mixed:
            rows = self._own_rows
        self.rows = rows
        if rows is None:
            check_rows(_constants_cached(self._key, self.sr, self.n)[None],
                       self.D, self.L, self.wave)
            self.consts = _constants_on(self._key, self.sr, self.n, dev)
            self.cstride = 0
        else:
            if rows.b != self.b:
                raise ValueError(f"params rows for {rows.b} clips, state of "
                                 f"{self.b}")
            if self.mixed and not np.array_equal(
                    _tex.clip_materials(
                        {"material": rows.column(2, "material")}), self.mode):
                raise ValueError("params rows' materials differ from the "
                                 "state's")
            check_rows(rows.consts, self.D, self.L, self.wave_clips)
            self.consts, self.cstride = rows.table(dev), N_CONSTS

    def clone(self) -> "KernelChain":
        """A copy whose state tensors are the copy's own."""
        kc = copy.copy(self)
        for name in (*_CLIP_AXIS, "s0", "s1"):
            v = getattr(self, name)
            if v is not None:
                setattr(kc, name, v.clone())
        return kc

    def write_clip(self, b: int, fresh: "KernelChain"):
        """Clip `b`'s column of every state tensor from the one-clip
        `fresh` (a fresh state packed). A fresh ring is zeros, whatever its
        head, so the block-uniform ring heads stay where they are."""
        for name, axis in _CLIP_AXIS.items():
            dst = getattr(self, name)
            if dst is not None:
                dst.select(axis, b).copy_(getattr(fresh, name).select(axis, 0))

    def launch(self, x, out, lane_prev, fin, acc, fit):
        """One block: x, out [N, 2, B] (time-major), lane_prev / fin
        [14, 5, B], acc [14, 10, B], fit [B] (the block's context fit), all
        contiguous float32 on the card. Raises on a refused launch."""
        from juicy_tpu_torch.kernels import _build

        lib = _build.load_library()
        for t in (x, out, lane_prev, fin, acc, fit):
            if not (t.is_contiguous() and t.dtype == F32
                    and t.device == self.s0.device):
                raise ValueError("chain kernel buffers must be contiguous "
                                 "float32 on the state's device")
        ptrs = [t.data_ptr() for t in (
            x, out, self.s0, self.s1, self.consts)]
        state = [None if t is None else t.data_ptr() for t in (
            self.punch_env, self.sat_tone, self.tex_dsp, self.tex_mat,
            self.tex_rng, self.tex_ring, self.mot_mono, self.mot_cd,
            self.mot_rng, self.mot_chan, self.haas, self.co_mono,
            self.co_tail, fit, lane_prev, fin, acc)]
        device = self.s0.device
        tail = (self.L, self.tex_widx, self.D, self.haas_pos, *self.jump,
                self.cooldown, self.narrow)
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            if self.mixed:
                entry = "juicy_chain_block_mixed"
                err = lib.juicy_chain_block_mixed(
                    *ptrs, self.cstride, N_CONSTS, *state, self.b, self.n,
                    self.mask, *tail, self.cta.data_ptr(), stream)
            else:
                entry = "juicy_chain_block"
                err = lib.juicy_chain_block(
                    *ptrs, self.cstride, N_CONSTS, *state, self.b, self.n,
                    self.mode, *tail, stream)
        if err != 0:
            raise RuntimeError(f"{entry} launch failed: CUDA error "
                               f"{err} ({_build.error_string(lib, err)})")
        chain_kernel_step.launches += 1
        check_kernel_outputs(entry, (out, fin, acc, fit))
        if self.wave:
            self.tex_widx = (self.tex_widx + self.n) % self.L
        self.haas_pos = (self.haas_pos + self.n) % self.D

    def unpack(self, states0, context_fit) -> List[Dict]:
        """The kernel-form state back in the ``Chain`` form: one dsp dict
        per stage (`context_fit` [B] is the last block's)."""
        tex = dict(states0[2]["dsp"])
        tex.update(zip(sk._TEX_DSP_KEYS, self.tex_dsp.unbind(0)))
        tex.update(sk.tex_mat_unstack(tex, self.tex_mat, self.mode))
        tex["rng"] = self.tex_rng
        if self.wave:
            tex["waveguide"] = self.tex_ring
            widx = torch.full_like(tex["wave_idx"], self.tex_widx)
            if self.mixed:      # the other clips' index never moves
                widx = torch.where(torch.from_numpy(self.wave_clips).to(
                    widx.device)[:, None], widx, tex["wave_idx"])
            tex["wave_idx"] = widx
        motion = dict(zip(_motion.MONO_KEYS, self.mot_mono.unbind(0)))
        motion.update(zip(_motion.CHAN_KEYS, self.mot_chan.unbind(0)))
        motion["onset_cooldown"] = self.mot_cd
        motion["rng"] = _noise.i32_bits_to_u32(self.mot_rng)
        a_low, a_high, t_low, t_mid, t_high = self.co_mono.unbind(0)
        fast, slow = self.punch_env.unbind(0)
        return [
            {"fast_env": fast, "slow_env": slow},
            {"tone_state": self.sat_tone},
            sk.texture_ring_state(tex, self.mode),
            motion,
            {"haas_window": torch.roll(self.haas, -self.haas_pos, 0).t()
             .contiguous()},
            {"target_low": t_low, "target_mid": t_mid, "target_high": t_high,
             "analysis_low": a_low, "analysis_high": a_high,
             "tail": self.co_tail, "context_fit": context_fit},
            dict(states0[6]["dsp"]),
        ]


def chain_geometry(mode: int, n: int, device=None) -> Dict[str, int]:
    """The chain kernel's launch geometry for texture material `mode` and
    block size `n` on the card (stage_kernels.read_geometry's fields)."""
    return sk.read_geometry("juicy_chain_geometry", mode, n, device=device)


def chain_mixed_geometry(n: int, device=None) -> Dict[str, int]:
    """The mixed kernel's (a material per CTA; its registers the largest of
    the five bodies') launch geometry for block size `n` on the card."""
    return sk.read_geometry("juicy_chain_mixed_geometry", n, device=device)


# ---------------------------------------------------------------------------
# The two routes over a run of blocks: (out, dsp states, fin, acc, fit)
# ---------------------------------------------------------------------------

def _lane_buffers(nb: int, b: int, device):
    return (torch.empty((nb, N_LANES, 5, b), dtype=F32, device=device),
            torch.empty((nb, N_LANES, 10, b), dtype=F32, device=device),
            torch.empty((nb, b), dtype=F32, device=device))


def _launch_blocks(kc, clips, an_states, return_audio: bool, tables=None):
    """Every block of `clips` [B, 2, T] through `kc`, one launch each, the
    first block's pre lanes seeded from `an_states`; with per-block
    constant `tables` ([nb, N_CONSTS], or [nb, B, N_CONSTS] with per-clip
    rows: automation) block i reads tables[i]. Returns (out [B, 2, T]
    or None, fin [nb, 14, 5, B], acc [nb, 14, 10, B], context fit
    [nb, B])."""
    b, _c, t = clips.shape
    nb = t // kc.n
    with span("juicy.chain.pack"):
        xt = clips.permute(2, 1, 0).contiguous()             # [T, 2, B]
        out_t = torch.empty_like(xt) if return_audio else None
        fin, acc, fit = _lane_buffers(nb, b, clips.device)
        prev = lane_seed(an_states, b, clips.device)
        # without audio every block's output goes to one scratch block
        sink = None if return_audio else torch.empty_like(xt[:kc.n])
    for i in range(nb):
        sl = slice(i * kc.n, (i + 1) * kc.n)
        if tables is not None:
            kc.consts = tables[i]
        kc.launch(xt[sl], out_t[sl] if return_audio else sink, prev, fin[i],
                  acc[i], fit[i])
        prev = fin[i]
    with span("juicy.chain.unpack"):
        out = out_t.permute(2, 1, 0).contiguous() if return_audio else None
    return out, fin, acc, fit


def block_tables(kc: KernelChain, chain, curves, nb: int) -> torch.Tensor:
    """Per-block automation as constant rows on `kc`'s device: block i's
    chain params with every curve's value at i, [nb, N_CONSTS] (each worked
    out once through the constants cache), or, where each clip reads its
    own row (``ParamRows``: per-clip materials or params), [nb, B, N_CONSTS]:
    each block's distinct rows, gathered by clip on the device. Every row's
    delays are checked (check_rows)."""
    device = kc.s0.device
    if kc.rows is not None:
        consts, inverse, first = kc.rows.block_consts(curves, nb)
        check_rows(consts, kc.D, kc.L,
                   np.resize(np.asarray(kc.wave_clips, bool), kc.b)[first])
        return torch.from_numpy(consts).to(device)[
            :, torch.from_numpy(inverse).to(device)]
    table = np.stack([_constants_cached(
        _chain_key(chain, block_params(chain, curves, i)), kc.sr, kc.n)
        for i in range(nb)])
    check_rows(table, kc.D, kc.L, kc.wave)
    return torch.from_numpy(table).to(device)


def _run_cuda(chain, states, clips, return_audio: bool, rows=None,
              curves=None):
    """The kernel route over every block of `clips` [B, 2, T]: one launch
    per block, with per-block constants under automation (`curves`,
    automation_curves). Returns (out [B, 2, T] or None, dsp states, fin
    [nb, 14, 5, B], acc [nb, 14, 10, B], context fit [nb, B])."""
    with span("juicy.chain.pack"):
        kc = KernelChain(chain, states, clips.shape[0], clips.device, rows)
        tables = block_tables(kc, chain, curves, clips.shape[-1] // kc.n) \
            if curves else None
    out, fin, acc, fit = _launch_blocks(
        kc, clips, [st["analyzer"] for st in states], return_audio, tables)
    with span("juicy.chain.unpack"):
        dsps = kc.unpack(states, fit[-1])
    return out, dsps, fin, acc, fit


def chain_block_plain(chain, dsps, lane_prev, block):
    """Plain PyTorch version of one kernel launch, on the ``Chain`` state
    form: for each stage in chain order its model's ``process`` between a
    serial pre lane over its input (started from the stage's post lane in
    `lane_prev` [14, 5, B]) and a serial post lane over its output. Returns
    (out, dsp states', fin [14, 5, B], acc [14, 10, B])."""
    x = block
    new, fins, accs = [], [], []
    for i, plug in enumerate(chain.plugins):
        p = plug.full_params(chain.params[i])
        y, dsp = plug.defn.process(p, dsps[i], x, chain.sr)
        pre_fin, pre_acc, post_fin, post_acc = sk._lanes_around(
            x, y, lane_prev[2 * i + 1], chain.sr)
        fins += [pre_fin, post_fin]
        accs += [pre_acc, post_acc]
        new.append(dsp)
        x = y
    return x, new, torch.stack(fins), torch.stack(accs)


def _run_plain(chain, states, clips, return_audio: bool, rows=None,
               curves=None):
    """The plain route over every block of `clips`; _run_cuda's contract.
    Under automation each block runs the chain with that block's params."""
    if rows is not None:
        return _run_plain_rows(chain, states, clips, return_audio, rows)
    b, _c, t = clips.shape
    n = chain.block_size
    nb = t // n
    fin, acc, fit = _lane_buffers(nb, b, clips.device)
    prev = lane_seed([st["analyzer"] for st in states], b, clips.device)
    dsps = [st["dsp"] for st in states]
    out = torch.empty_like(clips) if return_audio else None
    for i in range(nb):
        sl = slice(i * n, (i + 1) * n)
        blk_chain = chain
        if curves:
            blk_chain = copy.copy(chain)
            blk_chain.params = block_params(chain, curves, i)
        y, dsps, fin[i], acc[i] = chain_block_plain(blk_chain, dsps, prev,
                                                    clips[..., sl])
        fit[i] = dsps[5]["context_fit"]
        if return_audio:
            out[..., sl] = y
        prev = fin[i]
    return out, dsps, fin, acc, fit


def _run_plain_rows(chain, states, clips, return_audio: bool, rows):
    """The plain route with per-clip params. Clips are independent, so it
    runs once per distinct setting, on that setting's clips with its params
    as the chain's, and scatters the results back: the kernel's
    function."""
    b, _c, t = clips.shape
    fin, acc, fit = _lane_buffers(t // chain.block_size, b, clips.device)
    out = torch.empty_like(clips) if return_audio else None
    dsps = None
    for params, idx in rows.groups:
        idx = idx.to(clips.device)
        sub = copy.copy(chain)
        sub.params = params
        sub_states = [{g: {k: v[idx] for k, v in st[g].items()}
                       for g in ("analyzer", "dsp")} for st in states]
        o, d, fin[..., idx], acc[..., idx], fit[:, idx] = _run_plain(
            sub, sub_states, clips[idx], return_audio)
        if return_audio:
            out[idx] = o
        if dsps is None:
            dsps = [{k: v.new_empty((b, *v.shape[1:])) for k, v in dd.items()}
                    for dd in d]
        for whole, part in zip(dsps, d):
            for k, v in part.items():
                whole[k][idx] = v
    return out, dsps, fin, acc, fit


# ---------------------------------------------------------------------------
# Finalize: the score formulas over the lanes
# ---------------------------------------------------------------------------

def _finalize(chain, i, pre, post, fit, params_list=None):
    plug = chain.plugins[i]
    finalize = plug.defn.finalize_metrics or _default_finalize
    carry = {"context_fit": fit} if plug.defn.name == "cohere" else None
    params = plug.full_params(chain.params[i]) if params_list is None \
        else params_list[i]
    return finalize(params, pre, post, carry)


def finalize_block(chain, an_states, fin, acc, fit):
    """One block's lanes (fin [14, 5, B], acc [14, 10, B], context fit [B])
    -> (analyzer states', per-stage metrics): each stage's pre lane from its
    analyzer state, its post lane from the pre lane's, as Plugin.step. The
    form ``finalize_stream`` is held to, block by block."""
    n, sr = chain.block_size, chain.sr
    new_an, metrics = [], []
    for i, st in enumerate(an_states):
        pre_state, pre = sk.finalize_lane(fin[2 * i], acc[2 * i], st, n, sr)
        post_state, post = sk.finalize_lane(fin[2 * i + 1], acc[2 * i + 1],
                                            pre_state, n, sr)
        new_an.append(post_state)
        metrics.append(_finalize(chain, i, pre, post, fit))
    return new_an, metrics


def _lane_formulas(chain, fin, acc):
    """The score formulas of every lane of a stream (fin [nb, 14, 5, B],
    acc [nb, 14, 10, B]) at once: ``_an._lane_stateless``'s (metrics without
    the EMA fields, EMA inputs), leaves [nb, 14, B]."""
    n, sr = chain.block_size, chain.sr
    inv_n = f32(1.0 / n)

    def f(j):
        return fin[:, :, j]                               # [nb, 14, B]

    def a(j):
        return acc[:, :, j]

    return _an._lane_stateless(
        f(0), f(1), f(2), f(3), f(4), a(0), a(1), a(4), a(5), a(2), a(3),
        a(6), a(4), a(7), torch.sqrt(a(8) * inv_n), torch.sqrt(a(9) * inv_n),
        n, sr)


#: ema_scan's inputs, in its argument order, by their ``_lane_stateless`` keys
EMA_INPUTS = ("onset_rate", "crest_penalty", "harsh_penalty")


def ema_scan_plain(rep, fat, onset_rate, crest_penalty, harsh_penalty):
    """Plain PyTorch version of ``ema_scan``: the repetition/fatigue EMA
    pair walked serially over a stream's lanes, block by block, the pre
    lanes (slots 2i) then the post lanes (2i + 1), for every analyzer at
    once (``_an._ema_update`` per step). rep, fat [A, B] before the first
    block; the inputs [nb, 2A, B]. Returns (repetition_density,
    fatigue_risk [nb, 2A, B], rep, fat [A, B] after the last block)."""
    ema_in = dict(zip(EMA_INPUTS, (onset_rate, crest_penalty, harsh_penalty)))
    density, risk = torch.empty_like(onset_rate), torch.empty_like(onset_rate)
    for blk in range(onset_rate.shape[0]):
        for half in (0, 1):              # the pre lanes, then the post
            rep, fat, density[blk, half::2], risk[blk, half::2] = \
                _an._ema_update(rep, fat, {k: v[blk, half::2]
                                           for k, v in ema_in.items()})
    return density, risk, rep, fat


def _check_ema(rep, fat, *ema_in):
    for t in (rep, fat, *ema_in):
        if not (isinstance(t, torch.Tensor) and t.dtype == F32
                and t.is_contiguous() and t.device == rep.device):
            raise ValueError("ema_scan takes contiguous float32 tensors on "
                             "one device")
    if rep.ndim != 2 or fat.shape != rep.shape or 0 in rep.shape:
        raise ValueError(f"ema_scan: rep {tuple(rep.shape)} and fat "
                         f"{tuple(fat.shape)} must be one [A, B]")
    lanes, b = 2 * rep.shape[0], rep.shape[1]
    for t in ema_in:
        if t.ndim != 3 or t.shape[1:] != (lanes, b) or t.shape[0] == 0:
            raise ValueError(f"ema_scan: input {tuple(t.shape)}, expected "
                             f"[nb, {lanes}, {b}] with nb >= 1")


def ema_scan(rep, fat, onset_rate, crest_penalty, harsh_penalty):
    """The stream's repetition/fatigue EMA pair, ``ema_scan_plain``'s
    contract: for CUDA tensors one launch of ``juicy_ema_scan``
    (csrc/finalize.cu; a thread per analyzer and clip walks the 2·nb steps)
    on the tensors' card's current stream, for CPU tensors the plain
    version. ValueError, before any launch, unless every argument is
    contiguous float32 on one device in the shapes of the contract."""
    _check_ema(rep, fat, onset_rate, crest_penalty, harsh_penalty)
    if rep.device.type == "cpu":
        return ema_scan_plain(rep, fat, onset_rate, crest_penalty,
                              harsh_penalty)
    if rep.device.type != "cuda":
        raise ValueError(f"no EMA kernel for device {rep.device}")
    from juicy_tpu_torch.kernels import _build

    density, risk = torch.empty_like(onset_rate), torch.empty_like(onset_rate)
    rep1, fat1 = torch.empty_like(rep), torch.empty_like(fat)
    lib = _build.load_library()
    with torch.cuda.device(rep.device):
        stream = torch.cuda.current_stream(rep.device).cuda_stream
        err = lib.juicy_ema_scan(
            onset_rate.data_ptr(), crest_penalty.data_ptr(),
            harsh_penalty.data_ptr(), rep.data_ptr(), fat.data_ptr(),
            density.data_ptr(), risk.data_ptr(), rep1.data_ptr(),
            fat1.data_ptr(), onset_rate.shape[0], rep.shape[0], rep.shape[1],
            stream)
    if err != 0:
        raise RuntimeError(f"juicy_ema_scan launch failed: CUDA error {err} "
                           f"({_build.error_string(lib, err)})")
    ema_scan.launches += 1
    return density, risk, rep1, fat1


#: EMA kernel launches made by ema_scan (CUDA tensors only)
ema_scan.launches = 0


def finalize_stream(chain, an0, fin, acc, fit, params_list=None):
    """A stream's lanes (fin [nb, 14, 5, B], acc [nb, 14, 10, B], context
    fit [nb, B]) -> (analyzer states', per-stage metrics with leaves
    [nb, B]). The score formulas run once over all 14 lanes × nb blocks;
    the repetition/fatigue EMA pair runs serially over 2·nb steps (pre, then
    post, per block) for the seven analyzers at once (``ema_scan``: one
    kernel launch for CUDA lanes): bit-equal to ``finalize_block`` applied
    block by block. `params_list`: each stage's full params with [B] leaves
    (per-clip rows), where the chain's are not the clips'."""
    with span("juicy.finalize"):
        b = fin.shape[-1]
        mets, ema_in = _lane_formulas(chain, fin, acc)
        rep, fat = (torch.stack([torch.broadcast_to(st[key], (b,))
                                 for st in an0]).to(fin.device)
                    for key in ("repetition_ema", "fatigue_ema"))   # [7, B]
        density, risk, rep, fat = ema_scan(
            rep, fat, *(ema_in[k].contiguous() for k in EMA_INPUTS))
        new_an, metrics = [], []
        for i in range(len(an0)):
            pre, post = ({k: v[:, s] for k, v in mets.items()}
                         for s in (2 * i, 2 * i + 1))
            for m, s in ((pre, 2 * i), (post, 2 * i + 1)):
                m["repetition_density"] = density[:, s]
                m["fatigue_risk"] = risk[:, s]
            metrics.append(_finalize(chain, i, pre, post, fit, params_list))
            last = fin[-1, 2 * i + 1]
            new_an.append({"short_env": last[0], "long_env": last[1],
                           "low_state": last[2], "high_state": last[3],
                           "repetition_ema": rep[i], "fatigue_ema": fat[i],
                           "onset_cooldown": last[4].to(torch.int32)})
        return new_an, metrics


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def _check_input(chain, clips, what: str):
    if clips.dtype != F32 or clips.ndim != 3:
        raise ValueError(f"expected float32 {what} [B, 2, N], got "
                         f"{clips.dtype} {tuple(clips.shape)}")
    b, c, t = clips.shape
    n = chain.block_size
    if c != 2 or b == 0 or t == 0 or t % n:
        raise ValueError(f"{what} {tuple(clips.shape)}: the chain kernel "
                         f"takes [B, 2, T] with T a positive multiple of the "
                         f"block size {n}")


def _route(clips):
    if clips.device.type == "cuda":
        return _run_cuda
    if clips.device.type == "cpu":
        return _run_plain
    raise ValueError(f"no chain kernel for device {clips.device}")


def _check_block(chain, block):
    _check_chain(chain)
    _check_input(chain, block, "block")
    if block.shape[-1] != chain.block_size:
        raise ValueError(f"block of {block.shape[-1]} samples, expected "
                         f"{chain.block_size}")


def _finalize_one(chain, an_states, fin, acc, fit, rows, device):
    """A one-block run's lanes through finalize_stream (nb = 1, bit-equal
    to finalize_block and far fewer small launches): (analyzer states',
    per-stage metrics with leaves [B])."""
    new_an, ms = finalize_stream(
        chain, an_states, fin, acc, fit,
        None if rows is None else rows.full_on(device))
    return new_an, [{k: v[0] for k, v in m.items()} for m in ms]


def _ordered(run, chain, states, clips, return_audio: bool, rows=None,
             curves=None):
    """`run` over `clips`; with per-clip materials that the CTAs do not
    share, over the clips sorted by material into runs of 32
    (stage_kernels.MaterialOrder: one gather of the clips, their states and
    rows before, one scatter of the outputs, states and lanes after; the
    padding never leaves). Same contract as `run`. The sorted route's two
    halves are the spans ``juicy.order.gather`` (the order's host sort
    among them) and ``juicy.order.scatter``."""
    mode = kernel_mode(chain, rows)
    if isinstance(mode, int) or sk.cta_uniform(mode):
        return run(chain, states, clips, return_audio, rows, curves)
    with span("juicy.order.gather"):
        order = sk.MaterialOrder(mode)
        b = clips.shape[0]
        sub = copy.copy(chain)
        sub.params = [order.tree(p, b) for p in chain.params]
        sub_states = [{g: order.tree(st[g], b) for g in ("analyzer", "dsp")}
                      for st in states]
        sub_rows = None if rows is None else rows.take(order.take.numpy())
        sub_clips = order.clips(clips)
    out, dsps, fin, acc, fit = run(sub, sub_states, sub_clips, return_audio,
                                   sub_rows, curves)
    with span("juicy.order.scatter"):
        bp = len(order.take)
        return (None if out is None else order.scatter(out),
                [order.tree(d, bp, scatter=True) for d in dsps],
                order.scatter(fin, -1), order.scatter(acc, -1),
                order.scatter(fit, -1))


def _automated_params(chain, rows, curves, device):
    """Each stage's full params for the score formulas over [nb, B]
    metrics: the rows' [B] leaves (or the chain's), each automated param
    its curve [nb, 1]."""
    params = [dict(p) for p in (_full_params(chain) if rows is None
                                else rows.full_on(device))]
    for (stage, key), v in curves.items():
        params[stage][key] = v.to(device)[:, None]
    return params


def _step(run, chain, states, block, params_rows):
    _check_block(chain, block)
    rows = _as_rows(chain, params_rows, block.shape[0])
    states = list(states)
    out, dsps, fin, acc, fit = _ordered(run, chain, states, block, True, rows)
    new_an, metrics = _finalize_one(chain, [st["analyzer"] for st in states],
                                    fin, acc, fit, rows, block.device)
    return out, [{"analyzer": a, "dsp": d} for a, d in zip(new_an, dsps)], \
        metrics


def kernel_chain_tick(kc: KernelChain, chain, an_states, block,
                      rows: ParamRows = None, return_audio: bool = True):
    """One block [B, 2, N] of a CUDA pool whose chain state lives in `kc`
    from call to call (updated in place; the serving tick): one launch of
    the chain kernel, each clip reading its row of `rows` when given.
    Returns (out [B, 2, N] or None, analyzer states', per-stage metrics with
    leaves [B]): ``chain_kernel_step``'s numbers."""
    _check_block(chain, block)
    if block.shape[0] != kc.b or block.device != kc.s0.device:
        raise ValueError(f"block of {block.shape[0]} clips on "
                         f"{block.device}, pool of {kc.b} on "
                         f"{kc.s0.device}")
    kc.set_rows(rows)
    out, fin, acc, fit = _launch_blocks(kc, block, an_states, return_audio)
    new_an, metrics = _finalize_one(chain, an_states, fin, acc, fit, rows,
                                    block.device)
    return out, new_an, metrics


def _stream(run, chain, states, clips, metrics: str, return_audio: bool,
            automation=None):
    if metrics not in ("blocks", "final", "none"):
        raise ValueError(f"metrics must be blocks, final or none; got "
                         f"{metrics!r}")
    _check_chain(chain)
    _check_input(chain, clips, "clips")
    if automation and "material" in automation.get(2, {}):
        raise ChainKernelUnsupported(
            "texture's material selects the kernel's code path and cannot "
            "be automated on the chain kernel")
    curves = chain_automation(chain, automation,
                              clips.shape[-1] // chain.block_size)
    states = list(states)
    out, dsps, fin, acc, fit = _ordered(run, chain, states, clips,
                                        return_audio, None, curves)
    new_an, ms = finalize_stream(
        chain, [st["analyzer"] for st in states], fin, acc, fit,
        _automated_params(chain, None, curves, clips.device) if curves
        else None)
    if metrics == "final":
        ms = [{k: v[-1] for k, v in m.items()} for m in ms]
    elif metrics == "none":
        ms = None
    return out, [{"analyzer": a, "dsp": d} for a, d in zip(new_an, dsps)], ms


def chain_kernel_step_plain(chain, states, block, params_rows=None):
    """The chain step as plain PyTorch, on any device."""
    return _step(_run_plain, chain, states, block, params_rows)


def chain_kernel_step(chain, states, block, params_rows=None):
    """One block [B, 2, N] through the whole chain: one launch of the chain
    kernel for a CUDA `block`, the plain version for a CPU `block`. Returns
    (out [B, 2, N], new states, per-stage metrics with leaves [B]), as
    ``fused_chain_step`` with metrics="blocks".

    `params_rows`: per-clip parameters, one dict per stage with the keys of
    ``chain.params`` and [B] (or scalar) leaves, or a ``ParamRows`` built
    from them; every stage's every knob may differ from clip to clip."""
    return _step(_route(block), chain, states, block, params_rows)


#: chain kernel launches made by chain_kernel_step and chain_kernel_stream
#: (CUDA tensors only)
chain_kernel_step.launches = 0


def chain_kernel_stream_plain(chain, states, clips, metrics: str = "blocks",
                              return_audio: bool = True, automation=None):
    """The chain stream as plain PyTorch, on any device."""
    return _stream(_run_plain, chain, states, clips, metrics, return_audio,
                   automation)


def chain_kernel_stream(chain, states, clips, metrics: str = "blocks",
                        return_audio: bool = True, automation=None):
    """A [B, 2, T] corpus through the chain block by block: one chain-kernel
    launch per block for CUDA `clips` (the state packed and the corpus
    permuted once each way), the plain version for CPU `clips`. Returns
    (out [B, 2, T] or None without `return_audio`, final states, per-stage
    metrics with leaves [nb, B], the last block's under "final", or None
    under "none"), as ``fused_chain_stream``.

    `automation`: {stage index: {param: curve}} with one value per block
    ([nb]): block i reads the constant row of the chain's params with the
    curves' values at i (a table [nb, N_CONSTS] made once, one row pointer
    per launch), and the score formulas take them per block. Texture's
    material cannot be automated (ChainKernelUnsupported). A texture stage
    with per-clip materials runs sorted by material (``_ordered``), one
    launch per block over the whole corpus."""
    return _stream(_route(clips), chain, states, clips, metrics, return_audio,
                   automation)
