"""Multi-stream realtime serving: a pool of live streams batched per tick.
PyTorch port of juicy_tpu/runtime/serve.py (``StreamServer``,
``TickHandle``), with the same public API.

A fixed pool of stream slots, each with its own full chain state and its own
parameter rows (``set_params`` / ``set_preset``: every DAW track running the
same insert chain with its own knobs). ``submit`` / ``submit_many`` write
each stream's [C, N] block into a persistent slot-major host buffer; every
``tick`` runs one batched step over all slots (idle slots process silence)
and returns each submitting stream's block and scores.

The tick's route:
- the canonical seven-stage chain (``supports_chain_kernel``) with
  ``metrics="blocks"`` takes the chain kernel: on a CUDA pool one launch of
  ``csrc/chain.cu`` per tick, the pool's state kept in kernel form from tick
  to tick (a ``KernelChain`` that lives as long as the server; no pack or
  unpack per tick); on a CPU pool its plain version (``chain_kernel_step``).
  Per-slot edits ride ``ParamRows``: each clip reads its own constant row,
  and an edit rewrites that one row in place, so every knob, the Haas
  delay and the texture knobs of a waveguide material included, stays on
  the kernel tick;
- any other chain or metrics mode takes ``fused_chain_step``, with [S]
  rows for the edited knobs.

Per-stream texture materials: a chain whose texture stage keeps `material`
as a param (``Plugin.with_traced("material")``) makes it a per-slot row
like any knob, and its pool ticks on ``fused_chain_step``, where texture's
traced model runs each slot's own material (as JAX's server sends such
pools to its fused executor). The mixed chain kernel wants the 32 slots of
each CTA to share a material; a tenant may change its material at any
tick and slots are claimed in any order, so keeping that would mean moving
slots' states between CTAs on edits and opens. That is not done here.

The pool lives on `device`: None is the card (and raises without one),
``"cpu"`` the plain routes. The assembly buffer stays on the host; a CUDA
pool copies it through pinned memory. With a `mesh` (parallel/mesh.py) of
K devices on its ``data`` axis the slots are split into K equal parts
(``max_streams`` must divide by K, ValueError otherwise, as JAX's server
raises): each part's state, kernel chain and constant rows live on its
device and tick there as one pool does, and the audio and scores are
gathered on the mesh's first device. A one-device mesh is one pool.
"""

from __future__ import annotations

from typing import Dict, Union

import numpy as np
import torch

from juicy_tpu_torch.kernels import chain_kernel as ck
from juicy_tpu_torch.ops.precise import F32
from juicy_tpu_torch.parallel.mesh import gather
from juicy_tpu_torch.runtime.chain_fused import fused_chain_step
from juicy_tpu_torch.runtime.device import on_device, resolve_device

_I16_SCALE = 32768.0


class _Pool:
    """One device's slots [lo, hi) of a server: their state (in Chain form,
    or on a CUDA kernel pool the analyzers in Chain form and every DSP
    state in a ``KernelChain``), the kernel tick's constant rows, and the
    step over them."""

    def __init__(self, srv, device, lo: int, hi: int):
        self.srv = srv
        self.lo, self.hi = lo, hi
        s = hi - lo
        self.device = device
        self.cuda = device.type == "cuda"
        if self.cuda and device.index is None:      # the tensors' own
            self.device = torch.device("cuda", torch.cuda.current_device())
        chain = srv.chain
        self.fresh = chain.init_state((1,), self.device)
        states = chain.init_state((s,), self.device)
        self.kc = None
        if srv._kernel_tick and self.cuda:
            with on_device(self.device):
                self.kc = ck.KernelChain(chain, states, s, self.device)
                self.fresh_kc = ck.KernelChain(chain, self.fresh, 1,
                                               self.device)
            states = [{"analyzer": st["analyzer"]} for st in states]
        self.states = states
        self.rows = None                # ParamRows, edited in place once built

    def reset_slot(self, sid: int) -> None:
        """Slot `sid`'s column of every state leaf from a fresh state."""
        sid -= self.lo
        for st, fresh in zip(self.states, self.fresh):
            for group, leaves in st.items():
                for key, v in leaves.items():
                    if not v.is_contiguous():   # a view: take a copy once
                        leaves[key] = v = v.contiguous()
                    v[sid] = fresh[group][key][0]
        if self.kc is not None:
            self.kc.write_clip(sid, self.fresh_kc)

    def write_row(self, sid: int, values) -> None:
        if self.rows is not None:
            self.rows.set_row(sid - self.lo, values)

    def param_rows(self):
        """The kernel tick's per-slot rows, built at their first use (the
        warmup's) and kept up to date edit by edit."""
        if self.rows is None:
            self.rows = ck.ParamRows(
                self.srv.chain,
                [{k: torch.from_numpy(v[self.lo:self.hi])
                  for k, v in rows.items()} for rows in self.srv._params],
                self.hi - self.lo)
        return self.rows

    def fused_params(self):
        """The fused tick's params: [S] rows for the edited knobs, the
        chain's shared values for the others."""
        srv = self.srv
        edited = set().union(*srv._custom_slots.values())
        params = [dict(p) for p in srv.chain.params]
        for i, k in edited:
            params[i][k] = torch.from_numpy(
                srv._params[i][k][self.lo:self.hi]).to(self.device)
        return params

    def step(self, states, kc, x, custom: bool):
        """One step over the pool from `states` (and `kc`): (out, states',
        per-stage metrics). Writes kc's state in place."""
        srv = self.srv
        chain = srv.chain
        with on_device(self.device):
            if kc is not None:
                an = [st["analyzer"] for st in states]
                out, an, ms = ck.kernel_chain_tick(
                    kc, chain, an, x, self.param_rows() if custom else None,
                    return_audio=srv.audio_out)
                return out, [{"analyzer": a} for a in an], ms
            if srv._kernel_tick:
                return ck.chain_kernel_step(
                    chain, states, x,
                    params_rows=self.param_rows() if custom else None)
            return fused_chain_step(chain, states, x, metrics=srv.metrics,
                                    params=self.fused_params() if custom
                                    else None)

    def blocks_in(self, blocks: np.ndarray) -> torch.Tensor:
        """The pool's rows of a host buffer on its device (a snapshot:
        later submits do not reach it), decoded to float32 on an i16
        wire."""
        blocks = blocks[self.lo:self.hi]
        if self.cuda:
            pinned = torch.empty(
                blocks.shape, pin_memory=True,
                dtype=torch.int16 if self.srv.wire == "i16" else F32)
            pinned.numpy()[...] = blocks
            x = pinned.to(self.device, non_blocking=True)
        else:
            x = torch.from_numpy(blocks.copy())
        if self.srv.wire == "i16":
            x = x.to(F32) * (1.0 / _I16_SCALE)
        return x

    def warmup(self, rows: bool) -> None:
        x = self.blocks_in(np.zeros_like(self.srv._assembly))
        for custom in (False, True) if rows else (False,):
            kc = None if self.kc is None else self.kc.clone()
            self.step(self.states, kc, x, custom)
        if self.cuda:
            torch.cuda.synchronize(self.device)

    def dispatch(self, custom: bool):
        out, self.states, metrics = self.step(
            self.states, self.kc, self.blocks_in(self.srv._assembly), custom)
        return out, metrics


class StreamServer:
    #: tick_arrays_async depth cap: dispatching past this resolves the
    #: oldest in-flight tick first
    MAX_INFLIGHT = 8

    def __init__(self, chain, max_streams: int, metrics: str = "blocks",
                 stage_metrics: str = "last", mesh=None, wire: str = "f32",
                 audio_out: bool = True, device=None):
        """`stage_metrics`: "last" returns the final stage's scores per
        tick, "all" every stage's metric dict per stream (``tick``).
        `wire`: "f32" moves float32 blocks both ways; "i16" moves 16-bit PCM
        (scale 32768), decoded and encoded on the pool's device, the
        processing float32. `audio_out=False` is the metering rail: ticks
        return scores only and the audio never leaves the device. `mesh`
        splits the slots over its ``data`` axis (``max_streams`` must
        divide by it); it replaces `device`."""
        if metrics not in ("blocks", "final", "none"):
            raise ValueError(f"metrics must be blocks, final or none; got "
                             f"{metrics!r}")
        if stage_metrics not in ("last", "all"):
            raise ValueError(f"stage_metrics must be last or all; got "
                             f"{stage_metrics!r}")
        if not audio_out and metrics != "blocks":
            raise ValueError("audio_out=False needs metrics='blocks' "
                             "(scores are the only output)")
        if wire not in ("f32", "i16"):
            raise ValueError(f"wire must be 'f32' or 'i16', got {wire!r}")
        if mesh is not None and device is not None:
            raise ValueError("pass a mesh or a device, not both")
        devices = ([resolve_device(device)] if mesh is None
                   else mesh.axis_devices("data"))
        self.chain = chain
        self.max_streams = s = int(max_streams)
        if s % len(devices):
            raise ValueError(f"max_streams {s} must be a multiple of the "
                             f"mesh's {len(devices)} devices")
        self.metrics = metrics
        self.stage_metrics = stage_metrics
        self.audio_out = bool(audio_out)
        self.wire = wire
        self._wire_np = np.int16 if wire == "i16" else np.float32
        self._free = list(range(s))[::-1]
        self._active: Dict[int, bool] = {}

        # per-stream materials (a traced material) tick on the executor
        traced = any(plug.defn.name == "texture" and "material" in params
                     for plug, params in zip(chain.plugins, chain.params))
        self._kernel_tick = metrics == "blocks" and not traced and \
            ck.supports_chain_kernel(chain)

        # per-slot parameter rows on the host, seeded from the chain's
        self._default_rows = [
            {k: np.full(s, float(v), np.float32) for k, v in p.items()}
            for p in chain.params]
        self._params = [{k: v.copy() for k, v in rows.items()}
                        for rows in self._default_rows]
        # slots whose rows differ from the defaults -> the (stage, key)
        # pairs they edited; while empty, ticks use the chain's shared row
        self._custom_slots: Dict[int, set] = {}

        # the persistent slot-major assembly buffer: submits write into it
        self._assembly = np.zeros((s, chain.channels, chain.block_size),
                                  self._wire_np)
        self._assembled_sids = np.empty(0, np.int64)
        self._staged: set = set()       # sids written since the last tick
        self._inflight: list = []       # tick_arrays_async queue

        # the pools: one per device, each a contiguous range of slots
        per = s // len(devices)
        self._pools = [_Pool(self, dev, i * per, (i + 1) * per)
                       for i, dev in enumerate(devices)]
        self.device = self._pools[0].device
        self._cuda = self._pools[0].cuda

    # -- stream lifecycle --------------------------------------------------

    def open_stream(self) -> int:
        """Claim a slot (fresh chain state + default params). Raises when
        the pool is full."""
        if not self._free:
            raise RuntimeError(f"all {self.max_streams} stream slots in use")
        sid = self._free.pop()
        self._reset_slot(sid)
        self._reset_params(sid)
        self._active[sid] = True
        return sid

    def close_stream(self, sid: int) -> None:
        if sid not in self._active:       # double close / never-opened sid
            raise KeyError(f"stream {sid} is not open")
        self._active.pop(sid, None)
        if sid in self._staged:           # staged but never ticked: keep the
            self._staged.discard(sid)     # pool clean (every row outside
            self._assembly[sid] = 0       # staged|assembled is silence)
        self._reset_params(sid)
        self._free.append(sid)

    def _pool(self, sid: int) -> _Pool:
        return self._pools[sid // (self.max_streams // len(self._pools))]

    def _reset_slot(self, sid: int) -> None:
        """Slot `sid`'s column of every state leaf from a fresh state."""
        self._pool(sid).reset_slot(sid)

    def _reset_params(self, sid: int) -> None:
        edited = self._custom_slots.pop(sid, None)
        if edited:
            # restore only the rows this tenant touched
            values = [{} for _ in self._params]
            for i, k in edited:
                values[i][k] = self._default_rows[i][k][sid]
            self._write_row(sid, values)

    @property
    def active_streams(self) -> int:
        return len(self._active)

    # -- per-stream parameters ---------------------------------------------

    def _stage_index(self, stage: Union[int, str]) -> int:
        if isinstance(stage, int):
            return stage
        for i, plug in enumerate(self.chain.plugins):
            if plug.defn.name == stage:
                return i
        raise KeyError(f"no stage named {stage!r} in this chain")

    def set_params(self, sid: int, stage: Union[int, str], **updates) -> None:
        """Set parameter values for ONE stream's instance of one stage (the
        per-track knob). Takes effect at the next tick."""
        if sid not in self._active:
            raise KeyError(f"stream {sid} is not open")
        i = self._stage_index(stage)
        rows = self._params[i]
        for key in updates:                # validate before any write
            if key not in rows:
                raise KeyError(f"stage {self.chain.plugins[i].defn.name!r} "
                               f"has no parameter {key!r}")
        values = [{} for _ in self._params]
        values[i] = {key: np.float32(v) for key, v in updates.items()}
        self._write_row(sid, values)
        self._custom_slots.setdefault(sid, set()).update(
            (i, key) for key in updates)

    def set_preset(self, sid: int, stage: Union[int, str],
                   preset: str) -> None:
        """Apply a named factory preset to one stream's stage."""
        i = self._stage_index(stage)
        values = {k: float(v)
                  for k, v in self.chain.plugins[i].preset(preset).items()}
        self.set_params(sid, i, **values)

    def get_params(self, sid: int, stage: Union[int, str]) -> Dict[str, float]:
        i = self._stage_index(stage)
        return {k: float(v[sid]) for k, v in self._params[i].items()}

    def _write_row(self, sid: int, values) -> None:
        """Slot `sid`'s new values (one dict per stage) into the host rows
        and, once they are built, its pool's constant table: one row
        worked out and written in place, whatever the pool holds."""
        self._pool(sid).write_row(sid, values)
        for i, upd in enumerate(values):
            for key, v in upd.items():
                self._params[i][key][sid] = v

    def _audio_out(self, out):
        if not self.audio_out or out is None:
            return None
        if self.wire == "i16":
            return torch.clamp(torch.round(out * _I16_SCALE), -32768.0,
                               32767.0).to(torch.int16)
        return out

    def warmup(self, rows: bool = True) -> None:
        """Build the kernel library and the constant rows, and run one tick
        of each route this pool can take (the shared params, and with
        `rows` the per-slot rows) over zeros on a copy of the state: slot
        states do not advance."""
        for pool in self._pools:
            pool.warmup(rows)

    def _to_wire(self, a: np.ndarray) -> np.ndarray:
        """A host block in the pool's wire type: on an i16 wire int16 passes
        as it is and floats are quantized as the device encoder does."""
        if self.wire == "i16":
            if a.dtype == np.int16:
                return a
            return np.clip(np.round(np.asarray(a, np.float32) * _I16_SCALE),
                           -32768.0, 32767.0).astype(np.int16)
        return np.asarray(a, np.float32)

    def submit(self, sid: int, block: np.ndarray) -> None:
        """Stage one [C, N] block for stream `sid` for the next tick."""
        if sid not in self._active:
            raise KeyError(f"stream {sid} is not open")
        block = np.asarray(block)
        expected = (self.chain.channels, self.chain.block_size)
        if block.shape != expected:
            raise ValueError(f"block shape {block.shape} != expected "
                             f"(channels, block_size) = {expected}")
        self._assembly[sid] = self._to_wire(block)
        self._staged.add(sid)

    def submit_many(self, sids, blocks) -> None:
        """Bulk submit: `sids` [K] stream ids, `blocks` [K, C, N], one
        fancy-index write."""
        sids = np.asarray(sids, np.int64)
        blocks = np.asarray(blocks)
        expected = (len(sids), self.chain.channels, self.chain.block_size)
        if blocks.shape != expected:
            raise ValueError(f"blocks shape {blocks.shape} != {expected}")
        for sid in sids.tolist():
            if sid not in self._active:
                raise KeyError(f"stream {sid} is not open")
        self._assembly[sids] = self._to_wire(blocks)
        self._staged.update(sids.tolist())

    def _assemble(self):
        """Seal the staged writes for one tick: the sorted submitted sids.
        Rows live last tick but not this one go back to silence."""
        sids = np.sort(np.fromiter(self._staged, np.int64, len(self._staged)))
        stale = np.setdiff1d(self._assembled_sids, sids, assume_unique=True)
        if stale.size:
            self._assembly[stale] = 0
        self._assembled_sids = sids
        self._staged.clear()
        return sids

    def _dispatch(self):
        """One step over the assembled pool, without waiting for it. Slot
        states advance here. Returns (out on the first pool's device or
        None, per-stage metrics)."""
        custom = bool(self._custom_slots)
        if len(self._pools) == 1:
            out, metrics = self._pools[0].dispatch(custom)
        else:
            res = [pool.dispatch(custom) for pool in self._pools]
            out = None if res[0][0] is None else gather([r[0] for r in res])
            metrics = [None if m is None else
                       {k: gather([r[1][i][k] for r in res]) for k in m}
                       for i, m in enumerate(res[0][1])]
        return self._audio_out(out), metrics

    def tick_arrays(self):
        """One step over every submitted block, bulk form: (sids [K]
        sorted, audio [K, C, N] or None, scores [K] or None, pre_scores [K]
        or None). Streams that submitted nothing process silence."""
        return self.tick_arrays_async().result()

    def tick_arrays_async(self) -> "TickHandle":
        """Dispatch one step without waiting; the handle's ``result()``
        gives what ``tick_arrays`` gives. The results are copied to pinned
        host memory behind the step on the card's stream. Slot state
        advances at dispatch, so submits between two async ticks land in
        the later one."""
        sids = self._assemble()
        out, metrics = self._dispatch()
        handle = TickHandle(self, sids, out, metrics)
        while len(self._inflight) >= self.MAX_INFLIGHT:
            self._inflight[0].result()
        self._inflight.append(handle)
        return handle

    def tick(self) -> Dict[int, Dict[str, np.ndarray]]:
        """One step over every submitted block: {stream id: {"audio":
        [C, N], "score": float, "pre_score": float[, "stages": [per-stage
        metric dicts]]}}. For many streams prefer tick_arrays."""
        sids = self._assemble()
        out, metrics = self._dispatch()
        sel = torch.from_numpy(sids).to(self.device)
        audio = None if out is None else out[sel].cpu().numpy()
        last = metrics[-1] if metrics else None
        host = {} if last is None else {
            k: last[k].cpu().numpy() for k in ("score", "pre_score")}
        stage_rows = None
        if self.stage_metrics == "all" and last is not None:
            stage_rows = [{k: v.cpu().numpy() for k, v in m.items()}
                          for m in metrics]
        results: Dict[int, Dict[str, np.ndarray]] = {}
        for k, sid in enumerate(sids.tolist()):
            entry = {} if audio is None else {"audio": audio[k]}
            if host:
                entry["score"] = float(host["score"][sid])
                entry["pre_score"] = float(host["pre_score"][sid])
            if stage_rows is not None:
                entry["stages"] = [{key: float(v[sid]) for key, v in row.items()}
                                   for row in stage_rows]
            results[sid] = entry
        return results


class TickHandle:
    """An in-flight tick from StreamServer.tick_arrays_async(). On a CUDA
    pool it holds pinned host copies enqueued behind the step and an event
    recorded after them; ``result()`` waits on the event and returns
    (sids, audio, scores, pre_scores) as tick_arrays() does."""

    __slots__ = ("_srv", "_sids", "_parts", "_event", "_res")

    def __init__(self, srv, sids, out, metrics):
        self._srv = srv
        self._sids = sids
        sel = torch.from_numpy(sids).to(srv.device)
        last = metrics[-1] if metrics else None
        parts = [None if out is None else out[sel]]
        parts += [None, None] if last is None else \
            [last["score"][sel], last["pre_score"][sel]]
        self._event = None
        if srv._cuda:
            host = []
            for p in parts:
                if p is not None:
                    h = torch.empty(p.shape, dtype=p.dtype, pin_memory=True)
                    h.copy_(p, non_blocking=True)
                    p = h
                host.append(p)
            parts = host
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(srv.device))
        self._parts = parts
        self._res = None

    def result(self):
        if self._res is None:
            if self._event is not None:
                self._event.synchronize()
            audio, scores, pre = (None if p is None else p.numpy()
                                  for p in self._parts)
            self._parts = self._event = None         # release the buffers
            self._res = (self._sids, audio, scores, pre)
            try:
                self._srv._inflight.remove(self)
            except ValueError:
                pass
        return self._res
