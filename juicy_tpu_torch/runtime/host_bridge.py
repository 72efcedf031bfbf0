"""Realtime host bridge: ring-buffered block streaming into the runtime.
PyTorch port of juicy_tpu/runtime/host_bridge.py.

The reference's plugins live inside a host audio callback, its thread
boundary a set of relaxed atomics. Here an audio host (or any producer)
pushes interleaved blocks into a lock-free SPSC ring (native/juicyio.cpp);
the bridge pops them, steps the plugin, pushes the rendered audio to an
output ring and publishes the latest metrics for a UI poller (ui/meters.py
at ~20 Hz).

A single stream steps through its plugin's kernel wherever the plugin has
one (``StreamStep``): the stage kernel for punch, the saturator, texture
and motion, one launch per block; ``Plugin.step`` for width, cohere and
infer, which have no kernel. ``PipelinedStream`` runs the canonical chain
on the chain kernel, one launch per tick. On a CPU device the same calls
run the kernels' plain versions.
"""

from __future__ import annotations

import collections
import threading
from typing import Dict, Optional

import numpy as np
import torch

from juicy_tpu_torch.runtime import native
from juicy_tpu_torch.runtime.device import resolve_device
from juicy_tpu_torch.runtime.plugin import Chain, Plugin


class StreamStep:
    """A plugin's block step for `batch` streams [B, C, N] on `device`
    (None is the card), picked once: its stage kernel step where it has
    one (``parallel/corpus.py::_stage_kernel_step``), else ``Plugin.step``.
    Holds the streams' state from call to call."""

    def __init__(self, plugin: Plugin, batch: int = 1, device=None):
        from juicy_tpu_torch.parallel.corpus import _stage_kernel_step

        self.plugin = plugin
        self.device = resolve_device(device)
        self.kstep = _stage_kernel_step(plugin)
        self._state = plugin.init_state((batch,), self.device)
        self._mode = None           # texture: the material of the kernel form

    def _texture_form(self, mode):
        """Texture's stage kernel keeps its state in kernel form, which
        depends on the material: converted on the first block and when the
        material changes."""
        from juicy_tpu_torch.kernels import stage_kernels as sk

        if self._mode is not None and _same(mode, self._mode):
            return
        dsp = self._state["dsp"]
        if self._mode is not None:
            dsp = sk.texture_ring_state(dsp, self._mode)
        self._state = dict(self._state, dsp=sk.texture_kernel_state(dsp, mode))
        self._mode = mode

    def step(self, params, block):
        """One block [B, C, N] on the device -> (out, metrics with leaves
        [B])."""
        if self.kstep is None:
            out, self._state, m = self.plugin.step(params, self._state, block)
            return out, m
        p = self.plugin.full_params(params)
        if self.plugin.defn.name == "texture":
            from juicy_tpu_torch.models import texture as _tex

            self._texture_form(_tex.material_mode(p))
        out, self._state, m = self.kstep(p, self._state, block,
                                         self.plugin.sr)
        return out, m

    @property
    def state(self):
        """The streams' state in ``Plugin.init_state``'s form."""
        if self._mode is None:
            return self._state
        from juicy_tpu_torch.kernels import stage_kernels as sk

        return dict(self._state,
                    dsp=sk.texture_ring_state(self._state["dsp"], self._mode))


def _same(a, b) -> bool:
    if isinstance(a, int) or isinstance(b, int):
        return a == b
    return a.shape == b.shape and bool(torch.equal(a, b))


def stack_metrics(m):
    """A metrics dict with one value per key (leaves of one element) ->
    (sorted keys, float32 vector on the metrics' device): the metrics
    leave the card in one copy."""
    keys = tuple(sorted(m))
    return keys, torch.stack([torch.as_tensor(m[k]).reshape(())
                              .to(torch.float32) for k in keys])


class HostBridge:
    def __init__(self, plugin: Plugin, params=None, ring_blocks: int = 64,
                 device=None):
        if not native.available():
            raise RuntimeError("native juicyio library unavailable")
        self.plugin = plugin
        self.params = params if params is not None else plugin.default_params()
        self.stream = StreamStep(plugin, 1, device)
        n = plugin.block_size * plugin.channels
        self.in_ring = native.RingBuffer(n * ring_blocks)
        self.out_ring = native.RingBuffer(n * ring_blocks)
        self._out_room = n * ring_blocks     # at most the ring's capacity
        self._latest_metrics: Dict[str, float] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    @property
    def state(self):
        """The stream's state (leaves with a leading batch of one)."""
        return self.stream.state

    # -- producer side (the "audio callback") --------------------------------

    def push_block(self, block: np.ndarray) -> bool:
        """Push one [C, N] block (interleaved into the ring). Non-blocking."""
        c, n = block.shape
        assert (c, n) == (self.plugin.channels, self.plugin.block_size)
        return self.in_ring.push(np.ascontiguousarray(block.T, np.float32))

    def pop_block(self) -> Optional[np.ndarray]:
        """Pop one rendered [C, N] block, or None if not ready."""
        n = self.plugin.block_size * self.plugin.channels
        flat = self.out_ring.pop(n)
        if flat is None:
            return None
        return flat.reshape(self.plugin.block_size, self.plugin.channels).T

    # -- consumer side (the device feeder) -----------------------------------

    def process_available(self) -> int:
        """Step every complete block of the input ring that the output ring
        has room for. A block whose output would not fit stays in the input
        ring until the consumer pops (JAX's bridge steps it and drops the
        output)."""
        c, n = self.plugin.channels, self.plugin.block_size
        processed = 0
        while self.in_ring.readable() >= n * c and \
                self._out_room - self.out_ring.readable() >= n * c:
            flat = self.in_ring.pop(n * c)
            block = torch.from_numpy(np.ascontiguousarray(
                flat.reshape(n, c).T))[None].to(self.stream.device)
            out, metrics = self.stream.step(self.params, block)
            keys, vec = stack_metrics(metrics)
            self.out_ring.push(np.ascontiguousarray(out[0].cpu().numpy().T))
            with self._lock:
                self._latest_metrics = dict(zip(keys, vec.cpu().tolist()))
            processed += 1
        return processed

    def latest_metrics(self) -> Dict[str, float]:
        """The 20 Hz-poll analog of getLatestMetrics (atomics snapshot)."""
        with self._lock:
            return dict(self._latest_metrics)

    # -- background pump -----------------------------------------------------

    def start(self, poll_s: float = 0.001):
        def pump():
            while not self._stop.is_set():
                if not self.process_available():
                    self._stop.wait(poll_s)

        self._thread = threading.Thread(target=pump, daemon=True)
        self._thread.start()

    def stop(self):
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5.0)
        self.in_ring.close()
        self.out_ring.close()


class PipelinedStream:
    """Single-stream live client with pipelined dispatch.

    ``tick(block_k)`` queues block k's step on the device, starts copying
    its audio and metrics into pinned host memory without waiting, and
    returns block ``k − depth``'s finished audio, whose copy has had
    `depth` block periods to complete. The price is ``depth · block_size``
    samples of reported latency, what a JUCE host absorbs through
    setLatencySamples.

    Works with a Plugin (one [C, N] stream, through ``StreamStep``) or a
    Chain (each stage's state threading block to block like a DAW insert
    chain). ``blocks_per_tick`` = k > 1 takes [C, k·N] samples a tick;
    latency_samples = depth · k · N.

    The canonical seven-stage stereo chain with its own params rides the
    chain kernel (``use_kernel="auto"``, or True, which raises for a target
    that cannot): one stream is a batch of one, ``chain_kernel_step`` over
    [1, 2, N] a tick (one launch; a CTA with 31 idle lanes), or
    ``chain_kernel_stream`` over [1, 2, k·N] with ``metrics="final"``. On a
    CPU device these run the kernel's plain version. Other chains, and a
    chain given `params`, step stage by stage through ``StreamStep``.
    """

    def __init__(self, target, params=None, depth: int = 2,
                 blocks_per_tick: int = 1, use_kernel="auto", device=None):
        from juicy_tpu_torch.kernels import chain_kernel as ck

        self.depth = max(0, int(depth))
        self.blocks_per_tick = max(1, int(blocks_per_tick))
        self.block_size = target.block_size
        self.channels = target.channels
        self.device = resolve_device(device)
        self._q = collections.deque()
        self._metric_keys = None
        self._pinned = collections.deque()
        k, n = self.blocks_per_tick, self.block_size
        self.kernel_path = bool(
            use_kernel in ("auto", True) and isinstance(target, Chain)
            and params is None and ck.supports_chain_kernel(target))
        if use_kernel is True and not self.kernel_path:
            raise ValueError("use_kernel=True but this target cannot ride "
                             "the chain kernel")

        if self.kernel_path:
            self._state = target.init_state((1,), self.device)

            def tick_fn(blocks):
                if k == 1:
                    out, self._state, ms = ck.chain_kernel_step(
                        target, self._state, blocks[None])
                else:
                    out, self._state, ms = ck.chain_kernel_stream(
                        target, self._state, blocks[None], metrics="final")
                return out[0], ms[-1]
        else:
            if isinstance(target, Chain):
                stages = [StreamStep(p, 1, self.device)
                          for p in target.plugins]
                plist = params if params is not None else target.params
            else:
                stages = [StreamStep(target, 1, self.device)]
                plist = [params if params is not None
                         else target.default_params()]

            def step(blk):
                for st, p in zip(stages, plist, strict=True):
                    blk, m = st.step(p, blk)
                return blk, m

            def tick_fn(blocks):
                outs = []
                for j in range(k):
                    out, m = step(blocks[None, :, j * n:(j + 1) * n])
                    outs.append(out[0])
                return torch.cat(outs, dim=-1), m
        self._tick_fn = tick_fn

    @property
    def latency_samples(self) -> int:
        """What the host reports upstream (setLatencySamples analog)."""
        return self.depth * self.blocks_per_tick * self.block_size

    def _to_host(self, out, mvec):
        """Start the copies of a tick's audio and metrics to the host: on
        CUDA into pinned buffers (reused; the depth + 1 newest ticks hold
        theirs) behind an event; on the CPU, the tensors themselves."""
        if out.device.type != "cuda":
            return out, mvec, None
        if len(self._pinned) > self.depth:
            bufs = self._pinned.popleft()
        else:
            bufs = (torch.empty(out.shape, dtype=out.dtype, pin_memory=True),
                    torch.empty(mvec.shape, dtype=mvec.dtype,
                                pin_memory=True))
        bufs[0].copy_(out, non_blocking=True)
        bufs[1].copy_(mvec, non_blocking=True)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(out.device))
        self._pinned.append(bufs)
        return bufs[0], bufs[1], done

    def _unpack(self, o, mvec, done):
        if done is not None:
            done.synchronize()      # the copies have landed
        m = mvec.tolist()
        return (np.array(o.numpy(), copy=True),
                {k: m[i] for i, k in enumerate(self._metric_keys)})

    def tick(self, block: np.ndarray):
        """Queue one [C, k·N] block; return (audio, metrics) for the block
        `depth` ticks ago, or None while the pipeline fills."""
        x = torch.as_tensor(np.asarray(block, np.float32)).to(self.device)
        out, m = self._tick_fn(x)
        self._metric_keys, mvec = stack_metrics(m)
        self._q.append(self._to_host(out, mvec))
        if len(self._q) > self.depth:
            return self._unpack(*self._q.popleft())
        return None

    def flush(self):
        """Drain the in-flight tail (end of stream)."""
        outs = []
        while self._q:
            outs.append(self._unpack(*self._q.popleft()))
        return outs
