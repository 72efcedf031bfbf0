"""The analyzer alone over a block in one launch: PyTorch port of
juicy_tpu/kernels/analyzer_kernel.py (``analyze_fused``).

``analyze_fused(state, block, sr)`` keeps the JAX contract: ``block``
[B, C, N] float32, analyzer-state leaves [B], returns ``(state', metrics)``
equal to the batched ``analyze``. For a CUDA tensor it launches
``juicy_analyzer_block`` (csrc/analyzer.cu) once on the block as given
([B, C, N], made contiguous only if it is not): 32 clips per CTA, the
lane split across three warps (the envelopes, the onsets, the energies)
and a copy warp that brings the block's rows into shared memory chunk by
chunk. It writes ``fin`` [5, B] and ``acc`` [10, B]. For a CPU tensor it
runs the plain version, the same lane as a serial loop over [B] tensors
(``stage_kernels._lane_step``). Any other device raises; neither route
gives way to the other. ``finalize_lane`` then gives the metrics.

Unlike the TPU kernel, any B >= 1 runs: the kernel masks the ragged edge of
the batch, so JAX's 1024-clip tile rule and its VMEM grouping are not
ported. The side, corr, L² and R² sums that JAX leaves to XLA are taken in
the lane, serially, as in the stage kernels.
"""

from __future__ import annotations

import torch

from juicy_tpu_torch.kernels import stage_kernels as sk
from juicy_tpu_torch.ops.precise import F32
from juicy_tpu_torch.runtime.observe import check_kernel_outputs


def _analyzer_lanes_plain(x, lane0, lane_k):
    """Plain PyTorch version of the kernel: x [B, C, N], lane0 [5, B] ->
    (fin [5, B], acc [10, B])."""
    c = x.shape[1]
    lane = sk._lane_from_fin(lane0)
    for t in range(x.shape[2]):
        lane = sk._lane_step(lane, x[:, 0, t], x[:, c - 1, t], lane_k)
    return sk._store_lane(lane)


def analyzer_launch(x, lane0, fin, acc, lane_k):
    """One launch of ``juicy_analyzer_block`` on prepared buffers (x
    [B, C, N], lane0 / fin [5, B], acc [10, B], contiguous float32 on one
    card), on that card's current stream; raises on a refused launch."""
    from juicy_tpu_torch.kernels import _build

    b, c, n = x.shape
    for t in (x, lane0, fin, acc):
        if not (t.is_contiguous() and t.dtype == F32
                and t.device == x.device):
            raise ValueError("analyzer kernel buffers must be contiguous "
                             "float32 on one device")
    lib = _build.load_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.juicy_analyzer_block(
            x.data_ptr(), lane0.data_ptr(), fin.data_ptr(), acc.data_ptr(),
            b, c, n, *lane_k, stream)
    if err != 0:
        raise RuntimeError(f"juicy_analyzer_block launch failed: CUDA error "
                           f"{err} ({_build.error_string(lib, err)})")
    analyze_fused.launches += 1
    check_kernel_outputs("juicy_analyzer_block", (fin, acc))


def _analyzer_lanes_cuda(x, lane0, lane_k):
    """The kernel route: one launch on the block in its own layout. Same
    contract as _analyzer_lanes_plain."""
    b = x.shape[0]
    fin = torch.empty((5, b), dtype=F32, device=x.device)
    acc = torch.empty((10, b), dtype=F32, device=x.device)
    analyzer_launch(x.contiguous(), lane0.contiguous(), fin, acc, lane_k)
    return fin, acc


def analyzer_geometry(n: int, channels: int = 2, device=None):
    """The analyzer kernel's geometry (stage_kernels.GEOMETRY_KEYS) for
    block size `n`, read off the card."""
    return sk.read_geometry("juicy_analyzer_geometry", channels, n,
                            device=device)


def _analyze(lanes_fn, state, block, sr: float):
    if block.dtype != F32 or block.ndim != 3:
        raise ValueError(f"expected float32 block [B, C, N], got "
                         f"{block.dtype} {tuple(block.shape)}")
    b, c, n = block.shape
    if c not in (1, 2) or n == 0 or b == 0:
        raise ValueError(f"unsupported block shape {tuple(block.shape)}")
    lane0 = sk.pack_lane(state, b)
    if lane0.device != block.device or lane0.dtype != F32:
        raise ValueError("analyzer state must be float32 on the block's "
                         "device")
    fin, acc = lanes_fn(block, lane0, sk._lane_consts(sr))
    return sk.finalize_lane(fin, acc, state, n, sr)


def analyze_fused_plain(state, block, sr: float):
    """``analyze_fused`` as plain PyTorch, on any device."""
    return _analyze(_analyzer_lanes_plain, state, block, sr)


def analyze_fused(state, block, sr: float):
    """The batched analyzer over one block [B, C, N] (state leaves [B]) in
    one kernel launch for a CUDA `block`, the plain version for a CPU
    `block`. Returns (state', metrics), as ``analyze`` over the batch."""
    if block.device.type == "cuda":
        return _analyze(_analyzer_lanes_cuda, state, block, sr)
    if block.device.type == "cpu":
        return analyze_fused_plain(state, block, sr)
    raise ValueError(f"no analyzer kernel for device {block.device}")


#: kernel launches made by analyze_fused (CUDA tensors only)
analyze_fused.launches = 0
