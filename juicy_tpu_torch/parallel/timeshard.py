"""Sequence parallelism for linear recurrences, PyTorch port of
juicy_tpu/parallel/timeshard.py.

y[n] = a[n]·y[n−1] + b[n] with time split over the devices of a mesh's
``seq`` axis, in the two-level (Blelloch) decomposition:

  1. each device runs an associative scan over its shard, whose last entry
     is the shard's whole affine map (A_d, B_d);
  2. every shard's map is copied to the other devices (JAX's
     ``all_gather``: K values per lane), and each device folds the maps of
     the shards before it, in device order, into its boundary state;
  3. each device applies its boundary to its local scan.

O(T/K) work per device and O(K) values moved.
"""

from __future__ import annotations

import torch

from juicy_tpu_torch.ops.precise import as_f32
from juicy_tpu_torch.ops.scan_utils import _affine_compose, associative_scan


def sequence_parallel_linear_scan(mesh, a, b, init, seq_axis: str = "seq"):
    """Solve y[n] = a[n]·y[n−1] + b[n] with time (the last axis) split over
    `seq_axis`. `a` broadcasts against `b` [..., T]; `init` against
    `b[..., 0]`. T must divide by the axis size. Returns y [..., T] on the
    mesh's first device."""
    b = as_f32(b)
    a = torch.broadcast_to(as_f32(a).to(b.device), b.shape)
    devices = mesh.axis_devices(seq_axis)
    k = len(devices)
    if b.shape[-1] % k:
        raise ValueError(f"a sequence of {b.shape[-1]} does not divide over "
                         f"the mesh axis {seq_axis!r} of {k} devices")
    init = torch.broadcast_to(as_f32(init).to(b.device), b.shape[:-1])

    # 1. the local scans, each shard on its device
    local = [associative_scan(_affine_compose, (aa.to(dev), bb.to(dev)))
             for aa, bb, dev in zip(torch.chunk(a, k, dim=-1),
                                    torch.chunk(b, k, dim=-1), devices)]
    # 2. every shard's total map on every device
    totals = [(big_a[..., -1], big_b[..., -1]) for big_a, big_b in local]
    out = []
    for idx, ((big_a, big_b), dev) in enumerate(zip(local, devices)):
        boundary = init.to(dev)
        for a_d, b_d in totals[:idx]:
            boundary = a_d.to(dev) * boundary + b_d.to(dev)
        # 3. the boundary applied to the local scan
        out.append(big_a * boundary[..., None] + big_b)
    return torch.cat([y.to(devices[0]) for y in out], dim=-1)
