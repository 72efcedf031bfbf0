"""Device meshes and clip sharding, PyTorch port of juicy_tpu/parallel/mesh.py.

The reference's parallelism is one plugin instance per DAW track; here the
clip batch is the parallel axis, split over the devices of a mesh's
``data`` axis. The work is clip-parallel: each device runs its shard on the
single-device path, and only the outputs and the corpus aggregates are
gathered (parallel/corpus.py, runtime/serve.py). A ``seq`` axis splits
time for the sequence-parallel linear scan (parallel/timeshard.py).

A :class:`Mesh` is an array of ``torch.device`` shaped by the axis sizes.
A device may appear more than once (``[cuda:0, cuda:0]`` checks the split
and the gather on one card; ``["cpu"] * K`` on the CPU).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch


class Mesh:
    """Devices on named axes: ``devices`` an object array of
    ``torch.device`` whose shape is the axis sizes."""

    def __init__(self, devices: np.ndarray, axis_names: Tuple[str, ...]):
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim} mesh axes but names "
                             f"{tuple(axis_names)}")
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def shape(self):
        """{axis name: size}, as JAX's ``Mesh.shape``."""
        return dict(zip(self.axis_names, self.devices.shape))

    def axis_devices(self, axis: str):
        """The devices along `axis`, at index 0 of every other axis."""
        if axis not in self.axis_names:
            raise ValueError(f"mesh has no axis {axis!r}; axes "
                             f"{self.axis_names}")
        k = self.axis_names.index(axis)
        idx = [0] * self.devices.ndim
        idx[k] = slice(None)
        return list(self.devices[tuple(idx)])


def visible_devices():
    """Every visible CUDA device; RuntimeError without one (the port runs
    on the card unless its caller names devices)."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: a mesh spans the visible cards unless the "
            "caller gives its devices, e.g. devices=[\"cpu\", \"cpu\"]")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(axis_sizes: Optional[Sequence[int]] = None,
              axis_names: Tuple[str, ...] = ("data",),
              devices=None) -> Mesh:
    """A mesh over every visible CUDA device, or the given `devices`.

    Default: a 1-D ``data`` mesh. ``axis_names=("data", "seq")`` with
    matching sizes gives a dp×sp layout."""
    devices = [torch.device(d) for d in
               (visible_devices() if devices is None else devices)]
    if axis_sizes is None:
        axis_sizes = (len(devices),) + (1,) * (len(axis_names) - 1)
    arr = np.empty(len(devices), dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(tuple(axis_sizes)), tuple(axis_names))


def shard_clips(mesh: Mesh, batch, axis: str = "data"):
    """A [B, ...] batch split into equal chunks along `axis`'s devices,
    each chunk on its device. B must divide by the axis size (ValueError
    otherwise, as JAX's batch sharding requires)."""
    devices = mesh.axis_devices(axis)
    k = len(devices)
    if batch.shape[0] % k:
        raise ValueError(
            f"a batch of {batch.shape[0]} does not divide over the mesh "
            f"axis {axis!r} of {k} devices")
    return [chunk.to(dev) for chunk, dev in
            zip(torch.chunk(torch.as_tensor(batch), k), devices)]


def gather(parts, dim: int = 0):
    """Equal per-device results concatenated along `dim` on the first
    one's device, laid out as the unsharded result would be: a part that
    is a view into a wider buffer (the runners' metrics are rows of one
    table) keeps its strides, those outside `dim` scaled by the part
    count, so that a reduction over the whole (the corpus aggregates) runs
    in the unsharded order."""
    p0, k = parts[0], len(parts)
    shape = list(p0.shape)
    shape[dim] *= k
    strides = [st * k if st > p0.stride(dim) and n > 1 else st
               for st, n in zip(p0.stride(), p0.shape)]
    whole = torch.empty_strided(shape, strides, dtype=p0.dtype,
                                device=p0.device)
    for i, p in enumerate(parts):
        whole.narrow(dim, i * p0.shape[dim], p0.shape[dim]).copy_(p)
    return whole
