"""Carry params and state across between the JAX package and the port.

The JAX package's trees (``Plugin.init_state()``, preset and ``full_params``
dicts, batched state after ``vmap``) are dicts, lists and tuples of arrays.
Given as numpy arrays (``jax.device_get`` or ``np.asarray`` on the JAX side;
this module imports no JAX), :func:`to_torch` turns them into the port's
tensors and :func:`to_numpy` turns the port's back. Float32 and int32 leaves
keep their dtype (motion's ``onset_cooldown`` is int32). A uint32 leaf (the
LCG state ``rng`` of texture and motion) becomes the port's u32 carrier, an
int64 tensor holding the unsigned value (``ops/noise.py``), and comes back
as uint32. A Python int (a static param such as texture's ``material`` in
``full_params``) stays an int. Any other dtype raises rather than
converting silently. An empty dict (infer's DSP state) stays empty.
"""

from __future__ import annotations

import numpy as np
import torch

from juicy_tpu_torch.runtime.device import resolve_device

_DTYPES = {np.dtype(np.float32): torch.float32, np.dtype(np.int32): torch.int32,
           np.dtype(np.uint32): torch.int64}


def to_torch(tree, device=None):
    """numpy (or array-like) leaves -> torch tensors on `device` (None is
    the card); uint32 leaves become int64 u32 carriers."""
    device = resolve_device(device)
    if isinstance(tree, dict):
        return {k: to_torch(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_torch(v, device) for v in tree)
    if isinstance(tree, int):
        return tree
    arr = np.asarray(tree)
    if arr.dtype not in _DTYPES:
        raise TypeError(f"unsupported leaf dtype {arr.dtype} (float32, int32 "
                        f"and uint32 only)")
    dtype = _DTYPES[arr.dtype]
    if arr.dtype == np.uint32:
        arr = arr.astype(np.int64)
    return torch.tensor(arr, dtype=dtype, device=device)


def to_numpy(tree):
    """torch tensor leaves -> numpy arrays copied to the host: float32 and
    int32 as they are, int64 u32 carriers as uint32."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_numpy(v) for v in tree)
    if isinstance(tree, int):
        return tree
    if tree.dtype == torch.int64:
        arr = tree.detach().cpu().numpy()
        if arr.size and (arr.min() < 0 or arr.max() > 0xFFFFFFFF):
            raise ValueError("int64 leaf is not a u32 carrier (outside "
                             "[0, 2**32))")
        return arr.astype(np.uint32)
    if tree.dtype not in (torch.float32, torch.int32):
        raise TypeError(f"unsupported leaf dtype {tree.dtype} (float32, int32 "
                        f"and int64 u32 carriers only)")
    return tree.detach().cpu().numpy()
