"""Checkpoint and resume: params and state to a msgpack file and back.
PyTorch port of juicy_tpu/runtime/state.py, in the same file format.

The reference persists only parameter values (get/setStateInformation,
JuicyPunch/PluginProcessor.cpp:131-145); here the whole carry is saved:
params, analyzer state and DSP state (envelopes, delay windows, learned
targets, the LCG position), so a batch job resumes mid-corpus exactly.

A file holds ``{version, meta, params, state}``; each tree is a list of
leaves in the order ``jax.tree.flatten`` gives (dict keys sorted, lists
and tuples in order, None no leaf), each ``{dtype, shape, data}`` as numpy
writes them. A u32 leaf (the LCG state ``rng``, an int64 carrier in the
port, ``ops/noise.py``) is stored as ``<u4``, as JAX stores it, so a
checkpoint written by either package restores in the other bit for bit.
JAX stores its treedef as text and never reads it back; the port stores a
description of its own and checks, as JAX does, the leaf count.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import msgpack
import numpy as np
import torch

from juicy_tpu_torch.runtime.device import resolve_device
from juicy_tpu_torch.utils.from_jax import to_numpy, to_torch

_FORMAT_VERSION = 1


def tree_leaves(tree) -> List[Any]:
    """The leaves of `tree` in ``jax.tree.flatten``'s order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_unflatten(like, leaves: List[Any]):
    """A tree of `like`'s structure holding `leaves` (in tree_leaves'
    order)."""
    it = iter(leaves)

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            built = {k: build(t[k]) for k in sorted(t)}
            return {k: built[k] for k in t}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)
    return build(like)


def _describe(tree) -> str:
    if tree is None:
        return "None"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_describe(tree[k])}"
                               for k in sorted(tree)) + "}"
    if isinstance(tree, (list, tuple)):
        inner = ", ".join(_describe(v) for v in tree)
        return f"[{inner}]" if isinstance(tree, list) else f"({inner})"
    return "*"


def _pack_leaf(x):
    arr = to_numpy(x) if isinstance(x, torch.Tensor) else np.asarray(x)
    return {
        b"dtype": arr.dtype.str.encode(),
        b"shape": list(arr.shape),
        b"data": arr.tobytes(),
    }


def _unpack_leaf(d, device):
    arr = np.frombuffer(d[b"data"], dtype=np.dtype(d[b"dtype"].decode()))
    return to_torch(arr.reshape(d[b"shape"]), device)


def save_state(path: str, params: Any, state: Any,
               meta: Dict[str, Any] = None):
    """Write (params, state) trees to a msgpack checkpoint file."""
    payload = {}
    for name, tree in (("params", params), ("state", state)):
        payload[name] = {
            b"leaves": [_pack_leaf(x) for x in tree_leaves(tree)],
            b"treedef": _describe(tree).encode(),
        }
    blob = msgpack.packb({
        b"version": _FORMAT_VERSION,
        b"meta": {str(k).encode(): str(v).encode()
                  for k, v in (meta or {}).items()},
        b"params": payload["params"],
        b"state": payload["state"],
    })
    with open(path, "wb") as f:
        f.write(blob)


def _read(path: str):
    with open(path, "rb") as f:
        return msgpack.unpackb(f.read())


def load_state(path: str, params_like: Any, state_like: Any, device=None
               ) -> Tuple[Any, Any, Dict[str, str]]:
    """Restore (params, state, meta) into trees of the structure of
    `params_like` and `state_like`, the leaves on `device` (None is the
    card). As in the reference's tag check before replaceState
    (JuicyPunch/PluginProcessor.cpp:143-144), the structure must match:
    a different leaf count raises."""
    device = resolve_device(device)
    blob = _read(path)
    if blob[b"version"] != _FORMAT_VERSION:
        raise ValueError(f"unsupported checkpoint version {blob[b'version']}")

    def restore(section, like):
        n_like = len(tree_leaves(like))
        packed = blob[section][b"leaves"]
        if len(packed) != n_like:
            raise ValueError(
                f"checkpoint {section.decode()} has {len(packed)} leaves, "
                f"expected {n_like}")
        return tree_unflatten(like, [_unpack_leaf(d, device) for d in packed])

    meta = {k.decode(): v.decode() for k, v in blob[b"meta"].items()}
    return restore(b"params", params_like), restore(b"state", state_like), meta


def save_plugin_state(path: str, plugin, params: Any, state: Any,
                      meta: Dict[str, Any] = None):
    """A checkpoint with the plugin's name, current program and program
    names in its meta block (the reference keeps the program implicitly in
    its parameter values, JuicyPunch/PluginProcessor.cpp:147-187)."""
    m = dict(meta or {})
    m.setdefault("processor", plugin.defn.name)
    m.setdefault("current_program", plugin.current_program)
    m.setdefault("program_names", "\x1f".join(
        plugin.program_name(i) for i in range(plugin.num_programs)))
    save_state(path, params, state, m)


def load_plugin_state(path: str, plugin, params_like: Any, state_like: Any,
                      device=None):
    """Restore a save_plugin_state checkpoint onto `device` (None is the
    card), applying its program index and program names to `plugin`. A
    checkpoint of another processor raises before the leaves are read."""
    tagged = _read(path).get(b"meta", {}).get(b"processor", b"").decode()
    if tagged and tagged != plugin.defn.name:
        raise ValueError(
            f"checkpoint is for {tagged!r}, not {plugin.defn.name!r}")
    params, state, meta = load_state(path, params_like, state_like, device)
    if "current_program" in meta:
        plugin._current_program = int(meta["current_program"])
    names = meta.get("program_names", "")
    if names:
        plugin._program_names = names.split("\x1f")
    return params, state, meta
