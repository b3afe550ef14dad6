"""Tree checkpoints: an npz payload with a JSON manifest inside, written
atomically (the twin of ``repro.checkpoint.checkpoint``, in its format).

A tree is nested dicts (keys in sorted order), lists, tuples and NamedTuples
over tensors, numpy arrays and Python scalars.  Each leaf is stored as
``arr_<i>`` under the key path ``jax.tree_util`` gives the same tree: ``d:``
a dict key, ``s:`` a list or tuple index, ``a:`` a NamedTuple field (so the
PISCO state's ``x`` leaf ``w`` is ``a:x/d:w``); the manifest carries the
keys, the dtype names and the structure, and restore rebuilds the tree from
it.  So a checkpoint written here loads in the JAX package and the other
way round.

* bfloat16 leaves are written as 2-byte void with the dtype name
  ``"bfloat16"``, as numpy stores the reference's ml_dtypes arrays, and read
  back through a ``uint16`` view: nothing here needs ``ml_dtypes``.
* Tensors on the card are copied to the host on save; restore returns CPU
  tensors unless given a ``device``.
* A ``torch.Generator`` (the stochastic-rounding stream in a compressed
  PISCO state's ``ef["gen"]``) is written as its ``get_state()`` bytes, a
  uint8 leaf under its own key path (``a:ef/d:gen``), and listed in the
  manifest's ``"generators"`` (key -> device type), which the reference
  ignores.  Restore rebuilds the generator on that device type, so a
  compressed state continues bit for bit.  The reference keeps a JAX PRNG
  key under ``d:key`` instead: it comes back here as a uint32 tensor and
  does not map onto a generator.
"""
from __future__ import annotations

import json
import os
import re
import tempfile
import zipfile
from typing import Any, Optional

import numpy as np
import torch

_CKPT_RE = re.compile(r"^ckpt_(\d+)\.npz$")


def _is_namedtuple(tree) -> bool:
    return isinstance(tree, tuple) and hasattr(tree, "_fields")


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.contiguous().view(torch.int16).numpy().view("V2")
        return t.numpy()
    if leaf is None:
        raise TypeError("checkpoint leaves must be tensors, arrays or scalars, got None")
    return np.asarray(leaf)


def _flatten(tree, path: tuple, items: list, generators: dict) -> None:
    """Leaves of ``tree`` in ``jax.tree_util`` order, with their key paths."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            _flatten(tree[k], path + (f"d:{k}",), items, generators)
    elif _is_namedtuple(tree):
        for name, v in zip(tree._fields, tree):
            _flatten(v, path + (f"a:{name}",), items, generators)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _flatten(v, path + (f"s:{i}",), items, generators)
    else:
        key = "/".join(path)
        if isinstance(tree, torch.Generator):
            generators[key] = tree.device.type
            items.append((key, "uint8", tree.get_state().numpy()))
        else:
            arr = _to_numpy(tree)
            name = "bfloat16" if arr.dtype.kind == "V" else str(arr.dtype)
            items.append((key, name, arr))


def _structure_of(tree):
    """The JSON structure descriptor of the reference's manifest."""
    if isinstance(tree, dict):
        return {"kind": "dict", "items": {str(k): _structure_of(tree[k]) for k in sorted(tree)}}
    if isinstance(tree, list):
        return {"kind": "list", "items": [_structure_of(v) for v in tree]}
    if _is_namedtuple(tree):
        return {"kind": "namedtuple", "fields": list(tree._fields),
                "items": [_structure_of(v) for v in tree]}
    if isinstance(tree, tuple):
        return {"kind": "tuple", "items": [_structure_of(v) for v in tree]}
    return {"kind": "leaf"}


def save_checkpoint(directory: str, step: int, tree: Any, *,
                    metadata: Optional[dict] = None) -> str:
    """Atomically write ``ckpt_<step>.npz`` (manifest inside) to
    ``directory``; ``metadata`` (JSON-serialisable) rides in the manifest."""
    os.makedirs(directory, exist_ok=True)
    items: list = []
    generators: dict = {}
    _flatten(tree, (), items, generators)
    manifest = {
        "step": step,
        "keys": [k for k, _, _ in items],
        "dtypes": [name for _, name, _ in items],
        "structure": _structure_of(tree),
        "metadata": metadata or {},
    }
    if generators:
        manifest["generators"] = generators
    payload = {f"arr_{i}": arr for i, (_, _, arr) in enumerate(items)}
    payload["__manifest__"] = np.frombuffer(json.dumps(manifest).encode(), dtype=np.uint8)
    path = os.path.join(directory, f"ckpt_{step}.npz")
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **payload)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return path


def _to_tensor(arr: np.ndarray, name: str, device) -> torch.Tensor:
    # a member read from the archive is a fresh array, taken as it is; any
    # other is copied (np.array keeps 0-d leaves 0-d, ascontiguousarray would not)
    if not (arr.flags.writeable and arr.flags.c_contiguous):
        arr = np.array(arr)
    if name == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    elif str(arr.dtype) == name:
        t = torch.from_numpy(arr)
    else:
        raise ValueError(f"leaf dtype {name!r} stored as {arr.dtype} is not supported")
    return t if device is None else t.to(device)


class _Npz:
    """The arrays of an ``.npz`` by name, as ``np.load`` gives them.  A
    member stored uncompressed (as ``np.savez`` writes them) is read with
    one ``np.fromfile`` at its offset in the archive, not through
    ``zipfile``'s checked stream and a second copy: several times faster
    for the GiB-sized leaves of a full-width state.  Compressed members go
    through ``np.load``."""

    def __init__(self, path: str):
        self._path = path
        self._zip = zipfile.ZipFile(path)
        self._file = open(path, "rb")
        self._npz = None

    def __enter__(self) -> "_Npz":
        return self

    def __exit__(self, *exc) -> None:
        self._file.close()
        self._zip.close()
        if self._npz is not None:
            self._npz.close()

    def __getitem__(self, name: str) -> np.ndarray:
        info = self._zip.getinfo(name + ".npy")
        if info.compress_type != zipfile.ZIP_STORED:
            if self._npz is None:
                self._npz = np.load(self._path)
            return self._npz[name]
        f = self._file
        f.seek(info.header_offset)
        local = f.read(30)  # the local file header: name and extra lengths at 26 and 28
        f.seek(info.header_offset + 30 + int.from_bytes(local[26:28], "little")
               + int.from_bytes(local[28:30], "little"))
        return np.lib.format.read_array(f, allow_pickle=False)


def _generator(state: np.ndarray, device_type: str, device) -> torch.Generator:
    dev = torch.device(device_type if device is None else device)
    if dev.type != device_type:
        raise ValueError(f"a {device_type} generator's state cannot seed one on {dev}")
    gen = torch.Generator(device=dev)
    gen.set_state(torch.from_numpy(np.array(state)))
    return gen


def _n_leaves(structure) -> int:
    if structure["kind"] == "leaf":
        return 1
    items = structure["items"]
    return sum(_n_leaves(v) for v in (items.values() if isinstance(items, dict) else items))


def _locate(structure, subtree: tuple):
    """``(first leaf index, sub-structure)`` of the node ``subtree`` (dict
    keys and sequence indices from the root) in a structure descriptor;
    leaves are numbered in the order the keys list them."""
    start = 0
    for step in subtree:
        items = structure["items"]
        if isinstance(items, dict):
            names = list(items)
            if step not in items:
                raise KeyError(f"checkpoint has no {step!r} under {names}")
            before = [items[k] for k in names[:names.index(step)]]
            structure = items[step]
        else:
            before, structure = items[:step], items[step]
        start += sum(_n_leaves(v) for v in before)
    return start, structure


def _rebuild(structure, leaves_iter):
    kind = structure["kind"]
    if kind == "dict":
        return {k: _rebuild(v, leaves_iter) for k, v in structure["items"].items()}
    if kind == "list":
        return [_rebuild(v, leaves_iter) for v in structure["items"]]
    if kind in ("tuple", "namedtuple"):
        return tuple(_rebuild(v, leaves_iter) for v in structure["items"])
    return next(leaves_iter)


def restore_checkpoint(path: str, device=None, *, subtree: tuple = ()) -> tuple:
    """``(step, tree)``: NamedTuples come back as plain tuples, leaves as
    tensors of their saved dtypes on the CPU (on ``device`` when given),
    generators on the device type they were saved from (or ``device``).

    ``subtree`` (dict keys and sequence indices from the root, e.g. ``(0,)``
    for a state's first field) restores only that part of the tree and
    reads only its arrays."""
    with _Npz(path) as data:
        manifest = json.loads(bytes(data["__manifest__"].tobytes()).decode())
        start, structure = _locate(manifest["structure"], tuple(subtree))
        generators = manifest.get("generators", {})
        leaves = []
        for i in range(start, start + _n_leaves(structure)):
            key, name, arr = manifest["keys"][i], manifest["dtypes"][i], data[f"arr_{i}"]
            if key in generators:
                leaves.append(_generator(arr, generators[key], device))
            else:
                leaves.append(_to_tensor(arr, name, device))
    return manifest["step"], _rebuild(structure, iter(leaves))


def read_manifest(path: str) -> dict:
    """The checkpoint's manifest (step, leaf keys, structure, metadata)
    without loading the payload arrays."""
    with _Npz(path) as data:
        manifest = json.loads(bytes(data["__manifest__"].tobytes()).decode())
    manifest.setdefault("metadata", {})
    return manifest


def latest_checkpoint(directory: str) -> Optional[str]:
    """The ``ckpt_<step>.npz`` in ``directory`` with the highest step, or
    None."""
    if not os.path.isdir(directory):
        return None
    best, best_step = None, -1
    for name in os.listdir(directory):
        m = _CKPT_RE.match(name)
        if m and int(m.group(1)) > best_step:
            best_step = int(m.group(1))
            best = os.path.join(directory, name)
    return best
