"""orbax ``StandardCheckpointer`` directories, read and written without
orbax, tensorstore or zstandard.

A directory ``{epoch}_state.orbax/`` as the JAX package's
``--ckpt_backend orbax`` writes it holds:

- ``_CHECKPOINT_METADATA``: JSON naming the handler, with the init and
  commit times;
- ``_METADATA``: JSON, ``tree_metadata`` listing every leaf of the state
  by its key path (each key with its type: 2 a dict key or attribute, 1
  a sequence index such as the optax chain's ``0``/``1``/``2``). An
  empty node (the clip's ``EmptyState``, a ``--fix_layers`` leaf's
  ``mu``/``nu``) is ``{"value_type": "None", "skip_deserialize": true}``
  and holds no array: it is ``{}`` in the state dict, as in msgpack;
- an OCDBT store (``nerfsr_torch/utils/ocdbt.py``) of zarr v2 arrays:
  for each array leaf ``a.b.c`` (its path joined with ``.``) the
  ``a.b.c/.zarray`` metadata and its chunks ``a.b.c/0.0`` (``0`` for a
  0-d array). orbax writes one chunk of the whole shape, zstd-compressed.

``restore`` reads any chunk grid, missing chunks as the fill value, and
zstd or uncompressed chunks. ``save`` writes the JAX package's metadata
fields, one chunk per array as a zstd frame of raw blocks, into a
temporary sibling (``...orbax-checkpoint-tmp-<ns>``, which the resume
scan does not match) and renames it into place, replacing what was
there. ``save_async`` copies the state on the calling thread and writes
on a background thread; ``wait_for_saves`` joins it and re-raises its
error.
"""

from __future__ import annotations

import itertools
import json
import os
import shutil
import threading
import time
from typing import Any, Dict, Iterator, Optional, Sequence, Tuple

import numpy as np

from nerfsr_torch.utils import ocdbt, zstd

HANDLER = ("orbax.checkpoint._src.handlers.standard_checkpoint_handler."
           "StandardCheckpointHandler")
TMP = ".orbax-checkpoint-tmp-"
DICT_KEY, SEQUENCE_KEY = 2, 1

_saver: Dict[str, Any] = {"thread": None, "error": None}


# ---------------------------------------------------------------------------
# zarr v2 arrays
# ---------------------------------------------------------------------------

def zarray(a: np.ndarray) -> bytes:
    """The ``.zarray`` orbax writes for ``a``: one chunk of its shape."""
    return json.dumps({
        "chunks": [max(1, d) for d in a.shape],
        "compressor": {"id": "zstd", "level": 1},
        "dimension_separator": ".", "dtype": a.dtype.str,
        "fill_value": None, "filters": None, "order": "C",
        "shape": list(a.shape), "zarr_format": 2},
        sort_keys=True, separators=(",", ":")).encode()


def _fill(value):
    if value is None:
        return 0
    if isinstance(value, str):      # zarr v2 spells the special floats
        return {"NaN": np.nan, "Infinity": np.inf,
                "-Infinity": -np.inf}[value]
    return value


def read_array(store: ocdbt.Store, name: str) -> np.ndarray:
    """The zarr v2 array ``name`` of ``store``."""
    raw = store.get(name + "/.zarray")
    if raw is None:
        raise KeyError(f"no array {name!r}")
    meta = json.loads(raw)
    if meta.get("zarr_format") != 2 or meta.get("order", "C") != "C" \
            or meta.get("filters"):
        raise ValueError(f"{name}: only C-order zarr v2 arrays without "
                         f"filters are read ({meta})")
    comp = meta.get("compressor")
    if comp is not None and comp.get("id") != "zstd":
        raise ValueError(f"{name}: compressor {comp}")
    dtype = np.dtype(meta["dtype"])
    shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
    sep = meta.get("dimension_separator", ".")
    grid = [-(-s // c) for s, c in zip(shape, chunks)]
    out = None
    for idx in itertools.product(*(range(g) for g in grid)):
        data = store.get(f"{name}/{sep.join(map(str, idx)) or '0'}")
        if data is None:
            continue
        if comp is not None:
            data = zstd.decompress(data)
        if len(data) != int(np.prod(chunks)) * dtype.itemsize:
            raise ValueError(f"{name}: chunk {idx} has {len(data)} bytes")
        chunk = np.frombuffer(data, dtype).reshape(chunks)
        if chunks == shape:
            return chunk                       # orbax's one whole chunk
        if out is None:
            out = np.full(shape, _fill(meta["fill_value"]), dtype)
        lo = [i * c for i, c in zip(idx, chunks)]
        box = tuple(slice(a, min(a + c, s))
                    for a, c, s in zip(lo, chunks, shape))
        out[box] = chunk[tuple(slice(0, b.stop - b.start) for b in box)]
    if out is None:
        out = np.full(shape, _fill(meta["fill_value"]), dtype)
    return out


def _array_items(name: str, a: np.ndarray) -> Dict[str, Sequence]:
    items = {f"{name}/.zarray": [zarray(a)]}
    if a.size:
        key = ".".join("0" * a.ndim) or "0"
        items[f"{name}/{key}"] = list(zstd.raw_frame_parts(
            np.ascontiguousarray(a)))
    return items


# ---------------------------------------------------------------------------
# the state dict's tree
# ---------------------------------------------------------------------------

def _leaves(tree: dict, path=()) -> Iterator[Tuple[tuple, Optional[Any]]]:
    """(key path, array) of every leaf; an empty dict is a None leaf."""
    for k, v in tree.items():
        p = path + (str(k),)
        if isinstance(v, dict):
            if v:
                yield from _leaves(v, p)
            else:
                yield p, None
        else:
            yield p, v


def _key_type(path: tuple, i: int) -> int:
    """The optax chain's entries are a tuple's indices; all else is a dict
    key or a dataclass attribute."""
    chain = i > 0 and path[i - 1] in ("opt_state", "inner_state")
    return SEQUENCE_KEY if chain and path[i].isdigit() else DICT_KEY


def _tree_metadata(sd: dict) -> dict:
    out = {}
    for path, leaf in _leaves(sd):
        out[str(path)] = {
            "key_metadata": [{"key": k, "key_type": _key_type(path, i)}
                             for i, k in enumerate(path)],
            "value_metadata": {
                "value_type": "None" if leaf is None else "np.ndarray",
                "skip_deserialize": leaf is None}}
    return {"tree_metadata": out, "use_ocdbt": True, "use_zarr3": False,
            "store_array_data_equal_to_fill_value": True,
            "custom_metadata": None}


def _set(tree: dict, keys: Sequence[str], value):
    for k in keys[:-1]:
        tree = tree.setdefault(k, {})
    tree[keys[-1]] = value


# ---------------------------------------------------------------------------
# directories
# ---------------------------------------------------------------------------

def restore(path: str) -> Dict[str, Any]:
    """The state dict of the checkpoint directory ``path``: every array
    leaf from the store, every empty node as ``{}``."""
    with open(os.path.join(path, "_METADATA")) as f:
        meta = json.load(f)
    store = ocdbt.Store(path)
    sd: Dict[str, Any] = {}
    for entry in meta["tree_metadata"].values():
        keys = [str(k["key"]) for k in entry["key_metadata"]]
        value = entry["value_metadata"]
        if value.get("value_type") == "None" or value.get("skip_deserialize"):
            _set(sd, keys, {})
        else:
            _set(sd, keys, read_array(store, ".".join(keys)))
    return sd


def _write_json(path: str, obj) -> None:
    with open(path, "w") as f:
        json.dump(obj, f)
        f.flush()
        os.fsync(f.fileno())


def save(path: str, sd: Dict[str, Any]) -> str:
    """Write ``sd`` as the checkpoint directory ``path`` (absolute): into a
    temporary sibling, then renamed into place over what was there."""
    path = os.path.abspath(path)
    start = time.time_ns()
    tmp = f"{path}{TMP}{start}"
    os.makedirs(tmp)
    items = {}
    for keys, leaf in _leaves(sd):
        if leaf is not None:
            items.update(_array_items(".".join(keys), np.asarray(leaf)))
    ocdbt.write_store(tmp, items)
    _write_json(os.path.join(tmp, "_METADATA"), _tree_metadata(sd))
    _write_json(os.path.join(tmp, "_CHECKPOINT_METADATA"), {
        "item_handlers": HANDLER, "metrics": {}, "performance_metrics": {},
        "init_timestamp_nsecs": start,
        "commit_timestamp_nsecs": time.time_ns(), "custom_metadata": {}})
    ocdbt.fsync_dir(tmp)
    old = None
    if os.path.lexists(path):
        old = f"{tmp}-replaced"
        os.replace(path, old)
    os.replace(tmp, path)
    ocdbt.fsync_dir(os.path.dirname(path))
    if old is not None:
        shutil.rmtree(old)
    return path


def _host_copy(tree):
    """A copy of the state dict that owns its arrays: training goes on
    updating the tensors the arrays may share memory with."""
    if isinstance(tree, dict):
        return {k: _host_copy(v) for k, v in tree.items()}
    return np.array(tree, copy=True)


def _write(paths: Sequence[str], sd) -> None:
    try:
        for p in paths:
            save(p, sd)
    except BaseException as e:      # re-raised by wait_for_saves
        _saver["error"] = e


def save_async(paths: Sequence[str], sd: Dict[str, Any]) -> None:
    """Copy ``sd`` now and write it as each directory of ``paths`` on a
    background thread. A save first waits for the one before it."""
    wait_for_saves()
    sd = _host_copy(sd)
    thread = threading.Thread(target=_write, args=(list(paths), sd),
                              name="orbax-save")
    _saver["thread"] = thread
    thread.start()


def wait_for_saves() -> None:
    """Wait for the background save, if any, and re-raise its error."""
    thread = _saver["thread"]
    if thread is not None:
        thread.join()
        _saver["thread"] = None
    err, _saver["error"] = _saver["error"], None
    if err is not None:
        raise RuntimeError(f"the background orbax save failed: {err}") \
            from err
