"""OCDBT key-value stores on a local file system, read and written.

OCDBT (tensorstore's "optionally cooperative distributed B+tree") is
the store under an orbax checkpoint directory. The layout read here:

- ``manifest.ocdbt``: the header (magic ``0x0cdb3a2a`` big-endian, the
  file's length as u64 little-endian, a varint version 0 and a varint
  compression, 0 none or 1 zstd), then (possibly one zstd frame) the
  config (uuid, manifest kind, ``max_inline_value_bytes``,
  ``max_decoded_node_bytes``, the version tree's arity log2, the
  compression method and, for zstd, an i32 level), a data-file table and
  the newest versions as columns (generation, root height, the root's
  data file, offset and length, three statistics, commit time); the
  file ends in the crc32c of all bytes before it (u32 little-endian).
  Only the single-file manifest kind is read, and only its newest
  version: older versions (the version tree's nodes) are never needed to
  read a checkpoint.
- b-tree nodes (magic ``0x0cdb20de``, the same header and checksum),
  stored at (file, offset, length) in ``d/`` files: the height, a
  data-file table, the entry count, the keys prefix-coded against the
  previous key (shared length, suffix length, suffix bytes), and then
  - in an interior node: each child's common-prefix length, its data
    file, offset, length and three statistics; a child's keys are stored
    without the parent entry's common prefix;
  - in a leaf: each value's length and kind (0 inline, 1 indirect), the
    indirect values' data files and offsets, then the inline values.
- a data-file table: the file count, each path's length shared with the
  previous path, its suffix length and its base-path length, then the
  suffixes. Paths are relative to the store's root, after the base path
  of the node file that holds the table: orbax's root store points into
  ``ocdbt.process_0/d/`` this way.

Integers are LEB128 varints unless said otherwise. The writer makes a
single-version store with one leaf node and no compression (format 0):
values of at most ``max_inline_value_bytes`` inline, larger ones
indirect in one ``d/`` file, and the config orbax opens stores with.
"""

from __future__ import annotations

import os
import struct
import time
from typing import Dict, List, Optional, Sequence, Tuple, Union

from nerfsr_torch.utils import zstd

MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE
# orbax's store config (max_inline_value_bytes, max_decoded_node_bytes)
MAX_INLINE = 1024
MAX_NODE = 100_000_000
ARITY_LOG2 = 4
NO_LOCATION = (1 << 64) - 1

Bytes = Union[bytes, bytearray, memoryview]


class _Cursor:
    def __init__(self, data: bytes, what: str):
        self.data, self.pos, self.what = data, 0, what

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError(f"{self.what}: truncated")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def u8(self) -> int:
        return self.take(1)[0]

    def varint(self) -> int:
        value = shift = 0
        while True:
            b = self.u8()
            value |= (b & 0x7F) << shift
            if b < 0x80:
                return value
            shift += 7
            if shift > 63:
                raise ValueError(f"{self.what}: varint too long")

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]


def _varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _varints(values) -> bytes:
    return b"".join(_varint(v) for v in values)


def decode_file(blob: bytes, magic: int, what: str) -> bytes:
    """The body of a manifest or node file: magic, length and checksum
    checked, decompressed when the header says zstd."""
    if len(blob) < 18:
        raise ValueError(f"{what}: too short ({len(blob)} bytes)")
    got_magic, length = struct.unpack(">I", blob[:4])[0], \
        struct.unpack("<Q", blob[4:12])[0]
    if got_magic != magic:
        raise ValueError(f"{what}: magic {got_magic:#010x}, expected "
                         f"{magic:#010x}")
    if length != len(blob):
        raise ValueError(f"{what}: {len(blob)} bytes, the header says "
                         f"{length}")
    crc = struct.unpack("<I", blob[-4:])[0]
    if zstd.crc32c(blob[:-4]) != crc:
        raise ValueError(f"{what}: crc32c mismatch")
    cur = _Cursor(blob[:-4], what)
    cur.pos = 12
    version, compression = cur.varint(), cur.varint()
    if version != 0:
        raise ValueError(f"{what}: format version {version}")
    body = blob[cur.pos:-4]
    if compression == 1:
        return bytes(zstd.decompress(body))
    if compression != 0:
        raise ValueError(f"{what}: compression {compression}")
    return body


def encode_file(body: bytes, magic: int) -> bytes:
    """A manifest or node file of ``body``, uncompressed (format 0)."""
    length = 4 + 8 + 2 + len(body) + 4
    head = struct.pack(">I", magic) + struct.pack("<Q", length) + b"\0\0"
    blob = head + body
    return blob + struct.pack("<I", zstd.crc32c(blob))


def _read_file_table(cur: _Cursor, base: str) -> List[Tuple[str, str]]:
    """The data-file table as (base path, relative path) pairs, the base
    paths after ``base``, the base path of the file holding the table."""
    n = cur.varint()
    shared = [0] + cur.varints(n - 1) if n else []
    suffix_len = cur.varints(n)
    base_len = cur.varints(n)
    files, prev = [], b""
    for i in range(n):
        path = prev[:shared[i]] + cur.take(suffix_len[i])
        if base_len[i] > len(path):
            raise ValueError(f"{cur.what}: base path longer than its path")
        files.append((base + path[:base_len[i]].decode(),
                      path[base_len[i]:].decode()))
        prev = path
    return files


def _file_table(paths: Sequence[str]) -> bytes:
    enc = [p.encode() for p in paths]
    shared = [len(os.path.commonprefix([a, b]))
              for a, b in zip(enc, enc[1:])]
    return (_varint(len(enc)) + _varints(shared)
            + _varints(len(p) - s for p, s in zip(enc, [0] + shared))
            + _varints(0 for _ in enc)
            + b"".join(p[s:] for p, s in zip(enc, [0] + shared)))


def _read_keys(cur: _Cursor, n: int, interior: bool):
    shared = [0] + cur.varints(n - 1) if n else []
    suffix_len = cur.varints(n)
    common = cur.varints(n) if interior else None
    keys, prev = [], b""
    for i in range(n):
        key = prev[:shared[i]] + cur.take(suffix_len[i])
        keys.append(key)
        prev = key
    return keys, common


class Store:
    """A read-only OCDBT store at directory ``root``: every key of its
    newest version, with inline values in memory and indirect ones read
    from their files on demand."""

    def __init__(self, root: str):
        self.root = root
        with open(os.path.join(root, "manifest.ocdbt"), "rb") as f:
            body = decode_file(f.read(), MANIFEST_MAGIC, "manifest.ocdbt")
        cur = _Cursor(body, "manifest.ocdbt")
        cur.take(16)                                   # the uuid
        kind = cur.varint()
        cur.varints(2)              # max inline value and node bytes
        cur.u8()                                       # the arity's log2
        method = cur.varint()
        if method == 1:
            cur.take(4)                        # the level, an i32
        elif method != 0:
            raise ValueError(f"manifest.ocdbt: compression method {method}")
        if kind != 0:
            raise ValueError("manifest.ocdbt: only the single-file manifest "
                             f"kind is read (kind {kind})")
        files = _read_file_table(cur, "")
        n = cur.varint()
        if n == 0:
            raise ValueError("manifest.ocdbt: no version")
        _, heights, file_ids, offsets, lengths = (
            cur.varints(n) for _ in range(5))    # generations first
        self._values: Dict[bytes, Union[bytes, tuple]] = {}
        if offsets[-1] == NO_LOCATION:
            return                                     # an empty tree
        self._walk((*files[file_ids[-1]], offsets[-1], lengths[-1]),
                   heights[-1], b"")

    def _read(self, ref: tuple) -> bytes:
        """The bytes at (base path, relative path, offset, length)."""
        base, rel, offset, length = ref
        with open(os.path.join(self.root, base + rel), "rb") as f:
            f.seek(offset)
            data = f.read(length)
        if len(data) != length:
            raise ValueError(f"{base + rel}: {len(data)} bytes at {offset}, "
                             f"expected {length}")
        return data

    def _walk(self, ref: tuple, height: int, prefix: bytes):
        what = f"b-tree node {ref[0] + ref[1]}:{ref[2]}"
        cur = _Cursor(decode_file(self._read(ref), NODE_MAGIC, what), what)
        if cur.u8() != height:
            raise ValueError(f"{what}: height differs from its parent's")
        files = _read_file_table(cur, ref[0])
        n = cur.varint()
        keys, common = _read_keys(cur, n, height > 0)
        if height > 0:
            ids, offsets, lengths = (cur.varints(n) for _ in range(3))
            cur.varints(3 * n)                         # the statistics
            for key, c, i, o, length in zip(keys, common, ids, offsets,
                                            lengths):
                self._walk((*files[i], o, length), height - 1,
                           prefix + key[:c])
            return
        lengths, kinds = cur.varints(n), cur.varints(n)
        indirect = [i for i, k in enumerate(kinds) if k == 1]
        if any(k > 1 for k in kinds):
            raise ValueError(f"{what}: unknown value kind")
        ids, offsets = cur.varints(len(indirect)), \
            cur.varints(len(indirect))
        refs = dict(zip(indirect, zip(ids, offsets)))
        for i, key in enumerate(keys):
            if i in refs:
                fid, off = refs[i]
                value = (*files[fid], off, lengths[i])
            else:
                value = cur.take(lengths[i])
            self._values[prefix + key] = value
        if cur.pos != len(cur.data):
            raise ValueError(f"{what}: {len(cur.data) - cur.pos} bytes after "
                             "its values")

    def keys(self) -> List[bytes]:
        return sorted(self._values)

    def get(self, key: Union[str, bytes]) -> Optional[bytes]:
        value = self._values.get(_key(key))
        if value is None or isinstance(value, bytes):
            return value
        return self._read(value)


def _key(key: Union[str, bytes]) -> bytes:
    return key.encode() if isinstance(key, str) else key


def _leaf_node(entries: List[Tuple[bytes, int, Optional[int], bytes]],
               data_file: str) -> bytes:
    """A leaf node's body: (key, length, offset of an indirect value in
    ``data_file`` or None, inline bytes) per entry, keys sorted."""
    keys = [e[0] for e in entries]
    shared = [len(os.path.commonprefix([a, b]))
              for a, b in zip(keys, keys[1:])]
    indirect = [e for e in entries if e[2] is not None]
    body = [b"\0", _file_table([data_file] if indirect else []),
            _varint(len(entries)), _varints(shared),
            _varints(len(k) - s for k, s in zip(keys, [0] + shared)),
            b"".join(k[s:] for k, s in zip(keys, [0] + shared)),
            _varints(e[1] for e in entries),
            _varints(int(e[2] is not None) for e in entries),
            _varints(0 for _ in indirect), _varints(e[2] for e in indirect),
            b"".join(e[3] for e in entries if e[2] is None)]
    return b"".join(body)


def write_store(root: str, items: Dict[str, Sequence[Bytes]]) -> None:
    """Write a new store at directory ``root`` holding ``items`` (key ->
    the value's bytes, as parts written one after another): one version,
    one leaf node, values over ``MAX_INLINE`` bytes in one ``d/`` file
    after which the node is written. Every file and directory written is
    fsynced."""
    os.makedirs(os.path.join(root, "d"), exist_ok=True)
    data_file = "d/" + os.urandom(16).hex()
    entries, indirect_bytes = [], 0
    with open(os.path.join(root, data_file), "wb") as f:
        offset = 0
        for key in sorted(items, key=_key):
            parts = items[key]
            length = sum(len(memoryview(p).cast("B")) for p in parts)
            if length > MAX_INLINE:
                for p in parts:
                    f.write(p)
                entries.append((_key(key), length, offset, b""))
                offset += length
                indirect_bytes += length
            else:
                entries.append((_key(key), length, None,
                                b"".join(bytes(p) for p in parts)))
        node = encode_file(_leaf_node(entries, data_file), NODE_MAGIC)
        if len(node) > MAX_NODE:
            raise ValueError(f"{len(entries)} keys make a node of "
                             f"{len(node)} bytes, over {MAX_NODE}")
        f.write(node)
        _sync(f)
    config = (os.urandom(16) + _varint(0) + _varint(MAX_INLINE)
              + _varint(MAX_NODE) + bytes([ARITY_LOG2]) + _varint(1)
              + struct.pack("<i", 0))
    version = (_varint(1) + _varint(1) + b"\0" + _varint(0) + _varint(offset)
               + _varint(len(node)) + _varint(len(entries))
               + _varint(len(node)) + _varint(indirect_bytes)
               + struct.pack("<Q", time.time_ns()))
    manifest = encode_file(config + _file_table([data_file]) + version
                           + _varint(0), MANIFEST_MAGIC)
    with open(os.path.join(root, "manifest.ocdbt"), "wb") as f:
        f.write(manifest)
        _sync(f)
    for d in (os.path.join(root, "d"), root):
        fsync_dir(d)


def _sync(f):
    f.flush()
    os.fsync(f.fileno())


def fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)
