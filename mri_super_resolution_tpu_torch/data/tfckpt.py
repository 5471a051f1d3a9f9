"""TensorFlow checkpoint *index* reader (no TF dependency).

Copy of ``mri_super_resolution_tpu/data/tfckpt.py`` (pure Python): the
reference ships RAMS checkpoint index files whose data shards are missing
(multi-image-super-resolution/ckpt/RED_RAMS/ckpt-91.index). The index is a
LevelDB-format immutable SSTable whose keys are checkpoint variable names
and whose values are serialized ``BundleEntryProto`` messages (dtype, shape,
shard id, byte offset and size, crc); parsing it lets the port's RAMS be
checked against the trained reference network's variable shapes.

Format notes:
- SSTable footer: last 48 bytes = metaindex BlockHandle + index BlockHandle
  (each two varint64s) + padding + magic 0xdb4775248b80fb57 (little-endian).
- Block: prefix-compressed entries ``[shared][non_shared][value_len]
  key[value]``, then a restart array (u32 offsets) and u32 restart count.
  Each block is followed in the file by 1 compression-type byte (0 = raw,
  1 = snappy) + 4-byte masked crc32c.
- BundleEntryProto (tensorflow/core/protobuf/tensor_bundle.proto):
  1=dtype(varint) 2=shape(TensorShapeProto) 3=shard_id 4=offset 5=size
  6=crc32c(fixed32); TensorShapeProto.dim = field 2, Dim.size = field 1.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Iterator

_TABLE_MAGIC = 0xDB4775248B80FB57

# tensorflow/core/framework/types.proto (subset that appears in practice)
DTYPE_NAMES = {
    1: "float32", 2: "float64", 3: "int32", 4: "uint8", 5: "int16",
    6: "int8", 7: "string", 9: "int64", 10: "bool", 14: "bfloat16",
    19: "float16", 23: "uint32", 24: "uint64",
}


@dataclass(frozen=True)
class IndexEntry:
    name: str
    dtype: str
    shape: tuple[int, ...]
    shard_id: int
    offset: int
    size: int


def _varint(buf: bytes, pos: int) -> tuple[int, int]:
    out = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, pos
        shift += 7


def _snappy_decompress(buf: bytes) -> bytes:
    """Minimal snappy raw-format decompressor (literals + copies)."""
    n, pos = _varint(buf, 0)
    out = bytearray()
    while pos < len(buf):
        tag = buf[pos]
        pos += 1
        kind = tag & 3
        if kind == 0:  # literal
            length = (tag >> 2) + 1
            if length > 60:
                extra = length - 60
                length = int.from_bytes(buf[pos:pos + extra], "little") + 1
                pos += extra
            out += buf[pos:pos + length]
            pos += length
        else:
            if kind == 1:
                length = ((tag >> 2) & 7) + 4
                off = ((tag >> 5) << 8) | buf[pos]
                pos += 1
            elif kind == 2:
                length = (tag >> 2) + 1
                off = int.from_bytes(buf[pos:pos + 2], "little")
                pos += 2
            else:
                length = (tag >> 2) + 1
                off = int.from_bytes(buf[pos:pos + 4], "little")
                pos += 4
            for _ in range(length):  # may self-overlap; byte-by-byte is correct
                out.append(out[-off])
    if len(out) != n:
        raise ValueError(f"snappy block decoded to {len(out)} bytes, header says {n}")
    return bytes(out)


def _read_block(data: bytes, offset: int, size: int) -> bytes:
    raw = data[offset:offset + size]
    ctype = data[offset + size]
    if ctype == 0:
        return raw
    if ctype == 1:
        return _snappy_decompress(raw)
    raise ValueError(f"unsupported block compression type {ctype}")


def _block_entries(block: bytes) -> Iterator[tuple[bytes, bytes]]:
    (n_restarts,) = struct.unpack_from("<I", block, len(block) - 4)
    end = len(block) - 4 - 4 * n_restarts
    pos = 0
    key = b""
    while pos < end:
        shared, pos = _varint(block, pos)
        non_shared, pos = _varint(block, pos)
        value_len, pos = _varint(block, pos)
        key = key[:shared] + block[pos:pos + non_shared]
        pos += non_shared
        value = block[pos:pos + value_len]
        pos += value_len
        yield key, value


def _parse_bundle_entry(buf: bytes) -> tuple[str, tuple[int, ...], int, int, int]:
    dtype = 0
    shape: tuple[int, ...] = ()
    shard = offset = size = 0
    pos = 0
    while pos < len(buf):
        tag, pos = _varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 0:
            val, pos = _varint(buf, pos)
            if field == 1:
                dtype = val
            elif field == 3:
                shard = val
            elif field == 4:
                offset = val
            elif field == 5:
                size = val
        elif wire == 2:
            ln, pos = _varint(buf, pos)
            sub = buf[pos:pos + ln]
            pos += ln
            if field == 2:  # TensorShapeProto
                dims = []
                sp = 0
                while sp < len(sub):
                    stag, sp = _varint(sub, sp)
                    if stag >> 3 == 2 and stag & 7 == 2:  # repeated Dim
                        dln, sp = _varint(sub, sp)
                        dim = sub[sp:sp + dln]
                        sp += dln
                        dp = 0
                        while dp < len(dim):
                            dtag, dp = _varint(dim, dp)
                            if dtag >> 3 == 1 and dtag & 7 == 0:
                                dsize, dp = _varint(dim, dp)
                                dims.append(dsize)
                            elif dtag & 7 == 2:
                                sl, dp = _varint(dim, dp)
                                dp += sl
                            else:
                                _, dp = _varint(dim, dp)
                    elif stag & 7 == 0:
                        _, sp = _varint(sub, sp)
                    else:
                        sln, sp = _varint(sub, sp)
                        sp += sln
                shape = tuple(dims)
        elif wire == 5:
            pos += 4
        elif wire == 1:
            pos += 8
        else:
            raise ValueError(f"unexpected wire type {wire}")
    return DTYPE_NAMES.get(dtype, f"dtype{dtype}"), shape, shard, offset, size


def read_index(path: str) -> dict[str, IndexEntry]:
    """Parse a TF ``.index`` file into {variable_name: IndexEntry}."""
    with open(path, "rb") as f:
        data = f.read()
    footer = data[-48:]
    (magic,) = struct.unpack("<Q", footer[-8:])
    if magic != _TABLE_MAGIC:
        raise ValueError(f"{path}: not an SSTable (magic {magic:#x})")
    pos = 0
    _meta_off, pos = _varint(footer, pos)
    _meta_size, pos = _varint(footer, pos)
    idx_off, pos = _varint(footer, pos)
    idx_size, pos = _varint(footer, pos)

    out: dict[str, IndexEntry] = {}
    index_block = _read_block(data, idx_off, idx_size)
    for _sep_key, handle in _block_entries(index_block):
        hpos = 0
        b_off, hpos = _varint(handle, hpos)
        b_size, hpos = _varint(handle, hpos)
        for key, value in _block_entries(_read_block(data, b_off, b_size)):
            name = key.decode("utf-8", "replace")
            if not name:  # "" = BundleHeaderProto
                continue
            dtype, shape, shard, offset, size = _parse_bundle_entry(value)
            out[name] = IndexEntry(name, dtype, shape, shard, offset, size)
    return out


def model_variable_shapes(path: str) -> dict[str, tuple[int, ...]]:
    """Shapes of the MODEL variables (optimizer slots, counters and the
    object-graph blob filtered out), keyed by the object path under
    ``model/`` with the ``/.ATTRIBUTES/VARIABLE_VALUE`` suffix stripped."""
    suffix = "/.ATTRIBUTES/VARIABLE_VALUE"
    out = {}
    for name, e in read_index(path).items():
        if not name.startswith("model/") or not name.endswith(suffix):
            continue
        if "OPTIMIZER_SLOT" in name:
            continue
        out[name[len("model/"):-len(suffix)]] = e.shape
    return out
