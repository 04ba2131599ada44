"""Minimal protobuf wire-format codec for the ONNX message subset we emit.

The deployment image may lack the `onnx` package (it does here), so we
encode ModelProto by hand. Field numbers follow onnx.proto (IR version 6):

  ModelProto:    ir_version=1, producer_name=2, producer_version=3,
                 graph=7, opset_import=8
  OperatorSetId: domain=1, version=2
  GraphProto:    node=1, name=2, initializer=5, input=11, output=12
  NodeProto:     input=1, output=2, name=3, op_type=4, attribute=5, domain=7
  AttributeProto:name=1, f=2, i=3, s=4, t=5, floats=7, ints=8, type=20
  TensorProto:   dims=1, data_type=2, name=8, raw_data=9
  ValueInfoProto:name=1, type=2
  TypeProto:     tensor_type=1
  TypeProto.Tensor: elem_type=1, shape=2
  TensorShapeProto: dim=1;  Dimension: dim_value=1, dim_param=2
"""

from __future__ import annotations

import struct
from typing import Dict, Iterator, List, Tuple


# --- encoding ---------------------------------------------------------------


def _varint(value: int) -> bytes:
    out = bytearray()
    if value < 0:
        value += 1 << 64
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def tag(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def enc_varint(field: int, value: int) -> bytes:
    return tag(field, 0) + _varint(value)


def enc_bytes(field: int, data: bytes) -> bytes:
    return tag(field, 2) + _varint(len(data)) + data


def enc_str(field: int, s: str) -> bytes:
    return enc_bytes(field, s.encode("utf-8"))


def enc_msg(field: int, msg: bytes) -> bytes:
    return enc_bytes(field, msg)


# --- decoding ---------------------------------------------------------------


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def iter_fields(buf: bytes) -> Iterator[Tuple[int, int, object]]:
    """Yield (field_number, wire_type, value) over a message buffer."""
    pos = 0
    n = len(buf)
    while pos < n:
        key, pos = _read_varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:
            val, pos = _read_varint(buf, pos)
        elif wire == 2:
            ln, pos = _read_varint(buf, pos)
            val = buf[pos : pos + ln]
            pos += ln
        elif wire == 5:
            val = struct.unpack("<f", buf[pos : pos + 4])[0]
            pos += 4
        elif wire == 1:
            val = struct.unpack("<d", buf[pos : pos + 8])[0]
            pos += 8
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, val


def fields_to_dict(buf: bytes) -> Dict[int, List[object]]:
    out: Dict[int, List[object]] = {}
    for field, _wire, val in iter_fields(buf):
        out.setdefault(field, []).append(val)
    return out
