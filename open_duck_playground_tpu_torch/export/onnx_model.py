"""ONNX graph construction + parsing on top of the minimal protobuf codec."""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from open_duck_playground_tpu_torch.export import proto as pb

FLOAT = 1
INT64 = 7

_ATTR_INT = 2
_ATTR_INTS = 7


def tensor(name: str, arr: np.ndarray) -> bytes:
    arr = np.ascontiguousarray(arr)
    if arr.dtype == np.float32:
        dt = FLOAT
    elif arr.dtype == np.int64:
        dt = INT64
    else:
        raise ValueError(f"unsupported dtype {arr.dtype}")
    msg = b""
    for d in arr.shape:
        msg += pb.enc_varint(1, d)
    msg += pb.enc_varint(2, dt)
    msg += pb.enc_str(8, name)
    msg += pb.enc_bytes(9, arr.tobytes())
    return msg


def value_info(name: str, shape: Sequence[int], elem_type: int = FLOAT) -> bytes:
    dims = b""
    for d in shape:
        dims += pb.enc_msg(1, pb.enc_varint(1, d))  # Dimension.dim_value
    tensor_type = pb.enc_varint(1, elem_type) + pb.enc_msg(2, dims)
    type_proto = pb.enc_msg(1, tensor_type)
    return pb.enc_str(1, name) + pb.enc_msg(2, type_proto)


def attribute_ints(name: str, vals: Sequence[int]) -> bytes:
    msg = pb.enc_str(1, name)
    for v in vals:
        msg += pb.enc_varint(8, v)
    msg += pb.enc_varint(20, _ATTR_INTS)
    return msg


def attribute_int(name: str, val: int) -> bytes:
    return pb.enc_str(1, name) + pb.enc_varint(3, val) + pb.enc_varint(20, _ATTR_INT)


def node(
    op_type: str,
    inputs: Sequence[str],
    outputs: Sequence[str],
    name: str = "",
    attributes: Sequence[bytes] = (),
) -> bytes:
    msg = b""
    for i in inputs:
        msg += pb.enc_str(1, i)
    for o in outputs:
        msg += pb.enc_str(2, o)
    if name:
        msg += pb.enc_str(3, name)
    msg += pb.enc_str(4, op_type)
    for a in attributes:
        msg += pb.enc_msg(5, a)
    return msg


def graph(
    name: str,
    nodes: Sequence[bytes],
    inputs: Sequence[bytes],
    outputs: Sequence[bytes],
    initializers: Sequence[bytes],
) -> bytes:
    msg = b""
    for n in nodes:
        msg += pb.enc_msg(1, n)
    msg += pb.enc_str(2, name)
    for t in initializers:
        msg += pb.enc_msg(5, t)
    for i in inputs:
        msg += pb.enc_msg(11, i)
    for o in outputs:
        msg += pb.enc_msg(12, o)
    return msg


def model(graph_msg: bytes, opset: int = 11, producer: str = "open_duck_playground_tpu",
          metadata: Optional[Dict[str, str]] = None) -> bytes:
    opset_msg = pb.enc_str(1, "") + pb.enc_varint(2, opset)
    msg = pb.enc_varint(1, 6)  # ir_version 6
    msg += pb.enc_str(2, producer)
    msg += pb.enc_str(3, "0.1")
    msg += pb.enc_msg(7, graph_msg)
    msg += pb.enc_msg(8, opset_msg)
    # metadata_props (field 14, StringStringEntryProto key=1 value=2):
    # carries recipe constants the deploy loop must mirror
    for k, v in (metadata or {}).items():
        msg += pb.enc_msg(14, pb.enc_str(1, k) + pb.enc_str(2, v))
    return msg


# ---------------------------------------------------------------------------
# parsing (for the numpy interpreter)
# ---------------------------------------------------------------------------


class ParsedNode:
    def __init__(self, buf: bytes):
        self.inputs: List[str] = []
        self.outputs: List[str] = []
        self.op_type = ""
        self.name = ""
        self.attrs: Dict[str, object] = {}
        for field, _w, val in pb.iter_fields(buf):
            if field == 1:
                self.inputs.append(val.decode())
            elif field == 2:
                self.outputs.append(val.decode())
            elif field == 3:
                self.name = val.decode()
            elif field == 4:
                self.op_type = val.decode()
            elif field == 5:
                aname, aval = _parse_attr(val)
                self.attrs[aname] = aval


def _parse_attr(buf: bytes):
    name = ""
    ints: List[int] = []
    i_val = None
    f_val = None
    for field, wire, val in pb.iter_fields(buf):
        if field == 1:
            name = val.decode()
        elif field == 8:
            ints.append(val)
        elif field == 3:
            i_val = val
        elif field == 2:
            f_val = val
    if ints:
        return name, ints
    if i_val is not None:
        return name, i_val
    return name, f_val


def parse_tensor(buf: bytes):
    dims: List[int] = []
    dtype = FLOAT
    name = ""
    raw = b""
    floats: List[float] = []
    for field, _w, val in pb.iter_fields(buf):
        if field == 1:
            dims.append(val)
        elif field == 2:
            dtype = val
        elif field == 8:
            name = val.decode()
        elif field == 9:
            raw = val
        elif field == 4:
            floats.append(val)
    if raw:
        np_dtype = np.float32 if dtype == FLOAT else np.int64
        arr = np.frombuffer(raw, dtype=np_dtype).reshape(dims)
    else:
        arr = np.asarray(floats, np.float32).reshape(dims)
    return name, arr


class ParsedModel:
    def __init__(self, data: bytes):
        fields = pb.fields_to_dict(data)
        graph_buf = fields[7][0]
        self.metadata: Dict[str, str] = {}
        for entry in fields.get(14, []):
            e = pb.fields_to_dict(entry)
            if 1 in e and 2 in e:
                self.metadata[e[1][0].decode()] = e[2][0].decode()
        g = pb.fields_to_dict(graph_buf)
        self.nodes = [ParsedNode(b) for b in g.get(1, [])]
        self.initializers: Dict[str, np.ndarray] = {}
        for t in g.get(5, []):
            name, arr = parse_tensor(t)
            self.initializers[name] = arr
        self.inputs = [self._vi_name(b) for b in g.get(11, [])]
        self.outputs = [self._vi_name(b) for b in g.get(12, [])]

    @staticmethod
    def _vi_name(buf: bytes) -> str:
        for field, _w, val in pb.iter_fields(buf):
            if field == 1:
                return val.decode()
        return ""


def load_model(path: str) -> ParsedModel:
    with open(path, "rb") as f:
        return ParsedModel(f.read())
