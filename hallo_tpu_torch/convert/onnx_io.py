"""Dependency-free ONNX file reader/writer (protobuf wire-format subset).

The port's copy of hallo_tpu/convert/onnx_io.py (the port imports nothing
of the JAX package); its graphs run through `convert.onnx_torch`.

The reference's face-analysis stack executes two ONNX models through
onnxruntime (image_processor.py:100-138: `scrfd_10g_bnkps.onnx` detection +
`glintr100.onnx` ArcFace embedding). This environment has neither
onnxruntime nor the `onnx` package, and SURVEY.md §2.3 calls for a
TPU-native equivalent ("port inference to JAX"). The port needs to LOAD
the model files, so this module implements just enough of the protobuf
wire format to decode (and, for tests, encode) the ONNX schema subset
those models use. Field numbers come from the public onnx.proto3 schema
and are frozen by protobuf compatibility rules.

No protobuf runtime dependency: the wire format is ~4 primitives
(varint, fixed32, fixed64, length-delimited) and the schema subset is
small, so a hand decoder is both smaller and more robust here than
generating bindings with protoc at build time.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Dict, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np

# ---------------------------------------------------------------------------
# Wire-format primitives


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
        if shift > 70:
            raise ValueError("malformed varint")


def _iter_fields(buf: bytes) -> Iterator[Tuple[int, int, Union[int, bytes]]]:
    """Yield (field_number, wire_type, value); value is int for varint/fixed
    and bytes for length-delimited."""
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        field, wt = tag >> 3, tag & 7
        if wt == 0:  # varint
            val, pos = _read_varint(buf, pos)
            yield field, wt, val
        elif wt == 1:  # 64-bit
            yield field, wt, int.from_bytes(buf[pos : pos + 8], "little")
            pos += 8
        elif wt == 2:  # length-delimited
            ln, pos = _read_varint(buf, pos)
            yield field, wt, buf[pos : pos + ln]
            pos += ln
        elif wt == 5:  # 32-bit
            yield field, wt, int.from_bytes(buf[pos : pos + 4], "little")
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wt}")


def _signed(v: int) -> int:
    """Protobuf int64 varints are two's complement in 64 bits."""
    return v - (1 << 64) if v >= 1 << 63 else v


def _packed_varints(data: Union[int, bytes]) -> List[int]:
    if isinstance(data, int):  # unpacked repeated element
        return [_signed(data)]
    out, pos = [], 0
    while pos < len(data):
        v, pos = _read_varint(data, pos)
        out.append(_signed(v))
    return out


# ---------------------------------------------------------------------------
# Schema structures (the subset the executor needs)

# TensorProto.DataType → numpy
_DTYPES: Dict[int, np.dtype] = {
    1: np.dtype(np.float32),
    2: np.dtype(np.uint8),
    3: np.dtype(np.int8),
    4: np.dtype(np.uint16),
    5: np.dtype(np.int16),
    6: np.dtype(np.int32),
    7: np.dtype(np.int64),
    9: np.dtype(np.bool_),
    10: np.dtype(np.float16),
    11: np.dtype(np.float64),
    12: np.dtype(np.uint32),
    13: np.dtype(np.uint64),
}
_DTYPE_CODES = {v: k for k, v in _DTYPES.items()}


@dataclasses.dataclass
class OnnxNode:
    op_type: str
    inputs: List[str]
    outputs: List[str]
    attrs: Dict[str, object]
    name: str = ""


@dataclasses.dataclass
class OnnxGraph:
    nodes: List[OnnxNode]
    initializers: Dict[str, np.ndarray]
    inputs: List[Tuple[str, Optional[List[int]]]]  # (name, static shape or None)
    outputs: List[str]
    name: str = ""


@dataclasses.dataclass
class OnnxModel:
    graph: OnnxGraph
    opset: int = 11


# ---------------------------------------------------------------------------
# Decoding


def _decode_tensor(buf: bytes) -> Tuple[str, np.ndarray]:
    dims: List[int] = []
    dtype_code = 1
    name = ""
    raw: Optional[bytes] = None
    floats: List[float] = []
    ints: List[int] = []
    for field, wt, val in _iter_fields(buf):
        if field == 1:  # dims
            dims.extend(_packed_varints(val))
        elif field == 2:
            dtype_code = int(val)
        elif field == 4:  # float_data
            if wt == 5:
                floats.append(struct.unpack("<f", int(val).to_bytes(4, "little"))[0])
            else:
                floats.extend(struct.unpack(f"<{len(val) // 4}f", val))
        elif field in (5, 7):  # int32_data / int64_data
            ints.extend(_packed_varints(val))
        elif field == 8:
            name = val.decode()
        elif field == 9:
            raw = bytes(val)
        elif field == 13:
            raise ValueError(
                f"tensor {name!r} uses external data — not supported"
            )
    dtype = _DTYPES.get(dtype_code)
    if dtype is None:
        raise ValueError(f"tensor {name!r}: unsupported data type {dtype_code}")
    if raw is not None:
        arr = np.frombuffer(raw, dtype=dtype).copy()
    elif floats:
        arr = np.asarray(floats, np.float32).astype(dtype)
    else:
        arr = np.asarray(ints, np.int64).astype(dtype)
    return name, arr.reshape(dims) if dims else arr.reshape(())


def _decode_attr(buf: bytes) -> Tuple[str, object]:
    name = ""
    # AttributeProto fields: f=2, i=3, s=4, t=5, floats=7, ints=8, strings=9
    value: object = None
    ints: List[int] = []
    floats: List[float] = []
    strings: List[str] = []
    for field, wt, val in _iter_fields(buf):
        if field == 1:
            name = val.decode()
        elif field == 2:
            value = struct.unpack("<f", int(val).to_bytes(4, "little"))[0]
        elif field == 3:
            value = _signed(int(val))
        elif field == 4:
            value = val.decode(errors="replace")
        elif field == 5:
            value = _decode_tensor(val)[1]
        elif field == 7:
            if wt == 5:
                floats.append(struct.unpack("<f", int(val).to_bytes(4, "little"))[0])
            else:
                floats.extend(struct.unpack(f"<{len(val) // 4}f", val))
        elif field == 8:
            ints.extend(_packed_varints(val))
        elif field == 9:
            strings.append(val.decode(errors="replace"))
    if ints:
        value = ints
    elif floats:
        value = floats
    elif strings:
        value = strings
    return name, value


def _decode_value_info(buf: bytes) -> Tuple[str, Optional[List[int]]]:
    name = ""
    shape: Optional[List[int]] = None
    for field, _, val in _iter_fields(buf):
        if field == 1:
            name = val.decode()
        elif field == 2:  # TypeProto
            for f2, _, v2 in _iter_fields(val):
                if f2 != 1:  # tensor_type
                    continue
                for f3, _, v3 in _iter_fields(v2):
                    if f3 != 2:  # shape
                        continue
                    dims: List[int] = []
                    for f4, _, v4 in _iter_fields(v3):
                        if f4 != 1:  # dim
                            continue
                        dv = -1
                        for f5, _, v5 in _iter_fields(v4):
                            if f5 == 1:  # dim_value
                                dv = _signed(int(v5))
                        dims.append(dv)
                    shape = dims
    return name, shape


def _decode_node(buf: bytes) -> OnnxNode:
    inputs: List[str] = []
    outputs: List[str] = []
    attrs: Dict[str, object] = {}
    op_type = ""
    name = ""
    for field, _, val in _iter_fields(buf):
        if field == 1:
            inputs.append(val.decode())
        elif field == 2:
            outputs.append(val.decode())
        elif field == 3:
            name = val.decode()
        elif field == 4:
            op_type = val.decode()
        elif field == 5:
            k, v = _decode_attr(val)
            attrs[k] = v
    return OnnxNode(op_type, inputs, outputs, attrs, name)


def _decode_graph(buf: bytes) -> OnnxGraph:
    nodes: List[OnnxNode] = []
    inits: Dict[str, np.ndarray] = {}
    inputs: List[Tuple[str, Optional[List[int]]]] = []
    outputs: List[str] = []
    name = ""
    for field, _, val in _iter_fields(buf):
        if field == 1:
            nodes.append(_decode_node(val))
        elif field == 2:
            name = val.decode()
        elif field == 5:
            k, arr = _decode_tensor(val)
            inits[k] = arr
        elif field == 11:
            inputs.append(_decode_value_info(val))
        elif field == 12:
            outputs.append(_decode_value_info(val)[0])
    # graph "inputs" include initializers in some exporters; keep true inputs
    inputs = [(n, s) for n, s in inputs if n not in inits]
    return OnnxGraph(nodes, inits, inputs, outputs, name)


def load_onnx(path_or_bytes: Union[str, bytes]) -> OnnxModel:
    """Parse an ONNX ModelProto from a file path or raw bytes."""
    if isinstance(path_or_bytes, (bytes, bytearray)):
        buf = bytes(path_or_bytes)
    else:
        with open(path_or_bytes, "rb") as f:
            buf = f.read()
    graph: Optional[OnnxGraph] = None
    opset = 11
    for field, _, val in _iter_fields(buf):
        if field == 7:  # ModelProto.graph
            graph = _decode_graph(val)
        elif field == 8:  # opset_import: OperatorSetIdProto {domain=1, version=2}
            for f2, _, v2 in _iter_fields(val):
                if f2 == 2:
                    opset = _signed(int(v2))
    if graph is None:
        raise ValueError("no graph in model (not an ONNX file?)")
    return OnnxModel(graph, opset)


# ---------------------------------------------------------------------------
# Encoding (used by tests to build fixtures; also lets users re-save graphs)


def _varint(v: int) -> bytes:
    if v < 0:
        v += 1 << 64
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        out.append(b | (0x80 if v else 0))
        if not v:
            return bytes(out)


def _field(num: int, wt: int, payload: bytes) -> bytes:
    head = _varint((num << 3) | wt)
    if wt == 2:
        return head + _varint(len(payload)) + payload
    return head + payload


def _str_field(num: int, s: str) -> bytes:
    return _field(num, 2, s.encode())


def _encode_tensor(name: str, arr: np.ndarray) -> bytes:
    # NB: np.ascontiguousarray promotes 0-d to 1-d — keep dims from the
    # original array so scalar initializers stay 0-d through a round trip.
    arr = np.asarray(arr)
    code = _DTYPE_CODES[arr.dtype]
    out = b"".join(_field(1, 0, _varint(int(d))) for d in arr.shape)
    out += _field(2, 0, _varint(code))
    out += _str_field(8, name)
    out += _field(9, 2, np.ascontiguousarray(arr).tobytes())
    return out


def _encode_attr(name: str, value: object) -> bytes:
    out = _str_field(1, name)
    if isinstance(value, float):
        out += _field(2, 5, struct.pack("<f", value)) + _field(20, 0, _varint(1))
    elif isinstance(value, (bool, int, np.integer)):
        out += _field(3, 0, _varint(int(value))) + _field(20, 0, _varint(2))
    elif isinstance(value, str):
        out += _str_field(4, value) + _field(20, 0, _varint(3))
    elif isinstance(value, np.ndarray):
        out += _field(5, 2, _encode_tensor("", value)) + _field(20, 0, _varint(4))
    elif isinstance(value, (list, tuple)) and value and isinstance(value[0], float):
        out += _field(7, 2, struct.pack(f"<{len(value)}f", *value))
        out += _field(20, 0, _varint(6))
    elif isinstance(value, (list, tuple)):
        out += _field(8, 2, b"".join(_varint(int(v)) for v in value))
        out += _field(20, 0, _varint(7))
    else:
        raise TypeError(f"attr {name}: unsupported {type(value)}")
    return out


def _encode_value_info(name: str, shape: Sequence[int]) -> bytes:
    dims = b"".join(
        _field(1, 2, _field(1, 0, _varint(int(d)))) for d in shape
    )
    tensor_type = _field(1, 0, _varint(1)) + _field(2, 2, dims)  # elem f32
    return _str_field(1, name) + _field(2, 2, _field(1, 2, tensor_type))


def save_onnx(
    path: str,
    nodes: Sequence[OnnxNode],
    initializers: Dict[str, np.ndarray],
    inputs: Dict[str, Sequence[int]],
    outputs: Dict[str, Sequence[int]],
    opset: int = 11,
) -> None:
    """Serialize a graph to an ONNX file loadable by load_onnx (and by real
    onnx runtimes — the encoding is standard)."""
    g = _str_field(2, "graph")
    for n in nodes:
        body = b"".join(_str_field(1, s) for s in n.inputs)
        body += b"".join(_str_field(2, s) for s in n.outputs)
        body += _str_field(3, n.name or n.op_type)
        body += _str_field(4, n.op_type)
        body += b"".join(_field(5, 2, _encode_attr(k, v)) for k, v in n.attrs.items())
        g += _field(1, 2, body)
    for k, arr in initializers.items():
        g += _field(5, 2, _encode_tensor(k, arr))
    for k, shape in inputs.items():
        g += _field(11, 2, _encode_value_info(k, shape))
    for k, shape in outputs.items():
        g += _field(12, 2, _encode_value_info(k, shape))
    model = _field(1, 0, _varint(7))  # ir_version
    model += _field(8, 2, _field(2, 0, _varint(opset)))
    model += _field(7, 2, g)
    with open(path, "wb") as f:
        f.write(model)
