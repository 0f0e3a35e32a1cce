"""Hand-rolled protobuf wire codec for the four tiny messages in
protos/serve.proto.

Why not generated code: this image ships protoc 3.21 but a protobuf 6.x
Python runtime, which refuses 3.x-generated modules.  The messages are all
length-delimited scalar fields, whose wire format is trivial and frozen by
the protobuf spec — encoding them by hand keeps the TYPED service (callable
from any language that compiles serve.proto) without a codegen dependency.
Interop is pinned by tests that decode bytes produced by the real
google.protobuf runtime.

Wire format recap: each field is (field_number << 3 | wire_type) varint,
then for wire type 2 (len-delimited: strings, bytes, embedded) a varint
length + that many bytes.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

_LEN_TYPE = 2


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    shift = 0
    result = 0
    while True:
        if pos >= len(buf):
            raise ValueError("truncated varint")
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 63:
            raise ValueError("varint too long")


def _field(num: int, data: bytes) -> bytes:
    return _varint(num << 3 | _LEN_TYPE) + _varint(len(data)) + data


def _parse_fields(buf: bytes) -> Dict[int, List[bytes]]:
    """All len-delimited fields by number; other wire types are skipped
    (forward compatibility with clients sending unknown scalar fields)."""
    out: Dict[int, List[bytes]] = {}
    pos = 0
    while pos < len(buf):
        key, pos = _read_varint(buf, pos)
        num, wt = key >> 3, key & 0x7
        if wt == _LEN_TYPE:
            ln, pos = _read_varint(buf, pos)
            if pos + ln > len(buf):
                raise ValueError("truncated field")
            out.setdefault(num, []).append(buf[pos : pos + ln])
            pos += ln
        elif wt == 0:  # varint scalar: skip
            _, pos = _read_varint(buf, pos)
        elif wt == 5:  # fixed32
            pos += 4
            if pos > len(buf):
                raise ValueError("truncated fixed32 field")
        elif wt == 1:  # fixed64
            pos += 8
            if pos > len(buf):
                raise ValueError("truncated fixed64 field")
        else:
            raise ValueError(f"unsupported wire type {wt}")
    return out


# -- CallRequest { string application = 1; bytes payload = 2; } -------------


def encode_call_request(application: str, payload: bytes) -> bytes:
    return _field(1, application.encode()) + _field(2, payload)


def decode_call_request(buf: bytes) -> Tuple[str, bytes]:
    f = _parse_fields(buf)
    app = f.get(1, [b""])[-1].decode()
    payload = f.get(2, [b""])[-1]
    return app, payload


# -- CallResponse { bytes payload = 1; } ------------------------------------


def encode_call_response(payload: bytes) -> bytes:
    return _field(1, payload)


def decode_call_response(buf: bytes) -> bytes:
    return _parse_fields(buf).get(1, [b""])[-1]


# -- ListApplicationsResponse { repeated string application_names = 1; } ----


def encode_list_applications_response(names: List[str]) -> bytes:
    return b"".join(_field(1, n.encode()) for n in names)


def decode_list_applications_response(buf: bytes) -> List[str]:
    return [b.decode() for b in _parse_fields(buf).get(1, [])]


# -- HealthzResponse { string message = 1; } --------------------------------


def encode_healthz_response(message: str) -> bytes:
    return _field(1, message.encode())


def decode_healthz_response(buf: bytes) -> str:
    return _parse_fields(buf).get(1, [b""])[-1].decode()
