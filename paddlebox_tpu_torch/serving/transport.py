"""Length-prefixed frames between a fleet and its replica children
(counterpart of ``paddlebox_tpu/serving/transport.py``, the same bytes).

Every message is one frame: a 4-byte big-endian payload length, then the
payload. An object payload is a 2-byte ``WIRE_VERSION`` word, then the
pickle (requests carry ``SlotRecord`` batches, replies numpy scores). A
peer that dies mid-write leaves a torn frame, which the reader reports as
:class:`TornFrame` instead of unpickling garbage or blocking; a peer of
another build reports :class:`WireVersionMismatch` (an unversioned peer's
pickle starts with the 0x80 opcode, never a version word).

Fault points (``utils/faults.py`` ``SERVE_FAULT_OPS``): ``send_frame``
passes ``serve.frame_send`` before the header and ``serve.frame_mid``
between header and payload, where an injected ``OSError`` leaves a torn
frame for the peer, as a killed child does.

Imports neither torch nor numpy.
"""

from __future__ import annotations

import pickle
import socket
import struct
from typing import Any, Optional

from paddlebox_tpu_torch.serving.batcher import ServingError
from paddlebox_tpu_torch.utils import faults

_HEADER = struct.Struct(">I")

#: Version of the object layer (``send_obj``/``recv_obj``), stamped ahead
#: of every pickled payload and checked on receipt.
WIRE_VERSION = 1
_VERSION = struct.Struct(">H")

#: Bound on a frame's declared size: a corrupt header fails at once
#: instead of waiting on gigabytes that never arrive.
MAX_FRAME = 1 << 30


class TransportError(ServingError):
    """Base error of the replica wire transport."""


class TornFrame(TransportError):
    """The peer vanished mid-frame (or the header is garbage): the mark a
    killed child leaves."""


class WireVersionMismatch(TransportError):
    """The peer speaks another WIRE_VERSION (a parent and child of mixed
    builds, or an unversioned peer)."""


def _recv_exact(sock: socket.socket, n: int,
                frame_start: bool) -> Optional[bytes]:
    """Exactly ``n`` bytes; None on a clean EOF between frames,
    :class:`TornFrame` on EOF inside one."""
    chunks = []
    got = 0
    while got < n:
        chunk = sock.recv(n - got)
        if not chunk:
            if got == 0 and frame_start:
                return None
            raise TornFrame(
                f"peer closed mid-frame ({got}/{n} bytes arrived)")
        chunks.append(chunk)
        got += len(chunk)
    return b"".join(chunks)


def send_frame(sock: socket.socket, payload: bytes) -> None:
    """Write one frame: header and payload are separate sends, so
    ``serve.frame_mid`` tears the frame where a process death would."""
    if len(payload) > MAX_FRAME:
        raise TransportError(f"frame too large: {len(payload)} bytes")
    faults.io_point("serve.frame_send")
    sock.sendall(_HEADER.pack(len(payload)))
    faults.io_point("serve.frame_mid")
    sock.sendall(payload)


def recv_frame(sock: socket.socket) -> Optional[bytes]:
    """One frame's payload; None on a clean EOF between frames."""
    head = _recv_exact(sock, _HEADER.size, frame_start=True)
    if head is None:
        return None
    (n,) = _HEADER.unpack(head)
    if n > MAX_FRAME:
        raise TornFrame(f"impossible frame length {n} (corrupt header)")
    return _recv_exact(sock, n, frame_start=False)


def pack_obj(obj: Any) -> bytes:
    """The version-stamped pickled payload of ``obj``."""
    return _VERSION.pack(WIRE_VERSION) + \
        pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)


def unpack_obj(payload: bytes) -> Any:
    """Check the version word, then unpickle."""
    if len(payload) < _VERSION.size:
        raise WireVersionMismatch(
            f"runt payload ({len(payload)} bytes): no version word")
    (v,) = _VERSION.unpack(payload[:_VERSION.size])
    if v != WIRE_VERSION:
        hint = (" (unversioned pre-WIRE_VERSION peer?)"
                if v >= 0x8000 else " (mixed-build parent/child?)")
        raise WireVersionMismatch(
            f"peer speaks wire version {v}, this build speaks "
            f"{WIRE_VERSION}{hint}")
    return pickle.loads(payload[_VERSION.size:])


def send_obj(sock: socket.socket, obj: Any) -> None:
    send_frame(sock, pack_obj(obj))


def recv_obj(sock: socket.socket) -> Optional[Any]:
    """One message; None on a clean EOF (messages are never None)."""
    payload = recv_frame(sock)
    if payload is None:
        return None
    return unpack_obj(payload)
