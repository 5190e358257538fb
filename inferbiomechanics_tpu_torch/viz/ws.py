"""Minimal RFC 6455 WebSocket framing (server side), stdlib only.

The reference's live GUI rode NimbleGUI's embedded C++ web server
(visualize.py:123-127); the TPU-native rebuild streams viewer frames over
a WebSocket implemented directly on stdlib sockets — handshake
(Sec-WebSocket-Accept), server->client frame encoding (unmasked) and
client->server decoding (masked), text/ping/pong/close opcodes. No
external dependency, so it works in air-gapped TPU pods.
"""

from __future__ import annotations

import base64
import hashlib
import struct
from typing import List, Optional, Tuple

_GUID = '258EAFA5-E914-47DA-95CA-C5AB0DC85B11'

OP_CONT, OP_TEXT, OP_BINARY, OP_CLOSE, OP_PING, OP_PONG = 0, 1, 2, 8, 9, 10


def accept_key(sec_websocket_key: str) -> str:
    """Sec-WebSocket-Accept for a client's Sec-WebSocket-Key."""
    digest = hashlib.sha1((sec_websocket_key.strip() + _GUID).encode()).digest()
    return base64.b64encode(digest).decode()


def handshake_response(sec_websocket_key: str) -> bytes:
    return ('HTTP/1.1 101 Switching Protocols\r\n'
            'Upgrade: websocket\r\n'
            'Connection: Upgrade\r\n'
            f'Sec-WebSocket-Accept: {accept_key(sec_websocket_key)}\r\n'
            '\r\n').encode()


def encode_frame(payload: bytes, opcode: int = OP_TEXT) -> bytes:
    """One server->client frame (FIN set, unmasked per RFC 6455 §5.1)."""
    head = bytes([0x80 | opcode])
    n = len(payload)
    if n < 126:
        head += bytes([n])
    elif n < (1 << 16):
        head += bytes([126]) + struct.pack('>H', n)
    else:
        head += bytes([127]) + struct.pack('>Q', n)
    return head + payload


def decode_frames(buf: bytes) -> Tuple[List[Tuple[int, bytes]], bytes]:
    """Parse complete client frames from `buf`.

    Returns ([(opcode, payload), ...], remainder), reassembling fragmented
    messages (RFC 6455 §5.4): continuation frames are concatenated onto
    the initial frame's payload and surfaced once, with the initial
    opcode, when the FIN frame arrives. Client frames are masked
    (§5.3); unmasked frames are tolerated.
    """
    out: List[Tuple[int, bytes]] = []
    frag_opcode: int = -1
    frag_payload = b''
    pos = 0
    frag_start = 0      # buffer position of the unfinished fragment sequence
    frag_out_mark = 0   # frames emitted before the fragment started
    n = len(buf)
    while True:
        if n - pos < 2:
            break
        b0, b1 = buf[pos], buf[pos + 1]
        fin = bool(b0 & 0x80)
        opcode = b0 & 0x0F
        masked = bool(b1 & 0x80)
        ln = b1 & 0x7F
        p = pos + 2
        if ln == 126:
            if n - p < 2:
                break
            ln = struct.unpack_from('>H', buf, p)[0]
            p += 2
        elif ln == 127:
            if n - p < 8:
                break
            ln = struct.unpack_from('>Q', buf, p)[0]
            p += 8
        mask: Optional[bytes] = None
        if masked:
            if n - p < 4:
                break
            mask = buf[p:p + 4]
            p += 4
        if n - p < ln:
            break
        payload = buf[p:p + ln]
        if mask:
            payload = bytes(c ^ mask[i % 4] for i, c in enumerate(payload))
        if opcode == OP_CONT and frag_opcode >= 0:
            frag_payload += payload
            if fin:
                out.append((frag_opcode, frag_payload))
                frag_opcode, frag_payload = -1, b''
        elif not fin and opcode in (OP_TEXT, OP_BINARY):
            frag_opcode, frag_payload = opcode, payload
            frag_start = pos
            frag_out_mark = len(out)
        else:
            out.append((opcode, payload))
        pos = p + ln
    if frag_opcode >= 0:
        # message still fragmented: keep its bytes in the remainder so the
        # next call re-parses them with the missing continuation appended —
        # and withhold any frames parsed AFTER the fragment start (they are
        # inside the remainder and would otherwise be delivered twice)
        return out[:frag_out_mark], buf[frag_start:]
    return out, buf[pos:]


def encode_client_frame(payload: bytes, opcode: int = OP_TEXT,
                        mask: bytes = b'\x11\x22\x33\x44') -> bytes:
    """One masked client->server frame (used by tests as a WS client)."""
    head = bytes([0x80 | opcode])
    n = len(payload)
    if n < 126:
        head += bytes([0x80 | n])
    elif n < (1 << 16):
        head += bytes([0x80 | 126]) + struct.pack('>H', n)
    else:
        head += bytes([0x80 | 127]) + struct.pack('>Q', n)
    body = bytes(c ^ mask[i % 4] for i, c in enumerate(payload))
    return head + mask + body
