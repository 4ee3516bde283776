"""Wire protocol for the distributed M_L tier (the port's copy of
`repro.serving.remote.wire`: its frames are byte-identical, so a port
client and a JAX server, or the reverse, speak to each other).

`RemoteStubBackend` pinned the serialized request/response contract over
an in-process pipe; this module promotes that contract to a real socket
wire format shared by the M_L server (`remote.server.MLServer`) and the
socket client (`remote.client.SocketBackend`):

  * **Framing** — length-prefixed JSON: a 4-byte big-endian unsigned
    length followed by that many bytes of UTF-8 JSON. Frames above
    `MAX_FRAME` are rejected before allocation (a corrupt length prefix
    must not OOM the server); a peer closing mid-frame raises
    `WireError("truncated frame")` rather than returning garbage.
  * **Envelope** — every message carries ``{"schema": SCHEMA_VERSION,
    "kind": <str>, ...}``. A schema mismatch is rejected loudly on both
    sides: the version bump is the escape hatch for breaking the wire
    format across rolling server/client upgrades (the golden fixture in
    tests/golden/wire_v1.json fails first otherwise).
  * **Payloads** — requests serialize as ``{"rid", "prompt"}`` and
    results as ``{"rid", "tokens", "batch_id", "n_real", "pad_to",
    "reason", "prompt_len"}`` — byte-compatible with the
    `RemoteStubBackend` JSON contract, now with strict decode-side
    validation that echoes the offending ``rid`` back in the error.

JSON bytes are canonical (sorted keys, no whitespace) so the golden
wire-format test can pin exact frame bytes, not just parsed content.
"""
from __future__ import annotations

import json
import math
import socket
import struct
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.serving.large_backend import LargeResult

# bump when the frame layout or payload fields change incompatibly; the
# server rejects clients speaking a different version (and vice versa)
SCHEMA_VERSION = 1

# hard ceiling on one frame's body: a corrupt/hostile length prefix must
# fail fast instead of driving a multi-GiB allocation
MAX_FRAME = 64 * 1024 * 1024

_LEN = struct.Struct(">I")


class WireError(RuntimeError):
    """Malformed frame or payload. `rid` carries the offending request id
    when one could be extracted (echoed back to the client so it can
    reject that request instead of killing the whole connection)."""

    def __init__(self, msg: str, rid: Optional[int] = None):
        super().__init__(msg)
        self.rid = rid


def dumps(obj: Dict[str, Any]) -> bytes:
    """Canonical JSON bytes (sorted keys, compact separators): the same
    logical message always serializes to the same bytes, which is what
    lets the golden test pin frames instead of parse trees."""
    return json.dumps(obj, sort_keys=True,
                      separators=(",", ":")).encode("utf-8")


def frame_bytes(obj: Dict[str, Any]) -> bytes:
    """Full frame (length prefix + canonical JSON body) for `obj`."""
    body = dumps(obj)
    if len(body) > MAX_FRAME:
        raise WireError(f"frame body {len(body)} bytes exceeds "
                        f"MAX_FRAME {MAX_FRAME}")
    return _LEN.pack(len(body)) + body


def send_frame(sock: socket.socket, obj: Dict[str, Any]) -> None:
    sock.sendall(frame_bytes(obj))


def _recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    """Read exactly `n` bytes. Returns None on clean EOF at a frame
    boundary (zero bytes read); raises WireError if the peer vanishes
    mid-frame. Socket timeouts propagate as socket.timeout."""
    chunks: List[bytes] = []
    got = 0
    while got < n:
        chunk = sock.recv(n - got)
        if not chunk:
            if got == 0:
                return None
            raise WireError(f"truncated frame: peer closed after "
                            f"{got}/{n} bytes")
        chunks.append(chunk)
        got += len(chunk)
    return b"".join(chunks)


def recv_frame(sock: socket.socket) -> Optional[Dict[str, Any]]:
    """Read one frame. Returns the decoded dict, or None on clean EOF
    (peer closed between frames). Raises WireError on a truncated frame,
    an oversize length prefix, undecodable JSON, or a non-object body."""
    head = _recv_exact(sock, _LEN.size)
    if head is None:
        return None
    (n,) = _LEN.unpack(head)
    if n > MAX_FRAME:
        raise WireError(f"frame length {n} exceeds MAX_FRAME {MAX_FRAME} "
                        f"(corrupt length prefix?)")
    body = _recv_exact(sock, n)
    if body is None:
        raise WireError("truncated frame: peer closed after length prefix")
    try:
        msg = json.loads(body.decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise WireError(f"undecodable frame body: {e}") from e
    if not isinstance(msg, dict):
        raise WireError(f"frame body must be a JSON object, "
                        f"got {type(msg).__name__}")
    return msg


def envelope(kind: str, **fields: Any) -> Dict[str, Any]:
    """Build a versioned message: schema + kind + payload fields."""
    return {"schema": SCHEMA_VERSION, "kind": kind, **fields}


def check_schema(msg: Dict[str, Any]) -> None:
    """Reject messages from a peer speaking a different wire version —
    the loud failure that makes the schema field a real rolling-upgrade
    escape hatch instead of decoration."""
    v = msg.get("schema")
    if v != SCHEMA_VERSION:
        raise WireError(f"wire schema mismatch: peer speaks {v!r}, "
                        f"this side speaks {SCHEMA_VERSION}")
    if not isinstance(msg.get("kind"), str):
        raise WireError("message missing 'kind'")


# -- request / response payloads (the RemoteStubBackend contract) -----------

def encode_request(rid: int, prompt: np.ndarray) -> Dict[str, Any]:
    return {"rid": int(rid), "prompt": np.asarray(prompt).tolist()}


def decode_request(d: Any) -> Tuple[int, np.ndarray]:
    """Validate + decode one submitted request. Raises WireError carrying
    the rid (when extractable) so the server can reject exactly that
    request instead of dropping the connection."""
    if not isinstance(d, dict):
        raise WireError(f"request must be an object, "
                        f"got {type(d).__name__}")
    rid = d.get("rid")
    if not isinstance(rid, int) or isinstance(rid, bool) or rid < 0:
        raise WireError(f"request rid must be a non-negative int, "
                        f"got {rid!r}")
    prompt = d.get("prompt")
    if (not isinstance(prompt, list) or not prompt
            or not all(isinstance(t, int) and not isinstance(t, bool)
                       for t in prompt)):
        raise WireError(f"rid {rid}: prompt must be a non-empty list of "
                        f"ints", rid=rid)
    return rid, np.asarray(prompt, np.int32)


def encode_result(res: LargeResult) -> Dict[str, Any]:
    out = {"rid": int(res.rid), "tokens": np.asarray(res.tokens).tolist(),
           "batch_id": int(res.batch_id), "n_real": int(res.n_real),
           "pad_to": int(res.pad_to), "reason": str(res.reason),
           "prompt_len": int(res.prompt_len)}
    # optional: only present when finite (JSON has no nan; omitting it
    # keeps pre-ladder frames byte-identical under SCHEMA_VERSION 1 —
    # the golden fixture pins that)
    conf = getattr(res, "confidence", math.nan)
    if isinstance(conf, float) and math.isfinite(conf):
        out["confidence"] = conf
    return out


def decode_result(d: Any) -> LargeResult:
    if not isinstance(d, dict):
        raise WireError(f"result must be an object, got {type(d).__name__}")
    try:
        return LargeResult(
            rid=int(d["rid"]),
            tokens=np.asarray(d["tokens"], np.int32),
            batch_id=int(d["batch_id"]), n_real=int(d["n_real"]),
            pad_to=int(d["pad_to"]), reason=str(d["reason"]),
            prompt_len=int(d["prompt_len"]),
            confidence=float(d.get("confidence", math.nan)))
    except (KeyError, TypeError, ValueError) as e:
        raise WireError(f"malformed result payload "
                        f"(rid={d.get('rid')!r}): {e}",
                        rid=d.get("rid") if isinstance(d.get("rid"), int)
                        else None) from e
