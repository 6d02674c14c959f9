"""Small host-side helpers — the reference's `utils.rs` surface.

`elide_payload` mirrors the size-aware logging macros that hide payloads
>= 256 bytes (`reference/src/utils.rs:9-37`).  The char-device open /
binary-file helpers (utils.rs:60-84) and the retry combinator
(utils.rs:133-147) have no analog: PJRT owns the transport, a failed
transfer is not retried, and model "images" are compile-cache entries.
"""
from __future__ import annotations

_ELIDE_AT = 256  # bytes; utils.rs:9-37 threshold


def elide_payload(data, max_len: int = _ELIDE_AT) -> str:
    """Loggable repr of a payload, eliding bodies >= max_len bytes
    (the getter_log!/setter_log! behavior, utils.rs:9-37)."""
    try:
        n = len(data)
    except TypeError:
        return repr(data)
    if n >= max_len:
        return f"<{type(data).__name__} of {n} bytes>"
    return repr(data)
