"""Typed error hierarchy — the `DriverClientError` analog.

The reference defines one thiserror enum wrapping I/O failures, readiness
gates and bad parameters plus a crate-wide Result alias
(`/root/reference/src/error.rs:4-32`).  Python exceptions play both roles;
the variants map 1:1 where the concept survives the move from FPGA to a JAX device:

  WriteError/ReadError (io + offset)  -> DeviceError (wraps the jax/XLA error)
  HBICAPNotReady                      -> NotReady (engine busy / buffer empty)
  InvalidPrimitiveParam               -> InvalidPrimitiveParam
  LoadFailed (bitstream)              -> LoadFailed (compilation warm-up)
  CsvError / FileError                -> DataError
  Unknown                             -> BlazeError (base)
"""
from __future__ import annotations


class BlazeError(Exception):
    """Base class for all framework errors (error.rs:4 analog)."""


class DeviceError(BlazeError, RuntimeError):
    """Device transfer / execution failure (error.rs Write/Read analogs).

    Carries the logical buffer name in place of the reference's register
    offset (`error.rs:7-14`)."""

    def __init__(self, msg: str, *, buffer: str | None = None):
        super().__init__(msg if buffer is None else f"{msg} (buffer: {buffer})")
        self.buffer = buffer


class NotReady(BlazeError, RuntimeError):
    """Operation attempted before the engine/buffer is ready
    (HBICAPNotReady analog, error.rs:16-17).

    Also a RuntimeError so callers written against the generic hierarchy
    keep working."""


class InvalidPrimitiveParam(BlazeError, ValueError):
    """Bad lifecycle parameter (error.rs:19-20)."""


class LoadFailed(BlazeError, RuntimeError):
    """Kernel warm-up / compilation failure (bitstream LoadFailed analog,
    error.rs:25-26)."""


class DataError(BlazeError, ValueError):
    """Malformed input bytes / constants files (CsvError + FileError
    analogs, error.rs:22-23,28-29)."""
