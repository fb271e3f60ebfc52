"""Copied from ``lightgbm_tpu/utils/log.py`` for the PyTorch port (which imports nothing of
the JAX package); only imports and device hooks differ.

Leveled logging with an overridable sink.

TPU-native counterpart of the reference logger (include/LightGBM/utils/log.h:37-76):
Debug/Info/Warning/Fatal levels, Fatal raises, and a user-registerable callback the
language bindings use to reroute output.
"""
from __future__ import annotations

import sys
from typing import Callable, Optional


class LightGBMError(Exception):
    """Raised by Log.fatal — mirrors the reference's Fatal-throws contract."""


class _LogLevel:
    FATAL = -1
    WARNING = 0
    INFO = 1
    DEBUG = 2


class Log:
    """Static logger: ``Log.debug/info/warning/fatal`` gated by ``Log.reset_level``."""

    Level = _LogLevel
    _level: int = _LogLevel.INFO
    _callback: Optional[Callable[[str], None]] = None

    @classmethod
    def reset_level(cls, level: int) -> None:
        cls._level = level

    @classmethod
    def level_from_verbosity(cls, verbosity: int) -> int:
        if verbosity < 0:
            return _LogLevel.FATAL
        if verbosity == 0:
            return _LogLevel.WARNING
        if verbosity == 1:
            return _LogLevel.INFO
        return _LogLevel.DEBUG

    @classmethod
    def reset_callback(cls, callback: Optional[Callable[[str], None]]) -> None:
        cls._callback = callback

    @classmethod
    def _write(cls, level: int, tag: str, msg: str) -> None:
        if level > cls._level:
            return
        line = "[LightGBM-TPU] [%s] %s\n" % (tag, msg)
        if cls._callback is not None:
            cls._callback(line)
        else:
            sys.stdout.write(line)
            sys.stdout.flush()

    @classmethod
    def debug(cls, msg: str, *args) -> None:
        cls._write(_LogLevel.DEBUG, "Debug", msg % args if args else msg)

    @classmethod
    def info(cls, msg: str, *args) -> None:
        cls._write(_LogLevel.INFO, "Info", msg % args if args else msg)

    @classmethod
    def warning(cls, msg: str, *args) -> None:
        cls._write(_LogLevel.WARNING, "Warning", msg % args if args else msg)

    @classmethod
    def fatal(cls, msg: str, *args) -> None:
        text = msg % args if args else msg
        line = "[LightGBM-TPU] [Fatal] %s\n" % text
        if cls._callback is not None:
            cls._callback(line)
        else:
            sys.stderr.write(line)
            sys.stderr.flush()
        raise LightGBMError(text)
