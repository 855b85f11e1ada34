"""Typed exit codes.

Capability mirror of SPAdes' error-code contract
(`src/common/utils/logger/error_codes.hpp` and its Python
mirror `spades_pipeline/support.py:39-59`): codes 64-127 are user errors,
1-63 internal errors; spades.py exits with these so wrappers can distinguish
bad input from crashes."""
from __future__ import annotations

from enum import IntEnum


class ExitCode(IntEnum):
    SUCCESS = 0
    INTERNAL_ERROR = 1
    # user errors (support.py:39-59)
    INVALID_INPUT_FORMAT = 64
    INVALID_OPTION_VALUE = 65
    FILE_NOT_FOUND = 66
    OUTPUT_DIR_ERROR = 67
    MEMORY_LIMIT_EXCEEDED = 68
    UNSUPPORTED_PLATFORM = 69


class SpadesError(Exception):
    """Raised by pipeline components; carries a typed exit code."""

    def __init__(self, message: str, code: ExitCode = ExitCode.INTERNAL_ERROR):
        super().__init__(message)
        self.code = code
