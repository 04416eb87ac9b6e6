"""Application logging: one logger named ``StyleTransfer`` at INFO on stderr.

The JAX package's ``utils/logging.py`` contract for this slice. Setup is lazy
and idempotent, and writes no file, so importing the package has no side
effect; stdout stays free for programs that print results on it.
"""

from __future__ import annotations

import logging
import sys

_LOGGER_NAME = "StyleTransfer"

LOGGER_FORMATTER = logging.Formatter(
    "%(asctime)s [%(levelname)s] %(module)s.%(funcName)s #%(lineno)d - %(message)s"
)


class _StderrHandler(logging.StreamHandler):
    """Resolves ``sys.stderr`` at emit time, so redirection always applies."""

    def emit(self, record: logging.LogRecord) -> None:
        self.stream = sys.stderr
        super().emit(record)


def get_logger() -> logging.Logger:
    """Return the application-wide logger."""
    logger = logging.getLogger(_LOGGER_NAME)
    if not any(isinstance(h, _StderrHandler) for h in logger.handlers):
        logger.setLevel(logging.INFO)
        handler = _StderrHandler()
        handler.setFormatter(LOGGER_FORMATTER)
        logger.addHandler(handler)
    return logger
