"""Application logging that cooperates with tqdm progress bars.

The port of ``styletransfer_tpu/utils/logging.py``: one app-level logger
named ``StyleTransfer`` at INFO, a console handler that writes through
``tqdm.write`` on stderr (so progress bars stay pinned at the bottom), and a
file handler at ``runs/runtime.log`` (``constants.LOG_PATH``, in the working
directory, as the JAX package writes it) that each run truncates. Setup is
lazy, at the first :func:`get_logger`, and idempotent: importing the package
has no side effect. stdout stays free for the daemons' protocol lines.
"""

from __future__ import annotations

import logging
import os
import sys

from styletransfer_tpu_torch import constants

_LOGGER_NAME = "StyleTransfer"

LOGGER_FORMATTER = logging.Formatter(
    "%(asctime)s [%(levelname)s] %(module)s.%(funcName)s #%(lineno)d - %(message)s"
)


class TqdmLoggingHandler(logging.StreamHandler):
    """Console handler that emits through ``tqdm.write`` on **stderr**.

    ``sys.stderr`` is resolved when a line is written, not when the handler
    is built, so redirection (pytest capture, a shell ``2>``) always
    applies. Without tqdm it writes plainly to stderr."""

    def emit(self, record: logging.LogRecord) -> None:
        try:
            msg = self.format(record)
            try:
                import tqdm

                tqdm.tqdm.write(msg, file=sys.stderr)
            except ImportError:
                sys.stderr.write(msg + "\n")
            sys.stderr.flush()
        except (KeyboardInterrupt, SystemExit):
            raise
        except Exception:  # noqa: BLE001 - the logging.Handler contract
            self.handleError(record)


_configured = False


def _configure() -> logging.Logger:
    global _configured
    logger = logging.getLogger(_LOGGER_NAME)
    if _configured:
        return logger

    # Handlers are added once per process; those another package put on the
    # logger of the same name stay (the JAX package's, in a test process that
    # imports both).
    logger.setLevel(logging.INFO)
    console = TqdmLoggingHandler()
    console.setFormatter(LOGGER_FORMATTER)
    logger.addHandler(console)

    try:
        os.makedirs(constants.RUNS_PATH, exist_ok=True)
        file_handler = logging.FileHandler(constants.LOG_PATH, mode="w+")
        file_handler.setFormatter(LOGGER_FORMATTER)
        logger.addHandler(file_handler)
    except OSError:
        pass  # an unwritable working directory: console only

    _configured = True
    return logger


def get_logger() -> logging.Logger:
    """Return the application-wide logger, configured at the first call."""
    return _configure()
