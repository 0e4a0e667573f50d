"""Namespaced, optionally-colored logger (reference: kvcached/utils.py:212-258).

Engine-propagation is disabled so host-engine log config doesn't swallow or
duplicate our records.
"""

from __future__ import annotations

import logging
import os
import sys

_COLORS = {
    logging.DEBUG: "\033[36m",
    logging.INFO: "\033[32m",
    logging.WARNING: "\033[33m",
    logging.ERROR: "\033[31m",
    logging.CRITICAL: "\033[35m",
}
_RESET = "\033[0m"


class _ColorFormatter(logging.Formatter):
    def __init__(self, use_color: bool):
        super().__init__(
            "[%(asctime)s] [%(levelname)s] [%(name)s:%(lineno)d] %(message)s",
            datefmt="%H:%M:%S",
        )
        self._use_color = use_color

    def format(self, record: logging.LogRecord) -> str:
        msg = super().format(record)
        if self._use_color:
            color = _COLORS.get(record.levelno, "")
            if color:
                msg = f"{color}{msg}{_RESET}"
        return msg


def get_kvcached_logger(name: str = "kvcached_tpu") -> logging.Logger:
    logger = logging.getLogger(name)
    if getattr(logger, "_kvcached_configured", False):
        return logger
    level = os.getenv("KVCACHED_LOG_LEVEL", "INFO").upper()
    logger.setLevel(getattr(logging, level, logging.INFO))
    use_color = os.getenv("KVCACHED_LOG_COLOR", "auto")
    if use_color == "auto":
        colored = sys.stderr.isatty()
    else:
        colored = use_color.lower() in ("1", "true", "yes", "on")
    handler = logging.StreamHandler(sys.stderr)
    handler.setFormatter(_ColorFormatter(colored))
    logger.addHandler(handler)
    logger.propagate = False
    logger._kvcached_configured = True  # type: ignore[attr-defined]
    return logger
