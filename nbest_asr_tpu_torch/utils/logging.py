"""File+stdout logger -- a copy of ``nbest_asr_tpu/utils/logging.py``
(``make_logger`` :10; parity: `utils/util.py:6-17` -- bare-message format,
both handlers, DEBUG level)."""

from __future__ import annotations

import logging
import sys


def make_logger(fn: str, no_stdout: bool = False,
                name: str = "nbest_asr_tpu_torch") -> logging.Logger:
    formatter = logging.Formatter("%(message)s")
    logger = logging.getLogger(name)
    logger.setLevel(logging.DEBUG)
    # without this every metric line prints twice where a root handler is
    # configured (once more with an INFO: prefix)
    logger.propagate = False
    for h in logger.handlers:
        h.close()
    logger.handlers.clear()
    fh = logging.FileHandler(fn, mode="w")
    fh.setFormatter(formatter)
    logger.addHandler(fh)
    if not no_stdout:
        sh = logging.StreamHandler(sys.stdout)
        sh.setFormatter(formatter)
        logger.addHandler(sh)
    return logger
