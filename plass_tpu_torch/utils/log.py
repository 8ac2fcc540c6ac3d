"""Leveled logger with TTY color, mirroring the reference Debug levels
(lib/mmseqs/src/commons/Debug.h:43-47): NOTHING=0 ERROR=1 WARNING=2 INFO=3."""
import logging
import os
import sys

logger = logging.getLogger("plass_tpu_torch")


def setup(verbosity=3):
    level = {0: logging.CRITICAL, 1: logging.ERROR, 2: logging.WARNING,
             3: logging.INFO}.get(verbosity, logging.DEBUG)
    handler = logging.StreamHandler(sys.stderr)
    use_color = sys.stderr.isatty() and os.environ.get("TTY", "1") != "0"
    fmt = "%(message)s"
    if use_color:
        colors = {logging.ERROR: "\033[31m", logging.WARNING: "\033[33m"}

        class ColorFormatter(logging.Formatter):
            def format(self, record):
                msg = super().format(record)
                c = colors.get(record.levelno)
                return f"{c}{msg}\033[0m" if c else msg

        handler.setFormatter(ColorFormatter(fmt))
    else:
        handler.setFormatter(logging.Formatter(fmt))
    logger.handlers[:] = [handler]
    logger.setLevel(level)
    return logger


if not logger.handlers:
    setup()
