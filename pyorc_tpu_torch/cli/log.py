"""Colored console + file logging (reference ``pyorc/cli/log.py:12-97``)."""

import logging
import os
import sys

FMT = "%(asctime)s - %(name)s - %(levelname)s - %(message)s"


class CustomFormatter(logging.Formatter):
    """ANSI-colored level formatting."""

    grey = "\x1b[38;20m"
    yellow = "\x1b[33;20m"
    red = "\x1b[31;20m"
    bold_red = "\x1b[31;1m"
    reset = "\x1b[0m"

    FORMATS = {
        logging.DEBUG: grey + FMT + reset,
        logging.INFO: grey + FMT + reset,
        logging.WARNING: yellow + FMT + reset,
        logging.ERROR: red + FMT + reset,
        logging.CRITICAL: bold_red + FMT + reset,
    }

    def format(self, record):
        log_fmt = self.FORMATS.get(record.levelno, FMT)
        formatter = logging.Formatter(log_fmt)
        return formatter.format(record)


def setuplog(
    name: str = "pyorc_tpu_torch",
    path: str = None,
    log_level: int = 20,
    fmt: str = FMT,
    append: bool = True,
) -> logging.Logger:
    """Set up logger with console (colored) and optional file handler."""
    logger = logging.getLogger(name)
    for handler in list(logger.handlers):
        logger.removeHandler(handler)
    logger.handlers = []
    logger.setLevel(log_level)
    console = logging.StreamHandler(sys.stdout)
    console.setLevel(log_level)
    console.setFormatter(CustomFormatter())
    logger.addHandler(console)
    if path is not None:
        if os.path.dirname(path):
            os.makedirs(os.path.dirname(path), exist_ok=True)
        mode = "a" if append else "w"
        fh = logging.FileHandler(path, mode=mode)
        fh.setLevel(log_level)
        fh.setFormatter(logging.Formatter(fmt))
        logger.addHandler(fh)
    logger.info(f"Logger initialized: {name}")
    return logger
