"""Logging helpers (counterpart of mxnet_tpu/log.py)."""
import logging

CRITICAL = logging.CRITICAL
ERROR = logging.ERROR
WARNING = logging.WARNING
INFO = logging.INFO
DEBUG = logging.DEBUG
NOTSET = logging.NOTSET

__all__ = ["get_logger", "getLogger", "CRITICAL", "ERROR", "WARNING",
           "INFO", "DEBUG", "NOTSET"]


def get_logger(name=None, filename=None, filemode=None, level=WARNING):
    """A configured logger. A ``filename`` replaces the logger's handlers
    (the old ones closed), so repeated calls leak no file."""
    logger = logging.getLogger(name)
    fmt = logging.Formatter("%(asctime)s [%(levelname)s] %(message)s",
                            datefmt="%H:%M:%S")
    if filename:
        for h in list(logger.handlers):
            logger.removeHandler(h)
            h.close()
        handler = logging.FileHandler(filename, filemode or "a")
        handler.setFormatter(fmt)
        logger.addHandler(handler)
    elif not logger.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(fmt)
        logger.addHandler(handler)
    logger.setLevel(level)
    return logger


getLogger = get_logger  # noqa: N816
