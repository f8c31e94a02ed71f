"""Trace decorator (port of ``vfp_tpu/utils/logging.py``): logs each call's
entry at DEBUG level, which ``cli --verbose`` turns on."""

from __future__ import annotations

import functools


def trace(logger):
    def decorator(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            logger.debug("Entering %s()", fn.__name__)
            return fn(*args, **kwargs)

        return wrapper

    return decorator
