"""Asyncio helpers: spawned tasks always get an exception sink (a copy of
``nanofed_tpu/utils/aio.py``).

A bare ``asyncio.create_task`` whose reference is only shield-awaited (or
awaited under a broad ``except Exception: pass``) loses its traceback — the
failure surfaces as "Task exception was never retrieved" at interpreter exit,
long after the run that hit it has reported success.  fedlint's FED008 flags
those sites; :func:`spawn_logged` is the sanctioned replacement: the returned
task carries a done-callback that retrieves and logs any non-cancellation
exception the moment the task finishes, whatever the awaiting side does.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Any, Coroutine

__all__ = ["log_task_exception", "spawn_logged"]

_LOG = logging.getLogger("nanofed.aio")


def log_task_exception(task: asyncio.Task, log: logging.Logger | None = None) -> None:
    """Done-callback: retrieve (and log) the task's exception so it is never
    "never retrieved".  Cancellation is not an error.  Attachable directly —
    ``task.add_done_callback(log_task_exception)`` — for tasks that must be
    spawned through a specific loop rather than :func:`spawn_logged`."""
    if task.cancelled():
        return
    exc = task.exception()
    if exc is not None:
        (log or _LOG).error(
            "background task %r crashed: %r", task.get_name(), exc,
            exc_info=exc,
        )


def spawn_logged(
    coro: Coroutine[Any, Any, Any],
    *,
    name: str | None = None,
    log: logging.Logger | None = None,
) -> asyncio.Task:
    """``asyncio.create_task`` with a guaranteed exception sink.

    The caller may still await / cancel / shield the returned task normally;
    the logging callback is additive (an exception that also propagates to an
    awaiter is logged once here and raised there — abnormal paths may report
    twice, silent loss never happens).
    """
    task = asyncio.create_task(coro, name=name)
    task.add_done_callback(lambda t: log_task_exception(t, log))
    return task
