"""Context-scoped singleton logger and execution-timing decorator (a copy of
``nanofed_tpu/utils/logger.py``).

A singleton ``Logger`` with a component context stack, ANSI colors and console/file
handlers, on stdlib ``logging``, and the ``log_exec`` sync+async timing decorator.
``log_exec(block=True)`` synchronizes the card before the timer stops, so timings of
asynchronously launched GPU work mean something.  It logs under ``nanofed_tpu_torch``.
"""

from __future__ import annotations

import functools
import inspect
import logging
import sys
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Iterator, TypeVar

_COLORS = {
    "DEBUG": "\033[36m",  # cyan
    "INFO": "\033[32m",  # green
    "WARNING": "\033[33m",  # yellow
    "ERROR": "\033[31m",  # red
    "CRITICAL": "\033[35m",  # magenta
}
_RESET = "\033[0m"
_DIM = "\033[2m"


@dataclass(frozen=True)
class LogConfig:
    """Logging configuration: level, console and file sinks, colors."""

    level: int = logging.INFO
    console: bool = True
    file_path: str | Path | None = None
    color: bool = True


class _ContextFormatter(logging.Formatter):
    def __init__(self, color: bool) -> None:
        super().__init__()
        self._color = color

    def format(self, record: logging.LogRecord) -> str:
        ts = time.strftime("%H:%M:%S", time.localtime(record.created))
        ctx = getattr(record, "nf_context", "")
        ctx_part = f"[{ctx}] " if ctx else ""
        level = record.levelname
        msg = record.getMessage()
        if self._color and sys.stderr.isatty():
            color = _COLORS.get(level, "")
            return f"{_DIM}{ts}{_RESET} {color}{level:<8}{_RESET} {ctx_part}{msg}"
        return f"{ts} {level:<8} {ctx_part}{msg}"


class Logger:
    """Singleton logger with a component-context stack.

    Usage::

        log = Logger()
        with log.context("coordinator"):
            log.info("round %d started", r)
    """

    _instance: "Logger | None" = None

    def __new__(cls) -> "Logger":
        if cls._instance is None:
            cls._instance = super().__new__(cls)
            cls._instance._init()
        return cls._instance

    def _init(self) -> None:
        self._logger = logging.getLogger("nanofed_tpu_torch")
        self._logger.propagate = False
        self._context: list[str] = []
        self.configure(LogConfig())

    def configure(self, config: LogConfig) -> None:
        """(Re)configure handlers."""
        for h in list(self._logger.handlers):
            self._logger.removeHandler(h)
            h.close()
        self._logger.setLevel(config.level)
        if config.console:
            h = logging.StreamHandler(sys.stderr)
            h.setFormatter(_ContextFormatter(config.color))
            self._logger.addHandler(h)
        if config.file_path is not None:
            Path(config.file_path).parent.mkdir(parents=True, exist_ok=True)
            fh = logging.FileHandler(config.file_path)
            fh.setFormatter(_ContextFormatter(color=False))
            self._logger.addHandler(fh)

    @contextmanager
    def context(self, name: str) -> Iterator[None]:
        """Push a component name onto the context stack."""
        self._context.append(name)
        try:
            yield
        finally:
            self._context.pop()

    def _log(self, level: int, msg: str, *args: Any) -> None:
        self._logger.log(level, msg, *args, extra={"nf_context": ".".join(self._context)})

    def debug(self, msg: str, *args: Any) -> None:
        self._log(logging.DEBUG, msg, *args)

    def info(self, msg: str, *args: Any) -> None:
        self._log(logging.INFO, msg, *args)

    def warning(self, msg: str, *args: Any) -> None:
        self._log(logging.WARNING, msg, *args)

    def error(self, msg: str, *args: Any) -> None:
        self._log(logging.ERROR, msg, *args)


F = TypeVar("F", bound=Callable[..., Any])


def _synchronize() -> None:
    import torch

    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def log_exec(fn: F | None = None, *, block: bool = False, level: int = logging.DEBUG) -> Any:
    """Decorator logging wall-clock time of sync or async functions.

    With ``block=True`` the card is synchronized before the timer stops, so launched
    GPU work reports real device time, not launch time.
    """

    def deco(f: F) -> F:
        name = f.__qualname__

        if inspect.iscoroutinefunction(f):

            @functools.wraps(f)
            async def awrapper(*args: Any, **kwargs: Any) -> Any:
                t0 = time.perf_counter()
                try:
                    out = await f(*args, **kwargs)
                    if block:
                        _synchronize()
                    return out
                finally:
                    Logger()._log(level, "Completed %s in %.2fs", name, time.perf_counter() - t0)

            return awrapper  # type: ignore[return-value]

        @functools.wraps(f)
        def wrapper(*args: Any, **kwargs: Any) -> Any:
            t0 = time.perf_counter()
            try:
                out = f(*args, **kwargs)
                if block:
                    _synchronize()
                return out
            finally:
                Logger()._log(level, "Completed %s in %.2fs", name, time.perf_counter() - t0)

        return wrapper  # type: ignore[return-value]

    if fn is not None:
        return deco(fn)
    return deco
