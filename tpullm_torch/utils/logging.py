"""Async logger + verbosity system (≡ common/log.cpp).

The reference runs a dedicated log thread draining a message ring so hot
paths never block on stderr I/O (common_log's resume/pause worker); messages
carry a level, optional timestamp/prefix, and ANSI colors when the sink is a
TTY. Same design here: `log_add` enqueues (non-blocking), a daemon thread
formats + writes, `set_verbosity` gates levels, `log_pause`/`log_resume`
stop the worker around raw console output (interactive chat).

Env: TPULLM_LOG_VERBOSITY (int), TPULLM_LOG_COLORS (0/1/auto),
TPULLM_LOG_TIMESTAMPS (0/1), TPULLM_LOG_FILE (path tee).

The JAX package's utils/logging.py (standard library only), kept as the
port's own copy.
"""

from __future__ import annotations

import os
import queue
import sys
import threading
import time

# levels ≡ common/log.h
LEVEL_OUTPUT = 0  # tool output data — always shown
LEVEL_ERROR = 1
LEVEL_WARN = 2
LEVEL_INFO = 3
LEVEL_DEBUG = 4

_COL = {
    LEVEL_ERROR: "\033[31m",
    LEVEL_WARN: "\033[33m",
    LEVEL_INFO: "",
    LEVEL_DEBUG: "\033[90m",
    LEVEL_OUTPUT: "",
}
_COL_RESET = "\033[0m"
_PREFIX = {LEVEL_ERROR: "E", LEVEL_WARN: "W", LEVEL_INFO: "I",
           LEVEL_DEBUG: "D", LEVEL_OUTPUT: ""}


class AsyncLog:
    """Single-writer async sink (≡ struct common_log + its worker thread)."""

    def __init__(self, stream=None):
        self.stream = stream or sys.stderr
        self.verbosity = int(os.environ.get("TPULLM_LOG_VERBOSITY",
                                            LEVEL_INFO))
        colors_env = os.environ.get("TPULLM_LOG_COLORS", "auto")
        self.colors = (self.stream.isatty() if colors_env == "auto"
                       else colors_env not in ("0", "false", ""))
        self.timestamps = os.environ.get("TPULLM_LOG_TIMESTAMPS", "0") \
            not in ("0", "false", "")
        self.prefix = False
        self._file = None
        fpath = os.environ.get("TPULLM_LOG_FILE")
        if fpath:
            self.set_file(fpath)
        self._q: queue.Queue = queue.Queue(maxsize=4096)
        self._pause_flag = False
        self._t0 = time.monotonic()
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="tpullm-log")
        self._worker.start()

    # -- configuration (≡ common_log_set_*) --------------------------------

    def set_verbosity(self, v: int):
        self.verbosity = int(v)

    def set_colors(self, on: bool):
        self.colors = bool(on)

    def set_timestamps(self, on: bool):
        self.timestamps = bool(on)

    def set_prefix(self, on: bool):
        self.prefix = bool(on)

    def set_file(self, path: str | None):
        if self._file:
            self._file.close()
        self._file = open(path, "a", buffering=1) if path else None

    # -- producer side ------------------------------------------------------

    def add(self, level: int, msg: str):
        if level > self.verbosity and level != LEVEL_OUTPUT:
            return
        try:
            self._q.put_nowait((level, time.monotonic() - self._t0, msg))
        except queue.Full:  # hot path never blocks; drop the oldest
            try:
                self._q.get_nowait()
                self._q.put_nowait((level, 0.0, msg))
            except queue.Empty:
                pass

    # -- worker -------------------------------------------------------------

    def _format(self, level: int, ts: float, msg: str) -> str:
        parts = []
        if self.timestamps and level != LEVEL_OUTPUT:
            parts.append(f"{ts:10.3f} ")
        if self.prefix and level != LEVEL_OUTPUT:
            parts.append(f"{_PREFIX[level]} ")
        body = "".join(parts) + msg
        if self.colors and _COL[level]:
            body = _COL[level] + body + _COL_RESET
        return body

    def _run(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            while self._pause_flag:
                time.sleep(0.005)
            level, ts, msg = item
            line = self._format(level, ts, msg)
            try:
                self.stream.write(line + ("" if msg.endswith("\r") else "\n"))
                self.stream.flush()
            except ValueError:  # closed stream at interpreter exit
                return
            if self._file and level != LEVEL_OUTPUT:
                self._file.write(msg + "\n")

    def pause(self):
        """Stop draining (≡ common_log_pause) — around raw console output."""
        self.flush()
        self._pause_flag = True

    def resume(self):
        self._pause_flag = False

    def flush(self, timeout: float = 2.0):
        deadline = time.monotonic() + timeout
        while not self._q.empty() and time.monotonic() < deadline:
            time.sleep(0.002)


_MAIN: AsyncLog | None = None


def main_log() -> AsyncLog:
    global _MAIN
    if _MAIN is None:
        _MAIN = AsyncLog()
    return _MAIN


def set_verbosity(v: int):
    main_log().set_verbosity(v)


def log_error(msg: str):
    main_log().add(LEVEL_ERROR, msg)


def log_warn(msg: str):
    main_log().add(LEVEL_WARN, msg)


def log_info(msg: str):
    main_log().add(LEVEL_INFO, msg)


def log_debug(msg: str):
    main_log().add(LEVEL_DEBUG, msg)


def log_output(msg: str):
    main_log().add(LEVEL_OUTPUT, msg)
