"""Subprocess helpers: timeout prefix + asynchronous pipe reader.

Equivalents of the reference's process plumbing (reference
auto_rx/autorx/utils.py:53-80 `timeout_cmd`, :380-434
`AsynchronousFileReader`).  Capture subprocesses are always run under a
`timeout` prefix so a wedged SDR can never hang the station.
"""

import contextlib
import os
import platform
import shutil
import threading
import queue


@contextlib.contextmanager
def jax_cpu_children():
    """Processes started inside this block (``spawn`` start method) run
    JAX on the CPU: they inherit ``JAX_PLATFORMS=cpu`` from the
    environment at start-up, before they can import JAX.  A JAX process
    reserves most of an accelerator's memory the first time it touches
    it, so a helper process that did so would starve the process that
    owns the card.  The parent's own JAX is unaffected once imported."""
    old = os.environ.get("JAX_PLATFORMS")
    os.environ["JAX_PLATFORMS"] = "cpu"
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("JAX_PLATFORMS", None)
        else:
            os.environ["JAX_PLATFORMS"] = old


def timeout_cmd() -> str:
    """The timeout binary for this platform (reference utils.py:53-80):
    plain `timeout -k 30` where available, `gtimeout` on macOS."""
    if platform.system() == "Darwin":
        return "gtimeout -k 30 "
    if shutil.which("timeout"):
        return "timeout -k 30 "
    return ""


class AsynchronousFileReader(threading.Thread):
    """Drain a pipe on a daemon thread into a queue so the caller can poll
    without blocking (reference utils.py:380-434)."""

    def __init__(self, fd, autostart: bool = True):
        threading.Thread.__init__(self)
        self.daemon = True
        self._fd = fd
        self._queue = queue.Queue()
        self._running = True
        if autostart:
            self.start()

    def run(self):
        while self._running:
            line = self._fd.readline()
            if not line:
                break
            self._queue.put(line)
        self._running = False

    def eof(self) -> bool:
        return not self.is_alive() and self._queue.empty()

    def stop(self):
        self._running = False

    def readlines(self):
        while not self._queue.empty():
            yield self._queue.get()
