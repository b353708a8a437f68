"""Hung-run watchdog.

reference: stream/KillSwitch.java:17 — aborts the process when no
progress is reported for too long ("Process has decided it has
crashed"). Used by long-running CLI loops; progress is signalled by
calling tick().
"""

from __future__ import annotations

import os
import sys
import threading
import time


class Watchdog:
    def __init__(self, max_seconds: float = 600.0,
                 message: str = "Process has decided it has crashed."):
        self.max_seconds = max_seconds
        self.message = message
        self._last = time.time()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def tick(self) -> None:
        self._last = time.time()

    def start(self) -> "Watchdog":
        def run():
            while not self._stop.wait(min(30.0, self.max_seconds / 4)):
                if time.time() - self._last > self.max_seconds:
                    sys.stderr.write(self.message + "\n")
                    os._exit(17)
        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
