"""Progress watchdog for wedge-prone device backends.

A stuck collective or a dead device link leaves the Python process
blocked inside a C++ call — no
exception ever surfaces, so :func:`runtime.elastic.run_with_retries`
never gets a chance to retry. The reference has no failure story at all
(SURVEY.md §5); this module supplies the detection half that makes the
elastic half (retries + checkpointed resume) actually reachable:

- :class:`Watchdog` — a monitor thread that tracks a "last progress"
  timestamp. If no progress is reported within ``timeout_s`` it dumps
  every thread's traceback to stderr (so the wedge site is diagnosable)
  and terminates the process with exit code 124, the conventional
  timeout code. A supervising shell loop / scheduler restarts the run,
  which resumes from its last checkpoint
  (:func:`runtime.elastic.resumable_bundle_adjust`).
- pet() marks progress; use it after each host-visible completion (a
  fetched error value, a finished segment).

The abort-on-wedge default is deliberate: a process stuck in a device
RPC cannot unwind safely (the runtime's internal locks may be held), so
"die loudly and resume from checkpoint" is the only recovery that does
not risk corrupting in-flight state. Tests override ``on_timeout``.
"""

from __future__ import annotations

import faulthandler
import os
import sys
import threading
import time
from typing import Callable


def _default_abort(elapsed_s: float) -> None:
    sys.stderr.write(
        f"\n[mvrecon watchdog] no progress for {elapsed_s:.0f}s — dumping "
        "thread stacks and aborting with exit code 124 (resume from the "
        "last checkpoint).\n"
    )
    sys.stderr.flush()
    faulthandler.dump_traceback(file=sys.stderr)
    os._exit(124)


class Watchdog:
    """Monitor thread: abort (or call ``on_timeout``) when no progress is
    reported for ``timeout_s`` seconds.

    Usage::

        with Watchdog(timeout_s=600) as dog:
            for segment in segments:
                run_segment(segment)   # device work
                dog.pet()              # host-visible progress
    """

    def __init__(
        self,
        timeout_s: float,
        on_timeout: Callable[[float], None] | None = None,
        poll_s: float | None = None,
    ):
        self.timeout_s = float(timeout_s)
        self.on_timeout = on_timeout or _default_abort
        self.poll_s = poll_s if poll_s is not None else min(5.0, self.timeout_s / 4)
        self._last = time.monotonic()
        self._stop = threading.Event()
        self._fired = False
        self._thread: threading.Thread | None = None

    def pet(self) -> None:
        """Record progress (resets the timeout clock)."""
        self._last = time.monotonic()

    @property
    def fired(self) -> bool:
        return self._fired

    def _run(self) -> None:
        while not self._stop.wait(self.poll_s):
            elapsed = time.monotonic() - self._last
            if elapsed >= self.timeout_s:
                self._fired = True
                self.on_timeout(elapsed)
                return

    def start(self) -> "Watchdog":
        self.pet()
        self._thread = threading.Thread(
            target=self._run, name="mvrecon-watchdog", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2 * self.poll_s + 1)

    def __enter__(self) -> "Watchdog":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
