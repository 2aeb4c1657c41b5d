"""Progress/throughput telemetry.

Reference: src/task.rs. A background thread logs
`desc | %done | ETA | MB/s | MB/s per worker` every second while a
corpus pass runs; start/finish summary lines bracket it. This is the
framework's canonical training-speed metric (MB/s per stage). The port
runs as one process, so every Task logs.
"""

from __future__ import annotations

import logging
import os
import threading
import time

log = logging.getLogger("tokengeex.task")


def mb_per_sec(n: int, since: float) -> float:
    """reference: src/task.rs:139-141."""
    elapsed = time.monotonic() - since
    if elapsed <= 0:
        return 0.0
    return (n / 1024.0 / 1024.0) / elapsed


def num_workers() -> int:
    env = os.environ.get("TOKENGEEX_NUM_THREADS")
    if env:
        return max(1, int(env))
    return os.cpu_count() or 1


class Task:
    """reference: src/task.rs:10-128."""

    def __init__(self, desc: str, num_samples: int):
        self.desc = desc
        self.num_samples = num_samples
        self._samples_done = 0
        self._bytes_done = 0
        self._lock = threading.Lock()
        self._finished = threading.Event()
        self._start = time.monotonic()
        self._thread: threading.Thread | None = None
        log.info("%s | %d samples | %d workers", desc, num_samples,
                 num_workers())

    def start(self) -> None:
        self._start = time.monotonic()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def record(self, nbytes: int, nsamples: int = 0) -> None:
        with self._lock:
            self._bytes_done += nbytes
            self._samples_done += nsamples

    def finish(self) -> None:
        self._finished.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
        log.info(
            "FINISHED %s | %d samples | %.2fMB/s | %.2fs",
            self.desc,
            self.num_samples,
            mb_per_sec(self._bytes_done, self._start),
            time.monotonic() - self._start,
        )

    @property
    def bytes_done(self) -> int:
        return self._bytes_done

    @property
    def elapsed(self) -> float:
        return time.monotonic() - self._start

    def _loop(self) -> None:
        while not self._finished.wait(1.0):
            with self._lock:
                done = self._samples_done
                nbytes = self._bytes_done
            if done >= self.num_samples:
                break
            pct = (done / self.num_samples) * 100.0 if self.num_samples else 0.0
            if pct == 0.0:
                continue
            eta = (self.elapsed / pct) * (100.0 - pct)
            rate = mb_per_sec(nbytes, self._start)
            log.debug(
                "%s | %6.2f%% | ETA %5.0fs | %5.2fMB/s | %5.2fMB/s per worker",
                self.desc, pct, eta, rate, rate / num_workers(),
            )
