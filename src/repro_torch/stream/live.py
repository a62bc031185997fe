"""LiveQuery: a background refresh loop over an incremental query.

The thinnest possible driver: a daemon thread that calls
:meth:`~repro_torch.stream.incremental.IncrementalQuery.update` on an
interval.  Everything interesting already happens below it — polling
discovers new splits, the delta runs through the owning executor (for a
session-built query that means admission, fair scheduling, batching),
and every refresh appends one :class:`~repro_torch.runtime.reports.ActionReport`
(with the ``stream.*`` counters) to the query's report log.  When that
log is a session's :class:`~repro_torch.runtime.reports.ReportStream`,
``Session.follow()`` blocks until the next refresh lands — a live
dashboard is a ``follow()`` loop.  The current CUDA device is per
thread, so the refresh thread names the source's device.

Errors don't vanish into the thread: the first exception stops the loop
and is re-raised from :meth:`LiveQuery.stop` (and surfaced on
:attr:`error` meanwhile).
"""
from __future__ import annotations

import threading
from typing import Callable, Optional

from repro_torch.obs import METRICS
from repro_torch.runtime.executor import on_device
from repro_torch.stream.incremental import IncrementalQuery, StreamUpdate


class LiveQuery:
    """Continuously refresh an :class:`IncrementalQuery` (or
    :class:`~repro_torch.stream.windows.WindowedQuery`).

    .. code-block:: python

        with LiveQuery(query, interval_s=0.2) as live:
            while producing():
                drop_file(inbox)
                reports = session.follow(seen, timeout=5.0)
                seen += len(reports)
        # exiting stops the thread and re-raises any refresh error

    ``interval_s`` is the idle poll period — a refresh that found data
    immediately polls again (drain fast, sleep only when dry).
    ``max_epochs`` stops the loop after that many non-empty refreshes
    (None = run until :meth:`stop`); ``on_refresh`` is called with each
    :class:`StreamUpdate` from the refresh thread.
    """

    def __init__(self, query: IncrementalQuery, interval_s: float = 0.5,
                 max_epochs: Optional[int] = None,
                 on_refresh: Optional[Callable[[StreamUpdate], None]]
                 = None) -> None:
        if interval_s <= 0:
            raise ValueError(f"interval_s must be > 0, got {interval_s}")
        self.query = query
        self.interval_s = interval_s
        self.max_epochs = max_epochs
        self.on_refresh = on_refresh
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        self._latest: Optional[StreamUpdate] = None
        self._refreshes = 0
        self._error: Optional[BaseException] = None

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "LiveQuery":
        if self._thread is not None:
            raise RuntimeError("LiveQuery already started")
        self._thread = threading.Thread(
            target=self._loop, name=f"live-{self.query.label}", daemon=True)
        self._thread.start()
        METRICS.counter("stream.live_queries").inc()
        return self

    def _loop(self) -> None:
        with on_device(self.query.source.device):
            self._refresh_until_stopped()

    def _refresh_until_stopped(self) -> None:
        while not self._stop.is_set():
            try:
                update = self.query.update()
            except BaseException as e:  # surface on stop(), don't lose it
                with self._lock:
                    self._error = e
                METRICS.counter("stream.live_errors").inc()
                return
            if update is None:
                self._stop.wait(self.interval_s)
                continue
            with self._lock:
                self._latest = update
                self._refreshes += 1
                done = (self.max_epochs is not None
                        and self._refreshes >= self.max_epochs)
            if self.on_refresh is not None:
                self.on_refresh(update)
            if done:
                return

    def stop(self, timeout: Optional[float] = 10.0) -> None:
        """Stop the refresh loop and join the thread; re-raises the first
        error the loop hit (if any)."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None
        with self._lock:
            err, self._error = self._error, None
        if err is not None:
            raise err

    def __enter__(self) -> "LiveQuery":
        return self.start()

    def __exit__(self, *exc) -> None:
        # an exception already in flight wins over a refresh error
        if exc[0] is not None:
            self._stop.set()
            if self._thread is not None:
                self._thread.join(10.0)
                self._thread = None
            return
        self.stop()

    # -- state ---------------------------------------------------------------

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    @property
    def latest(self) -> Optional[StreamUpdate]:
        """Most recent non-empty refresh (None before the first)."""
        with self._lock:
            return self._latest

    @property
    def refreshes(self) -> int:
        """Non-empty refreshes completed so far."""
        with self._lock:
            return self._refreshes

    @property
    def error(self) -> Optional[BaseException]:
        with self._lock:
            return self._error

    def __repr__(self) -> str:
        state = "running" if self.running else "stopped"
        return (f"LiveQuery({self.query.label!r}, {state}, "
                f"refreshes={self.refreshes}, "
                f"watermark={self.query.epoch})")
