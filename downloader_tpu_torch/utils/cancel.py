"""Cooperative cancellation, the rebuild's analogue of Go's context.Context.

The reference threads ctx through every layer (e.g. cmd/downloader/
downloader.go:28, internal/downloader/downloader.go:138) and cancels it on
SIGINT/SIGTERM/SIGHUP. This token provides the same shape for threads:
``cancel()`` flips an event observed by all holders, and child tokens let a
subsystem (e.g. the queue client's worker pool) be cancelled independently
while still inheriting parent cancellation — mirroring Go's derived
contexts (internal/rabbitmq/client.go:95-96).
"""

from __future__ import annotations

import threading
from typing import Callable

from .logging import get_logger

log = get_logger("cancel")


class Cancelled(Exception):
    """Raised by ``raise_if_cancelled`` once a token is cancelled."""


class CancelToken:
    def __init__(self, parent: "CancelToken | None" = None):
        self._event = threading.Event()
        self._lock = threading.Lock()
        self._children: list[CancelToken] = []
        self._callbacks: dict[int, object] = {}
        self._next_cb_id = 0
        self._parent = parent
        if parent is not None:
            with parent._lock:
                if parent._event.is_set():
                    self._event.set()
                else:
                    parent._children.append(self)

    def cancel(self) -> None:
        with self._lock:
            self._event.set()
            children, self._children = self._children, []
            callbacks, self._callbacks = list(self._callbacks.values()), {}
        for callback in callbacks:
            try:
                callback()  # type: ignore[operator]
            except Exception as exc:
                # cancellation must never fail because a hook did — but
                # a hook that cannot run usually means some I/O it was
                # meant to interrupt will now block to its timeout;
                # leave a trace for whoever debugs the slow shutdown
                log.debug(f"cancel hook raised: {exc}")
        for child in children:
            child.cancel()

    def add_callback(self, callback) -> "Callable[[], None]":
        """Run ``callback`` when cancelled (immediately if already cancelled);
        used to interrupt blocking I/O, e.g. closing an in-flight socket.
        Returns a function that unregisters the callback."""
        with self._lock:
            if not self._event.is_set():
                cb_id = self._next_cb_id
                self._next_cb_id += 1
                self._callbacks[cb_id] = callback

                def remove() -> None:
                    with self._lock:
                        self._callbacks.pop(cb_id, None)

                return remove
        callback()
        return lambda: None

    def cancelled(self) -> bool:
        return self._event.is_set()

    def raise_if_cancelled(self) -> None:
        if self._event.is_set():
            raise Cancelled()

    def wait(self, timeout: float | None = None) -> bool:
        """Block until cancelled (or timeout); returns True if cancelled."""
        return self._event.wait(timeout)

    def child(self) -> "CancelToken":  # protocol: cancel-token acquire
        """Derive a token cancelled when either it or this token cancels."""
        return CancelToken(parent=self)

    def detach(self) -> None:  # protocol: cancel-token release
        """Unlink this token from its parent's fan-out list. A
        per-job child token that is not detached when its job settles
        accumulates in the daemon-lifetime parent forever — one dead
        token per processed job. Idempotent; a detached token can
        still be cancelled directly, it just no longer hears parent
        cancellation (by detach time the job is over and there is
        nothing left to interrupt)."""
        parent, self._parent = self._parent, None
        if parent is None:
            return
        with parent._lock:
            try:
                parent._children.remove(self)
            except ValueError:
                pass  # parent cancelled meanwhile; list already swapped
