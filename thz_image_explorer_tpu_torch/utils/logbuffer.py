"""Ring-buffer log capture.

The port's own copy of ``thz_image_explorer_tpu/utils/logbuffer.py``, the
equivalent of the reference's ``egui_logger`` integration: all log records
go to a bounded ring buffer viewable in the settings window, and the latest
warn/error is surfaced in the status bar (``gui/application.rs:304-471``,
``main.rs:138-142`` caps the level at Info because of framework spam).
"""

from __future__ import annotations

import collections
import logging
from typing import Optional


class LogRingBuffer(logging.Handler):
    """Synchronization rides the ``logging.Handler`` built-in lock
    (``handle()`` wraps ``emit`` in ``acquire``/``release``); the read
    paths take the same lock explicitly."""

    def __init__(self, capacity: int = 2000, level=logging.INFO):
        super().__init__(level)
        self.records = collections.deque(maxlen=capacity)
        self._last_warning: Optional[logging.LogRecord] = None
        self.setFormatter(
            logging.Formatter("%(asctime)s %(levelname)s %(name)s: %(message)s")
        )

    def emit(self, record: logging.LogRecord):
        # already under self.lock via Handler.handle()
        try:
            self.records.append((record.levelno, self.format(record)))
            if record.levelno >= logging.WARNING:
                self._last_warning = record
        except Exception:
            # never let a formatting error propagate into the caller's
            # logger.info(...) — the stdlib contract (Handler.handleError)
            self.handleError(record)

    @property
    def last_warning(self) -> Optional[str]:
        """The status-bar popup message (latest warn/error)."""
        with self.lock:
            if self._last_warning is None:
                return None
            return self._last_warning.getMessage()

    def clear_warning(self):
        with self.lock:
            self._last_warning = None

    def tail(self, n: int = 100, min_level: int = 0) -> list[str]:
        """Last ``n`` formatted lines at or above ``min_level`` — the
        level-filtered scrollable view of ``egui_logger``
        (``settings_window.rs:268-483``)."""
        with self.lock:
            lines = [m for lvl, m in self.records if lvl >= min_level]
        return lines[-n:]


_installed: Optional[LogRingBuffer] = None
_PACKAGE = "thz_image_explorer_tpu_torch"


def install_log_buffer(capacity: int = 2000) -> LogRingBuffer:
    """Install the ring buffer on the package's logger tree (idempotent).

    A second call returns the installed buffer; if it asks for a
    different ``capacity`` the ring is resized in place (keeping the most
    recent entries) rather than silently ignored."""
    global _installed
    if _installed is None:
        _installed = LogRingBuffer(capacity)
        logging.getLogger(_PACKAGE).addHandler(_installed)
        logging.getLogger(_PACKAGE).setLevel(logging.INFO)
    elif _installed.records.maxlen != capacity:
        with _installed.lock:
            _installed.records = collections.deque(
                _installed.records, maxlen=capacity
            )
    return _installed
