"""Logger abstraction (port of reference logger.go)."""

from __future__ import annotations

import logging
import sys


class Logger:
    def __init__(self, name: str = "pilosa_tpu", verbose: bool = False, stream=None):
        self._log = logging.getLogger(name)
        if not self._log.handlers:
            handler = logging.StreamHandler(stream or sys.stderr)
            handler.setFormatter(logging.Formatter("%(asctime)s %(levelname)s %(message)s"))
            self._log.addHandler(handler)
        self._log.setLevel(logging.DEBUG if verbose else logging.INFO)
        self.verbose = verbose

    def info(self, msg, *args):
        self._log.info(msg, *args)

    def debug(self, msg, *args):
        if self.verbose:
            self._log.debug(msg, *args)

    def error(self, msg, *args):
        self._log.error(msg, *args)


class NopLogger:
    verbose = False

    def info(self, msg, *args):
        pass

    def debug(self, msg, *args):
        pass

    def error(self, msg, *args):
        pass


class BufferLogger(NopLogger):
    """Captures log lines for assertions (reference test/logger.go:25)."""

    def __init__(self):
        self.lines = []

    def info(self, msg, *args):
        self.lines.append(("INFO", msg % args if args else msg))

    def debug(self, msg, *args):
        self.lines.append(("DEBUG", msg % args if args else msg))

    def error(self, msg, *args):
        self.lines.append(("ERROR", msg % args if args else msg))
