"""The port's logger (stdlib logging, configured by the embedding program;
the server and the dispatcher call ``configure_logging``)."""
from __future__ import annotations

import logging
import os
import sys
from typing import Optional

_FORMAT = "%(asctime)s.%(msecs)03d | %(levelname)-8s | [%(proc_tag)s] %(name)s - %(message)s"
_DATEFMT = "%Y-%m-%d %H:%M:%S"

log = logging.getLogger("chatterbox_tpu_torch")


class _TagFilter(logging.Filter):
    def __init__(self, tag: str):
        super().__init__()
        self.tag = tag

    def filter(self, record: logging.LogRecord) -> bool:
        record.proc_tag = self.tag
        return True


def configure_logging(level: Optional[str] = None, tag: str = "MASTER") -> logging.Logger:
    """Send every record to stderr with the process tag (e.g. "SERVER") in
    it, at ``level`` ($LOG_LEVEL or INFO by default); calling it again
    replaces the handler."""
    root = logging.getLogger()
    root.setLevel((level or os.environ.get("LOG_LEVEL", "INFO")).upper())
    for h in list(root.handlers):
        root.removeHandler(h)
    handler = logging.StreamHandler(sys.stderr)
    handler.setFormatter(logging.Formatter(_FORMAT, datefmt=_DATEFMT))
    handler.addFilter(_TagFilter(tag))
    root.addHandler(handler)
    return log
