"""The port's logger (stdlib logging, configured by the embedding program)."""
from __future__ import annotations

import logging

log = logging.getLogger("chatterbox_tpu_torch")
