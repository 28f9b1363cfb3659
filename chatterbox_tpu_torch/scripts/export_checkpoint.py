"""Export the engine's weights as a native checkpoint (the counterpart of
``scripts/export_checkpoint.py``).

    python -m chatterbox_tpu_torch.scripts.export_checkpoint OUT_DIR [--tiny] [--cpu]

Loads whatever MODEL_PATH resolves to (a reference snapshot, a native
checkpoint, or the engine's random init from seed 0) in the config
``TTSEngine()`` would build, on the CUDA device (the CPU with ``--cpu``),
and writes OUT_DIR in the native format both packages read
(``runtime/checkpoint.py``). The weights are the full logical ones whatever
CHATTERBOX_TP says: they do not depend on the tensor-parallel size, so they
are built by ``load_params`` in this process alone, with no follower and no
shard.
"""
from __future__ import annotations

import argparse
import logging
import os
from pathlib import Path

import torch

from ..logging_config import configure_logging
from ..runtime.checkpoint import save_checkpoint
from ..runtime.engine import _resolve_device, config_from_env
from ..runtime.loader import load_params
from ..runtime.tp_serving import tp_size
from ..settings import get_settings

log = logging.getLogger(__name__)
SEED = 0   # TTSEngine's default seed: the random init a served engine draws


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("out_dir")
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    if args.tiny:
        os.environ["CHATTERBOX_TINY_MODEL"] = "1"
    configure_logging(tag="EXPORT")
    if tp_size() > 1:
        log.info("CHATTERBOX_TP=%d is not used for the export: the full weights are written "
                 "from this process, with no follower", tp_size())

    cfg = config_from_env()
    device = _resolve_device("cpu" if args.cpu else None)
    dtype = torch.bfloat16 if cfg.param_dtype == "bfloat16" else torch.float32
    params = load_params(Path(get_settings().MODEL_PATH), cfg, dtype, device, SEED, {})
    save_checkpoint(args.out_dir, params, cfg)
    print(f"Checkpoint written to {args.out_dir}")


if __name__ == "__main__":
    main()
