"""Fine-tune T3 on a manifest of (wav, transcript) pairs (the port's
counterpart of ``scripts/train_t3.py``).

Featurizes with the serving models, runs the train step, and writes a
native checkpoint that either package's engine loads and serves.

Usage:
  python -m chatterbox_tpu_torch.training.train_t3 manifest.tsv --out ckpt_dir \\
      [--steps 100] [--batch 4] [--lr 1e-5] [--tiny] [--cpu] [--max-speech N]

manifest.tsv: one ``wav_path<TAB>transcript`` per line. Runs on the card
unless ``--cpu`` is given. Featurizing needs S3Tok: the DiT S3Gen arch
(``CHATTERBOX_S3GEN_ARCH=dit``, or ``--tiny``, whose default arch it is).
``--dp`` / ``--tp`` above 1 raise: the mesh is not ported.
"""
from __future__ import annotations

import argparse
import os
import time
from typing import Optional, Sequence


def _parse(argv: Optional[Sequence[str]]) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("manifest")
    ap.add_argument("--out", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--lr", type=float, default=1e-5)
    ap.add_argument("--dp", type=int, default=None)
    ap.add_argument("--tp", type=int, default=None)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--max-speech", type=int, default=None)
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Train as the command line says → {"losses", "step_s" (host wall of
    each step, ended by reading its loss), "engine" (its T3 now the trained
    leaves), "examples"}."""
    args = _parse(argv)
    if (args.dp or 1) > 1 or (args.tp or 1) > 1:
        raise NotImplementedError(
            f"--dp {args.dp} --tp {args.tp}: data and tensor parallelism are not ported — "
            "ROADMAP.md Queue 1 item 11 (chatterbox_tpu/parallel/)")
    if args.tiny:
        os.environ["CHATTERBOX_TINY_MODEL"] = "1"

    from ..convert import _walk
    from ..logging_config import configure_logging, log
    from ..runtime.checkpoint import save_checkpoint
    from ..runtime.engine import TTSEngine
    from .data import T3FeatureExtractor, load_manifest, make_batches
    from .train_step import adamw, make_train_step

    configure_logging(tag="TRAIN")
    engine = TTSEngine(device="cpu" if args.cpu else None)
    engine._init_models()
    cfg = engine.cfg

    pairs = load_manifest(args.manifest)
    if not pairs:
        raise SystemExit("empty manifest")
    log.info("Featurizing %d examples...", len(pairs))
    extractor = T3FeatureExtractor(engine.params, cfg, engine.tokenizer)
    examples = [extractor.extract(w, t) for w, t in pairs]

    init_state, train_step = make_train_step(cfg.t3, adamw(args.lr))
    state = init_state(engine.params["t3"])

    losses, step_s, step = [], [], 0
    t0 = time.time()
    while step < args.steps:
        for batch in make_batches(examples, cfg.t3, args.batch, max_speech=args.max_speech,
                                  shuffle_seed=step, device=engine.device):
            t_step = time.perf_counter()
            state, m = train_step(state, batch)
            losses.append(float(m["loss"]))
            step_s.append(time.perf_counter() - t_step)
            step += 1
            if step % 10 == 0 or step == 1:
                log.info("step %d: loss=%.4f grad_norm=%.2f (%.2fs/step)", step, losses[-1],
                         float(m["grad_norm"]), (time.time() - t0) / step)
            if step >= args.steps:
                break

    dtype = engine.params["t3"]["text_emb"].dtype
    engine.params["t3"] = _walk(state["params"], lambda x, key, parents: x.detach().to(dtype))
    save_checkpoint(args.out, engine.params, cfg)
    log.info("Saved fine-tuned checkpoint to %s", args.out)
    return {"losses": losses, "step_s": step_s, "engine": engine, "examples": examples}


if __name__ == "__main__":
    main()
