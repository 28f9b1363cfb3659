"""Fine-tune T3 on a manifest of (wav, transcript) pairs (the port's
counterpart of ``scripts/train_t3.py``).

Featurizes with the serving models, runs the train step, and writes a
native checkpoint that either package's engine loads and serves.

Usage:
  python -m chatterbox_tpu_torch.training.train_t3 manifest.tsv --out ckpt_dir \\
      [--steps 100] [--batch 4] [--lr 1e-5] [--dp N --tp M] [--tiny] [--cpu] \\
      [--max-speech N]

manifest.tsv: one ``wav_path<TAB>transcript`` per line. Runs on the card
unless ``--cpu`` is given. Featurizing needs S3Tok: the DiT S3Gen arch
(``CHATTERBOX_S3GEN_ARCH=dit``, or ``--tiny``, whose default arch it is).

``--dp N --tp M`` trains over a (dp, tp) mesh of N·M ranks that the command
starts itself (``parallel.launch``: one process per rank; rank r on GPU
r mod the card count, or on the CPU with ``--cpu``; an omitted one of the
two is 1). Rank 0 builds the engine, featurizes and sends the examples and
T3's weights to the others; every rank batches the same examples and trains
on its dp rows with its tp shard of T3 (``make_train_step(mesh=...)``);
rank 0 gathers the shards (``parallel.unshard_params``) and writes the
checkpoint, a native one that either package serves. ``--batch`` must
divide by dp, and tp must divide T3's heads and MLP width.
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


def _featurize(engine, manifest: str) -> list:
    from ..logging_config import log
    from .data import T3FeatureExtractor, load_manifest

    pairs = load_manifest(manifest)
    if not pairs:
        raise SystemExit("empty manifest")
    log.info("Featurizing %d examples...", len(pairs))
    extractor = T3FeatureExtractor(engine.params, engine.cfg, engine.tokenizer)
    return [extractor.extract(w, t) for w, t in pairs]


def _train(args: argparse.Namespace, cfg, state, train_step, examples, device) -> tuple:
    """``args.steps`` steps over the examples' batches → (state, losses,
    host wall of each step, ended by reading its loss)."""
    from ..logging_config import log
    from .data import make_batches

    losses, step_s, step = [], [], 0
    t0 = time.time()
    while step < args.steps:
        for batch in make_batches(examples, cfg, args.batch, max_speech=args.max_speech,
                                  shuffle_seed=step, device=device):
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
    return state, losses, step_s


def _save(engine, trained: dict, out: str) -> None:
    from ..convert import _walk
    from ..logging_config import log
    from ..runtime.checkpoint import save_checkpoint

    dtype = engine.params["t3"]["text_emb"].dtype
    engine.params["t3"] = _walk(trained, lambda x, key, parents: x.detach().to(dtype))
    save_checkpoint(out, engine.params, engine.cfg)
    log.info("Saved fine-tuned checkpoint to %s", out)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Train as the command line says → {"losses", "step_s" (host wall of
    each step, ended by reading its loss), "engine" (its T3 now the trained
    leaves), "examples"}; under ``--dp``/``--tp``, rank 0's {"losses",
    "step_s", "backend", "dp", "tp"}."""
    args = _parse(argv)
    if args.tiny:
        os.environ["CHATTERBOX_TINY_MODEL"] = "1"
    dp, tp = args.dp or 1, args.tp or 1
    if dp * tp > 1:
        return _launch(args, dp, tp)

    from ..logging_config import configure_logging
    from ..runtime.engine import TTSEngine
    from .train_step import adamw, make_train_step

    configure_logging(tag="TRAIN")
    engine = TTSEngine(device="cpu" if args.cpu else None)
    engine._init_models()
    examples = _featurize(engine, args.manifest)
    init_state, train_step = make_train_step(engine.cfg.t3, adamw(args.lr))
    state = init_state(engine.params["t3"])
    state, losses, step_s = _train(args, engine.cfg.t3, state, train_step, examples,
                                   engine.device)
    _save(engine, state["params"], args.out)
    return {"losses": losses, "step_s": step_s, "engine": engine, "examples": examples}


def _launch(args: argparse.Namespace, dp: int, tp: int) -> dict:
    """Check the mesh against the config, then start the dp·tp ranks."""
    import torch

    from ..parallel import check_tp, launch
    from ..runtime.engine import TTSEngine

    if args.batch % dp:
        raise ValueError(f"--batch {args.batch} does not split over --dp {dp}")
    check_tp(TTSEngine(device="cpu").cfg.t3, tp)
    n = dp * tp
    if args.cpu:
        devices = ["cpu"] * n
    else:
        cards = torch.cuda.device_count()
        if cards == 0:
            raise RuntimeError("no CUDA device: pass --cpu to train on the CPU")
        devices = [f"cuda:{r % cards}" for r in range(n)]
    return launch(_rank_main, devices, args=(args, dp, tp), timeout_s=24 * 3600.0)[0]


def _rank_main(rank, args: argparse.Namespace, dp: int, tp: int) -> Optional[dict]:
    """One rank of ``--dp``/``--tp`` training (``parallel.launch``'s
    function) → rank 0's result, None elsewhere."""
    import torch
    import torch.distributed as dist

    from ..logging_config import configure_logging, log
    from ..parallel import make_mesh, unshard_params
    from ..parallel.sharding import _map_leaves
    from ..runtime.engine import TTSEngine
    from .train_step import _leaves, adamw, make_train_step

    configure_logging(tag=f"TRAIN{rank.rank}")
    if rank.device.type == "cpu":   # the host's cores split between the ranks
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // rank.world_size))
    mesh = make_mesh(dp, tp, rank.devices)
    engine = TTSEngine(device=rank.device)
    sent = [None, None]
    if rank.rank == 0:
        log.info("mesh: dp=%d tp=%d over %s", dp, tp, rank.backend)
        engine._init_models()
        examples = _featurize(engine, args.manifest)
        t3 = engine.params["t3"]
        sent = [examples, _map_leaves(t3, lambda path, x: (tuple(x.shape), x.dtype))]
    dist.broadcast_object_list(sent, src=0)
    examples, shapes = sent
    with torch.inference_mode():
        if rank.rank != 0:
            t3 = _map_leaves(shapes, lambda path, s: torch.empty(s[0], dtype=s[1],
                                                                 device=rank.device))
        for leaf in _leaves(t3):
            dist.broadcast(leaf, src=0)
    init_state, train_step = make_train_step(engine.cfg.t3, adamw(args.lr), mesh=mesh)
    state = init_state(t3)
    del t3
    state, losses, step_s = _train(args, engine.cfg.t3, state, train_step, examples,
                                   rank.device)
    trained = unshard_params(state["params"], mesh)
    if rank.rank != 0:
        return None
    _save(engine, trained, args.out)
    return {"losses": losses, "step_s": step_s, "backend": rank.backend, "dp": dp, "tp": tp}



if __name__ == "__main__":
    main()
