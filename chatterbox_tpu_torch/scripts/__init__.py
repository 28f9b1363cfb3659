"""The port's entry points, each run as ``python -m``:

- ``serve_bench``: waves of concurrent requests through the in-process
  engine (TTFA, RTF, real-time streams, stage times, the device's busy share);
- ``ttfa_trace``: one request's stage timeline up to its first audio;
- ``bench``: the stage micro-measurements and the headline line of
  ``bench.py``'s shape;
- ``ab``: serve_bench for two or more environments in interleaved turns;
- ``quality_study``: MCD / LSD of each serving knob's WAV against the
  default's, a fresh process per variant (``run_variant``, which also adds
  one variant to a study directory; ``quality_salvage`` scores one);
- ``parity_check``: MCD / LSD against a reference WAV, the serving
  deviations pinned off;
- ``export_checkpoint``, ``demo_synthesis``, ``clone_voice``,
  ``gen_manifest``, ``download_models``: the JAX package's entry scripts.
"""
