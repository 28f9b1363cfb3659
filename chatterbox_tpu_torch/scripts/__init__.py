"""The port's measuring entry points, each run as ``python -m``:

- ``serve_bench``: waves of concurrent requests through the in-process
  engine (TTFA, RTF, real-time streams, stage times, the device's busy share);
- ``ttfa_trace``: one request's stage timeline up to its first audio;
- ``bench``: the stage micro-measurements and the headline line of
  ``bench.py``'s shape;
- ``ab``: serve_bench for two or more environments in interleaved turns.
"""
