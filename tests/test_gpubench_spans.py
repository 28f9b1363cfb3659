"""The benchmark's readers of the engine's spans (``gpubench/spans.py`` and
its nine ``gpubench/metrics/*.closed.py``) on a hand-made context: two
worker threads whose spans overlap in time, each kernel attributed by the
thread that launched it; the decoder's cache capacity from the slices'
attributes; and the join of torch.profiler's device events to their
runtime calls, with the thread id as CUPTI reports it."""
import threading
from types import SimpleNamespace

import pytest

from chatterbox_tpu_torch.runtime.metrics import SpanEvent
from gpubench import manifest, spans

MS = 1_000_000
LOOP, T3, S3, OTHER = 1, 2, 3, 9


def ev(name, tid, a, b, cpu=0.0, **attrs):
    return SpanEvent(name, tid, int(a * MS), int(b * MS), int(cpu * MS), attrs)


def launch(a, b, tid, t, kernel=True, corr=0):
    return (int(a * MS), int(b * MS), corr, tid, int(t * MS), kernel)


SPANS = [
    ev("t3.slice", LOOP, 0, 100, 1, steps=10, slots=4),
    ev("s3gen.call", LOOP, 50, 250, 1, jobs=2),
    # the T3 worker's enqueue overlaps the S3Gen worker's stack and enqueue
    ev("t3.slice.enqueue", T3, 5, 65, 30, steps=10),
    ev("t3.slice.fetch", T3, 65, 95, 1),
    ev("s3gen.stack", S3, 55, 60, 5),
    ev("s3gen.enqueue", S3, 60, 150, 80),
    ev("s3gen.fetch", S3, 150, 240, 2),
    ev("t3.admit_wait", LOOP, 0, 4, request="r1", slot=0),
    ev("t3.admit_wait", LOOP, 300, 350, request="r1", slot=1),   # r1's second chunk
    ev("t3.admit_wait", LOOP, 10, 20, request="r2", slot=1),
    ev("t3.admit_wait", LOOP, 12, 13, request="r3", slot=2),     # r3: no S3Gen job yet
    ev("s3gen.job_wait", LOOP, 100, 102, request="r1", bucket=16),
    ev("s3gen.job_wait", LOOP, 110, 130, request="r2", bucket=16),
    ev("s3gen.job_wait", LOOP, 140, 190, request="r2", bucket=32),
]
LAUNCHES = [
    launch(20, 30, T3, 10),                 # T3
    launch(30, 40, T3, 58),                 # T3, while S3's stack is open on its own thread
    launch(40, 45, S3, 58),                 # S3Gen's stack
    launch(60, 160, S3, 100),               # S3Gen's model
    launch(160, 161, T3, 70, kernel=False),  # the fetch's copy: no kernel
    launch(161, 170, T3, 70),               # a kernel queued in the fetch, not the enqueue
    launch(200, 210, OTHER, 10),            # a thread with no spans
]


def ctx(spans_=SPANS, launches=LAUNCHES):
    return {"spans": spans_, "launches": launches, "window_s": 0.3,
            "records": [SimpleNamespace(rid=r) for r in ("r1", "r2", "r3", "r4")]}


def read(name, c):
    return manifest.metric_reader(name)(c)


# device busy: [20, 45] + [60, 170] + [200, 210] = 145 of 300 ms; the gap
# 45–60 (its middle 52.5 inside the T3 enqueue) is 15 of the 155 idle
EXPECTED = {
    "t3_enqueue_ms.closed": 6.0,                 # 60 ms over 10 steps
    "t3_fetch_ms.closed": 3.0,                   # 30 ms over 10 steps
    "t3_cpu_share.closed": 50.0,                 # 30 of 60 ms on the CPU
    "t3_device_ms.closed": 2.0,                  # two 10 ms kernels over 10 steps
    "t3_launches_per_step.closed": 0.2,
    "s3gen_device_ms.closed": 105.0,             # 5 + 100 ms in one call
    "idle_t3_enqueue.closed": 100.0 * 15 / 155,
    "first_audio_wait_ms.closed": 18.0,          # median of r1's 4 + 2, r2's 10 + 20
}


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_on_two_threads_overlapping(name):
    assert read(name, ctx()) == pytest.approx(EXPECTED[name])


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_finds_nothing_without_spans(name):
    """A program without the span recorder: every reader gives None."""
    assert read(name, ctx(spans_=[])) is None


@pytest.mark.parametrize("name", ["t3_device_ms.closed", "t3_launches_per_step.closed",
                                  "s3gen_device_ms.closed", "idle_t3_enqueue.closed"])
def test_trace_readers_find_nothing_without_launches(name):
    assert read(name, ctx(launches=[])) is None


@pytest.mark.parametrize("window, want", [
    ([ev("t3.slice", LOOP, 0, 10, steps=35, cache_rows=256),
      ev("t3.cache.resize", T3, 11, 12, rows_from=256, rows_to=768),
      ev("t3.slice", LOOP, 10, 20, steps=35, cache_rows=768),
      ev("t3.cache.resize", T3, 21, 22, rows_from=768, rows_to=512),
      ev("t3.slice", LOOP, 20, 30, steps=35, cache_rows=512)], 768.0),
    (SPANS, None),                                   # slices without the attribute
    ([ev("t3.cache.resize", T3, 0, 1, rows_from=256, rows_to=512)], None),   # no slice
    ([], None),
], ids=["largest", "no-attribute", "no-slice", "no-spans"])
def test_cache_rows_reads_the_largest_slice_capacity(window, want):
    assert read("t3_cache_rows.closed", ctx(spans_=window)) == want


def test_innermost_span_by_thread_and_time():
    nest = [ev("outer", 5, 0, 100), ev("inner", 5, 10, 20), ev("later", 5, 30, 40),
            ev("elsewhere", 6, 0, 100)]
    got = spans.innermost(nest, [launch(0, 1, 5, t) for t in (15, 25, 35, 45, 100)]
                          + [launch(0, 1, 6, 50), launch(0, 1, None, 50), launch(0, 1, 7, 50)])
    assert [g.name if g else None for g in got] == [
        "inner", "outer", "later", "outer", None, "elsewhere", None, None]


class _Kineto:
    def __init__(self, name, device, a, b, corr, resource=0):
        self._v = (name, device, a, b, corr, resource)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def end_ns(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def device_resource_id(self):
        return self._v[5]


def test_collect_launches_joins_kernels_to_their_runtime_calls():
    """Device events joined by correlation id to the runtime call that
    queued them; the call's thread as CUPTI reports it on the card (the low
    32 bits of ``pthread_self``, signed) mapped to the native id."""
    cpu, cuda = "cpu", "cuda"
    low = threading.get_ident() & 0xFFFFFFFF
    reported = low - (1 << 32) if low >= 1 << 31 else low
    events = [
        _Kineto("cudaLaunchKernel", cpu, 100, 110, 7, reported),
        _Kineto("void gemm_kernel<float>(...)", cuda, 120, 170, 7),
        _Kineto("cudaMemcpyAsync", cpu, 200, 205, 8, reported),
        _Kineto("Memcpy DtoH (Device -> Pinned)", cuda, 210, 215, 8),
        _Kineto("cudaLaunchKernelExC", cpu, 300, 301, 9, 424242),   # a thread long gone
        _Kineto("sm90_xmma_gemm", cuda, 310, 320, 9),
        _Kineto("Memset (Device)", cuda, 400, 401, 10),             # no runtime call seen
    ]
    me = threading.get_native_id()
    assert spans.collect_launches(events, cuda, spans.thread_ids()) == [
        (120, 170, 7, me, 100, True), (210, 215, 8, me, 200, False),
        (310, 320, 9, None, 300, True), (400, 401, 10, None, None, False)]


def test_readers_gather_the_window_from_the_recorder_and_the_profiler():
    """A context without ``spans`` and ``launches`` (``run.py`` hands over
    none): the spans come from the program's recorder, the events that
    started inside the window's ``perf_counter`` bounds; the launches from
    the stopped torch.profiler a caller holds as ``prof``, or as its
    ``prof``, up the stack (with CPU activity alone it has no device
    events); both are kept in the context."""
    import time

    import torch

    from chatterbox_tpu_torch.runtime.metrics import metrics

    metrics.record(True)
    try:
        with metrics.span("before"):
            pass
        t_open = time.perf_counter()
        with metrics.span("t3.slice.enqueue", steps=4):
            time.sleep(0.002)
        t_close = time.perf_counter()
        with metrics.span("after"):
            pass
    finally:
        metrics.record(False)
    c = {"t_open": t_open, "t_close": t_close, "window_s": t_close - t_open}
    assert [e.name for e in spans.window_spans(c)] == ["t3.slice.enqueue"]
    assert c["spans"] is spans.window_spans(c)
    assert spans.t3_steps(c) == 4

    assert spans.traced_results() is None
    assert spans.window_launches(dict(c)) == []

    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])
    prof.start()
    torch.ones(4).add_(1)
    prof.stop()

    def harness(profiler):
        prof = SimpleNamespace(prof=profiler)  # noqa: F841 (held as run.Profiler holds it)
        return reader()

    def reader():
        return spans.traced_results(), spans.window_launches(c)

    results, got = harness(prof)
    assert results is prof.profiler.kineto_results
    assert got == [] and c["launches"] == []
