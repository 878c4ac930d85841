"""The port's profiler capture (``spmv_tpu_torch.profile.capture``) and
the harness's flush hook, against the JAX package's xplane parsing
(``spmv_tpu/profile/xplane.py``) and harness on the CPU.

- ``interval_union_ns`` equals JAX's exactly, on the JAX test's interval
  sets and on 200 random ones.
- ``summarize_capture`` of a CPU ``torch.profiler`` capture of the JAX
  test's work (three ``(x @ x) * 1e-3`` on 256 x 256) has the keys of
  ``summarize_xplane`` on a JAX CPU capture of the same work, and the
  same invariants (counts, fractions, order, busy time).
- A card's capture (a Chrome trace in Kineto's layout, written here):
  the device plane is each GPU's kernels, memcpys and memsets, a line a
  stream; the host plane shows only when asked, and a card capture with
  no device event yields no plane rather than the host's.
- ``op_bytes_accessed`` pinned on a recorded ``aten::mm``;
  ``profiling_events_section`` and ``list_profile_events`` as JAX's.
- ``profile_kernel_fn``'s ``between_runs`` and ``cache_flusher``.

Captures stay at the JAX tests' size (tier-1's time is counted).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spmv_tpu.profile import xplane as jx
from spmv_tpu.profile.harness import profile_kernel_fn as jax_profile_fn
from spmv_tpu_torch.errors import ProfileError
from spmv_tpu_torch.models.device import DEVICE_ENV
from spmv_tpu_torch.profile import capture as tc
from spmv_tpu_torch.profile.harness import cache_flusher, profile_kernel_fn

# the JAX test's interval sets (tests/test_profile.py)
JAX_INTERVALS = [
    [],
    [(5.0, 9.0)],
    [(0.0, 100.0), (10.0, 20.0), (30.0, 90.0)],
    [(0.0, 10.0), (5.0, 15.0), (20.0, 25.0)],
    [(0.0, 5.0), (0.0, 5.0), (5.0, 7.0)],
    [(50.0, 60.0), (0.0, 10.0), (55.0, 70.0)],
]
EVENT_KEYS = {"name", "line", "count", "total_ns", "duration_ns",
              "fraction_of_plane"}
# the keys summarize_xplane adds where it has them
OPTIONAL_EVENT_KEYS = {"bytes_accessed", "total_bytes", "achieved_gb_per_s",
                       "counter_stats"}
MM_BYTES = 2 * 256 * 256 * 4


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv(DEVICE_ENV, "cpu")


@pytest.fixture(scope="module")
def captures(tmp_path_factory):
    """(torch capture dir, JAX capture dir) of three (x @ x) * 1e-3 on
    256 x 256, float32."""
    t = str(tmp_path_factory.mktemp("torch_cap"))
    with tc.trace(t, "cpu"):
        x = torch.ones(256, 256)
        for _ in range(3):
            x = (x @ x) * 1e-3
    j = str(tmp_path_factory.mktemp("jax_cap"))
    with jax.profiler.trace(j):
        y = jnp.ones((256, 256), jnp.float32)
        for _ in range(3):
            y = (y @ y) * 1e-3
        y.block_until_ready()
    return t, j


def test_interval_union_equals_jax():
    for ivs in JAX_INTERVALS:
        assert tc.interval_union_ns(ivs) == jx.interval_union_ns(ivs)
    rng = np.random.default_rng(0)
    for _ in range(200):
        n = int(rng.integers(0, 40))
        starts = rng.uniform(0.0, 1e6, n)
        ivs = [(float(s), float(s + d))
               for s, d in zip(starts, rng.exponential(5e4, n))]
        assert tc.interval_union_ns(ivs) == jx.interval_union_ns(ivs)


def test_trace_writes_one_capture(captures):
    files = [f for f in os.listdir(captures[0])
             if f.endswith(tc.CAPTURE_SUFFIX)]
    assert len(files) == 1
    path = os.path.join(captures[0], files[0])
    assert tc.find_capture_file(captures[0]) == path
    assert tc.find_capture_file(path) == path
    # the window is the schedule's step after the warm-up: its marker is
    # in the trace, not in the summary
    with open(path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "ProfilerStep#1" in names
    summary = tc.summarize_capture(path, top_k=1000, include_host=True)
    assert not [e for p in summary["planes"] for e in p["events"]
                if e["name"].startswith("ProfilerStep#")]


def _check_invariants(summary):
    for plane in summary["planes"]:
        events = plane["events"]
        assert plane["busy_ns"] > 0
        for e in events:
            assert e["count"] == e["duration_ns"]["samples"]
            assert 0.0 <= e["fraction_of_plane"] <= 1.0
            assert e["duration_ns"]["min"] > 0
        totals = [e["total_ns"] for e in events]
        assert totals == sorted(totals, reverse=True)
        if plane["events_dropped_below_top_k"] == 0:
            longest = max(e["duration_ns"]["max"] for e in events)
            assert longest - 1e-6 <= plane["busy_ns"] <= sum(totals) + 1e-6


def test_summary_has_the_jax_summarys_keys(captures):
    got = tc.summarize_capture(captures[0], top_k=10)
    want = jx.summarize_xplane(captures[1], top_k=10)
    assert set(got) == set(want) == {"capture", "planes"}
    assert got["capture"].endswith(".pt.trace.json")
    # on the CPU the host's plane is the device plane, as in JAX
    assert [p["name"] for p in got["planes"]] == ["/host:CPU"]
    assert "/host:CPU" in [p["name"] for p in want["planes"]]
    for p, q in zip(got["planes"], want["planes"]):
        assert set(p) == set(q)
        assert p["num_event_kinds"] == (len(p["events"])
                                        + p["events_dropped_below_top_k"])
    for e in got["planes"][0]["events"]:
        assert set(e) - OPTIONAL_EVENT_KEYS == EVENT_KEYS
    for q in want["planes"]:
        for e in q["events"]:
            assert set(e) - OPTIONAL_EVENT_KEYS == EVENT_KEYS
    _check_invariants(got)
    _check_invariants(tc.summarize_capture(captures[0], top_k=1000))


def test_op_bytes_accessed_of_a_recorded_mm(captures):
    with open(tc.find_capture_file(captures[0])) as f:
        events = json.load(f)["traceEvents"]
    mms = [e for e in events if e.get("name") == "aten::mm"]
    assert len(mms) == 3
    for e in mms:
        assert tc.op_bytes_accessed(e["args"]) == MM_BYTES
    assert tc.op_bytes_accessed({}) is None
    assert tc.op_bytes_accessed({"Input Dims": [[], [4]], "Input type": [
        "Scalar", "c10::BFloat16"]}) == 8
    summary = tc.summarize_capture(captures[0], top_k=1000)
    mm = [e for e in summary["planes"][0]["events"]
          if e["name"] == "aten::mm"]
    assert len(mm) == 1 and mm[0]["count"] == 3
    assert mm[0]["bytes_accessed"] == MM_BYTES
    assert mm[0]["total_bytes"] == 3 * MM_BYTES
    assert mm[0]["achieved_gb_per_s"] == pytest.approx(
        3 * MM_BYTES / mm[0]["total_ns"])


def test_profiling_events_section_as_jax(tmp_path, captures):
    assert tc.profiling_events_section(None) is None
    assert jx.profiling_events_section(None) is None
    got = tc.profiling_events_section(str(tmp_path))
    want = jx.profiling_events_section(str(tmp_path))
    assert set(got) == set(want) == {"error"}
    assert "ProfileError" in got["error"]
    with pytest.raises(ProfileError, match="--jax-profile"):
        tc.find_capture_file(str(tmp_path))
    assert set(tc.profiling_events_section(captures[0])) == {"capture",
                                                             "planes"}


def test_list_profile_events_as_jax(captures):
    want = jx.list_profile_events()
    for got in (tc.list_profile_events(),
                tc.list_profile_events(captures[0])):
        assert set(got) == set(want)
        assert got["planes"] and want["planes"]
        for p in got["planes"]:
            assert set(p) == {"plane", "lines"}
            for line in p["lines"]:
                assert set(line) == {"line", "num_events", "event_stats"}
                assert line["num_events"] > 0
                for s in line["event_stats"]:
                    assert set(s) == {"name", "type"}
    lines = tc.list_profile_events(captures[0])["planes"][0]["lines"]
    stats = {s["name"]: s["type"] for s in lines[0]["event_stats"]}
    assert stats["Input Dims"] == "list" and stats["External id"] == "int"


def _card_trace(path, device_events=True, lost=()):
    """A card's capture in the layout of an H100 capture (Kineto's Chrome
    trace: a device's events under pid = its index, args ``device`` and
    ``stream``, times in us): two kernels on stream 7 of GPU 0, a
    memcpy on stream 13, the runtime calls and an op on the host thread.
    The K1 kernels whose correlation ids are in ``lost`` keep their
    launch records and lose their device records."""
    events = [
        {"ph": "M", "name": "thread_name", "pid": 11, "tid": 11,
         "args": {"name": "thread 11 (python)"}},
        {"ph": "M", "name": "process_name", "pid": 0, "tid": 0,
         "args": {"name": "GPU 0"}},
        {"ph": "X", "cat": "cpu_op", "name": "aten::sum", "pid": 11,
         "tid": 11, "ts": 100.0, "dur": 30.0,
         "args": {"Input Dims": [[1024]], "Input type": ["float"]}},
    ] + [
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "pid": 11, "tid": 11, "ts": 105.0 + 20.0 * i - 10.0, "dur": 4.0,
         "args": {"correlation": i}} for i in range(3)
    ] + [
        # a runtime call that enqueues no device work
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaStreamSynchronize",
         "pid": 11, "tid": 11, "ts": 260.0, "dur": 2.0,
         "args": {"correlation": 9}},
        {"ph": "X", "cat": "Trace", "name": "PyTorch Profiler (0)",
         "pid": "Spans", "tid": "PyTorch Profiler", "ts": 0.0,
         "dur": 1000.0},
        # a host annotation as Kineto projects it onto the card
        {"ph": "X", "cat": "gpu_user_annotation", "name": "step",
         "pid": 0, "tid": 7, "ts": 100.0, "dur": 500.0,
         "args": {"device": 0}},
    ]
    if device_events:
        events += [
            {"ph": "X", "cat": "kernel",
             "name": "void spmv_tpu_torch::(anonymous namespace)::"
                     "dia_spmv_kernel<float, float, false>(...)",
             "pid": 0, "tid": 7, "ts": 110.0 + 20.0 * i, "dur": 10.0,
             "args": {"device": 0, "stream": 7, "correlation": i,
                      "registers per thread": 32,
                      "est. achieved occupancy %": 50}}
            for i in range(3) if i not in lost
        ] + [
            {"ph": "X", "cat": "kernel", "name": "void at::native::"
             "reduce_kernel<512, 1, ReduceOp<sum_functor<float>>>(...)",
             "pid": 0, "tid": 7, "ts": 200.0, "dur": 40.0,
             "args": {"device": 0, "stream": 7,
                      "est. achieved occupancy %": 90}},
            {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH",
             "pid": 0, "tid": 13, "ts": 230.0, "dur": 20.0,
             "args": {"device": 0, "stream": 13, "bytes": 4096,
                      "memory bandwidth (GB/s)": 0.2}},
        ]
    with open(path, "w") as f:
        json.dump({"deviceProperties": [{"id": 0, "name": "GPU"}],
                   "traceEvents": events}, f)


def test_card_capture_planes_and_lines(tmp_path):
    path = str(tmp_path / "card.pt.trace.json")
    _card_trace(path)
    s = tc.summarize_capture(path)
    assert [p["name"] for p in s["planes"]] == ["/device:GPU:0"]
    gpu = s["planes"][0]
    by_name = {e["name"]: e for e in gpu["events"]}
    k1 = by_name["void spmv_tpu_torch::(anonymous namespace)::"
                 "dia_spmv_kernel<float, float, false>(...)"]
    assert (k1["line"], k1["count"], k1["total_ns"]) == ("stream 7", 3,
                                                         30000.0)
    assert k1["duration_ns"]["median"] == 10000.0
    # a kernel records no shapes: no byte keys; its stats pass through
    assert not set(k1) & {"bytes_accessed", "total_bytes"}
    assert k1["counter_stats"] == {"est. achieved occupancy %": 150}
    copy = by_name["Memcpy DtoH"]
    assert copy["line"] == "stream 13"
    assert copy["counter_stats"] == {"bytes": 4096,
                                     "memory bandwidth (GB/s)": 0.2}
    # [110, 120] [130, 140] [150, 160] [200, 240] overlapping [230, 250]
    assert gpu["busy_ns"] == 80000.0
    _check_invariants(s)
    host = tc.summarize_capture(path, include_host=True)["planes"]
    assert [p["name"] for p in host] == ["/device:GPU:0", "/host:CPU"]
    assert {e["line"] for e in host[1]["events"]} == {"thread 11 (python)"}
    assert {e["name"] for e in host[1]["events"]} == {
        "aten::sum", "cudaLaunchKernel", "cudaStreamSynchronize"}
    assert "events_lost" not in host[1]
    assert gpu["events_lost"] == 0
    listed = tc.list_profile_events(path)["planes"]
    assert [p["plane"] for p in listed] == ["/device:GPU:0", "/host:CPU"]
    assert [ln["line"] for ln in listed[0]["lines"]] == ["stream 7",
                                                         "stream 13"]


def test_card_capture_without_device_events_has_no_plane(tmp_path):
    """A card's capture whose device events are missing reports no
    events: the host's plane never stands in for the card's, and the
    card's lists only the launches whose records it lost."""
    path = str(tmp_path / "card.pt.trace.json")
    _card_trace(path, device_events=False)
    planes = tc.summarize_capture(path)["planes"]
    assert [(p["name"], p["events"], p["busy_ns"], p["events_lost"])
            for p in planes] == [("/device:GPU:0", [], 0.0, 3)]


@pytest.mark.parametrize("lost", [(0,), (0, 1), (2,)])
def test_card_capture_counts_the_records_it_lost(tmp_path, lost):
    """Launch records whose device records are missing are counted on
    the card's plane, which still summarises the records it has; a
    runtime call that enqueues no work (a synchronise) is not counted."""
    path = str(tmp_path / "card.pt.trace.json")
    _card_trace(path, lost=lost)
    gpu = tc.summarize_capture(path)["planes"][0]
    assert gpu["events_lost"] == len(lost)
    k1 = [e for e in gpu["events"] if "dia_spmv_kernel" in e["name"]]
    assert [e["count"] for e in k1] == ([3 - len(lost)] if len(lost) < 3
                                        else [])
    section = tc.profiling_events_section(str(tmp_path))
    assert section["planes"][0]["events_lost"] == len(lost)


def _window_trace(path, launches, lost_first):
    """A card's capture of one window as ``trace`` takes it: the
    profiler's span, the window's step, ``launches`` K1 launches 20 us
    apart, the first ``lost_first`` of them without their device record
    (the loss a long-lived process's captures showed, PERF.md §6)."""
    events = [
        {"ph": "X", "cat": "Trace", "name": "PyTorch Profiler (0)",
         "pid": "Spans", "tid": "PyTorch Profiler", "ts": 0.0,
         "dur": 5000.0},
        {"ph": "X", "cat": "user_annotation", "name": "ProfilerStep#1",
         "pid": 11, "tid": 11, "ts": 1000.0, "dur": 3500.0},
    ]
    for i in range(launches):
        ts = 1010.0 + 20.0 * i
        events.append({"ph": "X", "cat": "cuda_runtime",
                       "name": "cudaLaunchKernel", "pid": 11, "tid": 11,
                       "ts": ts, "dur": 4.0, "args": {"correlation": i}})
        if i >= lost_first:
            events.append({
                "ph": "X", "cat": "kernel",
                "name": "void spmv_tpu_torch::(anonymous namespace)::"
                        "dia_spmv_kernel<float, float, false>(...)",
                "pid": 0, "tid": 7, "ts": ts + 6.0, "dur": 8.0,
                "args": {"device": 0, "stream": 7, "correlation": i}})
    with open(path, "w") as f:
        json.dump({"deviceProperties": [{"id": 0, "name": "GPU"}],
                   "traceEvents": events}, f)


@pytest.mark.parametrize("lost_first", [0, 1, 20, 40])
def test_window_that_loses_its_first_records(tmp_path, lost_first):
    """A window of 83 K1 launches whose first K device records are gone
    (K = 20 at 315 s and 40 after 13 minutes in a long-lived process on
    an H100): ``events_lost`` is K on the card's plane, the kernel
    counts the rest, and the capture study reads the losses as the
    window's first K launches, at their places after the window's start."""
    from spmv_tpu_torch.profile import capture_study

    path = str(tmp_path / "window.pt.trace.json")
    _window_trace(path, 83, lost_first)
    with open(path) as f:
        assert tc._events_lost(json.load(f)) == {"/device:GPU:0": lost_first}
    gpu = tc.summarize_capture(path)["planes"][0]
    assert gpu["events_lost"] == lost_first
    assert [e["count"] for e in gpu["events"]] == [83 - lost_first]
    r = capture_study.reading(path, 83)
    assert (r["launch_records"], r["exported"]) == (83, 83 - lost_first)
    assert r["lost_at"] == list(range(lost_first))
    assert r["window_minus_profiler_us"] == 1000.0
    if lost_first:
        assert r["lost_minus_window_us"] == [10.0,
                                             10.0 + 20.0 * (lost_first - 1)]
        assert r["first_record_minus_window_us"][0] == (
            16.0 + 20.0 * lost_first)
    else:
        assert r["lost_minus_window_us"] is None


def test_profile_kernel_fn_between_runs():
    """The counterpart of tests/test_profile.py's: the flush hook runs
    before every timed run, not before the warm-up."""
    for fn, make in ((profile_kernel_fn, torch.zeros),
                     (jax_profile_fn, lambda n: jnp.zeros((n,),
                                                          jnp.float32))):
        calls = []
        sample = fn(lambda v: v + 1.0, (make(8),), runs=4,
                    between_runs=lambda: calls.append(1))
        assert sample.size == 4
        assert len(calls) == 4
        assert sample.min > 0


def test_cache_flusher_sweeps_one_buffer(monkeypatch):
    made = []
    ones = torch.ones

    def counted(*a, **kw):
        made.append(a)
        return ones(*a, **kw)

    monkeypatch.setattr(torch, "ones", counted)
    flush = cache_flusher("cpu", nbytes=1 << 12)
    for _ in range(3):
        assert flush() is None
    assert made == [(1 << 10,)]
