"""The program's spans in a trace (``harness/spans.py``), the reader of
its host-wait counter, and ``tools/spans.py`` on a CPU-sized cell."""
import pathlib
import re
import types

import pytest

from perfbench.harness import bench, spans
from perfbench.harness import trace as tracing
from perfbench.harness.context import Context
from perfbench.harness.trace import OP_PREFIX, WINDOW, Event, summarize
from perfbench.tests.tiny import tiny
from perfbench.tools import spans as spans_tool

SEED = 2**31 + 4242


class _Raw:
    """One of kineto's raw events: its accessors, over microseconds."""

    def __init__(self, name, start_us, end_us, device=False,
                 annotation=False, corr=-1):
        self._n, self._s, self._e = name, start_us, end_us
        self._dev, self._ann, self._corr = device, annotation, corr

    def name(self):
        return self._n

    def start_ns(self):
        return int(self._s * 1e3)

    def duration_ns(self):
        return int((self._e - self._s) * 1e3)

    def device_type(self):
        from torch.autograd import DeviceType
        return DeviceType.CUDA if self._dev else DeviceType.CPU

    def is_user_annotation(self):
        return self._ann

    def correlation_id(self):
        return self._corr


def _prof(raw):
    """A finished profile holding ``raw``, as the readers walk it."""
    results = types.SimpleNamespace(events=lambda: list(raw))
    return types.SimpleNamespace(
        profiler=types.SimpleNamespace(kineto_results=results))


BASE = [
    _Raw(WINDOW, 100.0, 200.0, annotation=True),
    _Raw("spmm_chunk_kernel", 100.0, 120.0, device=True, corr=1),
    _Raw("Memcpy HtoD (Pinned -> Device)", 150.0, 160.0, device=True,
         corr=3),
    _Raw(OP_PREFIX + "spmm_csr", 95.0, 112.0, annotation=True),
    _Raw(OP_PREFIX + "spmm_csr", 100.0, 120.0, device=True,
         annotation=True),
    _Raw("cudaLaunchKernel", 96.0, 97.0, corr=1),
    _Raw("cudaMemcpyAsync", 140.0, 141.0, corr=3),
    _Raw("aten::copy_", 128.0, 152.0),
]
# the program's ranges and kineto's device-side copy of the one that
# launched device work: from its first kernel's start to its last copy's
# end, over the idle [120, 150] between them
PROGRAM = [
    _Raw("repro::step::forward", 94.0, 145.0, annotation=True),
    _Raw("repro::step::forward", 100.0, 160.0, device=True,
         annotation=True),
    _Raw("repro::step::batch", 145.0, 170.0, annotation=True),
]


def _numbers(s):
    return (s.window_s, s.busy_s, s.copy_s, s.op_s, s.device_ops,
            s.idle_share)


def test_program_ranges_change_no_summary_number():
    without = summarize(spans.events(_prof(BASE)))
    with_ = summarize(spans.events(_prof(BASE + PROGRAM)))
    assert _numbers(with_) == _numbers(without)
    assert without.idle_gaps == with_.idle_gaps
    assert abs(without.busy_s - 30e-6) < 1e-12
    assert without.op_s == {"spmm_csr": pytest.approx(20e-6)}
    # the trap: read by name alone, the device-side copies are kernels
    trapped = summarize(tracing.from_profiler(_prof(BASE + PROGRAM)))
    assert abs(trapped.busy_s - 60e-6) < 1e-12


def test_no_harness_turns_the_program_spans_on_while_its_reader_is_trapped():
    """``trace.from_profiler`` counts the device-side copies of the
    program's ranges as kernels.  Until it drops them, as
    ``spans.from_kineto`` does, no module of a benchmark run may turn
    the program's spans on (only ``tools/spans.py`` does, through
    ``spans.events``)."""
    root = pathlib.Path(tracing.__file__).resolve().parents[1]
    uses = re.compile(r"from repro_torch import trace|"
                      r"import repro_torch\.trace|from repro_torch\.trace ")
    turning_on = [str(f.relative_to(root)) for f in
                  [root / "run.py", *sorted(root.glob("harness/*.py")),
                   *sorted(root.glob("metrics/*.py"))]
                  if uses.search(f.read_text())]
    trapped = _numbers(summarize(tracing.from_profiler(
        _prof(BASE + PROGRAM)))) != _numbers(summarize(
            tracing.from_profiler(_prof(BASE))))
    assert not (turning_on and trapped), turning_on


def test_program_ranges_come_as_spans_and_never_as_device_activity():
    evs = spans.events(_prof(BASE + PROGRAM))
    program = [e for e in evs if e.name.startswith("repro::")]
    assert [e.kind for e in program] == ["span", "span"]
    assert not [e for e in evs if e.kind == "kernel"
                and e.name.startswith(("repro::", "perfbench::"))]


def test_span_union_and_idle_are_exact():
    """Window [0, 100]; device busy [10, 30] and [60, 70], so idle
    [0, 10], [30, 60], [70, 100].  ``outer``'s two ranges overlap,
    ``inner`` nests in it, ``late`` leaves the window."""
    evs = [Event(WINDOW, "range", 0.0, 100.0),
           Event("k", "kernel", 10.0, 30.0, 1),
           Event("Memcpy", "memcpy", 60.0, 70.0, 2),
           Event("outer", "span", 0.0, 50.0),
           Event("outer", "span", 40.0, 80.0),
           Event("inner", "span", 5.0, 15.0),
           Event("late", "span", 90.0, 120.0),
           Event("before", "span", -20.0, -10.0)]
    r = spans.report(evs)
    assert (r.window_s, r.busy_s) == (100e-6, 30e-6)
    assert r.count == {"inner": 1, "late": 1, "outer": 2}
    assert r.host_s == pytest.approx({"inner": 10e-6, "late": 10e-6,
                                      "outer": 90e-6})
    assert r.span_s == pytest.approx({"inner": 10e-6, "late": 10e-6,
                                      "outer": 80e-6})
    assert r.span_idle_s == pytest.approx({"inner": 5e-6, "late": 10e-6,
                                           "outer": 50e-6})
    assert spans.report([Event("outer", "span", 0.0, 1.0)]) is None


def _ctx(counters):
    return Context(None, 1.0, 1, [], counters)


def test_host_waits_reader_returns_none_without_its_counter():
    read = bench.metric_reader("host_waits_per_batch.serve")
    assert read(_ctx({})) is None
    # a program whose service does not count them (as the parent's)
    assert read(_ctx({"service": {"batches": 4, "completed": 9}})) is None
    assert read(_ctx({"service": {"batches": 0, "host_waits": 0}})) is None
    assert read(_ctx({"service": {"batches": 4, "host_waits": 12}})) == 3.0


def test_per_unit_figures():
    r = spans.SpanReport(
        2.0, 1.5,
        count={"repro::step::fetch": 4, "repro::step::batch": 28,
               "repro::host_wait::loss": 4, "repro::host_wait::landed": 4},
        host_s={"repro::step::batch": 0.04},
        span_s={"repro::step::batch": 0.05},
        span_idle_s={"repro::step::batch": 0.2})
    assert spans_tool.per_unit(r, "train") == pytest.approx(
        {"units": 4, "host_waits": 2.0, "step_batch_ms": 10.0,
         "idle_in_batch_share": 10.0})
    r = spans.SpanReport(
        2.0, 0.2, count={"repro::serve::batch": 10,
                         "repro::host_wait::ids": 10},
        host_s={"repro::serve::seen": 0.003},
        span_s={"repro::serve::batch": 1.0},
        span_idle_s={"repro::serve::batch": 0.8})
    assert spans_tool.per_unit(r, "serve") == pytest.approx(
        {"units": 10, "host_waits": 1.0, "seen_stage_ms": 0.3,
         "idle_in_batch_share": 80.0})
    assert spans_tool.per_unit(r, "train") == {}


@pytest.mark.parametrize("workload,waits", [("lightgcn-train-device", 1),
                                            ("lightgcn-serve-zipf", 3)])
def test_tool_runs_a_cell_with_the_spans_on(workload, waits):
    from repro_torch import trace as program_trace
    res = spans_tool.traced_run(workload, SEED, 0.3, True, "cpu",
                                cell=tiny(workload))
    assert not program_trace.enabled()
    assert res["correct"], res["checks"]
    assert res["per_unit"]["host_waits"] == waits
    assert res["program"]["spans"]["setup::csr"][0] >= 1
    if workload.endswith("serve-zipf"):
        assert res["metrics"]["host_waits_per_batch.serve"]["value"] == 3.0
