"""The trace reduction on a synthetic event list."""
from perfbench.harness.trace import OP_PREFIX, WINDOW, Event, summarize


def _events():
    return [
        Event(WINDOW, "range", 100.0, 200.0),
        # device: kernels at [100,120], [115,130] (overlap), copy [150,160],
        # one kernel outside the window
        Event("spmm_chunk_kernel", "kernel", 100.0, 120.0, 1),
        Event("spmm_combine_kernel", "kernel", 115.0, 130.0, 2),
        Event("Memcpy HtoD (Pinned -> Device)", "memcpy", 150.0, 160.0, 3),
        Event("late_kernel", "kernel", 250.0, 260.0, 4),
        # host: the launches, one inside the op range
        Event(OP_PREFIX + "spmm_csr", "range", 95.0, 112.0),
        Event("cudaLaunchKernel", "launch", 96.0, 97.0, 1),
        Event("cudaLaunchKernel", "launch", 113.0, 114.0, 2),
        Event("cudaMemcpyAsync", "launch", 140.0, 141.0, 3),
        # host activity in the gaps [130,150] and [160,200]
        Event("aten::item", "cpu", 128.0, 152.0),
        Event("aten::nonzero", "cpu", 131.0, 149.0),
        Event("python work", "cpu", 160.0, 200.0),
    ]


def test_busy_idle_and_copies():
    s = summarize(_events())
    assert s.window_s == 100e-6
    assert abs(s.busy_s - 40e-6) < 1e-12           # [100,130] + [150,160]
    assert abs(s.idle_share - 0.6) < 1e-9
    assert abs(s.copy_s - 10e-6) < 1e-12
    assert "late_kernel" not in dict(s.device_ops)


def test_kernels_attributed_to_the_op_range_that_launched_them():
    s = summarize(_events())
    assert abs(s.op_s["spmm_csr"] - 20e-6) < 1e-12   # only the first kernel


def test_breakdown():
    s = summarize(_events())
    names = [n for n, _ in s.device_ops]
    assert names[0] == "spmm_chunk_kernel"
    gaps = dict(s.idle_gaps)
    assert abs(gaps["aten::nonzero"] - 20e-6) < 1e-12   # most specific
    assert abs(gaps["python work"] - 40e-6) < 1e-12


def test_nothing_to_read_without_a_window_or_device_work():
    assert summarize([Event("k", "kernel", 0.0, 1.0)]) is None
    assert summarize([Event(WINDOW, "range", 0.0, 1.0)]) is None
