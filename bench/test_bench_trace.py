"""The trace's reduction to busy time, idle gaps and kernel time, on
hand-made events (the profiler's raw events have the same methods)."""
from pathlib import Path

import pytest

from bench import trace


class Ev:
    def __init__(self, name, dev, a, b):
        self._n, self._d, self._a, self._b = name, dev, a, b

    def name(self):
        return self._n

    def device_type(self):
        return f"DeviceType.{self._d}"

    def start_ns(self):
        return self._a

    def duration_ns(self):
        return self._b - self._a


def _events():
    ms = 1_000_000
    return [Ev("bench_window", "CPU", 0, 100 * ms),
            Ev("prefill", "CPU", 0, 40 * ms),
            Ev("decode", "CPU", 40 * ms, 100 * ms),
            Ev("aten::mm", "CPU", 1 * ms, 2 * ms),
            Ev("prefill", "CUDA", 5 * ms, 30 * ms),      # mirrored annotation
            Ev("void ssd_chunk_scan(SsdArgs)", "CUDA", 5 * ms, 20 * ms),
            Ev("ssd_cb", "CUDA", 10 * ms, 25 * ms),       # overlaps
            Ev("sm90_xmma_gemm_bf16", "CUDA", 30 * ms, 40 * ms),
            Ev("Memcpy DtoH", "CUDA", 60 * ms, 62 * ms),
            Ev("late kernel", "CUDA", 99 * ms, 103 * ms)]


def test_busy_gaps_and_labels():
    t = trace.from_events(_events(), "bench_window", {"prefill", "decode"})
    assert t.window_s == pytest.approx(0.1)
    # busy: 5-25, 30-40, 60-62, 99-100 (clipped to the window)
    assert t.busy_s == pytest.approx(0.033)
    assert dict(t.top_gaps()) == pytest.approx(
        {"prefill": 0.005 + 0.005, "decode": 0.020 + 0.037})
    assert t.op_seconds(["ssd_cb", "ssd_chunk_scan"]) == (
        pytest.approx(0.030), 2)
    assert t.op_seconds(["ssd"]) == (0, 0)              # whole names only
    assert t.top_ops(1) == [["void ssd_chunk_scan(SsdArgs)",
                             pytest.approx(0.015)]]


def test_nothing_on_the_device_reads_nothing():
    evs = [e for e in _events() if "CUDA" not in e.device_type()]
    assert trace.from_events(evs, "bench_window", {"prefill"}) is None


def test_kernel_names_come_from_the_sources():
    import repro_torch.kernels.mamba2_ssd as k6
    import repro_torch.kernels.flash_attention as k5
    csrc = Path(k6.__file__).resolve().parent / "csrc"
    assert trace.kernel_names(csrc) == ["ssd_cb", "ssd_chunk_scan",
                                        "ssd_chunk_state", "ssd_state_pass"]
    csrc = Path(k5.__file__).resolve().parent / "csrc"
    assert trace.kernel_names(csrc) == ["flash_fwd_kernel",
                                        "flash_wgmma_kernel"]
