"""The per-layer metrics read from the program's own spans
(``bench/program_spans.py``): the right µs a prompt token on hand-made
spans, one ``obs.take()`` a run shared by the readers, nothing read on the
CPU or from a program without ``obs``, and span names that never collide
with the benchmark's own."""
import re
import sys
import time
from pathlib import Path

import pytest

from bench import harness
from repro_torch import obs

READERS = {"mamba2_us_per_tok.serve": 3.0,
           "mamba2_glue_us_per_tok.serve": 1.0,
           "shared_block_us_per_tok.serve": 1.0}
SRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch"


def _run(items):
    return harness.Run("zamba2_prefill", {}, {}, 0.0, 1.0, items,
                       harness.Spans(False))


def _records():
    """Two batches: a Mamba-2 layer of 600 µs (GEMMs 100 + 100, scan 200:
    glue 200) and a shared block of 200 µs each."""
    R = obs.SpanRecord
    out = []
    for step in (1, 2):
        r = len(out)
        out += [R("serve.prefill_step", None, step, 0, 9, 1000.0),
                R("mamba2.layer", r, step, 1, 5, 600.0),
                R("mamba2.in_proj", r + 1, step, 1, 2, 100.0),
                R("mamba2.scan", r + 1, step, 2, 3, 200.0),
                R("mamba2.out_proj", r + 1, step, 3, 4, 100.0),
                R("shared.block", r, step, 6, 8, 200.0)]
    return out


def test_readers_divide_device_us_by_prompt_tokens(monkeypatch):
    calls = []

    def take():
        calls.append(1)
        return _records() if len(calls) == 1 else []
    monkeypatch.setattr(obs, "take", take)
    run = _run([{"prompt_tokens": 100}, {"prompt_tokens": 300}])
    for name, want in READERS.items():
        got = harness.load_module("metrics", name).read(run)
        assert got == pytest.approx(want), name
    assert len(calls) == 1                     # one take() for the run


def test_no_interval_and_no_obs_read_nothing(monkeypatch):
    recs = _records()
    for r in recs:
        r.device_us = None                     # spans recorded on the CPU
    monkeypatch.setattr(obs, "take", lambda: recs)
    run = _run([{"prompt_tokens": 100}])
    assert all(harness.load_module("metrics", n).read(run) is None
               for n in READERS)
    import repro_torch
    monkeypatch.delattr(repro_torch, "obs")    # the program before obs
    monkeypatch.setitem(sys.modules, "repro_torch.obs", None)
    run = _run([{"prompt_tokens": 100}])
    assert all(harness.load_module("metrics", n).read(run) is None
               for n in READERS)


def test_a_traced_cpu_run_records_spans_and_reports_none_of_them(
        monkeypatch):
    from bench.test_bench_control import HYBRID, SMALL_LIMITS, TRAFFIC, WORKLOAD
    taken = []
    real = obs.take

    def take():
        taken.append(real())
        return taken[-1]
    monkeypatch.setattr(obs, "take", take)
    out = harness.run_cell(WORKLOAD, 5, 0.05, True, time.perf_counter(),
                           device="cpu", config_over=HYBRID,
                           traffic_over=TRAFFIC, limits=SMALL_LIMITS)
    assert out["correct"] is True
    assert not set(READERS) & set(out["metrics"])
    assert len(taken) == 1
    names = [r.name for r in taken[0]]
    n_batches = names.count("serve.prefill_step")
    assert n_batches >= 1
    assert names.count("mamba2.layer") == n_batches * HYBRID["n_layers"]
    assert all(r.device_us is None for r in taken[0])


def test_span_names_never_collide_with_the_benchmarks():
    used = set()
    for path in SRC.rglob("*.py"):
        used |= set(re.findall(r'obs\.span\(\s*"([^"]+)"', path.read_text()))
    assert used == {"serve.prefill_step", "mamba2.layer", "mamba2.in_proj",
                    "mamba2.scan", "mamba2.out_proj", "shared.block"}
    ours = {"prefill", "sample", harness.WINDOW}
    for name in used:
        assert "." in name and name not in ours
