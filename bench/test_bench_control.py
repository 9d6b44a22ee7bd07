"""The check that decides ``correct``, shown to fail: the control (the
plain reference in float8 e4m3 in the program's place) against the cell's
limits, and a run of the harness with the timed path broken underneath
(each fault the cell can have) coming out not correct. On the CPU at a
reduced size through the kernels' plain versions; the control at the
cell's own size runs on a card (``-m cuda``)."""
import time

import pytest
import torch

from bench import control, harness

CELL = "zamba2_prefill"
HYBRID = dict(n_layers=4, d_model=128, n_heads=4, n_kv_heads=2, d_head=32,
              d_ff=256, vocab_size=512, shared_attn_every=2, ssm={
                  "d_state": 16, "d_head": 32, "expand": 2, "chunk": 16,
                  "d_conv": 4})
TRAFFIC = {"requests": 64, "prompt_median": 20, "max_len": 48, "bucket": 16,
           "batch": 8, "check_requests": 64}
SPEC = harness.benchmark_spec()
WORKLOAD = [w for w in SPEC["workloads"] if w["name"] == CELL][0]
# Limits at the test's size, set as the cell's are (bench/cells/*.json)
# from readings at this size on the CPU, seeds 0-11: token_gap 0-0.0070
# (program) against 0.037-0.114 (control). The control's gaps grow with
# depth and width, so the cell's own limit holds only at the cell's size
# (test_control_fails_at_the_cells_size).
SMALL_LIMITS = {"token_gap": 0.02}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_control_fails_where_the_program_passes(seed):
    r = control.readings(WORKLOAD, seed, 0.05, True, "cpu", HYBRID, TRAFFIC)
    lim = SMALL_LIMITS
    assert all(r["program"][n] <= lim[n] for n in lim), r
    assert any(r["control"][n] > lim[n] for n in lim), r


def _run():
    return harness.run_cell(WORKLOAD, 11, 0.05, False, time.perf_counter(),
                            device="cpu", spec=SPEC, config_over=HYBRID,
                            traffic_over=TRAFFIC, limits=SMALL_LIMITS)


def _layers_unchanged(monkeypatch):
    """Every Mamba-2 layer hands back the residual it was given."""
    from repro_torch.models import mamba2
    real = mamba2.mamba_block

    def unchanged(x, p, cfg, state, *a, **k):
        _, st = real(x, p, cfg, state, *a, **k)
        return x, st
    monkeypatch.setattr(mamba2, "mamba_block", unchanged)


def _half_the_batch(monkeypatch):
    """Prefill computes the first half of the batch; the other rows get
    the mean of their logits and a copy of their cache."""
    from repro_torch.serve import serve_step
    real = serve_step.forward_prefill

    def half(cfg, params, batch, *a):
        toks = batch["tokens"]
        n = (toks.shape[0] + 1) // 2
        logits, cache = real(cfg, params, {"tokens": toks[:n]}, *a)
        rest = logits.mean(0, keepdim=True).expand(toks.shape[0] - n, -1)

        def whole(t):
            if isinstance(t, dict):
                return {k: whole(v) for k, v in t.items()}
            return torch.cat([t, t[:, :1].expand(
                t.shape[0], toks.shape[0] - n, *t.shape[2:])], 1)
        return torch.cat([logits, rest], 0), whole(cache)
    monkeypatch.setattr(serve_step, "forward_prefill", half)


def _token_altered(monkeypatch):
    """The first row's sampled token moved to the next id."""
    import repro_torch.serve as serve
    real = serve.greedy_sample

    def altered(logits):
        tok = real(logits).clone()
        tok[0] = (tok[0] + 1) % logits.shape[-1]
        return tok
    monkeypatch.setattr(serve, "greedy_sample", altered)


FAULTS = [_layers_unchanged, _half_the_batch, _token_altered]


@pytest.mark.parametrize("fault", FAULTS,
                         ids=[f.__name__[1:] for f in FAULTS])
def test_a_broken_timed_path_is_not_correct(fault, monkeypatch):
    assert _run()["correct"] is True
    fault(monkeypatch)
    out = _run()
    assert out["correct"] is False, out["checks"]


@pytest.mark.cuda
def test_control_fails_at_the_cells_size(cuda):
    r = control.readings(WORKLOAD, 3, 2.0, True, cuda)
    lim = harness.load_json(harness.BENCH / "cells" / f"{CELL}.json")["check"]
    assert all(r["program"][n] <= lim[n] for n in lim), r
    assert any(r["control"][n] > lim[n] for n in lim), r
