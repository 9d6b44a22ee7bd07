"""The ``granite4h_prefill`` cell's driver (``bench/drivers/
hybrid_moe_prefill.py``), counts and check on the CPU at a reduced size,
through the kernels' plain versions: set-up, window and check run; the
control and each fault the timed path can have fail the check; the flop
count is the plain reference's own products; the configuration file is
the program's registered config cut to its ``n_layers``.

At this size the program runs in float32, so that its logits differ from
the reference's only by the order of the sums; the cell's limits, from the
card at the cell's size in bf16, are in PERF.md, section 2."""
import dataclasses
import math
import time

import pytest
import torch

from bench import harness
from bench.counts import hybrid_moe
from bench.drivers import hybrid_moe_prefill as drv
from bench.reference import granite4_hybrid as ref

CELL = "granite4h_prefill"
# the first 6 layers: 5 Mamba-2 and the attention layer at index 5
SMALL = dict(hidden_size=128, num_attention_heads=4, num_key_value_heads=2,
             n_layers=6, mamba_n_heads=8, mamba_d_head=32, mamba_d_state=16,
             mamba_expand=2, mamba_chunk_size=16, num_local_experts=8,
             num_experts_per_tok=3, intermediate_size=64,
             shared_intermediate_size=128, vocab_size=512,
             attention_multiplier=1 / 32, dtype="float32")
TRAFFIC = {"requests": 32, "prompt_median": 20, "max_len": 48, "bucket": 16,
           "batch": 8, "check_requests": 32}
SPEC = harness.benchmark_spec()
WORKLOAD = [w for w in SPEC["workloads"] if w["name"] == CELL][0]
# Limits at the test's size, from readings at this size on the CPU (weights
# from seeds 11 and 12): the program's rows (in f32) at most 1.49e-6 and
# 1.53e-6 from the reference, the control's at least 0.146 and 0.168 (at
# most 0.46); served_token_gap 0 (the served token is its logits' argmax)
SMALL_LIMITS = {"logit_err": 1e-3, "logit_err_max": 1e-3,
                "served_token_gap": 0.0}


def _config():
    config, _, _, _ = harness.cell_files(WORKLOAD, SMALL, TRAFFIC)
    return config


@pytest.fixture(scope="module")
def state():
    """The cell's driver set up once at the test's size (weights from seed
    11, every shape warmed), shared by the checks below: each runs a
    window through the timed path and checks it."""
    config, traffic, _, _ = harness.cell_files(WORKLOAD, SMALL, TRAFFIC)
    return drv.setup(config, traffic, 11, "cpu")


def _checked(st, seed=11, precision=None):
    items = drv.window(st, 0.05, harness.Spans(False))
    return {n: v for n, v, _ in drv.check(st, items, seed, SMALL_LIMITS,
                                          precision)}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_control_fails_where_the_program_passes(state, seed):
    from bench.reference.plain import FP8
    lim = SMALL_LIMITS
    program, ctrl = _checked(state, seed), _checked(state, seed, FP8)
    assert all(program[n] <= lim[n] for n in lim), program
    assert any(ctrl[n] > lim[n] for n in lim), ctrl


def test_the_cell_runs_and_reports_its_metrics():
    out = harness.run_cell(WORKLOAD, 11, 0.05, False, time.perf_counter(),
                           device="cpu", spec=SPEC, config_over=SMALL,
                           traffic_over=TRAFFIC, limits=SMALL_LIMITS)
    assert out["correct"] is True and out["attempted"] >= 32
    assert set(out["metrics"]) == {"setup_s", "prompt_tokens_per_s",
                                   "ttft_p95_ms"}


def _experts_drop(monkeypatch):
    """The router with a 1.25 capacity: rows of an expert past ceil(1.25
    T k / E), in token order, get no weight."""
    from repro_torch.models import moe
    real = moe.route_topk_softmax

    def capped(x, router, k):
        sel, gates = real(x, router, k)
        E = router.shape[-1]
        cap = math.ceil(1.25 * sel.numel() / E)
        onehot = torch.nn.functional.one_hot(sel.reshape(-1), E)
        pos = (torch.cumsum(onehot, 0) - onehot).gather(
            1, sel.reshape(-1, 1))[:, 0].reshape(sel.shape)
        return sel, gates * (pos < cap)
    monkeypatch.setattr(moe, "route_topk_softmax", capped)


def _layers_unchanged(monkeypatch):
    """Every Mamba-2 layer hands back the residual it was given."""
    from repro_torch.models import mamba2
    real = mamba2.mamba_block

    def unchanged(x, p, cfg, state, *a, **k):
        _, st = real(x, p, cfg, state, *a, **k)
        return x, st
    monkeypatch.setattr(mamba2, "mamba_block", unchanged)


def _longest_unchanged(monkeypatch):
    """Every Mamba-2 layer hands back its input in the batches of the
    longest padded length alone (a few requests: ``logit_err_max``'s)."""
    from repro_torch.models import mamba2
    real = mamba2.mamba_block
    longest = -(-TRAFFIC["max_len"] // TRAFFIC["bucket"]) * TRAFFIC["bucket"]

    def partly(x, p, cfg, state, *a, **k):
        y, st = real(x, p, cfg, state, *a, **k)
        return (x if x.shape[1] == longest else y), st
    monkeypatch.setattr(mamba2, "mamba_block", partly)


def _token_altered(monkeypatch):
    """The first row's sampled token moved to the next id."""
    import repro_torch.serve as serve
    real = serve.greedy_sample

    def altered(logits):
        tok = real(logits).clone()
        tok[0] = (tok[0] + 1) % logits.shape[-1]
        return tok
    monkeypatch.setattr(serve, "greedy_sample", altered)


FAULTS = [_experts_drop, _layers_unchanged, _longest_unchanged,
          _token_altered]


@pytest.mark.parametrize("fault", FAULTS,
                         ids=[f.__name__[1:] for f in FAULTS])
def test_a_broken_timed_path_is_not_correct(state, fault, monkeypatch):
    fault(monkeypatch)
    got = _checked(state)
    assert any(got[n] > SMALL_LIMITS[n] for n in SMALL_LIMITS), got


@pytest.mark.parametrize("S", [1, 37, 100])
def test_flops_are_the_references_products(S):
    """Each term of ``hybrid_moe_prefill`` equals what the plain reference's
    own products cost (``torch.utils.flop_counter``) for one prompt of S
    tokens: the Mamba-2 projections (its scan stubbed out), the attention
    projections, the router, the top-k experts' gathered rows and the
    shared expert, the head at the last position; attention's products
    over all S x S pairs rescaled to the S(S+1)/2 kept. The scan's term is
    the recurrence's 4 dh N a token and head."""
    from torch.utils.flop_counter import FlopCounterMode
    c = _config()
    g = torch.Generator().manual_seed(S)
    params = drv.draw_by_layer(ref.param_specs(c), g, torch.float32, "cpu")
    tok = torch.randint(0, c["vocab_size"], (1, S), generator=g)
    want = hybrid_moe.hybrid_moe_prefill(c, 1, S)
    real_scan, real_attn = ref.ssd_scan, ref.attention_mixer
    parts = {"mamba": 0, "attention": 0}

    def no_scan(x, lw, Bm, Cm, chunk):
        return torch.zeros_like(x)

    def attention(cc, h, p, precision):
        with FlopCounterMode(display=False) as fc:
            out = real_attn(cc, h, p, precision, block=h.shape[1])
        parts["attention"] += fc.get_total_flops()
        return out
    ref.ssd_scan, ref.attention_mixer = no_scan, attention
    try:
        with FlopCounterMode(display=False) as fc:
            ref.logits(c, params, tok, [S - 1])
    finally:
        ref.ssd_scan, ref.attention_mixer = real_scan, real_attn
    la = want["attention_proj"]
    core = parts["attention"] - la
    assert core == want["attention"] * S * S / (S * (S + 1) // 2)
    others = sum(want[k] for k in ("mamba", "attention_proj", "router",
                                   "experts", "shared", "head"))
    assert fc.get_total_flops() - core == others
    D, di, H, dh, N = hybrid_moe._widths(c)
    assert want["scan"] == 4 * S * 5 * H * dh * N


def test_k6_bounds_are_each_mamba_layers():
    from bench.counts.bounds import ssd_bound
    c = harness.load_json(harness.BENCH / "configs"
                          / "granite-4.0-h-small.json")
    assert hybrid_moe.ssd_bounds(c, 1000) == 18 * ssd_bound(1, 128, 1000,
                                                            64, 128)


def test_the_config_file_is_the_programs_config_cut():
    """``model_config`` of the configuration file is the registered
    granite-4.0-h-small at the file's 20 layers, field for field."""
    from repro_torch.configs import get_config
    c = harness.load_json(harness.BENCH / "configs"
                          / "granite-4.0-h-small.json")
    assert c["num_hidden_layers"] == 40 and c["n_layers"] == 20
    want = dataclasses.replace(get_config("granite-4.0-h-small"),
                               n_layers=20)
    got = drv.model_config(c)
    for f in dataclasses.fields(want):
        if f.name not in ("source", "max_seq", "preferred_policy"):
            assert getattr(got, f.name) == getattr(want, f.name), f.name


def test_weights_are_drawn_from_the_seed_layer_by_layer():
    c = _config()
    specs = ref.param_specs(c)
    a, b = (drv.draw_by_layer(specs, torch.Generator().manual_seed(7),
                              torch.bfloat16, "cpu") for _ in range(2))
    w, v = a["layers"]["moe"]["w13"], b["layers"]["moe"]["w13"]
    assert w.dtype == torch.bfloat16 and tuple(w.shape) == \
        specs["layers"]["moe"]["w13"][1]
    assert torch.equal(w, v) and not torch.equal(w[0], w[1])
    assert abs(float(w.float().std()) - 1 / math.sqrt(128)) < 0.01


def test_the_reference_is_the_tests_plain_reference():
    """``bench/reference/granite4_hybrid.py`` is a copy of the CPU tests'
    ``tests/plain/granite4_hybrid.py``, byte for byte."""
    here = harness.BENCH / "reference" / "granite4_hybrid.py"
    there = harness.ROOT / "tests" / "plain" / "granite4_hybrid.py"
    assert here.read_bytes() == there.read_bytes()
