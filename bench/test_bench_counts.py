"""The frozen yardstick against the program's own analytic count and
against the bounds worked out by hand."""
import json
from pathlib import Path

import pytest

from bench.counts import bounds, flops
from bench.counts.peaks import HBM_BYTES_PER_S, TF32_FLOPS
from bench.drivers import lm_prefill

BENCH = Path(__file__).resolve().parent
ZAMBA = json.loads((BENCH / "configs" / "zamba2-1.2b.json").read_text())
TRAFFIC = json.loads((BENCH / "traffic" / "prefill_only.json").read_text())
SHAPES = sorted({(S, len(r)) for S, r in lm_prefill.batches(TRAFFIC)})


def _program(name, S, B, kind):
    from repro_torch.analysis.flops import step_flops
    from repro_torch.configs import ShapeConfig, get_config
    return step_flops(get_config(name), ShapeConfig("cell", S, B, kind), kind)


@pytest.mark.parametrize("S,B", SHAPES)
def test_zamba2_prefill_count_matches_the_program(S, B):
    ours = flops.hybrid_prefill(ZAMBA, B, S)
    theirs = _program("zamba2-1.2b", S, B, "prefill")
    assert ours["matmul"] == theirs["matmul_fwd"]
    assert ours["head"] == theirs["head_fwd"] / S     # the last position
    from repro_torch.analysis.flops import _attn_flops
    n_sh = 38 // 6
    # the program counts every masked pair; the causal mask keeps S(S+1)/2
    full = n_sh * _attn_flops(B, S, S, 32, 64)
    assert ours["attention"] == pytest.approx(full * (S + 1) / (2 * S),
                                              rel=1e-12)
    # the program's prefill counts the chunked form of the scan; its
    # decode step counts the recurrence a token, which is what ours counts
    dec = _program("zamba2-1.2b", S, B, "decode")
    step = dec["attention_fwd"] - n_sh * _attn_flops(B, 1, S, 32, 64)
    assert ours["scan"] == step * S == 38 * B * S * 4 * 64 * 64 * 64


@pytest.mark.parametrize("S", [2000, 4096])
def test_k6_bound_at_serving_shapes(S):
    B = 4 if S == 2000 else 16
    H, dh, N = 64, 64, 64
    t = bounds.ssd_bound(B, H, S, dh, N)
    nbytes = 4 * (2 * B * S * H * dh + B * S * H + 2 * B * S * N
                  + 2 * B * H * dh * N)
    assert t == pytest.approx(nbytes / HBM_BYTES_PER_S, rel=1e-12)
    assert 4 * B * H * S * dh * N / TF32_FLOPS < t      # the bytes bind
    if S == 2000:      # PERF.md's 0.081 ms counted the state once
        assert t * 1e3 == pytest.approx(0.0826, abs=0.0005)
