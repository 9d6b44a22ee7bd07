"""Adding data extends the harness: in a copy of the benchmark, a new
configuration, traffic mix, cell and per-layer metric, each a new file
named in BENCHMARK.json, are found by name and run, with no edit to
``run.py`` or to any file the benchmark already had."""
import hashlib
import json
import shutil
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def _digests(root: Path):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((root / "bench").rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def test_new_files_extend_the_harness(tmp_path):
    shutil.copytree(BENCH, tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    before = _digests(tmp_path)

    b = tmp_path / "bench"
    zamba = json.loads((b / "configs" / "zamba2-1.2b.json").read_text())
    (b / "configs" / "tiny-hybrid.json").write_text(json.dumps(
        {**zamba, "name": "tiny-hybrid", "n_layers": 2, "d_model": 64,
         "n_heads": 2, "n_kv_heads": 2, "d_head": 32, "d_ff": 128,
         "vocab_size": 64, "shared_attn_every": 2, "ssm": {
             "d_state": 8, "d_head": 16, "expand": 2, "chunk": 16,
             "d_conv": 4}, "reduced": ["n_layers"]}))
    mix = json.loads((b / "traffic" / "prefill_only.json").read_text())
    (b / "traffic" / "tiny_mix.json").write_text(json.dumps(
        {**mix, "requests": 6, "prompt_median": 10, "max_len": 24,
         "bucket": 8, "batch": 4, "check_requests": 6}))
    (b / "cells" / "tiny_cell.json").write_text(json.dumps(
        {"check": {"token_gap": 0.05}}))
    (b / "metrics" / "requests_done.tiny.py").write_text(
        "def read(run):\n"
        "    return float(sum(it['requests'] for it in run.items))\n")
    spec["configs"].append({"name": "tiny-hybrid", "source": "test",
                            "file": "bench/configs/tiny-hybrid.json",
                            "reduced": ["n_layers"], "why": "test"})
    spec["workloads"].append({"name": "tiny_cell", "config": "tiny-hybrid",
                              "traffic": "tiny_mix", "chips": 1,
                              "why": "test"})
    for m in spec["end_to_end"][1:]:
        m["workloads"].append("tiny_cell")
    spec["per_layer"].append({"name": "requests_done.tiny", "unit": "req",
                              "better": "higher", "source": "host_clock",
                              "layer": "test", "moves": "prompt_tokens_per_s",
                              "workloads": ["tiny_cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))

    after = _digests(tmp_path)
    assert all(after[k] == v for k, v in before.items())   # nothing edited
    code = (
        "import json, sys, time; sys.path[:0] = [%r, %r]\n"
        "from bench import harness\n"
        "spec = harness.benchmark_spec()\n"
        "w = [w for w in spec['workloads'] if w['name'] == 'tiny_cell'][0]\n"
        "e2e, per = harness.cell_metrics(spec, 'tiny_cell')\n"
        "print(json.dumps([m['name'] for m in e2e + per]))\n"
        "for tr in (False, True):\n"
        "    out = harness.run_cell(w, 7, 0.2, tr, time.perf_counter(),\n"
        "                           device='cpu', spec=spec)\n"
        "    print(json.dumps(out))\n") % (str(tmp_path), str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=tmp_path)
    assert res.returncode == 0, res.stderr
    names, plain_run, traced = (json.loads(x)
                                for x in res.stdout.strip().splitlines())
    assert names == ["setup_s", "prompt_tokens_per_s", "ttft_p95_ms",
                     "requests_done.tiny"]
    assert set(plain_run["metrics"]) == set(names[:3])
    assert plain_run["correct"] is True
    assert traced["metrics"]["requests_done.tiny"]["value"] >= 6
    assert traced["metrics"]["requests_done.tiny"]["unit"] == "req"


def test_every_seed_sends_the_same_mix():
    """A cycle's lengths are the log-normal's quantiles, cut at the
    context; its batches hold every request once, at most ``batch`` of
    one bucket each, padded to that bucket."""
    from bench.drivers import lm_prefill
    mix = json.loads((BENCH / "traffic" / "prefill_only.json").read_text())
    lens = lm_prefill.lengths(mix)
    assert len(lens) == 256 and lens == sorted(lens)
    assert lens[127] < 1020 < lens[128] and max(lens) == 4096
    assert sum(n == 4096 for n in lens) == 16      # 6 % at or above the context
    got = sorted(i for _, reqs in lm_prefill.batches(mix) for i in reqs)
    assert got == list(range(256))
    for S, reqs in lm_prefill.batches(mix):
        assert 1 <= len(reqs) <= 16 and S % 256 == 0
        assert all(S - 256 < lens[i] <= S for i in reqs)
