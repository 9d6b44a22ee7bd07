#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU (H100, sm_90a) and
hold its CUDA kernels against their plain PyTorch versions.

    python3 chip_smoke.py [--seed 0]

Run from a checkout of the repository: it imports ``src/repro_torch`` (never
JAX, never the JAX package ``repro``) and builds the kernels from
``src/repro_torch/kernels/*/csrc`` with ``nvcc``. Phases, each fatal:

 1. build   - one nvcc per CUDA source, all started together.
 2. data    - raw scanner dumps made from ``--seed`` with numpy: per session
              a T1w at 256x256x176 and a DWI at 96x96x60x65 (float32; a 1 mm
              MPRAGE and a 65-direction series), plus one corrupted dump,
              one filtered protocol and one non-finite volume.
 3. ingest  - ``ingest_directory(device_qa=True, device="cuda")`` twice:
              one-shot QA (REPRO_STREAM_INGEST=0, kernel K1) and streamed QA
              (REPRO_STREAM_INGEST=1, kernel K2). Launch counts are zeroed
              just before and read just after each run. Every recorded
              checksum must equal ``ref.qa_checksum_ref`` of its volume, and
              both runs must commit the same records and bytes.
 4. run     - ``generate_jobs`` + ``LocalRunner`` for bias_correct,
              affine_register, segment_unest and dwi_prequal on cuda: every
              unit ok, outputs finite, a re-query finds no work. Launch
              counts are zeroed just before and read just after each
              pipeline's run: segment_unest launches K4 5 times and K5
              twice per unit (180,224 patch tokens of a 256x256x176 T1w),
              the others neither. Then at 64^3 the cuda outputs are held
              against the port's own cpu outputs with the parity tests'
              tolerances.
 4b. cluster - a campaign over phase 3's one-shot ingest, drained on
              the card: two sessions' T1w fetched into node-0's host cache
              and one into node-1's (K2 folding the streamed misses), the
              summaries harvested, ``generate_jobs(summaries=)`` writing
              ``campaign.json``, then ``ClusterRunner`` with 4 nodes, the
              plan, per-node caches, a journal and node-1 dying after one
              unit (default leases), ``segment_unest`` on cuda. One ok
              provenance a unit, inputs' sha256 the manifest's, outputs
              byte-equal to phase 4's for the same session, K4 / K5
              launched 5 / 2 times a pipeline run, warm units that ran on
              their planned node served from the cache, the journal recovering every unit retired, and
              ``campaign.json`` re-planning byte-equal. One of node-0's
              blobs is corrupted on disk first: the verified hit must drop
              it and read storage.
 4c. sockets - the same campaign over the socket transport:
              ``ClusterRunner(transport="rpc", peer_fabric=True)`` with two
              in-process nodes and a worker process (``python -m
              repro_torch.dist.rpc work``, no ``--device``: on the card)
              that must register and commit work; only node-0's cache warm
              (all four T1ws, through K2), so the others read node-0's blob
              server; one of its blobs corrupted, which the fabric's sha256
              must reject for storage; one coordinator crash and recovery
              mid-drain. One ok provenance a unit, outputs byte-equal to
              phase 4's, at least one peer hit of a whole T1w, K4 / K5 5 / 2
              a pipeline run in this process, the journal recovering all.
 5. model   - the dense stack at the published paper-unest width (12
              layers, d 512, 8 heads, Dh 64, d_ff 2048), bf16, forward over
              the 180,224 patch tokens of one ingested T1w, weights from a
              seeded generator: finite logits, K4 25 and K5 12 launches.
 5b. serve  - ``serve_batch`` for rwkv6-1.6b, zamba2-1.2b and llama3.2-1b
              at their published configs (no cut), bf16, weights from a
              seeded CPU generator: 4 prompts of 2,000 tokens, 32 new
              tokens. Launch counts are zeroed just before and read just
              after: K6 38 (zamba2), K7 24 (rwkv6). Inside the same run
              the prefill and the decode loop are timed and counted apart
              (decode launches neither K5, K6 nor K7); tokens in the
              vocabulary, logits finite. A run under torch.profiler just
              before gives the K6/K7 share of prefill and the card's busy
              share. Then, in f32 at full width with the depth cut
              (zamba2 6 layers, one shared-attention period; rwkv6 and
              llama 2) on a 300-token prompt: prefill(S-1) plus one decode
              step against prefill(S) within 2e-3, and the cuda prefill
              (logits and every cache tensor) against the port's own CPU
              run within 1e-4 of each one's largest |value|; with a
              broken scan in place (each chunk from a zero state) that
              check must fail.
 5c. train  - LM training on the card. llama3.2-1b at its published
              config (no cut: 16 layers, d 2,048, vocab 128,256, tied
              embeddings): ``init_train_state`` from a seeded CPU
              generator, f32 master weights, bf16 compute, remat on;
              batches of 4 x 2,048 tokens from a ``DataPipeline`` over a
              ``ShardedTokenSource`` synthesized from ``--seed``; five
              ``make_train_step`` steps, K4-K7's launch counts zeroed just
              before and reading 0 just after (training runs the
              differentiable ops, never the kernels). The first loss within
              0.5 of ln(128,256), every loss and grad_norm finite, every
              grad_norm > 0, every parameter leaf changed by step 1; the
              median step time, tokens/s and peak memory, and a sixth step
              under torch.profiler for the card's busy share of a step.
              ``CheckpointManager.save_async`` after step 3, then
              ``restore_checkpoint``: every restored leaf bit-equal to the
              saved one, and step 4 from the restored state within 1e-3 of
              the uninterrupted step 4's loss. Then for each served family
              and moonshot-v1-16b-a3b (moe) at full width with the depth
              cut (``CUT_LAYERS``), f32, a
              batch of 2 x 512 tokens: the cuda ``forward_train`` loss
              within 1e-4 relative of the port's own CPU run from the same
              params; its grad norm within 1e-4 relative, and each gradient
              leaf within 1e-3 of its largest |value|, of an f64 run of the
              same params, or, where the CPU's f32 gradient is itself
              farther than that (rwkv6: f32 rounding in the backward of the
              group norm over near-zero per-head outputs), no farther than
              4 times the CPU's; with one layer's output detached that check
              must fail (moe: the experts each token chose compared first;
              a row's targets from a token that chose otherwise on masked).
              Last, K4-K7's wrappers called on cuda tensors that require
              grad, under grad mode, must each raise.
 5d. families - ``serve_batch`` for the moe, audio and vlm families at
              their published widths, bf16, weights from a seeded CPU
              generator, 32 new tokens: whisper-small at its full depth
              (12 encoder + 12 decoder layers, d 768) on 4 x 1,500 zero
              frames and 4 prompts of 64 tokens; moonshot-v1-16b-a3b cut
              to 4 of 48 layers (d 2,048, 16 heads of 128, 64 experts,
              top-6 of 1,408) and internvl2-76b cut to 2 of 80 (d 8,192,
              64/8 heads of 128), on 4 prompts of 2,000 tokens (internvl2
              behind 256 zero patch embeddings). Launch counts zeroed just
              before and read just after: K5 36 / 4 / 2 in prefill and 0 in
              decode, K4 as the stacks call it (``_want_k4``). Then f32 at
              full width, depth cut (whisper 2 + 2 layers over 1,500
              random frames, 64 tokens; moonshot 2 layers at capacity
              factor 64; internvl2 1 layer behind 16 random patches; 300
              tokens): decode consistency within 2e-3 and the card's
              prefill against the port's own CPU run within 1e-4, moe's
              expert choices compared first; a broken model (a layer's
              cross-attention dropped, every token routed to expert 0,
              the patches zeroed) must fail that bound.
 5e. mesh   - phase 5c's training on a DeviceMesh: one NCCL rank (a
              file store in the work directory), ``make_local_mesh()``
              (1 x 1), llama3.2-1b at its published config, the same seed,
              token source, batches (4 x 2,048) and five steps through
              ``make_train_step(mesh=)``: f32 DTensor masters and moments
              placed as ``shardings_for(param_specs)`` says (the weights
              drawn on the host leaf by leaf by ``draw_sharded_state``,
              as the launcher does, only the rank's slices kept on the
              card, AdamW started on them), bf16 compute through the
              tensor-parallel path over 'model' (a group of one: the
              compute copy laid out by ``compute_model_dims``, the
              sequence gathers and scatters, the vocab-parallel loss,
              the per-leaf gradient moves, counted so that a step that
              skips them fails). Each loss within 1e-5 relative of
              phase 5c's at the same step; K4-K7 launched 0 times. Then
              5c's step-3 checkpoint restored with ``shardings=`` onto the
              mesh, every leaf bit-equal to 5c's restored leaves, and step
              4 from it giving 5c's uninterrupted step-4 loss exactly;
              ``compressed_tree_psum`` over the mesh's 'data' axis of that
              step's 1.24 B-parameter gradient tree, sum plus error within
              scale/127 of each leaf, and a second round with the error
              fed back within the reference test's bound. The broken
              control, step 4 with its gradient from the first half of
              the batch rows only (what a lost reduction over a data axis
              gives), must fail step 5's loss check. One log line with s
              a step beside 5c's, tokens/s, peak GB, the restore's s and
              the compressed sum's s, beside the card's name and power
              limit.
 5f. dryrun - phase 5e's configuration dry-run on the host's CPU
              (``launch.dryrun.lower_cell``: fake tensors on a (1, 1)
              placeholder mesh, one step, MemTracker's peak with the
              state in it): the predicted peak within 5 % of 5e's
              measured peak over its steps. The peak of that step lies in
              AdamW (the state twice and an f32 gradient), not in the
              activations: at twice the rows (8 x 2,048) the dry-run
              predicts the same peak (logged); at four times (16 x
              2,048, the broken control) the activations pass it, and
              that prediction must fail the check. One log line, beside
              the card's name and power limit, with the peaks, the
              counted flops a step, the
              TFLOP/s and MFU at 5e's measured s a step against the
              roofline's 989e12, and the H100-hours ``training_run_cost``
              gives at that MFU for one epoch of ``EPOCH_TOKENS`` (no
              price).
 5g. tp     - llama3.2-1b x train_4k dry-run on the host's CPU on the
              16 x 16 placeholder mesh (rank 0), the tensor-parallel step:
              its counted flops a rank at most TP_FLOPS_RATIO times the
              analytic count a chip, and its peak under 80 GB. The broken
              control traces the same cell with ``act_model``, ``vocab``
              and ``res_seq`` mapped to None (``Rules`` replaced here):
              every 'model' group repeats its rows, and that must fail
              the check. One log line with the counted flops, the peak
              and the collectives by kind, beside the card's name and
              power limit.
 5h. mesh serve - phase 5b's serving through the mesh steps on one NCCL
              rank (``make_local_mesh()``, 1 x 1): 5b's bf16 weights (its
              host copy) placed by ``shard_serve_state``, the caches by
              ``cache_specs``, ``serve_batch(mesh=)`` on 5b's prompts
              (once to warm, once timed). Tokens equal to 5b's, bit for
              bit (both decode with one arithmetic, and a group of one's
              collectives copy); where a row differs the failure names
              its first step and 5b's top-2 logit gap there; K5-K7's
              prefill launches and K4's in prefill and decode equal to
              5b's, K5-K7 0 in decode. f32 at 5b's cut depth (300
              tokens, one decode step) for llama3.2-1b and zamba2-1.2b:
              the mesh decode's logits within 1e-4 of the largest |logit|
              of the one-process decode's; the broken control grafts the
              prefill cache one position off (a wrong slice bound) and
              must fail that check against the unbroken mesh decode. One
              log line an arch: prefill s, decode ms a token and peak GB
              beside 5b's, with the card's name and power limit.
 5i. tp2d   - phase 5e's training and phase 5h's llama3.2-1b serving
              again through a (1, 1, 1) ('data', 'model', 'model2') NCCL
              mesh built by ``make_tp2d_mesh(shape=)``, the code that
              builds the production (16, 8, 2) tp2d mesh (one card is one
              rank: a 'model2' of one adds nothing). The five losses
              bit-equal to 5e's, K4-K7 launched 0 times in training; the
              tokens bit-equal to 5h's and K4's and K5's launches in
              prefill and decode equal to 5h's. One log line with s a
              step and ms a decoded token, beside 5e's and 5h's and the
              card's name and power limit.
 5j. examples - the six ``examples/torch_*.py`` with no arguments (the
              card, the port's default device), each its own process, all
              six started together: each must exit 0 (the training
              example's own assert: its loss fell over 200 steps). One
              log line an example with its seconds and last line.
 6. kernels - K1, K2, K3 against their plain versions on the card: on the
              ingested volumes, on every dtype, and the streaming
              accumulator at 64 KiB, 4 MiB and 1,000,003-byte chunks; K3
              also at starts 1-13 bytes past a 16-byte boundary (a T1w's
              bytes copied there must give the aligned volume's checksum).
              Bit-exact (min/max equal by value). K4 at (180,224 x 128) and
              (180,224 x 512) bf16, f32 and ragged shapes, at the serving
              shapes (phases 5b and 5d: d 768 to 8,192) with a bf16 and
              an f32 scale, on both sides of its
              layout threshold and on views 2 bytes past a 16-byte
              boundary: bit-exact (the plain version keeps the kernel's
              sum order). K5 at the
              slice's shapes over the full key length, on the first, a
              middle and the last query tile, with a flat and a peaked
              softmax; at the serving shapes (B 4, S 2,000, H 32, KV 8
              and 32, Dh 64, bf16) on every query tile; plus GQA, window
              64 and a ragged Sq = 200; at the families' prefill calls
              (moonshot: B 4, S 2,000, H 16, Dh 128; internvl2: S 2,256,
              H 64 over KV 8, Dh 128; whisper: its encoder, non-causal over
              1,500 frames, its decoder at S 64, and its cross-attention,
              64 queries over 1,500 keys; Dh 64), bf16. Each
              64-row query tile within 2e-5 absolute in f32, 3e-2 in bf16,
              and within 2^-12 (f32) or 2^-6 (bf16) of its largest
              |output|; outputs of broken kernels (zeros, one key tile,
              half the keys, a lost carry) must fail that bound. K6 at
              zamba2's width (4 x 2,000 steps, H 64, dh 64, N 64, chunk
              256) and K7 at rwkv6's (H 32, dh 64, chunk 128, bf16 r/k/v),
              in the model's strided layout, from a zero and a random
              state: y and the final state within 1e-4 of max(1, max|ref|)
              of the plain version; the first sequence against the
              sequential ``ref.py`` over all 2,000 steps; outputs of broken
              kernels (the inter-chunk term dropped, the state not carried)
              must fail the same bound.
 7. timing  - each kernel's median time (CUDA events, L2 flushed, the GPU
              kept busy so host enqueue time is not counted) at the main
              path's shapes, beside its plain version's, its bound and,
              for K4 and K5, one PyTorch call computing the same function
              (``F.rms_norm``, ``F.scaled_dot_product_attention``), which
              the port never calls. K5 also at the published width and at
              llama3.2-1b's prefill (4 x 2,000 tokens, H 32, KV 8, Dh 64),
              on contiguous (B,H,S,Dh) copies, and the card's clock and
              power read while it runs; and at the families' five prefill
              calls beside SDPA, with their launches in phase 5d. K4
              also at each (rows, d) that the serve phases' runs passed
              to it, with its launches there, beside ``F.rms_norm`` and
              an empty kernel's time, and its wrapper's host time a call
              at 4 x 2,048; K3 also at an unaligned start and at a DWI.
              torch.profiler's device time of each CUDA kernel of K1, K2
              and K3 (one kernel a call).
              K1's and K2's bound is also held to the chain of one
              dependent f32 add a step that their bit-exact fold fixes
              (``qa_bound``; "bound_term" names the larger term).
              K6 and K7 at the serve phase's shapes (no single PyTorch
              call computes either: library null), bounded by what the
              sequential recurrence needs; K6's and K7's times are the
              whole call (four and three CUDA kernels), and torch.profiler
              splits them.

Prints a ``{"kernels": [...]}`` line, the card's name and power limit, and
as its last line ``{"ok": true, "device": {...}}``. Without CUDA, or outside
a checkout, it exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, published
F32_OPS_PER_S = 67e12          # H100 SXM scalar float32, published
BF16_OPS_PER_S = 989e12        # H100 SXM bf16 tensor cores, dense, published
SM_HZ = 1.98e9                 # H100 SXM, the SM's highest clock
EXP_PER_S = 16 * 132 * SM_HZ   # MUFU: 16 exp2 per clock per SM
FADD_CYCLES = 4                # a dependent f32 add (tools/k12_ab.py measures it)
T1W = (256, 256, 176)
DWI = (96, 96, 60, 65)
SESSIONS = 4
BLK_V = 1024                   # qa_block_size for float32 volumes
TOKENS = 64 * 64 * 44          # patch tokens of a T1w at patch 4
# K5 against its plain version, per 64-row query tile: (absolute, relative
# to the tile's largest |output|). The absolute ones are the reference's
# (tests/test_kernels.py); 2^-6 of the largest output is two bf16 steps at
# it, and 2^-12 leaves float32's sum-order differences room
K5_TOL = {"float32": (2e-5, 2 ** -12), "bfloat16": (3e-2, 2 ** -6)}
CHECKSUM_CU = "src/repro_torch/kernels/checksum/csrc/checksum.cu"
TPU_CHECKSUM = "src/repro/kernels/checksum/checksum.py"
KERNELS = {  # wrapper name -> (its CUDA source, the TPU kernel it replaces)
    "qa_checksum": (CHECKSUM_CU, f"{TPU_CHECKSUM}:110"),
    "qa_checksum_chunk": (CHECKSUM_CU, f"{TPU_CHECKSUM}:223"),
    "device_checksum": (CHECKSUM_CU, f"{TPU_CHECKSUM}:47"),
    "rmsnorm": ("src/repro_torch/kernels/rmsnorm/csrc/rmsnorm.cu",
                "src/repro/kernels/rmsnorm/rmsnorm.py:12"),
    "flash_attention": (
        "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention/flash_attention.py:22"),
    "ssd_chunked": ("src/repro_torch/kernels/mamba2_ssd/csrc/mamba2_ssd.cu",
                    "src/repro/kernels/mamba2_ssd/mamba2_ssd.py:23"),
    "wkv6_chunked": ("src/repro_torch/kernels/rwkv6/csrc/rwkv6.cu",
                     "src/repro/kernels/rwkv6/rwkv6.py:20"),
}
SERVE_ARCHS = ("rwkv6-1.6b", "zamba2-1.2b", "llama3.2-1b")
SERVE_BATCH, SERVE_PROMPT, SERVE_NEW = 4, 2000, 32
CUT_LAYERS = {"rwkv6-1.6b": 2, "zamba2-1.2b": 6, "llama3.2-1b": 2,
              "moonshot-v1-16b-a3b": 2}
CUT_PROMPT = 300
# phase 5d: the moe, audio and vlm families at their published widths;
# decoder layers served (whisper's full 12, over its full 12-layer encoder)
FAMILY_LAYERS = {"whisper-small": 12, "moonshot-v1-16b-a3b": 4,
                 "internvl2-76b": 2}
# prompt tokens: whisper's inside its 448-token decoder context (each
# prompt against 1,500 encoder frames, 30 s of audio); the others as 5b's
# (internvl2's behind its 256 patch embeddings)
FAMILY_PROMPT = {"whisper-small": 64, "moonshot-v1-16b-a3b": SERVE_PROMPT,
                 "internvl2-76b": SERVE_PROMPT}
FAMILY_CUT_WHY = ("the weights are drawn on the host at ~100-120 M values "
                  "a second: the full 48-layer moonshot (~27.8 B "
                  "parameters) or 80-layer internvl2 (~70 B, ~150 GB in "
                  "bf16, more than the card holds) would take minutes")
# the f32 checks of phase 5d at full width: layers kept, and the prompt
FAMILY_CHECK = {"whisper-small": (dict(layers=2, enc_layers=2), 64),
                "moonshot-v1-16b-a3b": (dict(layers=2), CUT_PROMPT),
                "internvl2-76b": (dict(layers=1, n_patches=16), CUT_PROMPT)}
# K5 at the families' prefill calls, bf16: (B, Sq, Sk, H, KV, Dh, causal)
FAMILY_K5 = {"moonshot prefill": (4, 2000, 2000, 16, 16, 128, True),
             "internvl2 prefill": (4, 2256, 2256, 64, 8, 128, True),
             "whisper encoder": (4, 1500, 1500, 12, 12, 64, False),
             "whisper decoder": (4, 64, 64, 12, 12, 64, True),
             "whisper cross-attention": (4, 64, 1500, 12, 12, 64, False)}
TRAIN_ARCH = "llama3.2-1b"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 2048, 5
# phase 5e against phase 5c, relative: the same steps on a one-rank mesh
MESH_LOSS_TOL = 1e-5
# phase 5f: the dry-run's predicted peak against 5e's measured one,
# relative; and the epoch its cost line prices: 9e12 tokens, Meta's
# pretraining count for Llama 3.2 1B (its model card: "up to 9 trillion")
DRYRUN_PEAK_TOL = 0.05
EPOCH_TOKENS = 9e12
# phase 5g: a rank's counted flops against the analytic count a chip
TP_FLOPS_RATIO = 2.0
# phase 5h: the f32 cut-depth decode bound
MESH_CUT_TOL = 1e-4
# phase 5i: the arch served again on the tp2d mesh; phase 5j: each
# example's time limit (all six run at once)
TP2D_SERVE_ARCH = "llama3.2-1b"
EXAMPLES_TIMEOUT = 240
PARITY_BATCH, PARITY_SEQ = 2, 512
# training on the card against the port's own CPU run, f32: loss and grad
# norm relative, each gradient leaf relative to its largest |value|
TRAIN_LOSS_TOL, TRAIN_GRAD_TOL = 1e-4, 1e-3
# where the CPU's own f32 gradient is farther than that from the f64 one,
# the card's may be this many times as far (two f32 roundings of one
# ill-conditioned gradient; a lost gradient is 1.0 off)
GRAD_NOISE = 4
# K6/K7 against their plain versions and the sequential oracles: relative
# to max(1, max|ref|), the bound the reference holds its kernels to
SCAN_TOL = 1e-4
# the CUDA kernels one K6 call launches, in order (mamba2_ssd.cu)
K6_KERNELS = ("ssd_cb", "ssd_chunk_state", "ssd_state_pass", "ssd_chunk_scan")
# the CUDA kernels one K7 call launches, in order (rwkv6.cu)
K7_KERNELS = ("wkv6_chunk_state", "wkv6_state_pass", "wkv6_chunk_out")


def log(*a):
    print(*a, flush=True)


def check(cond, msg):
    if not cond:
        raise SystemExit(f"chip_smoke FAILED: {msg}")


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

def make_t1w(rng, shape=T1W):
    """A bright off-centre blob on a noisy floor under a smooth bias ramp."""
    import numpy as np
    g = [np.linspace(-1, 1, s, dtype=np.float32) for s in shape]
    gx, gy, gz = g[0][:, None, None], g[1][None, :, None], g[2][None, None, :]
    c = rng.uniform(-0.1, 0.1, 3).astype(np.float32)
    r2 = (gx - c[0]) ** 2 + (gy - c[1]) ** 2 + (gz - c[2]) ** 2
    v = 100 * np.exp(-3 * r2) + 10
    v = v + 2 * rng.standard_normal(shape, dtype=np.float32)
    return (v * (1 + 0.2 * gx)).astype(np.float32)


def make_dwi(rng, shape=DWI):
    """Three spatial maps times three direction profiles on a noise floor:
    the low-rank structure a DWI series has, which the rank-3 denoiser
    keeps (pure noise has no gap after the third singular value, so two
    SVD libraries may keep different subspaces of it)."""
    import numpy as np
    n, V = int(np.prod(shape[:-1])), shape[-1]
    maps = rng.standard_normal((n, 3), dtype=np.float32)
    profiles = rng.standard_normal((3, V), dtype=np.float32)
    sig = 80 + (maps * np.float32([20, 12, 7])) @ profiles
    sig += 3 * rng.standard_normal((n, V), dtype=np.float32)
    return sig.reshape(shape)


def write_dumps(raw: Path, seed: int, sessions: int):
    """Raw dumps for ``sessions`` sessions plus the three that must not
    commit; returns the volumes by dump name."""
    import numpy as np
    from repro_torch.core import write_raw_dump
    rng = np.random.default_rng(seed)
    vols = {}
    for s in range(sessions):
        sub = f"{s:03d}"
        for proto, make in (("T1w", make_t1w), ("dwi", make_dwi)):
            name = f"sub{sub}_{proto}.npz"
            vols[name] = make(rng)
            write_raw_dump(raw / name, vols[name], subject=sub,
                           session="01", protocol=proto)
    bad = make_t1w(rng)
    bad[tuple(s // 2 for s in bad.shape)] = np.nan
    vols["zz_nonfinite_T1w.npz"] = bad
    write_raw_dump(raw / "zz_nonfinite_T1w.npz", bad, subject="900",
                   session="01", protocol="T1w")
    write_raw_dump(raw / "zz_bold.npz", make_dwi(rng, (32, 32, 24, 8)),
                   subject="901", session="01", protocol="bold")
    (raw / "zz_corrupted.npz").write_bytes(b"PK\x03\x04" + rng.bytes(4096))
    return vols


# ---------------------------------------------------------------------------
# measuring and comparing
# ---------------------------------------------------------------------------

class Timer:
    """Median device time of a call: L2 flushed before each run, the GPU
    kept busy by a spin kernel while the host enqueues, so the two events
    bracket device work only."""

    def __init__(self):
        import torch
        self.flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")

    def __call__(self, fn, reps=15):
        import torch
        fn()                                        # warm up
        times = []
        for _ in range(reps):
            self.flush.zero_()
            torch.cuda._sleep(1_000_000)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize()
            times.append(a.elapsed_time(b))
        return statistics.median(times)


def qa_bound(nv: int, itemsize: int, nsteps: int):
    """Least time for the fused pass over nv values in nsteps steps: the
    largest of each input byte read once and 24 output bytes written, the
    scalar operations (per value a finite test, min, max and a tree add;
    per word an add, a multiply, a modulo and an add), and the chain of
    nsteps dependent f32 adds that the bit-exact fold fixes (one add a
    step, in step order, FADD_CYCLES each at SM_HZ). Returns (ms, what
    bounds it: "bytes", "operations" or "chain", the byte bound in ms)."""
    nw = (nv * itemsize + 3) // 4
    ms, by = _bound(nv * itemsize + 24, 4 * nv + 4 * nw)
    chain_ms = nsteps * FADD_CYCLES / SM_HZ * 1e3
    bytes_ms = (nv * itemsize + 24) / HBM_BYTES_PER_S * 1e3
    if chain_ms > ms:
        return chain_ms, "chain", bytes_ms
    return ms, by, bytes_ms


def _bound(nbytes: int, ops: float, rate: float = F32_OPS_PER_S):
    """(ms, what bounds it) for ``nbytes`` moved and ``ops`` at ``rate``."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / rate
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                        else "operations")


def attention_bound(S: int, H: int, KV: int, Dh: int, itemsize: int,
                    B: int = 1, Sk=None, causal: bool = True):
    """Least time for attention of B sequences of S queries over Sk keys
    (None: S): q, k, v read once and o written once, against the work the
    mask needs (causal, Sk = S: S(S+1)/2 query-key pairs per sequence and
    head; else S Sk): 4 flops per pair and head dim on the tensor cores
    (Q K^T and P V), and one exponential per pair on the MUFU, the larger
    of the two. Returns (ms, what bounds it)."""
    Sk = S if Sk is None else Sk
    pairs = B * S * (S + 1) // 2 if causal else B * S * Sk
    nbytes = B * (2 * S * H * Dh + 2 * Sk * KV * Dh) * itemsize
    flops, exps = 4 * pairs * Dh * H, H * pairs
    if flops / BF16_OPS_PER_S >= exps / EXP_PER_S:
        return _bound(nbytes, flops, BF16_OPS_PER_S)
    return _bound(nbytes, exps, EXP_PER_S)


def max_err(got, want) -> float:
    """Max |a - b| over matching outputs; equal values (inf, -0.0 vs +0.0,
    NaN vs NaN) count 0."""
    import numpy as np
    worst = 0.0
    for a, b in zip(got, want):
        check(a.shape == b.shape and a.dtype == b.dtype,
              f"outputs differ in kind: {a.shape}/{a.dtype} {b.shape}/{b.dtype}")
        a, b = a.cpu().double().numpy(), b.cpu().double().numpy()
        same = (a == b) | (np.isnan(a) & np.isnan(b))
        d = np.where(same, 0.0, np.abs(a - b))
        worst = max(worst, float(np.nan_to_num(d, nan=np.inf).max(
            initial=0.0)))
    return worst


# ---------------------------------------------------------------------------
# the run
# ---------------------------------------------------------------------------

def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build   # fails outside a checkout
    t_start = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "-i", "0",
                          "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0 and smi.stdout.strip(), "nvidia-smi failed")
    card = smi.stdout.strip().splitlines()[0]
    import numpy as np
    log(f"device: {torch.cuda.get_device_name(0)} | {card} | torch "
        f"{torch.__version__} cuda {torch.version.cuda} numpy "
        f"{np.__version__} python {sys.version.split()[0]}")
    # float32 matmuls and convolutions in full float32, no TF32 (the
    # defaults for matmul; stated here, where the comparisons are made)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    _build.build_all()
    log(f"build: {time.perf_counter() - t0:.3f} s ({len(_build.SOURCES)} "
        f"sources, one nvcc each, in parallel)")
    for name in _build.SOURCES:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                log(f"  ptxas {name}: {line.strip()}")
    work = ROOT / "build" / "chip_smoke"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    try:
        kernels = run(args, work, card)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    check("jax" not in sys.modules and "repro" not in sys.modules,
          "the port pulled in JAX or the JAX package")
    log(f"total: {time.perf_counter() - t_start:.3f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def run(args, work: Path, card: str):
    import numpy as np
    import torch
    from repro_torch.core import (LocalRunner, builtin_pipelines,
                                  generate_jobs, ingest_directory,
                                  query_available_work)
    from repro_torch.core import stream as stream_mod
    from repro_torch.kernels.checksum import (
        ACCUMULATOR_DTYPES, LAUNCHES, QAChecksumAccumulator, QAStats,
        device_checksum, device_checksum_plain, qa_checksum_batched,
        initial_carry, qa_checksum_batched_plain, qa_checksum_chunk,
        qa_checksum_chunk_plain, ref, reset_launches)
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rn

    # -- 2. data -------------------------------------------------------------
    t0 = time.perf_counter()
    raw = work / "raw"
    vols = write_dumps(raw, args.seed, SESSIONS)
    log(f"data: {len(vols)} volumes, "
        f"{sum(v.nbytes for v in vols.values()) / 1e6:.1f} MB float32, "
        f"{time.perf_counter() - t0:.3f} s")

    # -- 3. ingest: one-shot (K1), then streamed (K2) ------------------------
    ingests = {}
    os.environ.pop(stream_mod.CHUNK_MB_ENV, None)    # the 4 MiB default
    for mode in ("0", "1"):
        os.environ[stream_mod.STREAM_ENV] = mode
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        manifest, recs = ingest_directory(raw, work / f"bids{mode}", "smoke",
                                          device_qa=True, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(LAUNCHES)
        report = json.loads((work / f"bids{mode}" / "smoke" /
                             "ingestion_report.json").read_text())
        ingests[mode] = (manifest, recs, launches, wall, report)
        log(f"ingest stream={mode}: wall {wall:.3f} s, counts "
            f"{report['counts']}, launches {launches}, "
            f"stream {report.get('stream')}")
    m0, rec0, l0, _, rep0 = ingests["0"]
    m1, rec1, l1, _, rep1 = ingests["1"]
    qa_recs = [r for r in rec0 if r.status in ("ok", "failed_qa")]
    check(l0["qa_checksum"] == len(qa_recs) and l0["qa_checksum_chunk"] == 0,
          f"one-shot ingest launches {l0} for {len(qa_recs)} volumes")
    check(l1["qa_checksum_chunk"] >= len(qa_recs) and l1["qa_checksum"] == 0,
          f"streamed ingest launches {l1}")
    want = {"ok": 2 * SESSIONS, "corrupted": 1, "filtered": 1,
            "failed_qa": 1}
    check(rep0["counts"] == want == rep1["counts"],
          f"ingest counts {rep0['counts']} / {rep1['counts']}")
    t0 = time.perf_counter()
    for r in qa_recs:
        st = QAStats.from_carry(*ref.qa_checksum_ref(vols[r.source]))
        check(r.checksum == f"{st.checksum:016x}",
              f"{r.source}: checksum {r.checksum} != {st.checksum:016x}")
    log(f"oracle: {len(qa_recs)} checksums equal ref.qa_checksum_ref "
        f"({time.perf_counter() - t0:.3f} s)")

    def strip(recs, mode):
        return [(r.source, r.status, r.reason, r.checksum, r.sha256,
                 r.dest.replace(str(work / f"bids{mode}"), ""))
                for r in recs]
    check(strip(rec0, "0") == strip(rec1, "1"),
          "the two ingests committed different records")
    check([(i.path, i.sha256) for i in m0.images] ==
          [(i.path, i.sha256) for i in m1.images],
          "the two ingests committed different bytes")
    reasons = {r.source: r.reason for r in rec1}
    check(reasons["zz_nonfinite_T1w.npz"] == "non-finite voxels",
          f"non-finite volume: {reasons['zz_nonfinite_T1w.npz']}")

    # -- 4. the pipelines on cuda ---------------------------------------------
    pipes = builtin_pipelines("cuda")
    k45 = {}                                # launches of segment_unest's run
    for name, pipe in pipes.items():
        plan = generate_jobs(m1, pipe, work / "jobs")
        check(len(plan.units) == SESSIONS,
              f"{name}: {len(plan.units)} units for {SESSIONS} sessions")
        torch.cuda.synchronize()
        rn.reset_launches()
        fa.reset_launches()
        t0 = time.perf_counter()
        results = LocalRunner(pipe, m1.root).run(plan.units)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = (rn.LAUNCHES["rmsnorm"], fa.LAUNCHES["flash_attention"])
        want = (5 * SESSIONS, 2 * SESSIONS) if name == "segment_unest" \
            else (0, 0)
        check(got == want, f"{name}: K4/K5 launches {got}, want {want}")
        if name == "segment_unest":
            k45 = {"rmsnorm": got[0], "flash_attention": got[1],
                   "units": results}
        bad = [(r.unit.job_id, r.status, r.error) for r in results
               if r.status != "ok"]
        check(not bad, f"{name}: {bad}")
        for u in plan.units:
            for f in Path(u.out_dir).glob("*.npy"):
                check(np.all(np.isfinite(np.load(f))), f"{f} is not finite")
        again, _ = query_available_work(m1, pipe)
        check(not again, f"{name}: the re-query found {len(again)} units")
        log(f"run {name}: {len(results)} units ok, wall {wall:.3f} s, per "
            f"unit {[round(r.seconds, 3) for r in results]} s, K4/K5 "
            f"launches {got}")

    rng = np.random.default_rng(args.seed + 1)
    small = {"T1w": make_t1w(rng, (64, 64, 64)),
             "dwi": make_dwi(rng, (64, 64, 64, 65))}
    on_cpu = builtin_pipelines("cpu")
    gpu = {n: p.run(small) for n, p in pipes.items()}
    cpu = {n: p.run(small) for n, p in on_cpu.items()}

    def rel(a, b):
        return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))
    diffs = {
        "bias_correct_rel": max(rel(gpu["bias_correct"][k],
                                    cpu["bias_correct"][k])
                                for k in cpu["bias_correct"]),
        "affine_theta_abs": float(np.max(np.abs(
            gpu["affine_register"]["affine"]
            - cpu["affine_register"]["affine"]))),
        "affine_warped_abs": float(np.max(np.abs(
            gpu["affine_register"]["T1w_reg"]
            - cpu["affine_register"]["T1w_reg"]))),
        "dwi_prequal_rel": rel(gpu["dwi_prequal"]["dwi_denoised"],
                               cpu["dwi_prequal"]["dwi_denoised"]),
        "segment_logits_abs": float(np.max(np.abs(
            gpu["segment_unest"]["class_logits"]
            - cpu["segment_unest"]["class_logits"]))),
        "segment_argmax_agree": float(np.mean(
            gpu["segment_unest"]["class_logits"].argmax(-1)
            == cpu["segment_unest"]["class_logits"].argmax(-1))),
    }
    log(f"cuda vs cpu at 64^3: {diffs}")
    check(diffs["bias_correct_rel"] <= 1e-4
          and diffs["affine_theta_abs"] <= 1e-4
          and diffs["affine_warped_abs"] <= 5e-3
          and diffs["dwi_prequal_rel"] <= 1e-4
          and diffs["segment_logits_abs"] <= 1.6e-2
          and diffs["segment_argmax_agree"] >= 0.99, f"cuda vs cpu: {diffs}")

    # -- 4b. the campaign-planned cluster on cuda -------------------------------
    cluster_phase(m0, m1, pipes["segment_unest"], work, card)

    # -- 4c. the cluster over sockets: a worker process, the peer fabric ------
    socket_cluster_phase(m0, m1, pipes["segment_unest"], work, card)

    # -- 5. the dense stack at the published paper-unest width ---------------
    t1_rec = next(i for i in m1.images if i.suffix == "T1w")
    model_wall = model_phase(np.load(Path(m1.root) / t1_rec.path), args.seed)

    # -- 5b. serving: rwkv6, zamba2 and llama at their published widths -------
    t0 = time.perf_counter()
    serve = serve_phase(args.seed)
    cut_model_phase(args.seed)
    serve_s = time.perf_counter() - t0

    # -- 5c. training: llama at its published config, checkpoints, parity ---
    t0 = time.perf_counter()
    trained = train_phase(args.seed, work, card)
    train_parity_phase(args.seed)
    train_refusal_phase()
    log(f"train phase: {time.perf_counter() - t0} s in all")

    # -- 5d. families: moe, audio and vlm at their published widths --------
    t0 = time.perf_counter()
    fam = family_phase(args.seed)
    family_cut_phase(args.seed)
    log(f"families phase: {time.perf_counter() - t0} s in all")
    served = {**serve, **fam}           # every run that launched K4

    # -- 5e. training on a mesh: one NCCL rank, 5c's run and checkpoint -----
    t0 = time.perf_counter()
    mesh_measured = mesh_train_phase(args.seed, work, card, trained)
    del trained
    log(f"mesh train phase: {time.perf_counter() - t0} s in all")

    # -- 5f. the dry-run of 5e's configuration against 5e's measurements ---
    t0 = time.perf_counter()
    dryrun_phase(card, mesh_measured["peak_gb"], mesh_measured["step_s"])
    log(f"dryrun phase: {time.perf_counter() - t0} s in all")

    # -- 5g. the tensor-parallel step at 16 x 16, dry-run on the host ------
    t0 = time.perf_counter()
    tp_dryrun_phase(card)
    log(f"tp dryrun phase: {time.perf_counter() - t0} s in all")

    # -- 5h. serving on a mesh: one NCCL rank, 5b's runs through the mesh --
    t0 = time.perf_counter()
    mesh_served = mesh_serve_phase(args.seed, work, card, serve)
    log(f"mesh serve phase: {time.perf_counter() - t0} s in all")

    # -- 5i. the tp2d mesh's code at one rank: 5e's training, 5h's serving -
    t0 = time.perf_counter()
    tp2d_phase(args.seed, work, card, mesh_measured, mesh_served)
    del mesh_served
    log(f"tp2d phase: {time.perf_counter() - t0} s in all")

    # -- 5j. the six examples, each a process of its own on the card -------
    t0 = time.perf_counter()
    examples_phase(work, card)
    log(f"examples phase: {time.perf_counter() - t0} s in all")

    # -- 6. kernels against their plain versions ---------------------------------
    errs = dict.fromkeys(KERNELS, 0.0)

    def hold(name, got, want):
        errs[name] = max(errs[name], max_err(got, want))

    for v in vols.values():                 # the ingested volumes
        x = torch.from_numpy(v).cuda().reshape(1, -1)
        hold("qa_checksum", qa_checksum_batched(x),
             qa_checksum_batched_plain(x))
        hold("device_checksum", [device_checksum(x)],
             [device_checksum_plain(x)])
    bits = torch.from_numpy(np.random.default_rng(args.seed + 2).integers(
        0, 256, 3 * 4_000_012, np.uint8)).cuda()
    for dt in [getattr(torch, n) for n in ACCUMULATOR_DTYPES] + \
            [torch.bfloat16]:               # every dtype, every bit pattern
        x = bits.view(dt).reshape(3, -1)
        hold("qa_checksum", qa_checksum_batched(x),
             qa_checksum_batched_plain(x))
        hold("device_checksum", [device_checksum(x)],
             [device_checksum_plain(x)])
    t1_np = vols["sub000_T1w.npz"]
    t1 = torch.from_numpy(t1_np).cuda()
    payload = t1.view(torch.uint8).reshape(-1)
    n = t1.numel()
    # K3 at starts 1-15 bytes past a 16-byte boundary (the T1w's bytes
    # copied there: the same checksum as the aligned volume's), and on
    # random bytes at unaligned starts and ragged ends
    shifted = torch.empty(payload.numel() + 16, dtype=torch.uint8,
                          device="cuda")
    aligned = device_checksum(t1)
    for o in (1, 2, 3, 4, 7, 13):
        x = shifted[o:o + payload.numel()]
        x.copy_(payload)
        got = device_checksum(x)
        hold("device_checksum", [got], [device_checksum_plain(x)])
        hold("device_checksum", [got], [aligned])
        x = bits[o:o + 4_000_003]
        hold("device_checksum", [device_checksum(x)],
             [device_checksum_plain(x)])
    one = QAStats.from_carry(*(t.cpu().numpy()[0] for t in
                               qa_checksum_batched_plain(t1.reshape(1, -1))))
    data = t1_np.tobytes()
    for chunk in (64 << 10, stream_mod.DEFAULT_CHUNK_BYTES, 1_000_003):
        acc = QAChecksumAccumulator(n, np.float32, device="cuda")
        for o in range(0, len(data), chunk):
            acc.update(data[o:o + chunk])
        st = acc.finalize()
        check(st == one, f"accumulator at {chunk}-byte chunks: {st} != {one}")
        # one launch, the way the accumulator makes it, from a carry 3 MiB in
        head = 768 * BLK_V
        carry = qa_checksum_chunk(payload[:head * 4], (0, 0, n, n),
                                  initial_carry("cuda"), dtype=torch.float32,
                                  blk_v=BLK_V, nblocks=768)
        nb = chunk // (BLK_V * 4) or 1
        part = payload[head * 4:(head + nb * BLK_V) * 4]
        kw = dict(dtype=torch.float32, blk_v=BLK_V, nblocks=nb)
        hold("qa_checksum_chunk",
             qa_checksum_chunk(part, (head, head, n, n), carry, **kw),
             qa_checksum_chunk_plain(part, (head, head, n, n), carry, **kw))
    check(all(e == 0.0 for e in errs.values()), f"kernels disagree: {errs}")
    errs["rmsnorm"] = check_rmsnorm(args.seed, _k4_serving_shapes(served))
    errs["flash_attention"] = check_attention(args.seed)[0]
    errs.update(check_scans(args.seed)[0])
    log(f"kernels vs plain, max abs err: {errs}")

    # -- 7. timing at the main path's shapes ----------------------------------
    timer = Timer()
    t1r = t1.reshape(1, -1)
    dwi = torch.from_numpy(vols["sub000_dwi.npz"]).cuda().reshape(1, -1)
    nb4 = stream_mod.DEFAULT_CHUNK_BYTES // (BLK_V * 4)
    chunk4 = payload[:nb4 * BLK_V * 4]
    off4, carry0 = (0, 0, n, n), initial_carry("cuda")
    kw4 = dict(dtype=torch.float32, blk_v=BLK_V, nblocks=nb4)
    calls = {
        "qa_checksum": (lambda: qa_checksum_batched(t1r),
                        lambda: qa_checksum_batched_plain(t1r),
                        qa_bound(n, 4, n // BLK_V)),
        "qa_checksum_chunk": (
            lambda: qa_checksum_chunk(chunk4, off4, carry0, **kw4),
            lambda: qa_checksum_chunk_plain(chunk4, off4, carry0, **kw4),
            qa_bound(nb4 * BLK_V, 4, nb4)),
        "device_checksum": (lambda: device_checksum(t1),
                            lambda: device_checksum_plain(t1),
                            _bound(n * 4 + 8, 4 * n) + (None,)),
    }
    timing, bound_terms = {}, {}
    for name, (kern, plain, (b_ms, b_by, bytes_ms)) in calls.items():
        # the kernels line names the two kinds of the contract: a chain of
        # dependent adds is operations, at the rate such a chain can run
        bound_terms[name] = b_by
        timing[name] = (timer(kern), timer(plain, reps=5), b_ms,
                        "operations" if b_by == "chain" else b_by, None)
        log(f"time {name}: kernel {timing[name][0]} ms, plain "
            f"{timing[name][1]} ms, bound {b_ms} ms ({b_by}"
            + (f"; bytes {bytes_ms} ms)" if bytes_ms else ")"))
    timing.update(time_rmsnorm_and_attention(timer, args.seed))
    time_rmsnorm_serving(timer, args.seed, served)
    time_family_attention(timer, args.seed, fam)
    timing.update(time_scans(timer, args.seed))
    time_ssd_cells(timer, args.seed)
    check_and_time_mamba2_glue(timer, args.seed)
    dwi_ms = timer(lambda: qa_checksum_batched(dwi))
    b_dwi = qa_bound(dwi.numel(), 4, -(-dwi.numel() // BLK_V))
    log(f"time qa_checksum at DWI {DWI}: kernel {dwi_ms} ms, bound "
        f"{b_dwi[0]} ms ({b_dwi[1]}; bytes {b_dwi[2]} ms)")
    k3_at = {"T1w bytes 1 past a 16-byte boundary": shifted[1:1 + n * 4],
             "T1w bytes 4 past a 16-byte boundary": shifted[4:4 + n * 4],
             f"DWI {DWI}": dwi}
    for what, x in k3_at.items():
        nbytes = x.numel() * x.element_size()
        log(f"time device_checksum at {what}: kernel "
            f"{timer(lambda: device_checksum(x))} ms, bound "
            f"{_bound(nbytes + 8, nbytes)[0]} ms (bytes)")
    for name in ("qa_checksum", "qa_checksum_chunk", "device_checksum"):
        log(f"profile {name} (us per launch by CUDA kernel; one kernel a "
            f"call): {profile_kernels(calls[name][0])}")

    # ingest split: kernel time = launches x median time at that shape
    n_dwi = sum(1 for r in qa_recs if r.source.endswith("_dwi.npz"))
    k_s = {"0": ((len(qa_recs) - n_dwi) * timing["qa_checksum"][0]
                 + n_dwi * dwi_ms) / 1e3,
           "1": l1["qa_checksum_chunk"] * timing["qa_checksum_chunk"][0]
           / 1e3}
    for mode, (_, _, _, wall, rep) in ingests.items():
        log(f"ingest split stream={mode}: wall {wall} s, kernels {k_s[mode]}"
            f" s ({100 * k_s[mode] / wall} %), host work and copies "
            f"{wall - k_s[mode]} s")
    # segment_unest split, per unit: 5 K4 and 2 K5 launches at these shapes
    k_unit = (5 * timing["rmsnorm"][0] + 2 * timing["flash_attention"][0]) \
        / 1e3
    for r in k45["units"]:
        log(f"segment_unest split {r.unit.subject}: wall {r.seconds} s, "
            f"K4+K5 {k_unit} s ({100 * k_unit / r.seconds} %), rest "
            f"{r.seconds - k_unit} s")
    log(f"model split: wall {model_wall} s, K5 12 x "
        f"{timing['flash_attention_full'][0]} ms = "
        f"{12 * timing['flash_attention_full'][0] / 1e3} s")
    for arch, name, key in (("zamba2-1.2b", "ssd_chunked", "ssd_chunked"),
                            ("rwkv6-1.6b", "wkv6_chunked", "wkv6_chunked"),
                            ("llama3.2-1b", "flash_attention",
                             "flash_attention_llama")):
        n, ms = serve[arch]["launches"][name], timing[key][0]
        log(f"serve split {arch}: prefill {serve[arch]['prefill_s']} s, "
            f"{name} {n} x {ms} ms = {n * ms / 1e3} s "
            f"({100 * n * ms / 1e3 / serve[arch]['prefill_s']} %)")
    log(f"serve phase: {serve_s} s in all")

    launches = {"qa_checksum": l0["qa_checksum"],
                "qa_checksum_chunk": l1["qa_checksum_chunk"],
                # K3 is not on the main path: the JAX package calls it
                # only from tests
                "device_checksum": l0["device_checksum"]
                + l1["device_checksum"],
                "rmsnorm": k45["rmsnorm"],
                "flash_attention": k45["flash_attention"],
                # the serve phase's serve_batch runs (zamba2: K6, rwkv6: K7)
                "ssd_chunked": sum(v["launches"]["ssd_chunked"]
                                   for v in serve.values()),
                "wkv6_chunked": sum(v["launches"]["wkv6_chunked"]
                                    for v in serve.values())}
    return [{"name": name, "route": "cuda", "source": source,
             "replaces": replaces, "launches": launches[name],
             "max_abs_err": errs[name], "ms": timing[name][0],
             "plain_ms": timing[name][1], "bound_ms": timing[name][2],
             "bound_by": timing[name][3], "library_ms": timing[name][4],
             "bound_term": bound_terms.get(name, timing[name][3])}
            for name, (source, replaces) in KERNELS.items()]


def cluster_phase(m0, m1, pipe, work: Path, card: str):
    """Phase 4b: a campaign over ``m0`` (phase 3's one-shot ingest, on which
    no pipeline ran yet) drained by four in-process nodes running
    ``segment_unest`` on the card, each with its own host cache, the queue
    journaled, one node dying. Every unit must end in one ok provenance
    whose outputs are byte-equal to phase 4's for the same session (same
    bytes in, same weights, same card), K4/K5 launched 5/2 times a pipeline
    execution, warm units served from the cache, the journal replaying
    every unit retired and ``campaign.json`` re-planning byte-equal. A blob
    corrupted on disk before the run must be caught by the verified hit and
    fall back to storage."""
    import torch
    from repro_torch.core import (Provenance, generate_jobs,
                                  query_available_work)
    from repro_torch.core.campaign import (CampaignPlan, Cohort,
                                           plan_campaign)
    from repro_torch.dist import ClusterRunner, InputCache, WorkQueue
    from repro_torch.dist.cache import summaries_from_cache_dirs
    from repro_torch.dist.journal import Journal
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.kernels.checksum import LAUNCHES, reset_launches
    t_phase = time.perf_counter()
    root = work / "cluster"
    units, excluded = query_available_work(m0, pipe)
    check(len(units) == SESSIONS, f"cluster: {len(units)} units")
    by_session = sorted(units, key=lambda u: (u.subject, u.session))
    # warm host caches, through K2 (device QA on the streamed miss):
    # node-0 holds two sessions' T1w, node-1 one, the fourth is cold. The
    # nodes start in order and each leases its own shard first, then the
    # backlog (node-1 takes the cold unit as its prefetch): node-1 dies
    # after its warm unit, holding that lease, which the reaper requeues
    warm = {"node-0": by_session[:2], "node-1": by_session[2:3]}
    reset_launches()
    for node, take in warm.items():
        cache = InputCache(root / "caches" / node, device="cuda")
        for u in take:
            _, digest, origin, _, rep = cache.fetch_array(
                Path(m0.root) / u.inputs["T1w"], device_qa=True)
            check(origin == "storage" and rep["device_qa"]
                  and digest == u.input_digests["T1w"],
                  f"cluster: warming {u.job_id}: {origin}, {rep}")
    check(LAUNCHES["qa_checksum_chunk"] > 0,
          f"cluster: the warm-up launched no K2: {dict(LAUNCHES)}")
    log(f"cluster warm-up: K2 launches {LAUNCHES['qa_checksum_chunk']} | "
        f"{card}")
    summaries = summaries_from_cache_dirs(root / "caches")
    jobs = generate_jobs(m0, pipe, root / "jobs", summaries=summaries)
    plan = CampaignPlan.load(jobs.campaign_file)
    warm_ids = {s.node_id: set(s.unit_ids) for s in plan.shards if s.node_id}
    check(warm_ids == {n: {u.job_id for u in us} for n, us in warm.items()},
          f"cluster: the plan placed {warm_ids}")
    replan = plan_campaign(
        [Cohort(m0.name, pipe.name, pipe.digest(), units, excluded)],
        summaries, status=plan.resource)
    check(replan.to_json() == Path(jobs.campaign_file).read_text(),
          "cluster: campaign.json does not re-plan byte-equal")
    # the broken control: node-0's first warm blob corrupted on disk
    bad = by_session[0]
    blob = root / "caches" / "node-0" / "blobs" / bad.input_digests["T1w"]
    data = bytearray(blob.read_bytes())
    data[len(data) // 2] ^= 0xFF
    blob.write_bytes(bytes(data))
    executions = {"n": 0}
    run_fn = pipe.fn

    def counted(inputs):
        out = run_fn(inputs)
        executions["n"] += 1
        return out

    pipe.fn = counted
    runner = ClusterRunner(pipe, m0.root, nodes=4, plan=plan,
                           cache_dir=root / "caches", cache_per_node=True,
                           locality=True, journal_dir=root / "journal",
                           die_after={"node-1": 1})
    torch.cuda.synchronize()
    rn.reset_launches()
    fa.reset_launches()
    t0 = time.perf_counter()
    try:
        results = runner.run(jobs.units)
    finally:
        pipe.fn = run_fn
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k45 = (rn.LAUNCHES["rmsnorm"], fa.LAUNCHES["flash_attention"])
    ok = [r for r in results if r.status == "ok"]
    check(sorted(r.unit.job_id for r in ok)
          == sorted(u.job_id for u in units),
          f"cluster: ok results {[(r.unit.job_id, r.status) for r in results]}")
    reported = sum(1 for r in results if r.seconds > 0
                   and r.status in ("ok", "speculative", "skipped"))
    check(executions["n"] == reported,
          f"cluster: {executions['n']} pipeline runs, {reported} reported")
    check(k45 == (5 * executions["n"], 2 * executions["n"]),
          f"cluster: K4/K5 launches {k45} for {executions['n']} runs")
    check("node-1" in runner.stats.dead_nodes,
          f"cluster: node-1 did not die: {runner.stats}")
    again, _ = query_available_work(m0, pipe)
    check(not again, f"cluster: the re-query found {len(again)} units")
    by_id = {r.unit.job_id: r for r in ok}
    warm_hits = []
    for u in units:
        prov = Provenance.load(Path(u.out_dir))
        check(prov is not None and prov.status == "ok",
              f"cluster: {u.job_id} provenance {prov}")
        check(prov.inputs == {u.inputs["T1w"]: u.input_digests["T1w"]},
              f"cluster: {u.job_id} committed inputs {prov.inputs}")
        for name in ("segmentation", "class_logits"):
            f = f"sub-{u.subject}_ses-{u.session}_{name}.npy"
            got = (Path(u.out_dir) / f).read_bytes()
            want = (Path(m1.root) / "derivatives" / pipe.name
                    / f"sub-{u.subject}" / f"ses-{u.session}" / f
                    ).read_bytes()
            check(got == want,
                  f"cluster: {u.job_id} {name} differs from phase 4's")
            # the control: one flipped byte must fail the same comparison
            flipped = bytearray(got)
            flipped[-1] ^= 1
            check(bytes(flipped) != want,
                  "cluster: the byte check passed a flipped byte")
        res = by_id[u.job_id]
        home = next((n for n, ids in warm_ids.items() if u.job_id in ids),
                    None)
        if u.job_id == bad.job_id:
            check(res.bytes_from_cache == 0 and not prov.cache_hit,
                  f"cluster: the corrupted blob was served: {res}")
        elif home is not None and prov.node_id == home:
            # a warm unit that ran where the plan put it read its cache (a
            # steal or a requeue may move it, and then it reads storage)
            warm_hits.append(u.job_id)
            check(res.bytes_from_cache > 0 and prov.cache_hit,
                  f"cluster: warm unit {u.job_id} read storage: {res}")
    check(warm_hits, "cluster: no warm unit ran on its planned node")
    check(runner.stats.cache["hits"] >= 1,
          f"cluster: no cache hit: {runner.stats.cache}")
    rows, _, tail, torn = Journal(root / "journal").replay(truncate=False)
    q = WorkQueue.recover(Journal(root / "journal"))
    check(q.finished() and sorted(q.done_status().values())
          == ["ok"] * len(units),
          f"cluster: the journal recovers {q.done_status()}")
    q._journal.close()
    st = runner.stats.cache
    log(f"cluster: {len(units)} units on 4 nodes in {wall:.3f} s "
        f"({wall / len(units):.3f} s a unit; per unit "
        f"{[round(r.seconds, 3) for r in ok]} s), {executions['n']} "
        f"pipeline runs, K4/K5 launches {k45}, cache hits {st['hits']} / "
        f"misses {st['misses']}, bytes from cache {st['bytes_from_cache']}, "
        f"from storage {st['bytes_from_storage']}, stream hash "
        f"{st['stream_hash_seconds']:.4f} s / device "
        f"{st['stream_device_seconds']:.4f} s, dead {runner.stats.dead_nodes}"
        f", requeued {runner.stats.requeued}, speculated "
        f"{runner.stats.speculated}, warm hits {warm_hits}, journal "
        f"{len(rows)} units + "
        f"{len(tail)} tail records | {card}")
    log(f"cluster phase: {time.perf_counter() - t_phase:.3f} s in all "
        f"| {card}")


def socket_cluster_phase(m0, m1, pipe, work: Path, card: str):
    """Phase 4c: the campaign of phase 4b again (``m0``'s outputs of 4b
    removed first), drained over the socket: ``ClusterRunner(transport=
    "rpc", peer_fabric=True)`` with two in-process nodes and one worker
    process, ``ext-0``, started as a fresh interpreter (``python -m
    repro_torch.dist.rpc work``, no ``--device``: on the card, with its own
    empty cache and a blob server). Only node-0's cache is warm (all four
    T1ws, fetched through K2), so node-1 and ext-0 read their inputs from
    node-0's blob server. One of node-0's blobs is corrupted on disk first:
    node-1's first unit fetches it, and the fabric's sha256 must reject it
    and read storage. The coordinator is crashed and recovered once, from
    another thread, after the first unit retires. Checks as in 4b (one ok
    provenance a unit, outputs byte-equal to phase 4's, the journal), and
    ext-0 registered and committed work: the phase fails if the worker
    process dies before it registers, so a missing card cannot leave the
    drain to the in-process nodes."""
    import threading
    import torch
    from repro_torch.core import Provenance, query_available_work
    from repro_torch.dist import ClusterRunner, InputCache, WorkQueue
    from repro_torch.dist.journal import Journal
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.kernels.checksum import LAUNCHES, reset_launches
    t_phase = time.perf_counter()
    root = work / "sockets"
    shutil.rmtree(Path(m0.root) / "derivatives" / pipe.name)
    units, _ = query_available_work(m0, pipe)
    check(len(units) == SESSIONS, f"sockets: {len(units)} units")
    # node-0 warm with every T1w, through K2 (device QA on the streamed
    # miss); node-1 and ext-0 start cold
    reset_launches()
    warm = InputCache(root / "caches" / "node-0", device="cuda")
    for u in units:
        _, digest, origin, _, rep = warm.fetch_array(
            Path(m0.root) / u.inputs["T1w"], device_qa=True)
        check(origin == "storage" and rep["device_qa"]
              and digest == u.input_digests["T1w"],
              f"sockets: warming {u.job_id}: {origin}, {rep}")
    k2 = LAUNCHES["qa_checksum_chunk"]
    check(k2 > 0, f"sockets: the warm-up launched no K2: {dict(LAUNCHES)}")
    # the queue deals units round robin: node-1's first grant is units[1],
    # whose blob on node-0 is the broken control
    bad = units[1]
    blob = root / "caches" / "node-0" / "blobs" / bad.input_digests["T1w"]
    data = bytearray(blob.read_bytes())
    data[len(data) // 2] ^= 0xFF
    blob.write_bytes(bytes(data))
    runs = {"n": 0}
    run_fn = pipe.fn

    def counted(inputs):
        out = run_fn(inputs)
        runs["n"] += 1
        return out

    worker = {"proc": None, "joined": threading.Event(), "t": None}
    runner = None

    class GatedCache(InputCache):
        """node-1's cache: its first fetch waits (bounded) until node-0's
        summary reached the queue, so the fabric is asked, not raced."""

        def fetch_array(self, src, **kw):
            deadline = time.monotonic() + 30
            while time.monotonic() < deadline:
                q = runner.queue
                if q is not None and "node-0" in q.summaries_snapshot():
                    break
                time.sleep(0.005)
            return super().fetch_array(src, **kw)

    class Runner(ClusterRunner):
        def _make_cache(self, node_id=None):
            if node_id != "node-1":
                return super()._make_cache(node_id)
            return GatedCache(Path(self.cache_dir) / node_id)

    def hold(unit, attempt):
        # the in-process nodes wait (bounded) for ext-0 to join; a worker
        # process that exited ends the wait, and the checks below fail
        proc = worker["proc"]
        deadline = time.monotonic() + 180
        while not worker["joined"].is_set() and time.monotonic() < deadline:
            if proc is not None and proc.poll() is not None:
                return
            worker["joined"].wait(0.05)

    pipe.fn = counted
    runner = Runner(pipe, m0.root, transport="rpc", nodes=2,
                    cache_dir=root / "caches", cache_per_node=True,
                    peer_fabric=True, journal_dir=root / "journal",
                    locality=True, prefetch=0, fault_hook=hold)
    got, restarts = {}, []
    torch.cuda.synchronize()
    rn.reset_launches()
    fa.reset_launches()
    t0 = time.perf_counter()
    drain = threading.Thread(target=lambda: got.update(r=runner.run(units)))
    drain.start()
    log_path = root / "ext-0.log"
    try:
        while runner.server is None and drain.is_alive():
            time.sleep(0.005)
        check(runner.server is not None, "sockets: the coordinator never "
              f"served: {got}")
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        t_spawn = time.perf_counter()
        with open(log_path, "w") as wlog:
            worker["proc"] = subprocess.Popen(
                [sys.executable, "-m", "repro_torch.dist.rpc", "work",
                 "--addr", runner.server.addr_str, "--pipeline", pipe.name,
                 "--data-root", str(m0.root), "--node-id", "ext-0",
                 "--cache-dir", str(root / "ext-0-cache"),
                 "--blob-addr", "127.0.0.1:0"],
                env=env, cwd=ROOT, stdout=wlog, stderr=subprocess.STDOUT)
        while drain.is_alive() and worker["proc"].poll() is None:
            srv = runner.server
            if srv is not None and "ext-0" in srv.queue.alive_nodes():
                worker["t"] = time.perf_counter() - t_spawn
                break
            time.sleep(0.01)
        worker["joined"].set()
        # one coordinator restart, once a unit has retired
        while drain.is_alive():
            q = runner.queue
            if q is not None and len(q.done_status()) >= 1:
                info = runner.restart_coordinator()
                if info is not None:
                    restarts.append(info)
                break
            time.sleep(0.005)
        drain.join(timeout=600)
        check(not drain.is_alive(), "sockets: the drain did not finish")
        wall = time.perf_counter() - t0
        rc = worker["proc"].wait(timeout=120)
    finally:
        pipe.fn = run_fn
        worker["joined"].set()
        proc = worker["proc"]
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    torch.cuda.synchronize()
    wlog_text = log_path.read_text()
    check(worker["t"] is not None, "sockets: the worker process never "
          f"registered (rc {worker['proc'].returncode}): {wlog_text[-3000:]}")
    check(rc in (0, 3), f"sockets: worker exit {rc}: {wlog_text[-3000:]}")
    check("r" in got, "sockets: the drain raised")
    results = got["r"]
    k45 = (rn.LAUNCHES["rmsnorm"], fa.LAUNCHES["flash_attention"])
    ok = [r for r in results if r.status == "ok"]
    check(sorted(r.unit.job_id for r in ok) == sorted(u.job_id for u in units),
          f"sockets: ok results {[(r.unit.job_id, r.status) for r in results]}")
    check(k45 == (5 * runs["n"], 2 * runs["n"]),
          f"sockets: K4/K5 launches {k45} for {runs['n']} runs here")
    st = runner.stats
    check("ext-0" in st.remote_nodes, f"sockets: remote nodes {st}")
    by_node, unit_s = {}, []
    for u in units:
        prov = Provenance.load(Path(u.out_dir))
        check(prov is not None and prov.status == "ok",
              f"sockets: {u.job_id} provenance {prov}")
        check(prov.inputs == {u.inputs["T1w"]: u.input_digests["T1w"]},
              f"sockets: {u.job_id} committed inputs {prov.inputs}")
        by_node[prov.node_id] = by_node.get(prov.node_id, 0) + 1
        unit_s.append((prov.node_id, round(prov.finished_at
                                           - prov.started_at, 3)))
        for name in ("segmentation", "class_logits"):
            f = f"sub-{u.subject}_ses-{u.session}_{name}.npy"
            want = (Path(m1.root) / "derivatives" / pipe.name
                    / f"sub-{u.subject}" / f"ses-{u.session}" / f
                    ).read_bytes()
            check((Path(u.out_dir) / f).read_bytes() == want,
                  f"sockets: {u.job_id} {name} (on {prov.node_id}) differs "
                  "from phase 4's")
    check(by_node.get("ext-0", 0) >= 1,
          f"sockets: ext-0 committed no unit: {by_node}")
    # peer bytes: each unit fetched over the fabric moved its whole T1w
    peer = [r for r in ok if r.bytes_from_peer > 0]
    check(peer and all(r.bytes_from_peer == r.unit.input_bytes["T1w"]
                       for r in peer),
          f"sockets: peer fetches {[(r.unit.job_id, r.bytes_from_peer) for r in ok]}")
    peer_bytes = sum(r.bytes_from_peer for r in ok)
    # the broken control: node-1 fetched the corrupted blob, the fabric's
    # in-flight sha256 rejected it, and the unit read storage
    n1 = st.cache_by_node["node-1"]
    bad_res = next(r for r in ok if r.unit.job_id == bad.job_id)
    check(n1["peer_digest_mismatches"] >= 1 and bad_res.bytes_from_peer == 0
          and n1["bytes_from_storage"] >= bad.input_bytes["T1w"],
          f"sockets: the corrupted blob was not caught: {n1}, {bad_res}")
    check(len(restarts) == 1 and restarts[0]["total_s"]
          >= restarts[0]["recover_s"] >= 0,
          f"sockets: coordinator restart {restarts}")
    q = WorkQueue.recover(Journal(root / "journal"))
    check(q.finished() and sorted(q.done_status().values())
          == ["ok"] * len(units),
          f"sockets: the journal recovers {q.done_status()}")
    q._journal.close()
    remote = runner.queue.stats_snapshot()["cache"].get("ext-0", {})
    storage = st.cache["bytes_from_storage"] + remote.get(
        "bytes_from_storage", 0)
    log(f"sockets: {len(units)} units on node-0, node-1 and a worker "
        f"process in {wall:.3f} s ({wall / len(units):.3f} s a unit of "
        f"wall), units by node {dict(sorted(by_node.items()))}, unit s "
        f"{unit_s}, "
        f"{runs['n']} pipeline runs here, K4/K5 launches here {k45}, warm-up "
        f"K2 launches {k2}, peer hits {len(peer)} ({peer_bytes} bytes), "
        f"bytes from storage {storage} (node-1 {n1['bytes_from_storage']}, "
        f"ext-0 {remote.get('bytes_from_storage')}), fabric mismatches "
        f"{n1['peer_digest_mismatches']}, restart recover_s "
        f"{restarts[0]['recover_s']:.4f} total_s "
        f"{restarts[0]['total_s']:.4f}, worker start-up "
        f"{worker['t']:.3f} s, worker exit {rc} | {card}")
    log(f"sockets phase: {time.perf_counter() - t_phase:.3f} s in all "
        f"| {card}")


def model_phase(vol, seed: int) -> float:
    """Phase 5: the dense stack at the published paper-unest width over
    the patch tokens of ``vol``, in bf16; returns its wall time (s)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.pipelines import segment_logits
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.models import init_params
    cfg = get_config("paper-unest")
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator().manual_seed(seed),
                         device="cuda")
    proj = torch.randn((4 ** 3, cfg.d_model),
                       generator=torch.Generator().manual_seed(seed + 1))
    proj = (proj / 4 ** 1.5).cuda()
    v = torch.from_numpy(vol).cuda()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rn.reset_launches()
    fa.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with torch.inference_mode():
        logits = segment_logits(v, cfg, params, proj, 4)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = (rn.LAUNCHES["rmsnorm"], fa.LAUNCHES["flash_attention"])
    want = (2 * cfg.n_layers + 1, cfg.n_layers)
    check(got == want, f"model: K4/K5 launches {got}, want {want}")
    check(tuple(logits.shape) == (TOKENS, cfg.vocab_size),
          f"model: logits {tuple(logits.shape)}")
    check(bool(torch.isfinite(logits).all()), "model: logits not finite")
    log(f"model paper-unest L{cfg.n_layers} d{cfg.d_model} H{cfg.n_heads} "
        f"KV{cfg.n_kv_heads} Dh{cfg.d_head} ff{cfg.d_ff} bf16 over "
        f"{TOKENS} tokens: wall {wall} s (weights {init_s} s), K4/K5 "
        f"launches {got}, peak {torch.cuda.max_memory_allocated() / 1e9} "
        f"GB, max |logit| {logits.abs().max().item()}")
    return wall


def _path_kernels():
    """Wrapper name -> module of K4-K7 and the Mamba-2 glue, whose launches
    the serve phase counts."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mamba2_glue as glue
    from repro_torch.kernels import mamba2_ssd as k6
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.kernels import rwkv6 as k7
    return {"rmsnorm": rn, "flash_attention": fa, "ssd_chunked": k6,
            "wkv6_chunked": k7, "mamba2_conv_in": glue,
            "mamba2_gate_norm": glue}


def _counts():
    """Launches of K4-K7 and the Mamba-2 glue since their last reset."""
    return {name: mod.LAUNCHES[name] for name, mod in _path_kernels().items()}


def _reset_counts():
    for mod in _path_kernels().values():
        mod.reset_launches()


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)


def _leaves(tree):
    if isinstance(tree, (dict, tuple)):
        for v in (tree.values() if isinstance(tree, dict) else tree):
            yield from _leaves(v)
    else:
        yield tree


def _want_launches(cfg):
    """(K5, K6, K7) launches of one prefill of ``cfg``: with an encoder,
    its self-attention a layer and the decoder's self- and
    cross-attention."""
    L = cfg.n_layers
    if cfg.family == "hybrid":
        return L // cfg.shared_attn_every, L, 0
    if cfg.rwkv is not None:
        return 0, 0, L
    if cfg.encoder is not None:
        return 2 * L + cfg.encoder.n_layers, 0, 0
    return L, 0, 0


@contextlib.contextmanager
def _k4_shapes_tallied(tally):
    """K4's wrapper, where the port's modules hold it by name, wrapped so
    that each of its launches adds one to ``tally[(rows, d, the scale's
    dtype)]``."""
    from repro_torch.kernels import rmsnorm as rn
    real = rn.rmsnorm

    def rmsnorm(x, scale, *args, **kw):
        before = rn.LAUNCHES["rmsnorm"]
        out = real(x, scale, *args, **kw)
        if rn.LAUNCHES["rmsnorm"] > before:
            d = x.shape[-1]
            key = (x.numel() // d, d, str(scale.dtype).removeprefix("torch."))
            tally[key] = tally.get(key, 0) + 1
        return out
    mods = [m for name, m in list(sys.modules.items())
            if name.startswith("repro_torch.")
            and getattr(m, "rmsnorm", None) is real]
    for m in mods:
        m.rmsnorm = rmsnorm
    try:
        yield
    finally:
        for m in mods:
            m.rmsnorm = real


def _k4_serving_shapes(serve):
    """The (rows, d) at which the serve phase's runs launched K4."""
    return sorted({(r, d) for v in serve.values() for r, d, _ in v["k4_shapes"]})


def _probed_serve_batch(cfg, prompts, params, profile=False, mesh=None,
                        new=None, dtype=None):
    """One ``serve_batch`` run of ``cfg``'s arch, probed from the inside:
    ``launch.serve`` reads ``cfg`` for the arch's name (the published
    config, or one cut from it), and its step factories are wrapped so that
    the card
    is synchronised and the clock read around the prefill, and from the
    first decode step to the end of the run, and K4-K7's launches counted
    in each part; with ``profile`` each part also runs under
    torch.profiler, and K4's launches in the run are also counted by
    (rows, d, the scale's dtype), under "k4_shapes", and each step's gap
    between its two largest logits, relative to the larger, per row, under
    "gaps". ``mesh`` serves through the mesh steps, ``new`` tokens
    (SERVE_NEW) in ``dtype`` (bf16). The counts are zeroed just before the
    run. Returns the tokens and, per part, its seconds, launches, last
    logits (decode: also the first step's) and device time by kernel
    (us)."""
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as Profile
    from repro_torch.launch import serve as serve_mod
    parts = {"k4_shapes": {}, "gaps": []}

    def gap(logits):
        if profile:     # on the card, read after the run
            top = torch.topk(logits.float(), 2, dim=-1).values
            parts["gaps"].append((top[..., 0] - top[..., 1])
                                 / top[..., 0].abs())

    def begin(part):
        torch.cuda.synchronize()
        prof = Profile(activities=[ProfilerActivity.CUDA]) if profile \
            else None
        if prof:
            prof.start()
        parts[part] = {"prof": prof, "before": _counts(),
                       "t0": time.perf_counter()}

    def end(part):
        torch.cuda.synchronize()
        p = parts[part]
        p["s"] = time.perf_counter() - p.pop("t0")
        prof = p.pop("prof")
        if prof:
            prof.stop()
        p["us"] = _device_us(prof, False) if prof else {}
        before, now = p.pop("before"), _counts()
        p["launches"] = {k: now[k] - before[k] for k in now}

    real = serve_mod.make_prefill_step, serve_mod.make_decode_step

    def prefill_factory(cfg, *a, **kw):
        step = real[0](cfg, *a, **kw)

        def prefill(params, batch):
            begin("prefill")
            logits, cache = step(params, batch)
            end("prefill")
            parts["prefill"]["logits"] = logits
            gap(logits)
            return logits, cache
        return prefill

    def decode_factory(cfg, *a, **kw):
        step = real[1](cfg, *a, **kw)

        def decode(params, cache, token, pos):
            if "decode" not in parts:
                begin("decode")
            logits, cache = step(params, cache, token, pos)
            parts["decode"].setdefault("first", logits)
            parts["decode"]["logits"] = logits
            gap(logits[:, 0])
            return logits, cache
        return decode

    _reset_counts()
    real_cfg = serve_mod.get_config
    serve_mod.make_prefill_step = prefill_factory
    serve_mod.make_decode_step = decode_factory
    serve_mod.get_config = lambda name: cfg
    try:
        with (_k4_shapes_tallied(parts["k4_shapes"]) if profile
              else contextlib.nullcontext()):
            toks = serve_mod.serve_batch(
                cfg.name, prompts, new or SERVE_NEW, reduced=False,
                params=params, device="cuda", mesh=mesh,
                compute_dtype=dtype or torch.bfloat16)
    finally:
        serve_mod.make_prefill_step, serve_mod.make_decode_step = real
        serve_mod.get_config = real_cfg
    end("decode")
    parts["gaps"] = [g.cpu().numpy() for g in parts["gaps"]]
    return toks, parts


def serve_phase(seed: int):
    """Phase 5b: ``serve_batch`` at the published configs, twice per arch:
    under torch.profiler, then timed and counted. Returns per arch the
    launches of the timed run and its measurements."""
    from repro_torch.configs import get_config
    return {arch: _serve_arch(get_config(arch), SERVE_PROMPT, seed,
                              keep=True)
            for arch in SERVE_ARCHS}


def _serve_arch(cfg, prompt_len: int, seed: int, k4_want=None,
                keep=False):
    """``serve_batch`` of ``cfg`` (its name's published config, or one cut
    from it) on SERVE_BATCH prompts of ``prompt_len`` tokens in bf16, with
    weights from a seeded CPU generator: once under torch.profiler, then
    timed and counted. Checks the tokens, the logits, K5-K7's launches
    (``_want_launches``) and, given ``k4_want`` (prefill, decode a token),
    K4's. Returns the timed run's launches and measurements; with
    ``keep`` also its tokens, the profiled run's top-2 logit gaps a step
    (the same tokens) and a host copy of the weights, for phase 5h."""
    import numpy as np
    import torch
    from repro_torch.models import init_params
    arch = cfg.name
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator().manual_seed(seed),
                         torch.bfloat16, "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prompts = np.random.default_rng(seed + 7).integers(
        0, cfg.vocab_size, (SERVE_BATCH, prompt_len), dtype=np.int32)
    want5, want6, want7 = _want_launches(cfg)
    # device time by kernel, from a run under torch.profiler, which
    # also takes the first run's start-up costs off the timed one
    again, prof = _probed_serve_batch(cfg, prompts, params, True)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    toks, parts = _probed_serve_batch(cfg, prompts, params)
    wall = time.perf_counter() - t0
    path = _counts()
    # K4's launches by shape, from the profiled run (the same work)
    k4_shapes = prof["k4_shapes"]
    check(sum(k4_shapes.values()) == path["rmsnorm"],
          f"{arch}: K4 launches by shape {k4_shapes}, in all "
          f"{path['rmsnorm']}")
    peak = torch.cuda.max_memory_allocated() / 1e9
    pre, dec = parts["prefill"], parts["decode"]
    check(toks.shape == (SERVE_BATCH, SERVE_NEW) and toks.min() >= 0
          and toks.max() < cfg.vocab_size, f"{arch}: tokens {toks}")
    check(tuple(pre["logits"].shape) == (SERVE_BATCH, cfg.vocab_size)
          and bool(torch.isfinite(pre["logits"]).all())
          and bool(torch.isfinite(dec["logits"]).all()),
          f"{arch}: prefill logits {tuple(pre['logits'].shape)} or "
          f"decode logits not finite")
    check(path["ssd_chunked"] == want6 and path["wkv6_chunked"] == want7
          and path["flash_attention"] == want5,
          f"{arch}: serve_batch launches {path}, want K5 {want5}, K6 "
          f"{want6}, K7 {want7}")
    check((pre["launches"]["flash_attention"],
           pre["launches"]["ssd_chunked"],
           pre["launches"]["wkv6_chunked"]) == (want5, want6, want7),
          f"{arch}: prefill launches {pre['launches']}")
    check(dec["launches"]["flash_attention"]
          == dec["launches"]["ssd_chunked"]
          == dec["launches"]["wkv6_chunked"] == 0,
          f"{arch}: decode launches {dec['launches']}")
    # the Mamba-2 glue kernels: once each a Mamba-2 layer in a bf16 prefill,
    # never in decode
    glue_n = cfg.n_layers if cfg.family == "hybrid" else 0
    check(pre["launches"]["mamba2_conv_in"] == glue_n
          and pre["launches"]["mamba2_gate_norm"] == glue_n
          and dec["launches"]["mamba2_conv_in"]
          == dec["launches"]["mamba2_gate_norm"] == 0,
          f"{arch}: the glue kernels' launches, prefill "
          f"{pre['launches']}, decode {dec['launches']}, want {glue_n} "
          f"and 0")
    if k4_want is not None:
        got4 = (pre["launches"]["rmsnorm"],
                dec["launches"]["rmsnorm"] / (SERVE_NEW - 1))
        check(got4 == k4_want, f"{arch}: K4 launches (prefill, decode a "
              f"token) {got4}, want {k4_want}")
    us, total = prof["prefill"]["us"], sum(prof["prefill"]["us"].values())
    share = {}
    for name, kernels in (("ssd_chunked", K6_KERNELS),
                          ("wkv6_chunked", K7_KERNELS),
                          ("flash_wgmma_kernel", ("flash_wgmma_kernel",)),
                          ("rmsnorm_kernel", ("rmsnorm_kernel",))):
        t = sum(v for k, v in us.items() if any(n in k for n in kernels))
        share[name] = (t / 1e3, 100 * t / total if total else None)
    share["device_ms"] = total / 1e3
    share["busy_%_of_prefill_wall"] = total / 1e3 / pre["s"] / 10
    share["decode_busy_%"] = sum(prof["decode"]["us"].values()) / 1e3 \
        / dec["s"] / 10
    share["top_prefill_kernels_ms"] = [
        (k[:60], v / 1e3) for k, v in
        sorted(us.items(), key=lambda kv: -kv[1])[:6]]
    out = {"launches": path, "k4_shapes": k4_shapes, "prefill_s": pre["s"],
           "prefill_launches": pre["launches"],
           "decode_launches": dec["launches"],
           "decode_ms_per_token": 1e3 * dec["s"] / (SERVE_NEW - 1),
           "wall_s": wall, "init_s": init_s, "peak_gb": peak}
    ahead = f"{cfg.vlm.n_patches} patches + " if cfg.vlm is not None else ""
    log(f"serve {arch} L{cfg.n_layers} d{cfg.d_model} bf16, "
        f"{SERVE_BATCH} x ({ahead}{prompt_len} tokens) + {SERVE_NEW} new: "
        f"serve_batch {wall} s (weights {init_s} s), launches {path}, "
        f"K4 launches by (rows, d, scale dtype) {k4_shapes}, "
        f"peak {peak} GB; prefill {pre['s']} s, launches "
        f"{pre['launches']}; decode {1e3 * dec['s']} ms for "
        f"{SERVE_NEW - 1} steps ({out['decode_ms_per_token']} ms "
        f"per token), launches {dec['launches']}; the profiled run gave "
        f"the same tokens {bool(np.array_equal(again, toks))}; prefill "
        f"device time by kernel (ms, % of device time) {share}")
    if keep:
        out.update(tokens=toks, gaps=prof["gaps"],
                   host_params=_tree_to(params, "cpu"))
    del params, pre, dec, prof
    torch.cuda.empty_cache()
    return out


def _family_cfg(arch: str, layers: int, enc_layers=None, n_patches=None,
                capacity_factor=None):
    """``arch``'s published config, its width kept, cut to ``layers``
    decoder layers (and ``enc_layers`` encoder layers, ``n_patches``
    patches, a capacity factor, where given)."""
    import dataclasses
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config(arch), n_layers=layers)
    if enc_layers is not None:
        cfg = dataclasses.replace(cfg, encoder=dataclasses.replace(
            cfg.encoder, n_layers=enc_layers))
    if n_patches is not None:
        cfg = dataclasses.replace(cfg, vlm=dataclasses.replace(
            cfg.vlm, n_patches=n_patches))
    if capacity_factor is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=capacity_factor))
    return cfg


def _want_k4(cfg):
    """K4's launches in one prefill and in one decode step of a transformer
    config: ln1 and ln2 a decoder layer (a second ln2 before the
    cross-attention with an encoder), the final norm, and an encoder's two
    a layer and its final norm."""
    per = 3 if cfg.encoder is not None else 2
    enc = 2 * cfg.encoder.n_layers + 1 if cfg.encoder is not None else 0
    return enc + per * cfg.n_layers + 1, per * cfg.n_layers + 1


def family_phase(seed: int):
    """Phase 5d: ``serve_batch`` for the moe, audio and vlm families at
    their published widths, whisper at its full depth, moonshot and
    internvl2 cut (FAMILY_LAYERS), K4's and K5's launches checked against
    the counts the code gives (``_want_k4``, ``_want_launches``). Returns
    per arch the serve run's launches and measurements."""
    from repro_torch.configs import get_config
    out = {}
    for arch, layers in FAMILY_LAYERS.items():
        cfg = _family_cfg(arch, layers)
        full = get_config(arch).n_layers
        log(f"families {arch}: width kept (d {cfg.d_model}, {cfg.n_heads}/"
            f"{cfg.n_kv_heads} heads of {cfg.d_head}, vocab "
            f"{cfg.vocab_size}), {layers} of {full} decoder layers"
            + ("" if layers == full else f" ({FAMILY_CUT_WHY})"))
        out[arch] = _serve_arch(cfg, FAMILY_PROMPT[arch], seed,
                                _want_k4(cfg))
    return out


@contextlib.contextmanager
def _scans_restarted_each_chunk():
    """The models' K6 and K7 calls replaced by a broken scan: each chunk
    from a zero state, the last chunk's state returned (the inter-chunk
    term dropped and the state not carried)."""
    import torch
    from repro_torch.models import mamba2, rwkv6

    def restarted(op):
        def scan(*args, chunk, state=None):
            S = args[0].shape[1]
            parts = [op(*(t[:, lo:lo + chunk] if t.dim() >= 3 else t
                          for t in args), chunk=chunk)
                     for lo in range(0, S, chunk)]
            return torch.cat([p[0] for p in parts], 1), parts[-1][1]
        return scan
    real = mamba2.ssd_chunked_op, rwkv6.wkv6_op
    mamba2.ssd_chunked_op = restarted(real[0])
    rwkv6.wkv6_op = restarted(real[1])
    try:
        yield
    finally:
        mamba2.ssd_chunked_op, rwkv6.wkv6_op = real


def cut_model_phase(seed: int):
    """Phase 5b, f32 at full width with the depth cut: decode consistency
    on the card (2e-3, the reference's bound), and the card's prefill (the
    logits and every cache tensor) against the port's own CPU run, each
    within 1e-4 of its largest |value|. With a broken chunk scan in place
    the same comparison must fail: the logits alone move little, since the
    embedding reaches the head through the residual, but the caches after
    the scans do not."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import graft
    from repro_torch.models import (forward_decode, forward_prefill,
                                    init_cache, init_params)
    f32 = torch.float32

    def rel(got, want):        # worst over the logits and every cache tensor
        return max(float((a.cpu() - b).abs().max())
                   / max(float(b.abs().max()), 1e-30)
                   for a, b in zip(_leaves(got), _leaves(want)))
    out = {}
    for arch in SERVE_ARCHS:
        cfg = dataclasses.replace(get_config(arch),
                                  n_layers=CUT_LAYERS[arch])
        p_cpu = init_params(cfg, torch.Generator().manual_seed(seed + 1),
                            f32, "cpu")
        params = _tree_to(p_cpu, "cuda")
        toks = torch.from_numpy(np.random.default_rng(seed + 8).integers(
            0, cfg.vocab_size, (2, CUT_PROMPT)))
        td = toks.cuda()
        with torch.inference_mode():
            full = forward_prefill(cfg, params, {"tokens": td}, f32)
            _, cache = forward_prefill(cfg, params, {"tokens": td[:, :-1]},
                                       f32)
            cache = graft(init_cache(cfg, 2, CUT_PROMPT, f32, "cuda"), cache)
            step, _ = forward_decode(cfg, params, cache, td[:, -1:],
                                     CUT_PROMPT - 1, f32)
            on_cpu = forward_prefill(cfg, p_cpu, {"tokens": toks}, f32)
            with _scans_restarted_each_chunk():
                broken = forward_prefill(cfg, params, {"tokens": td}, f32)
        consist = float((full[0] - step[:, 0]).abs().max())
        err, err_bad = rel(full, on_cpu), rel(broken, on_cpu)
        logits_bad = rel(broken[0], on_cpu[0])
        out[arch] = (consist, err, err_bad)
        log(f"cut {arch} L{cfg.n_layers} d{cfg.d_model} f32, {CUT_PROMPT} "
            f"tokens: decode vs prefill {consist} (bound 2e-3), cuda vs cpu "
            f"prefill {err} of the largest |value| (bound 1e-4), max |logit| "
            f"{float(on_cpu[0].abs().max())}; with each chunk scanned from a "
            f"zero state {err_bad} (the logits alone {logits_bad})")
        check(consist < 2e-3, f"{arch}: decode differs from prefill by "
              f"{consist}")
        check(err < 1e-4, f"{arch}: the card's prefill differs from the "
              f"CPU's by {err} of the largest")
        if cfg.family in ("hybrid", "ssm"):
            check(err_bad > 1e-4, f"{arch}: the prefill check passes a "
                  f"broken scan ({err_bad})")
    return out


@contextlib.contextmanager
def _routes_recorded(out):
    """Each ``moe._route`` call appends the experts it chose, as each
    token's sorted set (B, S, k), to ``out``. The order of a token's k
    choices changes nothing downstream but its top-1's count in the aux
    loss; the set decides the dispatch."""
    from repro_torch.models import moe
    real = moe._route

    def route(*a, **kw):
        sel, w, aux = real(*a, **kw)
        out.append(sel.sort(dim=-1).values.cpu())
        return sel, w, aux
    moe._route = route
    try:
        yield
    finally:
        moe._route = real


@contextlib.contextmanager
def _routed_to_expert_0():
    """A broken router: every slot of every token sent to expert 0."""
    from repro_torch.models import moe
    real = moe._route

    def route(*a, **kw):
        sel, w, aux = real(*a, **kw)
        return sel * 0, w, aux
    moe._route = route
    try:
        yield
    finally:
        moe._route = real


def _rows_agreeing(a, b, B: int):
    """Batch rows in which every layer's recorded choices agree between the
    runs ``a`` and ``b``, and the count of (layer, token)s that differ."""
    import torch
    rows = [r for r in range(B)
            if all(torch.equal(x[r], y[r]) for x, y in zip(a, b))]
    n = sum(int((x != y).any(-1).sum()) for x, y in zip(a, b))
    return rows, n


def family_cut_phase(seed: int):
    """Phase 5d, f32 at full width with the depth cut (FAMILY_CHECK):
    whisper 2 + 2 layers, 64 tokens against 1,500 seeded random frames;
    moonshot 2 layers at capacity factor ``n_experts`` (no token dropped,
    as the reference's decode test sets it); internvl2 1 layer behind 16
    seeded random patch embeddings; 2 rows of 300 tokens. Decode
    consistency on the card (prefill(S-1) plus one step against prefill(S),
    2e-3), and the card's prefill (the logits and every cache tensor)
    against the port's own CPU run within 1e-4 of its largest |value|.
    For moe the experts chosen are compared first: where a near-tie makes
    cuBLAS and the CPU choose other experts, only the rows whose choices
    agree are held, and the count of tokens that differ is printed. A
    broken model must fail the same bound: whisper with its first layer's
    cross-attention dropped, moonshot with every token routed to expert 0,
    internvl2 with its patch embeddings zeroed."""
    import numpy as np
    import torch
    from repro_torch.launch.serve import graft
    from repro_torch.models import (forward_decode, forward_prefill,
                                    init_cache, init_params)
    f32 = torch.float32

    def rel(got, want, rows):
        """Worst over the logits (rows on axis 0) and every cache tensor
        (rows on axis 1) of max |a - b| over the largest |b|."""
        logits = float((got[0][rows].cpu() - want[0][rows]).abs().max()) \
            / max(float(want[0][rows].abs().max()), 1e-30)
        return max([logits] + [
            float((a[:, rows].cpu() - b[:, rows]).abs().max())
            / max(float(b[:, rows].abs().max()), 1e-30)
            for a, b in zip(_leaves(got[1]), _leaves(want[1]))])
    for arch, (kw, S) in FAMILY_CHECK.items():
        t0 = time.perf_counter()
        cfg = _family_cfg(arch, **kw)
        if cfg.moe is not None:
            cfg = _family_cfg(arch, **kw,
                              capacity_factor=float(cfg.moe.n_experts))
        p_cpu = init_params(cfg, torch.Generator().manual_seed(seed + 1),
                            f32, "cpu")
        params = _tree_to(p_cpu, "cuda")
        rng = np.random.default_rng(seed + 8)
        batch = {"tokens": torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (2, S)))}
        n_pre = 0
        if cfg.encoder is not None:
            batch["enc_embeds"] = torch.from_numpy(rng.standard_normal(
                (2, cfg.encoder.enc_seq, cfg.d_model)).astype(np.float32))
        if cfg.vlm is not None:
            n_pre = cfg.vlm.n_patches
            batch["embeds"] = torch.from_numpy(rng.standard_normal(
                (2, n_pre, cfg.d_model)).astype(np.float32))
        bd = {k: v.cuda() for k, v in batch.items()}
        sel_card, sel_cpu = [], []
        with torch.inference_mode():
            with _routes_recorded(sel_card):
                full = forward_prefill(cfg, params, bd, f32)
            short = dict(bd, tokens=bd["tokens"][:, :-1])
            _, cache = forward_prefill(cfg, params, short, f32)
            cache = graft(init_cache(cfg, 2, S + n_pre, f32, "cuda"), cache)
            step, _ = forward_decode(cfg, params, cache,
                                     bd["tokens"][:, -1:], S - 1 + n_pre,
                                     f32)
            with _routes_recorded(sel_cpu):
                on_cpu = forward_prefill(cfg, p_cpu, batch, f32)
            if cfg.encoder is not None:
                bad_p = dict(params, layers=dict(params["layers"]))
                bad_p["layers"]["xattn"] = dict(
                    params["layers"]["xattn"],
                    wo=params["layers"]["xattn"]["wo"].clone())
                bad_p["layers"]["xattn"]["wo"][0] = 0
                broken, what = forward_prefill(cfg, bad_p, bd, f32), \
                    "the first layer's cross-attention dropped"
            elif cfg.moe is not None:
                with _routed_to_expert_0():
                    broken = forward_prefill(cfg, params, bd, f32)
                what = "every token routed to expert 0"
            else:
                bad = dict(bd, embeds=torch.zeros_like(bd["embeds"]))
                broken = forward_prefill(cfg, params, bad, f32)
                what = "the patch embeddings zeroed"
        rows, n_diff = _rows_agreeing(sel_card, sel_cpu, 2)
        consist = float((full[0] - step[:, 0]).abs().max())
        check(rows, f"{arch}: no row whose experts agree between the card "
              f"and the CPU ({n_diff} tokens differ)")
        err, err_bad = rel(full, on_cpu, rows), rel(broken, on_cpu, rows)
        log(f"families cut {arch} L{cfg.n_layers}"
            + (f"+{cfg.encoder.n_layers} encoder over "
               f"{cfg.encoder.enc_seq} frames" if cfg.encoder else "")
            + (f" behind {n_pre} patches" if n_pre else "")
            + (f", capacity factor {cfg.moe.capacity_factor}" if cfg.moe
               else "")
            + f" d{cfg.d_model} f32, 2 x {S} tokens: decode vs prefill "
            f"{consist} (bound 2e-3), cuda vs cpu prefill {err} of the "
            f"largest |value| (bound 1e-4) on rows {rows}; (layer, token)s "
            f"whose experts differ between the card and the CPU: {n_diff}; "
            f"max |logit| {float(on_cpu[0].abs().max())}; with {what}: "
            f"{err_bad}; {time.perf_counter() - t0} s")
        check(consist < 2e-3, f"{arch}: decode differs from prefill by "
              f"{consist}")
        check(err < 1e-4, f"{arch}: the card's prefill differs from the "
              f"CPU's by {err} of the largest")
        check(err_bad > 1e-4, f"{arch}: the prefill check passes a broken "
              f"model ({what}: {err_bad})")
        del p_cpu, params, full, cache, on_cpu, broken
        torch.cuda.empty_cache()


def _loss_and_grads(cfg, params, batch, dtype=None,
                    detach_first_layer=False):
    """``forward_train`` (remat on) in ``dtype`` (None: f32) and the
    gradient of every leaf of ``params``, in the reference's order. With
    ``detach_first_layer`` the first layer's output is detached (the
    control: gradients before it are lost)."""
    import torch
    from repro_torch import tree as tree_util
    from repro_torch.models import forward_train
    from repro_torch.models import model as model_mod
    from repro_torch.models import rwkv6 as rwkv_mod
    leaves = [t.detach().requires_grad_(True)
              for t in tree_util.leaves(params)]
    p = tree_util.unflatten_like(params, leaves)
    # each stack's layer, as the stacks look it up
    names = ((model_mod, "_txf_layer"), (rwkv_mod, "rwkv_block"),
             (model_mod, "_hybrid_layer"))
    real = {n: getattr(m, n) for m, n in names}
    first = [detach_first_layer]

    def detached(layer):
        def run(*a, **kw):
            out = layer(*a, **kw)
            if first[0]:
                first[0] = False
                out = (out[0].detach(),) + tuple(out[1:])
            return out
        return run
    for m, n in names:
        setattr(m, n, detached(real[n]))
    try:
        loss, _ = forward_train(cfg, p, batch, dtype or torch.float32,
                                remat=True)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
    finally:
        for m, n in names:
            setattr(m, n, real[n])
    return loss.detach(), list(grads)


def train_phase(seed: int, work: Path, card: str):
    """Phase 5c: llama3.2-1b trains TRAIN_STEPS steps at its published
    config on the card; a checkpoint after step 3 restores bit-equal and
    its step 4 gives the uninterrupted loss."""
    import math
    import torch
    from repro_torch import tree as tree_util
    from repro_torch.ckpt import CheckpointManager, restore_checkpoint
    from repro_torch.configs import get_config
    from repro_torch.data import DataPipeline, ShardedTokenSource
    from repro_torch.train import (OptConfig, init_train_state,
                                   make_train_step)
    from torch.profiler import ProfilerActivity, profile
    cfg = get_config(TRAIN_ARCH)
    t0 = time.perf_counter()
    params, opt_state = init_train_state(
        cfg, torch.Generator().manual_seed(seed), device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in tree_util.leaves(params))
    src = ShardedTokenSource.synthesize(
        work / "tokens", n_shards=4, tokens_per_shard=1 << 16,
        vocab_size=cfg.vocab_size, seed=seed)
    pipe = DataPipeline(src, batch=TRAIN_BATCH, seq_len=TRAIN_SEQ, seed=seed)
    step_fn = make_train_step(cfg, OptConfig(lr=3e-4, warmup_steps=2,
                                             total_steps=100),
                              torch.bfloat16, remat=True)
    mgr = CheckpointManager(work / "ckpt", keep=1, digest=cfg.digest())
    losses, norms, times, restored_loss, ckpt = [], [], [], None, {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    for s in range(TRAIN_STEPS):
        batch = pipe.batch_at(s)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        new_p, new_o, m = step_fn(params, opt_state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        if s == 0:
            same = [tree_util.path_key(pth) for (pth, a), b in zip(
                tree_util.flatten_with_paths(params),
                tree_util.leaves(new_p)) if torch.equal(a, b)]
            check(not same, f"train: leaves unchanged by step 1: {same}")
        params, opt_state = new_p, new_o
        if s == 2:                          # after step 3
            t0 = time.perf_counter()
            state = {"params": params, "opt": opt_state}
            mgr.save_async(3, state, extra={"loss": losses[-1]})
            ckpt["copy_s"] = time.perf_counter() - t0
            mgr.wait()
            ckpt["save_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            restored, step, extra = restore_checkpoint(work / "ckpt", state,
                                                       device="cuda")
            torch.cuda.synchronize()
            ckpt["restore_s"] = time.perf_counter() - t0
            ckpt["gb"] = sum(f.stat().st_size for f in
                             (work / "ckpt" / "step_00000003").iterdir()) \
                / 1e9
            diff = [tree_util.path_key(pth) for (pth, a), b in zip(
                tree_util.flatten_with_paths(state), tree_util.leaves(
                    restored)) if a.dtype != b.dtype or not torch.equal(a, b)]
            check(step == 3 and extra == {"loss": losses[-1]} and not diff,
                  f"train: the checkpoint restored step {step}, extra "
                  f"{extra}, leaves that differ {diff}")
            # phase 5e restores this checkpoint onto a mesh: its leaves
            # are held to these, bit for bit
            restored_host = [t.cpu() for t in tree_util.leaves(restored)]
            _, _, m_r = step_fn(restored["params"], restored["opt"],
                                pipe.batch_at(3))
            restored_loss = float(m_r["loss"])
            del restored, state, m_r
            torch.cuda.synchronize()
    path = _counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    # a sixth step under torch.profiler: the card's busy share of a step
    batch = pipe.batch_at(TRAIN_STEPS)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step_fn(params, opt_state, batch)
        torch.cuda.synchronize()
        prof_s = time.perf_counter() - t0
    us = _device_us(prof, False)
    busy = sum(us.values()) / 1e6 / prof_s
    top = [(k[:50], v / 1e3) for k, v in
           sorted(us.items(), key=lambda kv: -kv[1])[:8]]
    med = statistics.median(times)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    log(f"train {TRAIN_ARCH} L{cfg.n_layers} d{cfg.d_model} V"
        f"{cfg.vocab_size} ({n_params} params) f32 master, bf16 compute, "
        f"remat, {TRAIN_BATCH} x {TRAIN_SEQ} tokens: step s {times}, median "
        f"{med} s, {tokens / med} tokens/s, peak {peak} GB "
        f"(max_memory_allocated), weights {init_s} s; losses {losses}, "
        f"grad norms {norms}; K4-K7 launches {path}; checkpoint of step 3 "
        f"{ckpt['gb']} GB: host copy {ckpt['copy_s']} s, saved "
        f"{ckpt['save_s']} s, restored {ckpt['restore_s']} s, step 4 from "
        f"it {restored_loss} (uninterrupted {losses[3]}); a profiled step "
        f"{prof_s} s, device busy {100 * busy} %, top kernels (ms) {top}; "
        f"on {card}")
    check(all(v == 0 for v in path.values()),
          f"train: the steps launched kernels {path}")
    check(all(math.isfinite(x) for x in losses + norms)
          and all(x > 0 for x in norms),
          f"train: losses {losses}, grad norms {norms}")
    check(abs(losses[0] - math.log(cfg.vocab_size)) <= 0.5,
          f"train: first loss {losses[0]}, ln V {math.log(cfg.vocab_size)}")
    check(abs(restored_loss - losses[3]) <= 1e-3 * abs(losses[3]),
          f"train: step 4 from the checkpoint {restored_loss}, "
          f"uninterrupted {losses[3]}")
    del params, opt_state, new_p, new_o, prof
    torch.cuda.empty_cache()
    return {"losses": losses, "restored": restored_host,
            "restored_loss": restored_loss, "step_s": med}


def train_parity_phase(seed: int):
    """Phase 5c: ``forward_train``'s loss and gradients on the card against
    the port's own CPU run, f32, at full width with the depth cut, and
    against the f64 run of the same params (on the card: f64 needs no
    tolerance between devices at this bound). A gradient leaf of the card
    must be within TRAIN_GRAD_TOL of its largest |value| of the f64 one,
    or, where the CPU's f32 gradient is itself farther than that,
    no farther than GRAD_NOISE times the CPU's (the f32 rounding of an
    ill-conditioned gradient: rwkv's per-head group norm over near-zero
    outputs); the same for the grad norm at TRAIN_LOSS_TOL. With one
    layer's output detached the check must fail. For moe the experts each
    token chose are compared first, the card's and the CPU's f32 runs
    against the f64 one: where a near-tie makes a run choose other experts,
    the targets of that row from that token on are masked (-100) in every
    run (earlier tokens never see it), the count printed, and the runs
    repeated."""
    import dataclasses
    import math
    import numpy as np
    import torch
    from repro_torch import tree as tree_util
    from repro_torch.configs import get_config
    from repro_torch.models import init_params

    def norm(gs):
        return math.sqrt(sum(float(torch.sum(g.double() ** 2)) for g in gs))

    def leaf_errs(gs, want):
        """Each leaf's error, taken leaf by leaf on ``want``'s device (a
        moe layer's f64 gradients are 14 GB)."""
        return [float((g.to(w.device, torch.float64) - w).abs().max())
                / max(float(w.abs().max()), 1e-300)
                for g, w in zip(gs, want)]
    def runs(cfg, p_cpu, params, batch):
        """The CPU's and the card's f32 runs and the f64 one, each with
        the experts its forward chose (one entry a moe layer)."""
        sels = {k: [] for k in ("cpu", "cuda", "f64")}
        t0 = time.perf_counter()
        with _routes_recorded(sels["cpu"]):
            cpu_loss, cpu = _loss_and_grads(cfg, p_cpu, batch)
        cpu_s = time.perf_counter() - t0
        _reset_counts()
        t0 = time.perf_counter()
        with _routes_recorded(sels["cuda"]):
            loss, got = _loss_and_grads(cfg, params, batch)
        torch.cuda.synchronize()
        cuda_s = time.perf_counter() - t0
        path = _counts()
        with _routes_recorded(sels["f64"]):
            true_loss, true = _loss_and_grads(
                cfg, tree_util.tree_map(torch.Tensor.double, params), batch,
                torch.float64)
        # the forward's choices; remat's recomputes in backward follow
        sels = {k: v[:cfg.n_layers] if cfg.moe is not None else []
                for k, v in sels.items()}
        return (cpu_loss, cpu, cpu_s, loss, got, cuda_s, path, true_loss,
                true, sels)

    for arch, n_layers in CUT_LAYERS.items():
        cfg = dataclasses.replace(get_config(arch), n_layers=n_layers)
        p_cpu = init_params(cfg, torch.Generator().manual_seed(seed + 2),
                            torch.float32, "cpu")
        paths = [tree_util.path_key(q) for q, _ in
                 tree_util.flatten_with_paths(p_cpu)]
        toks = np.random.default_rng(seed + 9).integers(
            0, cfg.vocab_size, (PARITY_BATCH, PARITY_SEQ + 1))
        batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:].copy()}
        params = _tree_to(p_cpu, "cuda")
        (cpu_loss, cpu, cpu_s, loss, got, cuda_s, path, true_loss, true,
         sels) = runs(cfg, p_cpu, params, batch)
        n_diff = 0
        for side in ("cpu", "cuda"):
            for a, b in zip(sels[side], sels["f64"]):
                diff = (a != b).any(-1)
                n_diff += int(diff.sum())
                for r, t in zip(*np.nonzero(diff.numpy())):
                    batch["targets"][r, t:] = -100
        if n_diff:
            log(f"train parity {arch}: {n_diff} (layer, token)s chose other "
                f"experts than the f64 run; their rows' targets from there "
                f"on masked, {int((batch['targets'] < 0).sum())} of "
                f"{batch['targets'].size}; the runs repeated")
            (cpu_loss, cpu, cpu_s, loss, got, cuda_s, path, true_loss, true,
             sels) = runs(cfg, p_cpu, params, batch)
        _, bad = _loss_and_grads(cfg, params, batch, detach_first_layer=True)
        e_cpu, e_card = leaf_errs(cpu, true), leaf_errs(got, true)
        e_bad = leaf_errs(bad, true)
        bounds = [max(TRAIN_GRAD_TOL, GRAD_NOISE * e) for e in e_cpu]
        n_true = norm(true)
        n_cpu = abs(norm(cpu) - n_true) / n_true
        n_card = abs(norm(got) - n_true) / n_true
        n_bound = max(TRAIN_LOSS_TOL, GRAD_NOISE * n_cpu)
        loss_err = abs(float(loss) - float(cpu_loss)) / abs(float(cpu_loss))
        direct = leaf_errs(got, cpu)
        worst = max(range(len(paths)), key=lambda i: e_card[i] / bounds[i])
        log(f"train parity {arch} L{cfg.n_layers} d{cfg.d_model} f32, "
            f"{PARITY_BATCH} x {PARITY_SEQ} tokens: loss cuda {float(loss)} "
            f"cpu {float(cpu_loss)} f64 {float(true_loss)}, cuda vs cpu "
            f"{loss_err} (bound {TRAIN_LOSS_TOL}); grad norm against the "
            f"f64 one: cuda {n_card}, cpu {n_cpu} (bound {n_bound}); worst "
            f"leaf against the f64 one, of its largest |value|: cuda "
            f"{max(e_card)}, cpu {max(e_cpu)}; the nearest its bound "
            f"{paths[worst]} cuda {e_card[worst]} cpu {e_cpu[worst]} "
            f"(bound {bounds[worst]}); cuda vs cpu directly: worst leaf "
            f"{max(direct)} ({paths[int(np.argmax(direct))]}); with the "
            f"first layer's output detached: worst leaf {max(e_bad)} "
            f"({paths[int(np.argmax(e_bad))]}); cuda {cuda_s} s, cpu {cpu_s}"
            f" s; K4-K7 launches {path}")
        check(loss_err <= TRAIN_LOSS_TOL,
              f"{arch}: the card's loss differs from the CPU's by {loss_err}")
        check(max(e_cpu) < 0.1 and n_cpu < 0.1,
              f"{arch}: the CPU's f32 gradient is {max(e_cpu)} from the "
              f"f64 one: the check cannot see a lost gradient")
        check(all(e <= b for e, b in zip(e_card, bounds))
              and n_card <= n_bound,
              f"{arch}: the card's gradient: leaves over their bound "
              f"{[(q, e, b) for q, e, b in zip(paths, e_card, bounds) if e > b]}"
              f", grad norm {n_card} (bound {n_bound})")
        check(any(e > b for e, b in zip(e_bad, bounds)),
              f"{arch}: the gradient check passes a detached layer")
        check(all(v == 0 for v in path.values()),
              f"{arch}: forward_train launched kernels {path}")
        del params, got, bad, true
        torch.cuda.empty_cache()


def train_refusal_phase():
    """Phase 5c: K4-K7's wrappers refuse, on the card, an input that
    requires grad under grad mode."""
    import torch
    k = _path_kernels()
    g = torch.Generator(device="cuda").manual_seed(0)

    def r(*shape):
        return torch.randn(shape, device="cuda", generator=g)
    calls = {
        "rmsnorm": lambda a: k["rmsnorm"].rmsnorm(a(r(4, 64)), r(64)),
        "flash_attention": lambda a: k["flash_attention"].flash_attention(
            a(r(1, 4, 64, 64)), r(1, 2, 64, 64), r(1, 2, 64, 64)),
        "ssd_chunked": lambda a: k["ssd_chunked"].ssd_chunked(
            a(r(1, 2, 64, 64)), -r(1, 2, 64).abs(), r(1, 64, 64),
            r(1, 64, 64), chunk=32),
        "wkv6_chunked": lambda a: k["wkv6_chunked"].wkv6_chunked(
            a(r(1, 2, 64, 64)), r(1, 2, 64, 64), r(1, 2, 64, 64),
            -r(1, 2, 64, 64).abs() - 0.01, r(2, 64), chunk=32),
    }
    refused = {}
    for name, call in calls.items():
        with torch.no_grad():
            call(lambda t: t.requires_grad_(True))     # launches
        try:
            call(lambda t: t.requires_grad_(True))
            refused[name] = False
        except RuntimeError as e:
            refused[name] = "requires grad" in str(e)
    torch.cuda.synchronize()
    log(f"train refusal: K4-K7 on cuda inputs that require grad, under "
        f"grad mode, raised {refused}")
    check(all(refused.values()), f"kernels took inputs that require grad: "
          f"{refused}")


def mesh_train_phase(seed: int, work: Path, card: str, trained):
    """Phase 5e: phase 5c's run again, on a DeviceMesh of one NCCL rank:
    the same arch, published config, seed, batches and steps through
    ``make_train_step(mesh=)``, each loss within MESH_LOSS_TOL of 5c's;
    masters and moments DTensors on cuda placed as ``shardings_for`` says;
    5c's step-3 checkpoint restored with ``shardings=`` bit-equal to 5c's
    restored leaves, its step 4 giving 5c's uninterrupted step-4 loss; the
    int8 compressed sum of that step's gradient tree within each leaf's
    bound; K4-K7 launched 0 times. The broken control, a step whose
    gradient comes from the first half of the batch rows only (what a lost
    reduction over a data axis gives), must fail the next step's loss
    check."""
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from repro_torch import tree as tree_util
    from repro_torch.ckpt import restore_checkpoint
    from repro_torch.configs import get_config
    from repro_torch.data import DataPipeline, ShardedTokenSource
    from repro_torch.dist.collectives import (compressed_tree_psum,
                                              zeros_like_errors)
    from repro_torch.dist.sharding import P, param_specs, shardings_for
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.train import (OptConfig, draw_sharded_state,
                                   make_train_step)
    from repro_torch.train import train_step as train_step_mod
    from repro_torch.dist import sharding
    ref = trained["losses"]
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{work}/nccl_store",
                            rank=0, world_size=1,
                            device_id=torch.device("cuda", 0))
    try:
        mesh = make_local_mesh()
        cfg = get_config(TRAIN_ARCH)
        # drawn on the host leaf by leaf as the launcher does: only the
        # rank's slices reach the card, AdamW starts on them
        params, opt_state = draw_sharded_state(
            cfg, torch.Generator().manual_seed(seed), mesh)
        specs = param_specs(params, mesh)
        shard = shardings_for(mesh, {"params": specs, "opt": {
            "m": specs, "v": specs, "step": P()}})
        state = {"params": params, "opt": opt_state}
        misplaced = [tree_util.path_key(pth) for pth, x in
                     tree_util.flatten_with_paths(state)
                     if not isinstance(x, DTensor) or x.device.type != "cuda"
                     or tuple(x.placements) !=
                     tree_util.at(shard, pth).placements]
        del state
        check(not misplaced, f"mesh train: leaves not placed as "
              f"shardings_for says: {misplaced}")
        pipe = DataPipeline(ShardedTokenSource(work / "tokens"),
                            batch=TRAIN_BATCH, seq_len=TRAIN_SEQ, seed=seed)
        opt = OptConfig(lr=3e-4, warmup_steps=2, total_steps=100)
        step_fn = make_train_step(cfg, opt, torch.bfloat16, remat=True,
                                  mesh=mesh)
        losses, times = [], []
        # the tensor-parallel path's collectives, counted over the steps
        # where they are given a group (without one they are the identity)
        tp_calls = {"gather_seq": 0, "scatter_seq": 0,
                    "gather_for_compute": 0}
        grp_at = {"gather_seq": 2, "scatter_seq": 1}
        real_tp = {k: getattr(sharding, k) for k in tp_calls}

        def counting(name):
            def call(*a, **k):
                if name not in grp_at or (a[grp_at[name]] if len(a) >
                                          grp_at[name] else k["grp"]):
                    tp_calls[name] += 1
                return real_tp[name](*a, **k)
            return call
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        for k in tp_calls:
            setattr(sharding, k, counting(k))
        try:
            for s in range(TRAIN_STEPS):
                batch = pipe.batch_at(s)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                params, opt_state, m = step_fn(params, opt_state, batch)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
                losses.append(float(m["loss"]))
        finally:
            for k, fn in real_tp.items():
                setattr(sharding, k, fn)
        path = _counts()
        peak = torch.cuda.max_memory_allocated() / 1e9
        del params, opt_state, m
        torch.cuda.empty_cache()

        # the elastic restore of 5c's step-3 checkpoint, onto the mesh
        t0 = time.perf_counter()
        restored, step, _ = restore_checkpoint(
            work / "ckpt", _train_template(cfg), shardings=shard)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        differ = [tree_util.path_key(pth) for (pth, x), want in zip(
            tree_util.flatten_with_paths(restored), trained["restored"])
            if not isinstance(x, DTensor) or x.device.type != "cuda"
            or x.dtype != want.dtype
            or not torch.equal(x.to_local().cpu(), want)]
        _reset_counts()
        m4, grads = step_fn.grads(restored["params"], pipe.batch_at(3))
        loss4 = float(m4["loss"])
        path4 = _counts()

        # the compressed sum of that gradient tree over the mesh, and a
        # second round with the error fed back
        local = tree_util.tree_map(lambda g: g.to_local(), grads)
        del grads
        n_params = sum(t.numel() for t in tree_util.leaves(local))
        group = (mesh, "data")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        total, err1 = compressed_tree_psum(local, zeros_like_errors(local),
                                           group)
        torch.cuda.synchronize()
        psum_s = time.perf_counter() - t0
        second, _ = compressed_tree_psum(local, err1, group)
        far, far2 = [], []
        for (pth, x), y, e, y2 in zip(
                tree_util.flatten_with_paths(local), tree_util.leaves(total),
                tree_util.leaves(err1), tree_util.leaves(second)):
            bound = float(x.abs().max()) / 127
            if float((y + e - x).abs().max()) > bound:
                far.append(tree_util.path_key(pth))
            if float(((y + y2) / 2 - x).abs().max()) > bound:
                far2.append(tree_util.path_key(pth))
        del local, total, err1, second
        torch.cuda.empty_cache()

        # the broken control: step 4 from the first half of the rows only
        real = train_step_mod._local_rows

        def first_half(batch, rules):
            rows = real(batch, rules)
            return {k: v[: len(v) // 2] for k, v in rows.items()}
        train_step_mod._local_rows = first_half
        try:
            broken_p, broken_o, _ = step_fn(restored["params"],
                                            restored["opt"],
                                            pipe.batch_at(3))
        finally:
            train_step_mod._local_rows = real
        del restored
        m5, _ = step_fn.grads(broken_p, pipe.batch_at(4))
        broken5 = float(m5["loss"])
        del broken_p, broken_o, m5
        torch.cuda.synchronize()
    finally:
        dist.destroy_process_group()
        shutil.rmtree(work / "ckpt", ignore_errors=True)
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, ref)]
    med = statistics.median(times)
    n_leaves = len(tree_util.leaves(_train_template(cfg)["params"]))
    log(f"mesh train {TRAIN_ARCH} on a (1, 1) DeviceMesh, one NCCL rank "
        f"({n_params} params), f32 DTensor masters and moments, bf16 "
        f"compute tensor-parallel over a 'model' of 1 (calls over "
        f"{TRAIN_STEPS} steps {tp_calls}), {TRAIN_BATCH} x {TRAIN_SEQ} "
        f"tokens: step s {times}, median {med} s (5c, no mesh: "
        f"{trained['step_s']} s), {TRAIN_BATCH * TRAIN_SEQ / med} "
        f"tokens/s, peak "
        f"{peak} GB; losses {losses} (phase 5c {ref}, relative "
        f"{rel}); K4-K7 {path}, {path4}; elastic restore of step 3 "
        f"{restore_s} s, leaves that differ from 5c's {differ}, step 4 "
        f"from it {loss4} (5c uninterrupted {ref[3]}); compressed sum of "
        f"its gradient tree {psum_s} s, leaves past scale/127 {far}, past "
        f"the error-feedback bound {far2}; broken control (step 4 from half "
        f"the rows) step 5 {broken5} against {ref[4]}; on {card}")
    check(all(r <= MESH_LOSS_TOL for r in rel),
          f"mesh train: losses {losses} against phase 5c's {ref}")
    check(all(v == 0 for v in list(path.values()) + list(path4.values())),
          f"mesh train: the steps launched kernels {path} {path4}")
    check(tp_calls["gather_for_compute"] == TRAIN_STEPS * n_leaves
          and tp_calls["gather_seq"] >= TRAIN_STEPS * 2 * cfg.n_layers
          and tp_calls["scatter_seq"] >= TRAIN_STEPS * 2 * cfg.n_layers,
          f"mesh train: the steps skipped the tensor-parallel path: "
          f"{tp_calls} over {TRAIN_STEPS} steps of {n_leaves} leaves")
    check(step == 3 and not differ,
          f"mesh train: the elastic restore gave step {step}, leaves that "
          f"differ {differ}")
    check(loss4 == ref[3], f"mesh train: step 4 from the elastic restore "
          f"{loss4}, phase 5c uninterrupted {ref[3]}")
    check(not far and not far2, f"mesh train: compressed sum past its "
          f"bound at {far} / {far2}")
    check(abs(broken5 - ref[4]) > MESH_LOSS_TOL * abs(ref[4]),
          f"mesh train: the broken control passed the loss check: "
          f"{broken5} against {ref[4]}")
    return {"peak_gb": peak, "step_s": med, "losses": losses}


def dryrun_phase(card: str, peak_gb: float, step_s: float):
    """Phase 5f: phase 5e's configuration dry-run on the CPU (fake
    tensors, a (1, 1) placeholder mesh): its predicted peak within
    DRYRUN_PEAK_TOL of 5e's measured ``peak_gb``; the same at four times
    the rows must fail that check (twice the rows is logged: its peak is
    AdamW's too). Logs the counted flops, TFLOP/s and MFU at 5e's
    ``step_s``, and the H100-hours of one epoch of EPOCH_TOKENS."""
    from repro_torch.analysis.roofline import H100, model_flops
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.core.cost import GpuEnv, training_run_cost
    from repro_torch.launch.dryrun import lower_cell
    cfg = get_config(TRAIN_ARCH)

    def predict(batch):
        shape = ShapeConfig(f"phase 5e x{batch}", TRAIN_SEQ, batch, "train")
        return shape, lower_cell(cfg, shape, (1, 1), ("data", "model"))

    shape, rec = predict(TRAIN_BATCH)
    _, twice = predict(2 * TRAIN_BATCH)
    _, broken = predict(4 * TRAIN_BATCH)
    pred, pred2, pred4 = (r["peak_est_bytes"] / 1e9
                          for r in (rec, twice, broken))
    rel, rel2, rel4 = (abs(p - peak_gb) / peak_gb
                       for p in (pred, pred2, pred4))
    counted = rec["counted_flops_per_rank"]
    mfu = model_flops(cfg, shape, "train") / step_s / H100.peak_flops
    epoch = training_run_cost(GpuEnv("one H100", 1, None),
                              6 * cfg.n_active_params() * EPOCH_TOKENS, mfu)
    log(f"dryrun {TRAIN_ARCH}, phase 5e's configuration ({TRAIN_BATCH} x "
        f"{TRAIN_SEQ} tokens, (1, 1) placeholder mesh, traced on the CPU in "
        f"{rec['trace_s']} + {twice['trace_s']} + {broken['trace_s']} s): "
        f"predicted peak {pred} GB ({rec['peak_bytes_by_kind']}), measured "
        f"in 5e {peak_gb} GB, relative {rel}; at {2 * TRAIN_BATCH} x "
        f"{TRAIN_SEQ} {pred2} GB, relative {rel2}; broken control at "
        f"{4 * TRAIN_BATCH} x {TRAIN_SEQ} {pred4} GB, relative {rel4}; "
        f"counted flops a step {counted} ({rec['counted_to_analytic']} of "
        f"the analytic count), {counted / step_s / 1e12} TFLOP/s at 5e's "
        f"{step_s} s a step, MFU (6·N·T) {mfu} of {H100.peak_flops}; one "
        f"epoch of {EPOCH_TOKENS} tokens at that MFU "
        f"{epoch['gpu_hours']} H100-hours, no price; on {card}")
    check(rel <= DRYRUN_PEAK_TOL, f"dryrun: predicted peak {pred} GB, "
          f"measured {peak_gb} GB")
    check(rel4 > DRYRUN_PEAK_TOL, f"dryrun: the broken control "
          f"({4 * TRAIN_BATCH} rows) passed the peak check: {pred4} GB")


def tp_dryrun_phase(card: str):
    """Phase 5g: llama3.2-1b x train_4k dry-run on the 16 x 16 placeholder
    mesh with the tensor-parallel step: counted flops a rank at most
    TP_FLOPS_RATIO x the analytic count a chip, and a peak under 80 GB.
    The broken control maps ``act_model``, ``vocab`` and ``res_seq`` to
    None in every ``Rules`` the step builds (each 'model' group then
    repeats its rows) and must fail that check."""
    from repro_torch.analysis.roofline import H100
    from repro_torch.configs import SHAPE_BY_NAME, get_config
    from repro_torch.dist import sharding
    from repro_torch.launch.dryrun import lower_cell
    cfg, shape = get_config(TRAIN_ARCH), SHAPE_BY_NAME["train_4k"]

    def verdict(rec):
        return (rec["counted_to_analytic"] <= TP_FLOPS_RATIO
                and rec["peak_est_bytes"] < H100.hbm_bytes)

    rec = lower_cell(cfg, shape, (16, 16), ("data", "model"))
    real = sharding.Rules

    class NoTensorParallel(real):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            for name in ("act_model", "vocab", "res_seq"):
                self.map[name] = None
    sharding.Rules = NoTensorParallel
    try:
        broken = lower_cell(cfg, shape, (16, 16), ("data", "model"))
    finally:
        sharding.Rules = real

    def line(r):
        return (f"{r['counted_flops_per_rank']} flops a rank "
                f"({r['counted_to_analytic']} of the analytic "
                f"{r['flops_per_chip']} a chip), peak "
                f"{r['peak_est_bytes'] / 1e9} GB "
                f"({r['peak_bytes_by_kind']}), collectives "
                f"{r['collectives']['counts']} moving "
                f"{r['collectives']['per_op']} bytes, traced in "
                f"{r['trace_s']} s")
    log(f"tp dryrun {TRAIN_ARCH} x train_4k, 16 x 16 placeholder mesh, "
        f"rank 0, compute split over a 'model' of {rec['tp_compute']}: "
        f"{line(rec)}; broken control (act_model, vocab and res_seq to "
        f"None, compute split over {broken['tp_compute']}): {line(broken)}; "
        f"on {card}")
    check(rec["tp_compute"] == 16 and broken["tp_compute"] == 1,
          f"tp dryrun: the steps split their compute over "
          f"{rec['tp_compute']} and {broken['tp_compute']} ranks")
    check(verdict(rec), f"tp dryrun: {rec['counted_to_analytic']} of the "
          f"analytic flops, peak {rec['peak_est_bytes'] / 1e9} GB")
    check(not verdict(broken), f"tp dryrun: the broken control passed: "
          f"{broken['counted_to_analytic']} of the analytic flops, peak "
          f"{broken['peak_est_bytes'] / 1e9} GB")


def mesh_serve_phase(seed: int, work: Path, card: str, serve):
    """Phase 5h: phase 5b's serving again through the mesh steps, on a
    DeviceMesh of one NCCL rank (``make_local_mesh()``, 1 x 1): 5b's bf16
    weights (its host copy) placed by ``shard_serve_state``, the caches as
    ``cache_specs`` places them, ``serve_batch(mesh=)`` on 5b's prompts,
    once to start NCCL's communicators and once timed. The tokens must
    equal 5b's bit for bit: the decode's softmax has one arithmetic with
    and without a group, and a group of one's collectives copy (where a
    row differs, the failure gives its first step and 5b's two largest
    logits' gap there, relative to the larger). K5-K7's launches in
    prefill and K4's in prefill and in decode equal 5b's, K5-K7 0 in
    decode. Then f32 at 5b's cut depth (CUT_PROMPT tokens, one decode
    step) for the archs with a KV cache: the mesh decode's logits within
    MESH_CUT_TOL of the largest |logit| of the one-process decode's, and
    the broken control (the prefill cache grafted one position off, what
    a wrong slice bound gives) must fail that check against the unbroken
    mesh decode."""
    import dataclasses
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.dist import sharding
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import init_params
    from repro_torch.serve import shard_serve_state
    torch.cuda.set_device(0)
    dist.init_process_group("nccl",
                            init_method=f"file://{work}/nccl_serve_store",
                            rank=0, world_size=1,
                            device_id=torch.device("cuda", 0))
    try:
        mesh = make_local_mesh()
        rules = sharding.Rules(mesh, "decode", global_batch=SERVE_BATCH)
        out = {}
        for arch in SERVE_ARCHS:
            cfg, ref = get_config(arch), serve[arch]
            host = ref.pop("host_params")
            params = shard_serve_state(host, mesh, rules, cfg)
            if arch == TP2D_SERVE_ARCH:     # phase 5i serves it again
                out[arch] = {"host_params": host, "tokens": None}
            del host
            prompts = np.random.default_rng(seed + 7).integers(
                0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT),
                dtype=np.int32)
            _probed_serve_batch(cfg, prompts, params, mesh=mesh)
            torch.cuda.reset_peak_memory_stats()
            toks, parts = _probed_serve_batch(cfg, prompts, params,
                                              mesh=mesh)
            peak = torch.cuda.max_memory_allocated() / 1e9
            pre, dec = parts["prefill"], parts["decode"]
            ties = []
            for b in range(SERVE_BATCH):
                at = np.nonzero(toks[b] != ref["tokens"][b])[0]
                if len(at):
                    ties.append((b, int(at[0]),
                                 float(ref["gaps"][at[0]][b])))
            ms = 1e3 * dec["s"] / (SERVE_NEW - 1)
            log(f"mesh serve {arch} bf16 on a (1, 1) NCCL mesh, "
                f"{SERVE_BATCH} x {SERVE_PROMPT} tokens + {SERVE_NEW} new: "
                f"prefill {pre['s']} s (5b {ref['prefill_s']} s), decode "
                f"{ms} ms a token (5b {ref['decode_ms_per_token']}), peak "
                f"{peak} GB (5b {ref['peak_gb']}); launches prefill "
                f"{pre['launches']} (5b {ref['prefill_launches']}), decode "
                f"{dec['launches']} (5b {ref['decode_launches']}); tokens "
                f"equal to 5b's: {bool(np.array_equal(toks, ref['tokens']))}"
                f", first differing (row, step, 5b's top-2 gap) {ties}; on "
                f"{card}")
            check(not ties, f"mesh serve {arch}: tokens differ from 5b's "
                  f"at (row, first step, 5b's top-2 gap) {ties}")
            check(pre["launches"] == ref["prefill_launches"],
                  f"mesh serve {arch}: prefill launches {pre['launches']}, "
                  f"5b's {ref['prefill_launches']}")
            check(dec["launches"]["rmsnorm"] ==
                  ref["decode_launches"]["rmsnorm"]
                  and dec["launches"]["flash_attention"]
                  == dec["launches"]["ssd_chunked"]
                  == dec["launches"]["wkv6_chunked"] == 0,
                  f"mesh serve {arch}: decode launches {dec['launches']}, "
                  f"5b's {ref['decode_launches']}")
            if arch in out:
                out[arch].update(tokens=toks, prefill_s=pre["s"],
                                 decode_ms=ms, prefill_launches=pre[
                                     "launches"],
                                 decode_launches=dec["launches"])
            del params, pre, dec, parts
            torch.cuda.empty_cache()

        def shifted(real):
            def reslice(x, dim, *a):
                return torch.roll(real(x, dim, *a), 1, dim)
            return reslice
        for arch in ("llama3.2-1b", "zamba2-1.2b"):
            cfg = dataclasses.replace(get_config(arch),
                                      n_layers=CUT_LAYERS[arch])
            params = init_params(cfg, torch.Generator().manual_seed(seed + 1),
                                 torch.float32, "cuda")
            prompts = np.random.default_rng(seed + 8).integers(
                0, cfg.vocab_size, (2, CUT_PROMPT), dtype=np.int32)
            kw = dict(new=2, dtype=torch.float32)
            one = _probed_serve_batch(cfg, prompts, params, **kw)[1]
            placed = shard_serve_state(params, mesh, rules, cfg)
            got = _probed_serve_batch(cfg, prompts, placed, mesh=mesh, **kw)
            real = sharding.reslice_seq
            sharding.reslice_seq = shifted(real)
            try:
                bad = _probed_serve_batch(cfg, prompts, placed, mesh=mesh,
                                          **kw)
            finally:
                sharding.reslice_seq = real
            want = one["decode"]["first"].float()
            first = got[1]["decode"]["first"].full_tensor().float()
            scale = float(want.abs().max())
            err = float((first - want).abs().max()) / scale
            err_ctl = float((bad[1]["decode"]["first"].full_tensor().float()
                             - first).abs().max()) / scale
            log(f"mesh serve cut {arch} L{cfg.n_layers} f32, {CUT_PROMPT} "
                f"tokens, (1, 1) mesh: first decode step's logits against "
                f"the one-process decode's {err} of the largest |logit| "
                f"{scale} (bound {MESH_CUT_TOL}); the prefill cache grafted "
                f"one position off: {err_ctl} from the unbroken mesh "
                f"decode's")
            check(err <= MESH_CUT_TOL, f"mesh serve cut {arch}: {err}")
            check(err_ctl > MESH_CUT_TOL, f"mesh serve cut {arch}: the "
                  f"cache grafted one position off passed ({err_ctl})")
            del params, placed, one, got, bad
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    return out


def tp2d_phase(seed: int, work: Path, card: str, trained, served):
    """Phase 5i: phase 5e's training and phase 5h's serving of
    TP2D_SERVE_ARCH again, on a (1, 1, 1) ('data', 'model', 'model2')
    DeviceMesh of one NCCL rank built by ``make_tp2d_mesh(shape=)``, the
    code that builds the production tp2d mesh. A 'model2' of one adds
    nothing, so the step runs as 5e's and the serving as 5h's: the five
    losses bit-equal to 5e's, the tokens bit-equal to 5h's, K4's and K5's
    launches in prefill and in decode equal to 5h's, K4-K7 0 in training.
    One log line with s a step and ms a decoded token, beside 5e's and
    5h's and the card's name and power limit."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.data import DataPipeline, ShardedTokenSource
    from repro_torch.dist import sharding
    from repro_torch.launch.mesh import make_tp2d_mesh
    from repro_torch.serve import shard_serve_state
    from repro_torch.train import (OptConfig, draw_sharded_state,
                                   make_train_step)
    torch.cuda.set_device(0)
    dist.init_process_group("nccl",
                            init_method=f"file://{work}/nccl_tp2d_store",
                            rank=0, world_size=1,
                            device_id=torch.device("cuda", 0))
    try:
        mesh = make_tp2d_mesh(shape=(1, 1, 1))
        cfg = get_config(TRAIN_ARCH)
        params, opt_state = draw_sharded_state(
            cfg, torch.Generator().manual_seed(seed), mesh)
        pipe = DataPipeline(ShardedTokenSource(work / "tokens"),
                            batch=TRAIN_BATCH, seq_len=TRAIN_SEQ, seed=seed)
        opt = OptConfig(lr=3e-4, warmup_steps=2, total_steps=100)
        step_fn = make_train_step(cfg, opt, torch.bfloat16, remat=True,
                                  mesh=mesh)
        losses, times = [], []
        _reset_counts()
        for s in range(TRAIN_STEPS):
            batch = pipe.batch_at(s)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, opt_state, m = step_fn(params, opt_state, batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            losses.append(float(m["loss"]))
        train_path = _counts()
        del params, opt_state, m
        torch.cuda.empty_cache()

        arch, ref = TP2D_SERVE_ARCH, served[TP2D_SERVE_ARCH]
        cfg = get_config(arch)
        rules = sharding.Rules(mesh, "decode", global_batch=SERVE_BATCH)
        params = shard_serve_state(ref.pop("host_params"), mesh, rules, cfg)
        prompts = np.random.default_rng(seed + 7).integers(
            0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT), dtype=np.int32)
        _probed_serve_batch(cfg, prompts, params, mesh=mesh)
        toks, parts = _probed_serve_batch(cfg, prompts, params, mesh=mesh)
        pre, dec = parts["prefill"], parts["decode"]
        del params
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    med = statistics.median(times)
    ms = 1e3 * dec["s"] / (SERVE_NEW - 1)
    k45 = ("rmsnorm", "flash_attention")
    same = {part: {k: got["launches"][k] == ref[f"{part}_launches"][k]
                   for k in k45}
            for part, got in (("prefill", pre), ("decode", dec))}
    log(f"tp2d mesh (1, 1, 1) over data, model, model2, one NCCL rank: "
        f"train {TRAIN_ARCH} {TRAIN_BATCH} x {TRAIN_SEQ} tokens, step s "
        f"{times}, median {med} s (5e {trained['step_s']} s), losses "
        f"{losses} (5e {trained['losses']}), K4-K7 {train_path}; serve "
        f"{arch} {SERVE_BATCH} x {SERVE_PROMPT} tokens + {SERVE_NEW} new: "
        f"prefill {pre['s']} s (5h {ref['prefill_s']} s), decode {ms} ms "
        f"a token (5h {ref['decode_ms']}), launches prefill "
        f"{pre['launches']} decode {dec['launches']} (5h's equal: {same}),"
        f" tokens equal to 5h's: {bool(np.array_equal(toks, ref['tokens']))}"
        f"; on {card}")
    check(losses == trained["losses"], f"tp2d train: losses {losses}, "
          f"5e's {trained['losses']}")
    check(all(v == 0 for v in train_path.values()),
          f"tp2d train: the steps launched kernels {train_path}")
    check(np.array_equal(toks, ref["tokens"]),
          f"tp2d serve {arch}: tokens differ from 5h's")
    check(all(all(v.values()) for v in same.values()),
          f"tp2d serve {arch}: K4/K5 launches {pre['launches']} / "
          f"{dec['launches']}, 5h's {ref['prefill_launches']} / "
          f"{ref['decode_launches']}")


EXAMPLES = ("torch_quickstart", "torch_process_dataset",
            "torch_process_dataset_cluster", "torch_process_dataset_rpc",
            "torch_serve_lm", "torch_train_lm")


def examples_phase(work: Path, card: str):
    """Phase 5j: the six ``examples/torch_*.py``, each run as its own
    process with no arguments (so on the card: the port's default device),
    all started together from the root of the checkout with ``src`` on
    ``PYTHONPATH``; each must exit 0. One log line with each example's
    seconds and its last line of output, beside the card's name and power
    limit."""
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")])}
    procs = {}
    for name in EXAMPLES:
        out = open(work / f"{name}.out", "w+")
        procs[name] = (subprocess.Popen(
            [sys.executable, str(ROOT / "examples" / f"{name}.py")],
            cwd=ROOT, env=env, stdout=out, stderr=subprocess.STDOUT),
            out, time.perf_counter())
    walls, failed = {}, []
    try:
        for name, (proc, out, t0) in procs.items():
            try:
                proc.wait(timeout=EXAMPLES_TIMEOUT)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
            walls[name] = time.perf_counter() - t0
            out.seek(0)
            text = out.read()
            last = text.strip().splitlines()[-1:] or [""]
            log(f"example {name}: exit {proc.returncode}, {walls[name]} s "
                f"(all six started together), last line: {last[0][:300]}")
            if proc.returncode != 0:
                failed.append((name, proc.returncode, text[-3000:]))
    finally:
        for proc, out, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            out.close()
    log(f"examples: {len(EXAMPLES) - len(failed)} of {len(EXAMPLES)} exited "
        f"0, seconds {walls}; on {card}")
    check(not failed, f"examples failed: {failed}")


def _train_template(cfg):
    """A shape-only template of the train state (meta tensors)."""
    import torch
    from repro_torch.models import init_params
    from repro_torch.train import adamw_init
    params = init_params(cfg, None, torch.float32, device="meta")
    return {"params": params, "opt": adamw_init(params)}


def _scan_rel(got, want) -> float:
    return float((got.float() - want.float()).abs().max()
                 / max(1.0, float(want.float().abs().max())))


# decay laws of the scans' inputs: the reference's test distributions;
# slow ones, whose state survives a chunk (K7's is the model's init, w0 =
# -6), on which a dropped carry must show; and K7's down to the clip at -20
SCAN_DECAYS = {"ssd_chunked": {"reference": 0.1, "slow": 0.001},
               "wkv6_chunked": {"reference": (0.5, -2.0), "slow": (0.5, -6.0),
                                "strong": (2.0, -1.0)}}


def _scan_inputs(name: str, decay: str, g):
    """K6 (zamba2's widths: H 64, dh 64, N 64) or K7 (rwkv6's: H 32, dh 64)
    inputs in the model's layout: (B, S, H, ...) tensors seen as (B, H, S,
    ...) views, B and C slices of one projection, r/k/v in bf16; and a
    random initial state."""
    import torch
    B, S = SERVE_BATCH, SERVE_PROMPT

    def randn(*shape):
        return torch.randn(shape, generator=g).cuda()
    law = SCAN_DECAYS[name][decay]
    if name == "ssd_chunked":
        H, dh, N = 64, 64, 64
        x = randn(B, S, H, dh).transpose(1, 2)
        lw = (-randn(B, S, H).abs() * law).transpose(1, 2)
        bc = randn(B, S, 2 * N) * 0.3
        return (x, lw, bc[..., :N], bc[..., N:]), randn(B, H, dh, N)
    H, dh = 32, 64
    r, k, v = (randn(B, S, H, dh).to(torch.bfloat16).transpose(1, 2)
               for _ in range(3))
    lw = -torch.exp(randn(B, S, H, dh) * law[0] + law[1])
    lw = lw.clamp(-20.0, -1e-6).transpose(1, 2)
    return (r, k, v, lw, randn(H, dh) * 0.3), randn(B, H, dh, dh)


def _by_chunk(args, n_seq, lo, hi):
    """The slices [lo, hi) along S of a scan's inputs (the first n_seq
    carry S at dim 2, B/C at dim 1; u has none)."""
    out = []
    for i, t in enumerate(args):
        if t.dim() == 4 or (t.dim() == 3 and i < n_seq):
            out.append(t[:, :, lo:hi])
        elif t.dim() == 3:
            out.append(t[:, lo:hi])
        else:
            out.append(t)
    return out


def check_scans(seed: int):
    """K6 and K7 against their plain versions at the serve phase's widths
    (ragged S, from a zero and a random state, every decay law of
    SCAN_DECAYS) and the first sequence against the sequential oracle over
    all S steps. On the slow laws, outputs a broken kernel would give (the
    inter-chunk term dropped: each chunk from a zero state; the state not
    carried: the last chunk's alone) must fail the same bound; on the fast
    ones the carried state fades within a chunk, so no check can see
    either. Returns ({name: max abs err}, {name: worst rel err}, the least
    control error over its bound)."""
    import torch
    from repro_torch.kernels import mamba2_ssd as k6
    from repro_torch.kernels import rwkv6 as k7
    g = torch.Generator().manual_seed(seed + 11)
    abs_err, rel_err, controls = {}, {}, []
    fns = {"ssd_chunked": (k6.ssd_chunked, k6.ssd_chunked_plain, k6.ssd_ref,
                           256, 2),
           "wkv6_chunked": (k7.wkv6_chunked, k7.wkv6_chunked_plain,
                            k7.wkv6_ref, 128, 4)}
    for name, (kern, plain, seq, T, n_seq) in fns.items():
        for decay in SCAN_DECAYS[name]:
            args, s0 = _scan_inputs(name, decay, g)
            for state in (None, s0):
                y, st = kern(*args, chunk=T, state=state)
                yp, sp = plain(*args, chunk=T, state=state)
                e = max(_scan_rel(y, yp), _scan_rel(st, sp))
                check(e < SCAN_TOL, f"{name} differs from its plain version "
                      f"({decay} decays, state given {state is not None}): "
                      f"{e} of max(1, max|ref|)")
                abs_err[name] = max(abs_err.get(name, 0.0),
                                    float((y - yp).abs().max()),
                                    float((st - sp).abs().max()))
                rel_err[name] = max(rel_err.get(name, 0.0), e)
                if decay != "slow":
                    continue
                # broken outputs, from the plain version
                parts = [plain(*_by_chunk(args, n_seq, lo, lo + T), chunk=T)
                         for lo in range(0, SERVE_PROMPT, T)]
                for bad, want, what in (
                        (torch.cat([p[0] for p in parts], 2), yp,
                         "the inter-chunk term dropped"),
                        (parts[-1][1], sp, "the state not carried")):
                    eb = _scan_rel(bad, want)
                    check(eb > SCAN_TOL, f"the {name} check passes {what}: "
                          f"{eb}")
                    controls.append(eb / SCAN_TOL)
            y0, _ = kern(*args, chunk=T)
            one = [t[:1] if t.dim() >= 3 else t for t in args]
            e = _scan_rel(y0[:1], seq(*one))
            check(e < SCAN_TOL, f"{name} differs from the sequential oracle "
                  f"over {SERVE_PROMPT} steps ({decay} decays): {e}")
            rel_err[name] = max(rel_err[name], e)
            log(f"{name} ({decay} decays): vs plain max abs err "
                f"{abs_err[name]}, worst of max(1, max|ref|) so far "
                f"{rel_err[name]} (bound {SCAN_TOL}); vs the sequential "
                f"oracle over {SERVE_PROMPT} steps {e}")
    log(f"chunk scans: {len(controls)} broken outputs rejected, the closest "
        f"at {min(controls)} x the bound")
    return abs_err, rel_err, min(controls)


def glue_bytes(B: int, S: int, di: int = 4096, N: int = 64, H: int = 64,
               K: int = 4):
    """(conv_in's, gate_norm's) bytes, each input read once and each output
    written once, for a (B, S) bf16 batch of these Mamba-2 widths, bf16
    parameters: conv_in reads the conv and dt columns, the conv state and
    its parameters, and writes xs and B, C and lw in f32, xh and the new
    state in bf16; gate_norm reads y (f32), xh and z and its parameters,
    and writes the normed row (bf16)."""
    C, T = di + 2 * N, B * S
    conv = (T * (C + H) * 2 + B * (K - 1) * C * 2 + (K + 1) * C * 2
            + 2 * H * 2 + T * (di * 4 + di * 2 + 2 * N * 4 + H * 4)
            + B * (K - 1) * C * 2)
    gate = T * di * (4 + 2 + 2) + (H + di) * 2 + T * di * 2
    return conv, gate


# The Mamba-2 widths (d_inner, N, heads) of the benchmark cells and the
# (B, S) batches the glue is checked and timed at: the serve phase's prefill
# and each cell's largest batch
GLUE_CELLS = {"zamba2-1.2b": ((4096, 64, 64),
                              ((SERVE_BATCH, SERVE_PROMPT), (16, 4096))),
              "granite-4.0-h-small": ((8192, 128, 128), ((16, 4096),))}


def check_and_time_mamba2_glue(timer, seed: int):
    """The Mamba-2 glue kernels (``kernels/mamba2_glue``) at each cell's
    widths (:data:`GLUE_CELLS`): each held bit-equal to its plain version
    (the torch ops it replaces, on the card), then the median time of the
    wrapper's call, the plain version's, the byte bound, and the device
    time by CUDA kernel."""
    from repro_torch.kernels import mamba2_glue as glue
    for arch, ((di, N, H), shapes) in GLUE_CELLS.items():
        _check_and_time_glue(timer, seed, glue, arch, di, N, H, shapes)


def _check_and_time_glue(timer, seed, glue, arch, di, N, H, shapes, K=4):
    """:func:`check_and_time_mamba2_glue` at one cell's widths."""
    import torch
    check(glue.takes(di, N, H, K), f"the glue kernels do not take {arch}'s "
          f"widths")
    C = di + 2 * N
    g = torch.Generator(device="cuda").manual_seed(seed + 15)
    bf16 = dict(dtype=torch.bfloat16, device="cuda")

    def r(*shape, scale=1.0):
        return scale * torch.randn(shape, device="cuda", generator=g)
    p = {"conv_w": r(K, C, scale=0.5), "conv_b": r(C, scale=0.3),
         "dt_bias": r(H, scale=0.5),
         "A_log": torch.log(torch.linspace(1.0, 16.0, H, device="cuda")),
         "D": 1 + r(H, scale=0.5), "norm": 1 + r(di, scale=0.2)}
    p = {k: v.to(torch.bfloat16) for k, v in p.items()}
    for B, S in shapes:
        proj = r(B, S, 2 * di + 2 * N + H).to(**bf16)
        z, conv, dt = torch.split(proj, [di, C, H], -1)
        st = r(B, K - 1, C).to(**bf16)
        args = (conv, dt, st, p["conv_w"], p["conv_b"], p["dt_bias"],
                p["A_log"])
        with torch.inference_mode():
            got = glue.mamba2_conv_in(*args, d_state=N)
            want = glue.mamba2_conv_in_plain(*args, d_state=N)
            check(all(torch.equal(a, b) for a, b in zip(got, want)),
                  f"mamba2_conv_in at {arch}'s ({B}, {S}) differs from its "
                  f"plain version")
            y = r(B, S, H, di // H, scale=3.0)
            xh = got[4]
            gate = (y, xh, z, p["D"], p["norm"])
            check(torch.equal(glue.mamba2_gate_norm(*gate),
                              glue.mamba2_gate_norm_plain(*gate)),
                  f"mamba2_gate_norm at {arch}'s ({B}, {S}) differs from "
                  f"its plain version")
            conv_b, gate_b = glue_bytes(B, S, di, N, H, K)
            for name, fn, plain, nbytes in (
                    ("mamba2_conv_in",
                     lambda: glue.mamba2_conv_in(*args, d_state=N),
                     lambda: glue.mamba2_conv_in_plain(*args, d_state=N),
                     conv_b),
                    ("mamba2_gate_norm",
                     lambda: glue.mamba2_gate_norm(*gate),
                     lambda: glue.mamba2_gate_norm_plain(*gate), gate_b)):
                ms, plain_ms = timer(fn), timer(plain, reps=5)
                b_ms = nbytes / HBM_BYTES_PER_S * 1e3
                log(f"time {name} at {arch} prefill ({B} x {S}, d_inner "
                    f"{di}, N {N}, H {H}) bf16: kernel {ms} ms, plain "
                    f"{plain_ms} ms, bound {b_ms} ms (bytes, {nbytes} B); "
                    f"share of the bound {b_ms / ms}; by CUDA kernel (us a "
                    f"call) "
                    f"{profile_kernels(fn)}")
        del proj, z, conv, dt, st, got, want, y, xh, gate
        torch.cuda.empty_cache()


def scan_bound(name: str, B: int, H: int, S: int, dh: int, N: int,
               itemsize: int = 4):
    """Least time for one chunk scan over S steps: inputs read once and
    outputs (y and the final state) written once, against the operations
    the function needs, which the sequential recurrence (``ref.py``) does:
    per step and head, K6 dh N FMAs for the state update and dh N for y,
    K7 dh dh FMAs each for the state update and the output and dh
    exponentials of the decay (the chunked form applies each decay once a
    chunk, so no per-step multiply is counted). FMAs (two flops) at 67
    TFLOP/s f32, exponentials at the MUFU rate. Returns (ms, what bounds
    it)."""
    steps = B * H * S
    if name == "ssd_chunked":
        nbytes = 4 * (2 * steps * dh + steps + 2 * B * S * N
                      + B * H * dh * N)
        return _bound(nbytes, 4 * steps * dh * N)
    nbytes = 3 * steps * dh * itemsize + 4 * (2 * steps * dh + H * dh
                                              + B * H * dh * dh)
    flops, exps = 4 * steps * dh * dh, steps * dh
    if exps / EXP_PER_S >= flops / F32_OPS_PER_S:
        return _bound(nbytes, exps, EXP_PER_S)
    return _bound(nbytes, flops)


def time_scans(timer, seed: int):
    """Median times of K6 and K7 at the serve phase's shapes (from a zero
    state, as prefill calls them), their plain versions and bounds."""
    import torch
    from repro_torch.kernels import mamba2_ssd as k6
    from repro_torch.kernels import rwkv6 as k7
    g = torch.Generator().manual_seed(seed + 12)
    B, S = SERVE_BATCH, SERVE_PROMPT
    a6, _ = _scan_inputs("ssd_chunked", "reference", g)
    a7, _ = _scan_inputs("wkv6_chunked", "reference", g)
    out = {
        "ssd_chunked": (
            timer(lambda: k6.ssd_chunked(*a6, chunk=256)),
            timer(lambda: k6.ssd_chunked_plain(*a6, chunk=256), reps=5),
            *scan_bound("ssd_chunked", B, 64, S, 64, 64), None),
        "wkv6_chunked": (
            timer(lambda: k7.wkv6_chunked(*a7, chunk=128)),
            timer(lambda: k7.wkv6_chunked_plain(*a7, chunk=128), reps=5),
            *scan_bound("wkv6_chunked", B, 32, S, 64, 64, 2), None)}
    for key, (ms, plain, b_ms, b_by, _) in out.items():
        log(f"time {key}: kernel {ms} ms, plain {plain} ms, bound {b_ms} ms "
            f"({b_by}), library none")
    for key, kernels, fn in (
            ("ssd_chunked", K6_KERNELS, lambda: k6.ssd_chunked(*a6, chunk=256)),
            ("wkv6_chunked", K7_KERNELS,
             lambda: k7.wkv6_chunked(*a7, chunk=128))):
        us = profile_kernels(fn)
        mine = {n: [v for k, v in us.items() if n in k] for n in kernels}
        log(f"profile {key} (us per launch; None: not in the trace): "
            f"{ {n: sum(v) if v else None for n, v in mine.items()} }, all "
            f"kernels {us}")
    return out


# K6 at the benchmark cells' prefill shapes (B, S, H, dh, N): zamba2_prefill's
# and granite4h_prefill's largest batch (16 x 4,096 tokens)
SSD_CELLS = {"zamba2-1.2b": (16, 4096, 64, 64, 64),
             "granite-4.0-h-small": (16, 4096, 128, 64, 128)}


def time_ssd_cells(timer, seed: int):
    """K6 at each cell's largest prefill batch (model layout, B and C
    slices of one projection, chunk 256, from a zero state): checked
    against its plain version within SCAN_TOL, then its median time beside
    :func:`scan_bound` and its device time by CUDA kernel. Returns
    {arch: (ms, bound ms, what bounds it)}."""
    import torch
    from repro_torch.kernels import mamba2_ssd as k6
    g = torch.Generator(device="cuda").manual_seed(seed + 13)
    out = {}
    for arch, (B, S, H, dh, N) in SSD_CELLS.items():
        x = torch.randn(B, S, H, dh, generator=g, device="cuda")
        lw = -torch.randn(B, S, H, generator=g, device="cuda").abs() * 0.1
        bc = torch.randn(B, S, 2 * N, generator=g, device="cuda") * 0.3
        args = (x.transpose(1, 2), lw.transpose(1, 2), bc[..., :N],
                bc[..., N:])
        y, st = k6.ssd_chunked(*args, chunk=256)
        yp, sp = k6.ssd_chunked_plain(*args, chunk=256)
        err = max(_scan_rel(y, yp), _scan_rel(st, sp))
        check(err < SCAN_TOL, f"K6 at {arch}'s cell shape: {err} of the "
              f"plain version's scale, over {SCAN_TOL}")
        del y, st, yp, sp
        torch.cuda.empty_cache()
        ms = timer(lambda: k6.ssd_chunked(*args, chunk=256))
        b_ms, b_by = scan_bound("ssd_chunked", B, H, S, dh, N)
        out[arch] = (ms, b_ms, b_by)
        log(f"time ssd_chunked at {arch} prefill ({B} x {S}, H {H}, dh "
            f"{dh}, N {N}): kernel {ms} ms, bound {b_ms} ms ({b_by}); share "
            f"of the bound {b_ms / ms}; rel err vs plain {err}; by CUDA "
            f"kernel (us a call) "
            f"{profile_kernels(lambda: k6.ssd_chunked(*args, chunk=256))}")
        del x, lw, bc, args
        torch.cuda.empty_cache()
    return out


def check_rmsnorm(seed: int, serving) -> float:
    """K4 against its plain version on the card, at the main path's shapes
    and the reference's test shapes; at each (rows, d) of ``serving`` in
    bf16 with a bf16 and an f32 scale; on both sides of the rows where
    ``repro_rmsnorm_plan`` turns from a row spread over a block to 32 (or
    16) threads a row; and on views one value past a 16-byte boundary (x
    and the scale: the scalar path). Bit-exact (the plain version keeps the
    kernel's order of the sum of squares). Returns the max abs error."""
    import importlib
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels import rmsnorm as rn
    k4 = importlib.import_module("repro_torch.kernels.rmsnorm.rmsnorm")
    lib = _build.load("rmsnorm")
    g = torch.Generator(device="cuda").manual_seed(seed + 3)
    err = 0.0

    def hold(x, s):
        nonlocal err
        err = max(err, max_err([rn.rmsnorm(x, s)], [rn.rmsnorm_plain(x, s)]))

    for shape in ((TOKENS, 128), (TOKENS, 512), (8, 64, 128), (3, 100),
                  (512, 256), (1, 7)):
        for dt in (torch.bfloat16, torch.float32):
            x = torch.randn(shape, device="cuda", generator=g).to(dt)
            hold(x, torch.rand(shape[-1], device="cuda", generator=g) + 0.5)
    thresholds = {}
    for d in sorted({d for _, d in serving} | {128, 512}):
        for dt in (torch.bfloat16, torch.float32):
            lo = k4.threshold(lib, d, dt)
            thresholds[(d, str(dt).removeprefix("torch."))] = lo
            for rows in (max(lo - 1, 1), lo):
                x = torch.randn(rows, d, device="cuda", generator=g).to(dt)
                sc = torch.rand(d, device="cuda", generator=g) + 0.5
                for s in (sc.to(torch.bfloat16), sc):
                    hold(x, s)
    for rows, d in serving:
        x = torch.randn(rows, d, device="cuda",
                        generator=g).to(torch.bfloat16)
        sc = torch.rand(d, device="cuda", generator=g) + 0.5
        for s in (sc.to(torch.bfloat16), sc):
            hold(x, s)
        buf = torch.randn(rows * d + 1, device="cuda", generator=g).to(
            torch.bfloat16)
        sbuf = (torch.rand(d + 1, device="cuda", generator=g) + 0.5).to(
            torch.bfloat16)
        hold(buf[1:].view(rows, d), sbuf[1:])   # 2 bytes past 16
    check(err == 0.0, f"rmsnorm kernel differs from its plain version: {err}")
    log(f"rmsnorm vs plain: max abs err {err}; the fewest rows of the "
        f"many-rows layout by (d, dtype), each held with one row fewer: "
        f"{thresholds}")
    return err


def k5_bound(want) -> float:
    """K5_TOL's bound on one query tile of the plain output ``want``: the
    absolute tolerance or the relative one times the tile's largest
    |output|, whichever is smaller."""
    a, r = K5_TOL[str(want.dtype).removeprefix("torch.")]
    return min(a, r * float(want.abs().max()))


def hold_k5(got, want, what: str = ""):
    """Holds K5's output ``got`` to its plain version ``want``, both (B, H,
    S, Dh), on every 64-row query tile within :func:`k5_bound`. Returns the
    largest error and the largest error over its tile's largest |output|."""
    abs_err = rel_err = 0.0
    for r in range(0, want.shape[2], 64):
        w = want[:, :, r:r + 64]
        e, top = max_err([got[:, :, r:r + 64]], [w]), float(w.abs().max())
        check(e <= k5_bound(w), f"flash attention kernel differs from its "
              f"plain version: {e} at outputs up to {top}, bound "
              f"{k5_bound(w)} ({what} {tuple(want.shape)} {want.dtype}, "
              f"rows {r}..)")
        abs_err, rel_err = max(abs_err, e), max(rel_err, e / top)
    return abs_err, rel_err


def check_attention(seed: int, device: str = "cuda", tokens: int = TOKENS):
    """K5 against its plain version: at the slice's shapes over the full
    key length, on the first, a middle and the last 64-row query tile, with
    q drawn at two scales: a flat softmax, whose outputs late in the
    sequence average 90k-180k keys and are near 0.005, and a peaked one (q
    four times larger, v four times smaller), whose outputs follow a few
    keys and stay below about 1, where one bf16 step is under 3e-2. At the
    serving shapes (llama3.2-1b's prefill, B 4, S 2,000, H 32, KV 8, and
    zamba2's shared block, KV 32; Dh 64, bf16, in the model's layout: q and
    k dense as RoPE leaves them, v a slice of the fused q|k|v projection),
    on every 64-row tile of every sequence, at both scales. Plus GQA, a
    ragged Sq = 200 and window 64.

    Each 64-row query tile must agree within K5_TOL (:func:`hold_k5`): the
    absolute tolerance the reference sets on its own kernel, and a bound
    relative to the tile's largest |output|, which holds the late tiles
    (and so the carry of the online softmax across key tiles) to what their
    outputs' size allows. Outputs a broken kernel would give, made from the
    plain version (zeros, the first key tile alone, the first half of the
    keys, the last key tiles alone: a lost carry), must fail the same bound
    on a middle and the last tile, or the check could not tell them apart.
    Returns (max abs error, max error over the tile's largest |output|, the
    least control error over its bound)."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    f32, bf16 = torch.float32, torch.bfloat16
    g = torch.Generator(device=device).manual_seed(seed + 5)
    abs_err, rel_err, controls = 0.0, 0.0, []

    def randn(*shape, dtype, scale=1.0):
        return (scale * torch.randn(shape, device=device, generator=g)
                ).to(dtype)

    def hold(got, want, what=""):   # (B, H, S, Dh), per 64-row query tile
        nonlocal abs_err, rel_err
        e, r = hold_k5(got, want, what)
        abs_err, rel_err = max(abs_err, e), max(rel_err, r)

    def reject(bad, want, what):
        e = max_err([bad], [want])
        check(e > k5_bound(want), f"the K5 check passes {what}: error {e}, "
              f"bound {k5_bound(want)}")
        controls.append(e / k5_bound(want))

    def reject_broken(qt, kt, vt, r0, want, causal=True, scale=None):
        """The controls for query rows r0 .. r0 + 63, whose plain output
        is ``want`` (scores times ``scale``): zeros, and the keys these
        rows see cut to the first key tile, to their first half, or to the
        last key tiles alone (each cut that leaves some of those keys
        out)."""
        qs, S = qt[:, :, r0:r0 + 64], kt.shape[2]
        seen = min(r0 + 64, S) if causal else S
        c = r0 // 64 * 64 if causal else (S - 1) // 128 * 128

        def part(lo, hi):
            return fa.flash_attention_plain(
                qs, kt[:, :, lo:hi], vt[:, :, lo:hi], causal=causal,
                q_offset=r0 - lo, scale=scale)
        reject(torch.zeros_like(want), want, "zeros")
        half = r0 // 2 if causal and r0 else seen // 2
        for (lo, hi), what in (((0, 64), "the first key tile alone"),
                               ((0, half), "the first half of the keys"),
                               ((c, S), "the last key tiles alone")):
            if hi > lo and (lo > 0 or hi < seen):
                reject(part(lo, hi), want, what)

    S = tokens
    for H, KV, Dh, dt in ((4, 2, 32, bf16), (4, 2, 32, f32),
                          (8, 8, 64, bf16)):
        for q_scale in (1.0, 4.0):
            q = randn(1, S, H, Dh, dtype=dt, scale=q_scale)
            k = randn(1, S, KV, Dh, dtype=dt)
            v = randn(1, S, KV, Dh, dtype=dt, scale=1 / q_scale)
            o = fa.flash_attention_op(q, k, v, causal=True).transpose(1, 2)
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            for r0 in (0, S // 2 + 37, S - 64):     # first, middle, last
                want = fa.flash_attention_plain(qt[:, :, r0:r0 + 64], kt, vt,
                                                q_offset=r0)
                hold(o[:, :, r0:r0 + 64], want)
                if r0:                              # past one key tile
                    reject_broken(qt, kt, vt, r0, want)
    B, S, H, Dh = SERVE_BATCH, SERVE_PROMPT, 32, 64
    for KV, arch in ((8, "llama3.2-1b"), (32, "zamba2-1.2b")):
        for q_scale in (1.0, 4.0):
            q = randn(B, S, H, Dh, dtype=bf16, scale=q_scale)
            k = randn(B, S, KV, Dh, dtype=bf16)
            v = randn(B, S, H + 2 * KV, Dh, dtype=bf16,
                      scale=1 / q_scale)[:, :, H + KV:]
            o = fa.flash_attention_op(q, k, v, causal=True).transpose(1, 2)
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            want = fa.flash_attention_plain(qt, kt, vt)
            hold(o, want, f"{arch} prefill")
            for r0 in (S // 2 + 37, S - 64):        # a middle, the last
                reject_broken(qt, kt, vt, r0, want[:, :, r0:r0 + 64])
    # granite4h_prefill's attention layers at its largest batch: NoPE GQA,
    # q, k and v from separate projections, scores times 1/128
    B, S, H, KV, Dh, scale = 16, 4096, 32, 8, 128, 1 / 128
    for q_scale in (1.0, 4.0):
        q = randn(B, S, H, Dh, dtype=bf16, scale=q_scale)
        k = randn(B, S, KV, Dh, dtype=bf16)
        v = randn(B, S, KV, Dh, dtype=bf16, scale=1 / q_scale)
        o = fa.flash_attention_op(q, k, v, causal=True,
                                  scale=scale).transpose(1, 2)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        want = fa.flash_attention_plain(qt, kt, vt, scale=scale)
        hold(o, want, "granite-4.0-h-small prefill, scale 1/128")
        for r0 in (S // 2 + 37, S - 64):
            reject_broken(qt, kt, vt, r0, want[:, :, r0:r0 + 64],
                          scale=scale)
        del q, k, v, o, qt, kt, vt, want
        torch.cuda.empty_cache()
    for what, (B, Sq, Sk, H, KV, Dh, causal) in FAMILY_K5.items():
        for q_scale in (1.0, 4.0):  # the families' prefill calls, bf16
            q = randn(B, Sq, H, Dh, dtype=bf16, scale=q_scale)
            k = randn(B, Sk, KV, Dh, dtype=bf16)
            v = randn(B, Sk, KV, Dh, dtype=bf16, scale=1 / q_scale)
            o = fa.flash_attention_op(q, k, v,
                                      causal=causal).transpose(1, 2)
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            want = fa.flash_attention_plain(qt, kt, vt, causal=causal)
            hold(o, want, what)
            for r0 in sorted({Sq // 2 + 37 if Sq > 128 else 0, Sq - 64}):
                reject_broken(qt, kt, vt, r0, want[:, :, r0:r0 + 64],
                              causal)
    for dt in (f32, bf16):      # GQA, a ragged Sq = 200, masks on and off
        q = randn(2, 4, 200, 64, dtype=dt)
        k, v = (randn(2, 2, 200, 64, dtype=dt) for _ in range(2))
        for causal, window in ((True, None), (False, None), (True, 64)):
            kw = dict(causal=causal, window=window)
            hold(fa.flash_attention(q, k, v, **kw),
                 fa.flash_attention_plain(q, k, v, **kw))
    log(f"flash_attention vs plain: max abs err {abs_err}, max err / "
        f"largest |output| of its tile {rel_err} (bounds {K5_TOL}); "
        f"{len(controls)} broken outputs rejected, the closest at "
        f"{min(controls)} x its bound")
    return abs_err, rel_err, min(controls)


def time_rmsnorm_and_attention(timer, seed: int):
    """Median times of K4 and K5 at the main path's shapes (segment_unest:
    180,224 tokens, d 128, H 4, KV 2, Dh 32, bf16, causal), their plain
    versions, their bounds and one PyTorch call each; K5 also at the
    published width (key ``flash_attention_full``) and at llama3.2-1b's
    prefill (B 4, S 2,000, H 32, KV 8, Dh 64; key
    ``flash_attention_llama``)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rn
    bf16 = torch.bfloat16
    g = torch.Generator(device="cuda").manual_seed(seed + 4)
    x = torch.randn(TOKENS, 128, device="cuda", generator=g).to(bf16)
    sc = torch.rand(128, device="cuda", generator=g) + 0.5
    out = {"rmsnorm": (
        timer(lambda: rn.rmsnorm(x, sc)),
        timer(lambda: rn.rmsnorm_plain(x, sc), reps=5),
        *_bound(2 * x.numel() * 2 + 128 * 4, 4 * x.numel()),
        timer(lambda: F.rms_norm(x, (128,), sc.to(bf16), 1e-5)))}
    for key, (B, S, H, KV, Dh, reps) in (
            ("flash_attention", (1, TOKENS, 4, 2, 32, 5)),
            ("flash_attention_full", (1, TOKENS, 8, 8, 64, 3)),
            ("flash_attention_llama", (SERVE_BATCH, SERVE_PROMPT, 32, 8, 64,
                                       15))):
        q = torch.randn(B, S, H, Dh, device="cuda", generator=g).to(bf16)
        k, v = (torch.randn(B, S, KV, Dh, device="cuda",
                            generator=g).to(bf16) for _ in range(2))
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        plain = timer(lambda: fa.flash_attention_plain(qt, kt, vt), reps=2) \
            if key != "flash_attention_full" else None
        out[key] = (
            timer(lambda: fa.flash_attention_op(q, k, v), reps=reps), plain,
            *attention_bound(S, H, KV, Dh, 2, B),
            timer(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True)))
        # the main path reads the model's (B, S, H, Dh) in place; the same
        # kernel on dense (B, H, S, Dh) copies, and the card's clocks while
        # the main path's call runs, say what its time depends on
        dense = [t.contiguous() for t in (qt, kt, vt)]
        ms_dense = timer(lambda: fa.flash_attention(*dense), reps=reps)
        load = under_load(lambda: fa.flash_attention_op(q, k, v),
                          int(2000 / out[key][0]) + 1)
        log(f"time {key} on contiguous (B,H,S,Dh) copies: kernel {ms_dense} "
            f"ms; the card while the (B,S,H,Dh) call runs (sm clock, max "
            f"sm clock, power draw, temperature): {load}")
    for key, (ms, plain, b_ms, b_by, lib) in out.items():
        log(f"time {key}: kernel {ms} ms, plain {plain} ms, bound {b_ms} ms "
            f"({b_by}), library {lib} ms")
    return out


def time_family_attention(timer, seed: int, fam):
    """K5 at the families' prefill calls (FAMILY_K5, bf16, the model's (B,
    S, H, Dh) layout): the median time, the plain version's, the bound,
    ``F.scaled_dot_product_attention`` on the same inputs, and the
    launches at that shape in phase 5d's ``serve_batch`` run (whisper's
    prefill split by role: its encoder's layers, and per decoder layer one
    self- and one cross-attention)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    bf16 = torch.bfloat16
    g = torch.Generator(device="cuda").manual_seed(seed + 14)
    w = fam["whisper-small"]["prefill_launches"]["flash_attention"]
    enc = get_config("whisper-small").encoder.n_layers
    launches = {"moonshot prefill": fam["moonshot-v1-16b-a3b"][
                    "prefill_launches"]["flash_attention"],
                "internvl2 prefill": fam["internvl2-76b"][
                    "prefill_launches"]["flash_attention"],
                "whisper encoder": enc, "whisper decoder": (w - enc) // 2,
                "whisper cross-attention": (w - enc) // 2}
    out = {}
    for what, (B, Sq, Sk, H, KV, Dh, causal) in FAMILY_K5.items():
        q = torch.randn(B, Sq, H, Dh, device="cuda", generator=g).to(bf16)
        k, v = (torch.randn(B, Sk, KV, Dh, device="cuda",
                            generator=g).to(bf16) for _ in range(2))
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        ms = timer(lambda: fa.flash_attention_op(q, k, v, causal=causal))
        plain = timer(lambda: fa.flash_attention_plain(qt, kt, vt,
                                                       causal=causal),
                      reps=2)
        b_ms, b_by = attention_bound(Sq, H, KV, Dh, 2, B, Sk, causal)
        lib = timer(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=True))
        out[what] = (ms, plain, b_ms, b_by, lib, launches[what])
        log(f"time flash_attention at {what} (B {B}, Sq {Sq}, Sk {Sk}, H "
            f"{H}, KV {KV}, Dh {Dh}, causal {causal}, bf16): kernel {ms} "
            f"ms, plain {plain} ms, bound {b_ms} ms ({b_by}), library "
            f"(SDPA) {lib} ms; launches in phase 5d's serve_batch "
            f"{launches[what]}")
    return out


def time_rmsnorm_serving(timer, seed: int, serve):
    """K4 at each (rows, d) that the serve phase's ``serve_batch`` runs
    passed to it, in bf16 with a bf16 scale as the models hold it: the
    wrapper's call (one launch), ``F.rms_norm`` (unused by the port), the
    plain version, the bound, the device time by CUDA kernel of the
    wrapper's call, and the launches at that shape in each ``serve_batch``
    run. Beside them, the same Timer's reading of an empty kernel
    (``torch.cuda._sleep(0)``: the floor of a launch, which decode's shapes
    sit on), and at decode's 4 x 2,048 the wrapper's host time a call (the
    enqueue: ``perf_counter`` over 1,000 calls, then one synchronise)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import rmsnorm as rn
    g = torch.Generator(device="cuda").manual_seed(seed + 13)
    log(f"time an empty kernel (torch.cuda._sleep(0)), the same Timer: "
        f"{timer(lambda: torch.cuda._sleep(0), reps=50)} ms")
    for rows, d in _k4_serving_shapes(serve):
        x = torch.randn(rows, d, device="cuda", generator=g).to(torch.bfloat16)
        sc = (torch.rand(d, device="cuda", generator=g) + 0.5).to(
            torch.bfloat16)
        reps = 15 if rows * d > 1 << 20 else 50
        ms = timer(lambda: rn.rmsnorm(x, sc), reps=reps)
        lib = timer(lambda: F.rms_norm(x, (d,), sc, 1e-5), reps=reps)
        plain = timer(lambda: rn.rmsnorm_plain(x, sc), reps=3)
        b_ms, b_by = _bound(2 * x.numel() * 2 + d * 2, 4 * x.numel())
        launches = {arch: {dt: n for (r, dd, dt), n in v["k4_shapes"].items()
                           if (r, dd) == (rows, d)}
                    for arch, v in serve.items()}
        us = profile_kernels(lambda: rn.rmsnorm(x, sc))
        host = ""
        if (rows, d) == (4, 2048):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(1000):
                rn.rmsnorm(x, sc)
            host_us = (time.perf_counter() - t0) * 1e3
            torch.cuda.synchronize()
            host = f"; the wrapper's host time {host_us} us a call"
        log(f"time rmsnorm at serving ({rows}, {d}) bf16, bf16 scale: "
            f"wrapper {ms} ms, F.rms_norm {lib} ms, plain {plain} ms, bound "
            f"{b_ms} ms ({b_by}); share of the bound {b_ms / ms}; launches "
            f"per serve_batch by arch and scale dtype {launches}; the "
            f"wrapper's call by CUDA kernel (us) {us}{host}")


def under_load(fn, n: int) -> str:
    """nvidia-smi's reading of the card while ``fn`` runs ``n`` times back
    to back (queued before the reading, waited for after it)."""
    import torch
    torch.cuda.synchronize()
    for _ in range(n):
        fn()
    r = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=clocks.sm,"
                        "clocks.max.sm,power.draw,temperature.gpu",
                        "--format=csv,noheader"],
                       capture_output=True, text=True, timeout=60)
    torch.cuda.synchronize()
    return (r.stdout + r.stderr).strip()


def profile_kernels(fn, reps=5):
    """Device time per launch of each CUDA kernel ``fn`` launches, from
    torch.profiler (CUPTI). Late in this script a session's trace at
    times holds no device event at all, which a fresh process has not
    shown; such a session is repeated, up to three sessions, and the
    repeat logged with the events the empty trace did hold. An empty dict
    if every session came back empty."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    tries = 3
    for attempt in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = _device_us(prof, True)
        if not us:
            held = sorted({e.name()[:40] for e in
                           prof.profiler.kineto_results.events()})
        if us or attempt + 1 == tries:
            if attempt or not us:
                log(f"profile: {attempt + (not us)} session(s) of "
                    f"{attempt + 1} held no device event (the last empty "
                    f"one held {held})")
            return us


def _device_us(prof, per_launch: bool):
    """Device time (us) by CUDA kernel in a torch.profiler trace: per
    launch, or in all."""
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", 0.0)
        if us and e.count:
            name = e.key.replace("(anonymous namespace)::", "")
            key = name.split("(")[0]
            out[key] = out.get(key, 0.0) + (us / e.count if per_launch
                                            else us)
    return out


if __name__ == "__main__":
    sys.exit(main())
