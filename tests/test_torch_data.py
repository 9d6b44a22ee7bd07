"""The port's data pipeline (``repro_torch.data``) against the JAX
package's (``repro.data``): the same shard bytes and manifest from one
seed, byte-equal batches at every step, byte-equal ``make_lm_batches``;
and, on the port alone, the checks of ``tests/test_data_train.py:13-56``
(integrity, determinism and resume, DP slices, the prefetch iterator).
No tolerance anywhere: the pipeline is numpy on both sides."""
import numpy as np
import pytest

from repro.configs import get_config as ref_get_config
from repro.data import DataPipeline as RefPipeline
from repro.data import ShardedTokenSource as RefSource
from repro.data import make_lm_batches as ref_make_lm_batches
from repro_torch.configs import get_config
from repro_torch.core import IntegrityError
from repro_torch.data import DataPipeline, ShardedTokenSource, make_lm_batches


def _files(root):
    return {p.name: p.read_bytes() for p in sorted(root.iterdir())}


@pytest.mark.parametrize("n_shards,tokens,vocab,seed", [
    (2, 4096, 512, 0), (4, 65536, 128_256, 3), (3, 1000, 32_000, 7)])
def test_synthesize_writes_the_reference_shards_and_manifest(
        tmp_path, n_shards, tokens, vocab, seed):
    RefSource.synthesize(tmp_path / "ref", n_shards=n_shards,
                         tokens_per_shard=tokens, vocab_size=vocab, seed=seed)
    src = ShardedTokenSource.synthesize(
        tmp_path / "port", n_shards=n_shards, tokens_per_shard=tokens,
        vocab_size=vocab, seed=seed)
    assert _files(tmp_path / "port") == _files(tmp_path / "ref")
    assert src.vocab_size == vocab and len(src.shards) == n_shards


def test_port_reads_the_reference_shards(tmp_path):
    ref = RefSource.synthesize(tmp_path / "d", n_shards=2,
                               tokens_per_shard=4096)
    port = ShardedTokenSource(tmp_path / "d")
    for i in range(2):
        assert np.array_equal(port.load_shard(i), ref.load_shard(i))


@pytest.mark.parametrize("batch,seq,seed,dp", [
    (4, 128, 7, (0, 1)), (4, 64, 1, (1, 2)), (2, 32, 0, (0, 1)),
    (8, 100, 5, (3, 4))])
def test_batch_at_is_byte_equal(tmp_path, batch, seq, seed, dp):
    src = ShardedTokenSource.synthesize(tmp_path / "d", n_shards=2,
                                        tokens_per_shard=16384)
    rank, size = dp
    port = DataPipeline(src, batch=batch, seq_len=seq, seed=seed,
                        dp_rank=rank, dp_size=size)
    ref = RefPipeline(RefSource(tmp_path / "d"), batch=batch, seq_len=seq,
                      seed=seed, dp_rank=rank, dp_size=size)
    assert port.steps_per_epoch == ref.steps_per_epoch
    # across an epoch boundary, where the permutation is drawn anew
    for s in list(range(4)) + [port.steps_per_epoch - 1,
                               port.steps_per_epoch, 3 * port.steps_per_epoch
                               + 2]:
        got, want = port.batch_at(s), ref.batch_at(s)
        assert set(got) == set(want) == {"tokens", "targets"}
        for k in got:
            assert got[k].dtype == want[k].dtype == np.int32
            assert got[k].tobytes() == want[k].tobytes(), (s, k)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "rwkv6-1.6b",
                                  "zamba2-1.2b"])
@pytest.mark.parametrize("batch,seq,n,seed", [(4, 64, 1, 3), (2, 32, 4, 0)])
def test_make_lm_batches_is_byte_equal(arch, batch, seq, n, seed):
    got = make_lm_batches(get_config(arch).reduced(vocab_size=128), batch,
                          seq, n, seed=seed)
    want = ref_make_lm_batches(ref_get_config(arch).reduced(vocab_size=128),
                               batch, seq, n, seed=seed)
    assert len(got) == len(want) == n
    for g, w in zip(got, want):
        for k in ("tokens", "targets"):
            assert g[k].dtype == w[k].dtype
            assert g[k].tobytes() == w[k].tobytes()


# the port alone, as tests/test_data_train.py:13-56 holds the reference

def test_sharded_source_integrity(tmp_path):
    src = ShardedTokenSource.synthesize(tmp_path / "d", n_shards=2,
                                        tokens_per_shard=4096)
    arr = src.load_shard(0)
    assert arr.dtype == np.int32
    p = tmp_path / "d" / src.shards[1].path
    bad = np.load(p)
    bad[0] ^= 1
    np.save(p, bad)
    with pytest.raises(IntegrityError):
        src.load_shard(1)


def test_pipeline_deterministic_and_resumable(tmp_path):
    src = ShardedTokenSource.synthesize(tmp_path / "d", n_shards=2,
                                        tokens_per_shard=16384)
    pipe = DataPipeline(src, batch=4, seq_len=128, seed=7)
    b5a = pipe.batch_at(5)
    b5b = DataPipeline(src, batch=4, seq_len=128, seed=7).batch_at(5)
    assert np.array_equal(b5a["tokens"], b5b["tokens"])   # restart-safe
    assert not np.array_equal(pipe.batch_at(5)["tokens"],
                              pipe.batch_at(6)["tokens"])
    assert np.array_equal(b5a["tokens"][:, 1:], b5a["targets"][:, :-1])


def test_pipeline_dp_slices_partition(tmp_path):
    src = ShardedTokenSource.synthesize(tmp_path / "d")
    full = DataPipeline(src, batch=4, seq_len=64, seed=1).batch_at(0)
    parts = [DataPipeline(src, batch=4, seq_len=64, seed=1,
                          dp_rank=r, dp_size=2).batch_at(0) for r in range(2)]
    recon = np.concatenate([p["tokens"] for p in parts])
    assert np.array_equal(recon, full["tokens"])


def test_prefetch_iterator(tmp_path):
    src = ShardedTokenSource.synthesize(tmp_path / "d")
    pipe = DataPipeline(src, batch=2, seq_len=32, seed=0)
    it = pipe.iter_from(3)
    for s in (3, 4, 5):
        assert np.array_equal(next(it)["tokens"], pipe.batch_at(s)["tokens"])
    it.close()
