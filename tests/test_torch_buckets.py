"""The port's loader pieces for bucketed and multi-process training against
the JAX package's: `BucketedLoader`'s schedule (sequential over two
epochs, random with a seed, sharded), its batches on a tiny h5 byte for
byte against the JAX loader's raw-uint8 batches, `DenseCapLoader(shard=)`
and `PrefetchingLoader(source=)`; then the train CLI with
`--canvas_buckets`.
"""

import json

import numpy as np
import pytest
import torch

from densecap_tpu.data import loader as jl
from densecap_tpu_torch.data import loader as pl
from test_torch_eval import make_dataset
from test_torch_train_cli import _args, dataset, narrow_fc  # noqa: F401

torch.set_num_threads(2)
SIZES = ((32, 64), (64, 32), (48, 48), (64, 64), (16, 16), (40, 60))
BUCKETS = [(32, 64), (64, 32), (48, 48)]
KEYS = ("image", "height", "width", "gt_boxes", "gt_labels", "gt_valid",
        "weight")


class Stub:
    """The metadata protocol of a loader (canvas, split_size,
    example_meta, get_example_at) over n examples of SIZES, drawn from a
    seed; each image is filled with its index."""

    canvas = 64

    def __init__(self, n, seed=0):
        rng = np.random.default_rng(seed)
        self.hw = [SIZES[i] for i in rng.integers(0, len(SIZES), n)]

    def split_size(self, split):
        return len(self.hw)

    def example_meta(self, split, ri):
        return self.hw[ri]

    def get_example_at(self, split, ri):
        h, w = self.hw[ri]
        return {"image": np.full((64, 64, 3), ri, np.uint8),
                "height": np.float32(h), "width": np.float32(w),
                "gt_boxes": np.full((2, 4), ri, np.float32),
                "gt_labels": np.full((2, 3), ri, np.int32),
                "gt_valid": np.arange(2) < 1 + ri % 2, "ix": ri}


def _batches(bl, n):
    return [bl.next_batch() for _ in range(n)]


def _same(got, ref):
    """(bucket, batch) lists equal: buckets, ix, and every key byte for
    byte, dtypes included."""
    assert len(got) == len(ref)
    for (gb, g), (rb, r) in zip(got, ref):
        assert gb == rb
        assert g["ix"] == r["ix"]
        for k in KEYS:
            assert g[k].dtype == r[k].dtype, k
            np.testing.assert_array_equal(g[k], r[k], err_msg=k)


@pytest.mark.parametrize("n,B,buckets", [(7, 3, BUCKETS), (12, 4, BUCKETS),
                                         (5, 2, BUCKETS[:1]), (9, 8, []),
                                         (10, 1, BUCKETS)])
def test_schedule_matches_jax_over_two_epochs(n, B, buckets):
    stub = Stub(n, seed=n)
    steps = 2 * (n + len(buckets) + 1)  # past two epochs' batches
    got = _batches(pl.BucketedLoader(stub, buckets, B), steps)
    _same(got, _batches(jl.BucketedLoader(stub, buckets, B), steps))
    # each epoch trains every example once, the repeats at weight 0
    seen, epochs = [], 0
    for bucket, batch in got:
        assert batch["image"].shape == (B, *bucket, 3)
        assert len(batch["ix"]) == int(batch["weight"].sum())
        seen.extend(batch["ix"])
        if len(seen) == n and epochs < 2:
            assert sorted(seen) == list(range(n))
            seen, epochs = [], epochs + 1
    assert epochs == 2


def test_random_mode_matches_jax():
    stub = Stub(9, seed=1)
    got = _batches(pl.BucketedLoader(stub, BUCKETS, 4, iterate=False,
                                     seed=3), 12)
    _same(got, _batches(jl.BucketedLoader(stub, BUCKETS, 4, iterate=False,
                                          seed=3), 12))
    assert all(b["weight"].all() for _, b in got)


@pytest.mark.parametrize("iterate", [True, False], ids=["sequential",
                                                         "random"])
def test_shard_replicas_concatenate_to_the_global_batch(iterate):
    n, B, nproc = 11, 4, 2
    stub = Stub(n, seed=2)

    def loaders(mod, shard=None):
        return mod.BucketedLoader(stub, BUCKETS, B, iterate=iterate,
                                  shard=shard, seed=5)

    ref = _batches(loaders(pl), 12)
    shards = [_batches(loaders(pl, (pid, nproc)), 12) for pid in range(nproc)]
    for pid in range(nproc):
        _same(shards[pid], _batches(loaders(jl, (pid, nproc)), 12))
    for i, (bucket, batch) in enumerate(ref):
        parts = [s[i][1] for s in shards]
        assert all(s[i][0] == bucket for s in shards)
        assert sum((p["ix"] for p in parts), []) == batch["ix"]
        for k in KEYS:
            np.testing.assert_array_equal(
                np.concatenate([p[k] for p in parts]), batch[k], err_msg=k)


@pytest.fixture(scope="module")
def tiny_h5(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_buckets_vg")
    make_dataset(root)
    return str(root / "d.h5"), str(root / "d.json")


def test_bucketed_h5_batches_equal_jax_raw_batches(tiny_h5):
    """Split 1 holds 48x64 and 64x48 frames on the 64 px canvas; at most
    2 gt boxes each, so the 3-region images are subsampled (the loaders'
    own seeded draws)."""
    mine = pl.DenseCapLoader(*tiny_h5, max_gt_boxes=2)
    ref = jl.DenseCapLoader(*tiny_h5, max_gt_boxes=2, raw_images=True)
    try:
        got = _batches(pl.BucketedLoader(mine, [(48, 64)], 2, split=1), 8)
        want = _batches(jl.BucketedLoader(ref, [(48, 64)], 2, split=1), 8)
        _same(got, want)
        assert {b for b, _ in got} == {(48, 64), (64, 64)}
        assert got[0][1]["image"].dtype == np.uint8
    finally:
        mine.close()
        ref.h5.close()


@pytest.mark.parametrize("shard", [(0, 2), (1, 2), (0, 3), (2, 3)])
def test_sharded_split_ix_matches_jax(tiny_h5, shard):
    mine = pl.DenseCapLoader(*tiny_h5, shard=shard)
    ref = jl.DenseCapLoader(*tiny_h5, shard=shard)
    try:
        for s in (0, 1, 2):
            np.testing.assert_array_equal(mine.split_ix[s], ref.split_ix[s])
        ex = mine.get_example(split=1)
        assert ex["ix"] == int(ref.split_ix[1][0])
        assert mine.example_meta(1, 0) == ref.example_meta(1, 0)
    finally:
        mine.close()
        ref.h5.close()


def test_get_example_at_leaves_the_iterator(tiny_h5):
    mine = pl.DenseCapLoader(*tiny_h5)
    try:
        at = mine.get_example_at(1, 3)
        assert mine.iterators[1] == 0
        assert at["split_pos"] == (3, 5)
        first = mine.get_example(split=1)
        assert first["split_pos"] == (0, 5) and mine.iterators[1] == 1
    finally:
        mine.close()


def test_prefetch_source_covers_an_epoch_once():
    n = 10
    bl = pl.BucketedLoader(Stub(n, seed=4), BUCKETS, 3)
    pf = pl.PrefetchingLoader(source=lambda: bl.next_batch()[1])
    seen = []
    try:
        while len(seen) < n:
            seen.extend(pf.next()["ix"])
    finally:
        pf.close()
    assert sorted(seen) == list(range(n))
    assert not pf.thread.is_alive()


def test_prefetch_source_hands_its_error_to_the_consumer():
    def source():
        raise OSError("unreadable")

    pf = pl.PrefetchingLoader(source=source)
    with pytest.raises(OSError, match="unreadable"):
        pf.next()
    pf.close()
    assert not pf.thread.is_alive()


def test_train_cli_with_canvas_buckets(dataset, tmp_path, narrow_fc,  # noqa: F811
                                       monkeypatch):
    """Three 48x64 train frames at batch 2 with a 48x64 bucket: a bucket
    batch, the epoch's tail through the square (one slot of weight 0),
    then the bucket again."""
    from densecap_tpu_torch.cli import train as train_cli

    seen = []
    real = pl.BucketedLoader.next_batch

    def spy(self):
        bucket, batch = real(self)
        seen.append((bucket, batch["weight"].tolist()))
        return bucket, batch

    monkeypatch.setattr(pl.BucketedLoader, "next_batch", spy)
    prefix = str(tmp_path / "ck" / "b")
    train_cli.main(_args(dataset, prefix, 3) + ["--canvas_buckets", "48x64"])
    assert seen[:3] == [((48, 64), [1.0, 1.0]), ((64, 64), [1.0, 0.0]),
                        ((48, 64), [1.0, 1.0])]
    with open(prefix + ".json") as f:
        hist = json.load(f)
    assert sorted(map(int, hist["loss_history"])) == [1, 2, 3]
    assert all(np.isfinite(v["total_loss"])
               for v in hist["loss_history"].values())
