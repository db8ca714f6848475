"""Host-side dataset loader: padded, fixed-shape batches of raw uint8
canvases.

Twin of the raw-uint8 path of `densecap_tpu/data/loader.py`
(`DenseCapLoader(raw_images=True)`, with the split API that evaluation
and the CLIs use, its round-robin `shard`, `BucketedLoader` and
`PrefetchingLoader`). Images come back as the h5's uint8 BGR canvases
(S, S, 3), or cropped to a bucket; the model's caller normalizes them on
the device (`utils/image.py:normalize_uint8_images`).
Ground truth is padded to `max_gt_boxes` rows with a validity mask (and
uniformly subsampled when an image has more). The h5 is read with the
port's own codec (`utils/h5.py`): the index arrays once, each canvas by
index when its example is read. The JAX loader's external region
proposals (`proposals_h5`) are not ported: the model never reads them.
"""

from __future__ import annotations

import json
import queue
import threading

import numpy as np

from ..utils import h5

BATCH_KEYS = ("image", "height", "width", "gt_boxes", "gt_labels", "gt_valid")


class DenseCapLoader:
    """Reads the preprocessed HDF5 and its dicts json (the schema of
    `data/preprocess.py`, and of the JAX package's twin).

    shard: optional (process_id, num_processes); the loader then sees
    only every num_processes-th example of each split (round-robin), the
    per-process feed of multi-process training."""

    def __init__(self, h5_path, json_path, max_gt_boxes=128, seed=0,
                 shard=None):
        self.h5 = h5.File(h5_path)
        with open(json_path) as f:
            self.info = json.load(f)
        self.max_gt_boxes = max_gt_boxes
        self.rng = np.random.RandomState(seed)
        self.image_heights = self.h5["image_heights"][:]
        self.image_widths = self.h5["image_widths"][:]
        self.original_heights = self.h5["original_heights"][:]
        self.original_widths = self.h5["original_widths"][:]
        self.boxes = self.h5["boxes"][:].astype(np.float32)
        self.labels = self.h5["labels"][:].astype(np.int32)
        self.img_to_first_box = self.h5["img_to_first_box"][:]
        self.img_to_last_box = self.h5["img_to_last_box"][:]
        split = self.h5["split"][:]
        self.split_ix = {s: np.nonzero(split == s)[0] for s in (0, 1, 2)}
        if shard is not None:
            pid, nproc = shard
            if not 0 <= pid < nproc:
                raise ValueError(f"shard {shard}: need 0 <= pid < nproc")
            self.split_ix = {s: ix[pid::nproc]
                             for s, ix in self.split_ix.items()}
        self.iterators = {0: 0, 1: 0, 2: 0}
        self.images = self.h5["images"]
        self.canvas = self.images.shape[2]

    def vocab_size(self):
        return len(self.info["token_to_idx"])

    def seq_length(self):
        return self.labels.shape[1]

    def idx_to_token(self):
        return {int(k): v for k, v in self.info["idx_to_token"].items()}

    def reset_iterator(self, split):
        self.iterators[split] = 0

    def split_size(self, split):
        return len(self.split_ix[split])

    def example_meta(self, split, ri):
        """(height, width) on the canvas of the example at position ri of
        a split: metadata only, no image read (the bucket schedule)."""
        ix = int(self.split_ix[split][ri])
        return int(self.image_heights[ix]), int(self.image_widths[ix])

    def get_example(self, split=0, iterate=True):
        """One padded example (host numpy): the split's next, in order and
        wrapping at the end, or with `iterate=False` one drawn at random."""
        ix_list = self.split_ix[split]
        if not len(ix_list):
            raise ValueError(f"split {split} is empty")
        if iterate:
            ri = self.iterators[split]
            self.iterators[split] = (ri + 1) % len(ix_list)
        else:
            ri = self.rng.randint(len(ix_list))
        return self.get_example_at(split, ri)

    def get_example_at(self, split, ri):
        """The example at position ri of a split; the split's iterator is
        left alone. Besides the batch keys it carries the dataset index
        `ix`, the image's `filename` and `split_pos` (position, split
        size)."""
        ix_list = self.split_ix[split]
        ix = int(ix_list[ri])
        image = self.images[ix].transpose(1, 2, 0)  # (S, S, 3) uint8
        r0, r1 = self._box_rows(ix)
        boxes, labels = self.boxes[r0:r1], self.labels[r0:r1]
        G, n = self.max_gt_boxes, len(boxes)
        if n > G:
            keep = np.sort(self._subsample(n))
            boxes, labels, n = boxes[keep], labels[keep], G
        gt_boxes = np.zeros((G, 4), np.float32)
        gt_labels = np.zeros((G, self.seq_length()), np.int32)
        gt_boxes[:n] = boxes
        gt_labels[:n] = labels
        return {
            "image": image,
            "height": np.float32(self.image_heights[ix]),
            "width": np.float32(self.image_widths[ix]),
            "gt_boxes": gt_boxes,
            "gt_labels": gt_labels,
            "gt_valid": np.arange(G) < n,
            "ix": ix,
            "filename": self.info["idx_to_filename"].get(str(ix + 1)),
            "split_pos": (ri, len(ix_list)),
        }

    def _box_rows(self, ix):
        """The rows [r0, r1) of image ix's boxes (the h5's indices are
        1-based and inclusive)."""
        return (int(self.img_to_first_box[ix]) - 1,
                int(self.img_to_last_box[ix]))

    def _subsample(self, n):
        """The max_gt_boxes of n boxes an example keeps, one draw from
        the loader's generator."""
        return self.rng.choice(n, self.max_gt_boxes, replace=False)

    def pass_over_at(self, split, ri):
        """Draw from the generator as `get_example_at(split, ri)` would,
        without reading the example."""
        r0, r1 = self._box_rows(int(self.split_ix[split][ri]))
        if r1 - r0 > self.max_gt_boxes:
            self._subsample(r1 - r0)

    def _pass_over(self, split):
        """Step past the split's next example without reading it: the
        iterator moves and the generator draws as `get_example` would."""
        ix_list = self.split_ix[split]
        if not len(ix_list):
            raise ValueError(f"split {split} is empty")
        ri = self.iterators[split]
        self.iterators[split] = (ri + 1) % len(ix_list)
        self.pass_over_at(split, ri)

    def get_batch(self, batch_size=1, split=0, rows=None):
        """A stacked batch of padded examples. rows: (start, stop), to
        return only those rows of the batch; the examples of the other
        rows are passed over unread (`_pass_over`), so the iterator and
        the ground-truth subsample stay where the whole batch would
        leave them (a data rank's slice of its host's batch)."""
        start, stop = rows or (0, batch_size)
        exs = []
        for k in range(batch_size):
            if start <= k < stop:
                exs.append(self.get_example(split))
            else:
                self._pass_over(split)
        return {k: np.stack([e[k] for e in exs]) for k in BATCH_KEYS}

    def close(self):
        self.h5.close()


class BucketedLoader:
    """Canvas-bucketed batching (twin of the JAX `BucketedLoader`).

    Buckets are (bh, bw) canvas shapes; the full S x S square is always
    added as the fallback. Each image goes to the smallest-area bucket
    that holds its extent, batches form per bucket, and each batch's
    canvases are cropped to its bucket (the h5 canvas is top-left
    aligned, so nothing of the image is lost).

    Nothing is dropped: when the split wraps (the epoch's end), every
    pending example is flushed through the square, and a partial batch
    is padded by repeating its examples with weight 0, so each example of
    a finite split trains exactly once an epoch. Batches carry `weight`,
    which the train step's loss mean honours.

    The schedule is computed from metadata only (`loader.example_meta`).
    With shard=(process_id, num_processes) every process runs the same
    schedule over the same unsharded split and loads only its contiguous
    slice of each global batch, so all processes agree on every step's
    bucket without talking to each other.
    """

    def __init__(self, loader, buckets, batch_size, split=0, iterate=True,
                 shard=None, seed=0, rows=None):
        """batch_size is the global batch when shard is given (the loader
        must then be unsharded); this process loads batch_size //
        num_processes examples a batch. rows: (start, stop), to read only
        those rows of this process's slice; the others are passed over
        unread (`DenseCapLoader.pass_over_at`), so the loader's generator
        draws as it would for the whole slice (a data rank's rows of its
        host's slice)."""
        S = loader.canvas
        self.loader = loader
        self.buckets = sorted(set(tuple(b) for b in buckets) | {(S, S)},
                              key=lambda b: b[0] * b[1])
        self.batch_size = batch_size
        self.split = split
        self.iterate = iterate
        self.shard = shard
        self.rows = rows
        if shard is not None:
            pid, nproc = shard
            if not (0 <= pid < nproc and batch_size % nproc == 0):
                raise ValueError(f"shard {shard} of batch {batch_size}")
        # random mode draws from its own seeded stream, the same in every
        # shard replica
        self.rng = np.random.RandomState(seed)
        self.pos = 0
        self.pending = {b: [] for b in self.buckets}  # split positions
        self._flush_queue = []

    def _bucket_for(self, h, w):
        for bh, bw in self.buckets:
            if h <= bh and w <= bw:
                return (bh, bw)
        return self.buckets[-1]

    def _padded(self, ris):
        """Repeat-pad a partial batch; weight 0 marks the repeats."""
        n_real = len(ris)
        weight = np.ones(self.batch_size, np.float32)
        out = list(ris)
        while len(out) < self.batch_size:
            weight[len(out)] = 0.0
            out.append(out[len(out) % n_real])
        return out, weight

    def _flush_pending(self):
        """Epoch boundary: drain every bucket through the full square."""
        leftovers = []
        for b in self.buckets:
            leftovers.extend(self.pending[b])
            self.pending[b] = []
        full = self.buckets[-1]
        while leftovers:
            ris, leftovers = (leftovers[:self.batch_size],
                              leftovers[self.batch_size:])
            ris, weight = self._padded(ris)
            self._flush_queue.append((full, ris, weight))

    def _schedule_next(self):
        """Next (bucket, split positions, weights), from metadata only."""
        while True:
            if self._flush_queue:
                return self._flush_queue.pop(0)
            n = self.loader.split_size(self.split)
            if not n:
                raise ValueError(f"split {self.split} is empty")
            if self.iterate:
                ri = self.pos
                self.pos = (self.pos + 1) % n
            else:
                ri = int(self.rng.randint(n))
            b = self._bucket_for(*self.loader.example_meta(self.split, ri))
            self.pending[b].append(ri)
            full_bucket = None
            if len(self.pending[b]) == self.batch_size:
                ris, self.pending[b] = self.pending[b], []
                full_bucket = (b, ris, np.ones(self.batch_size, np.float32))
            # the split wraps next: queue the tail flush after any batch
            # that just filled
            if self.iterate and ri == n - 1:
                if full_bucket is not None:
                    self._flush_queue.append(full_bucket)
                    full_bucket = None
                self._flush_pending()
            if full_bucket is not None:
                return full_bucket

    def next_batch(self):
        """(bucket, batch): the batch keys with images cropped to the
        bucket, `weight` (0 for repeat padding) and `ix` (the real
        examples' dataset indices). Under shard the batch is this
        process's slice of the global batch."""
        bucket, ris, weight = self._schedule_next()
        bh, bw = bucket
        sel = slice(0, self.batch_size)
        if self.shard is not None:
            pid, nproc = self.shard
            lb = self.batch_size // nproc
            sel = slice(pid * lb, (pid + 1) * lb)
        local = ris[sel]
        start, stop = self.rows or (0, len(local))
        exs = []
        for k, ri in enumerate(local):
            if start <= k < stop:
                exs.append(self.loader.get_example_at(self.split, ri))
            else:
                self.loader.pass_over_at(self.split, ri)
        wloc = weight[sel][start:stop]
        batch = {k: np.stack([e[k][:bh, :bw] if k == "image" else e[k]
                              for e in exs]) for k in BATCH_KEYS}
        batch["weight"] = wloc
        batch["ix"] = [e["ix"] for e, wv in zip(exs, wloc) if wv > 0]
        return bucket, batch


class PrefetchingLoader:
    """A background thread that keeps `depth` batches ready, from
    `loader.get_batch(batch_size, split)` or from any zero-argument
    callable `source` (e.g. a `BucketedLoader`'s batches). A failure to
    read is raised by `next` in the consumer's thread."""

    def __init__(self, loader=None, batch_size=None, split=0, depth=2,
                 source=None):
        if source is None:
            if loader is None or batch_size is None:
                raise ValueError("give a loader and batch_size, or source")

            def source():
                return loader.get_batch(batch_size, split)

        self.q = queue.Queue(maxsize=depth)
        self._stop = threading.Event()

        def worker():
            while not self._stop.is_set():
                try:
                    item = source()
                except Exception as e:  # handed to the consumer by next()
                    item = e
                while not self._stop.is_set():
                    try:
                        self.q.put(item, timeout=0.5)
                        break
                    except queue.Full:
                        continue
                if isinstance(item, Exception):
                    return

        self.thread = threading.Thread(target=worker, daemon=True)
        self.thread.start()

    def next(self):
        item = self.q.get()
        if isinstance(item, Exception):
            raise item
        return item

    def close(self):
        self._stop.set()
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass
        # join: the thread may be mid-read, and its loader's file must
        # stay open until it is done
        self.thread.join(timeout=10.0)
