"""Host-side dataset loader: padded, fixed-shape batches of raw uint8
canvases.

Twin of the raw-uint8 path of `densecap_tpu/data/loader.py`
(`DenseCapLoader(raw_images=True)`, with the split API that evaluation
and the CLIs use) and of its `PrefetchingLoader`. Images come back as the
h5's uint8 BGR canvases (S, S, 3); the model's caller normalizes them on
the device (`utils/image.py:normalize_uint8_images`).
Ground truth is padded to `max_gt_boxes` rows with a validity mask (and
uniformly subsampled when an image has more). `h5py` is imported when a
loader is made, not with this module.
"""

from __future__ import annotations

import json
import queue
import threading

import numpy as np

BATCH_KEYS = ("image", "height", "width", "gt_boxes", "gt_labels", "gt_valid")


class DenseCapLoader:
    """Reads the preprocessed HDF5 and its dicts json (the schema of
    `densecap_tpu/data/preprocess.py`)."""

    def __init__(self, h5_path, json_path, max_gt_boxes=128, seed=0):
        import h5py

        self.h5 = h5py.File(h5_path, "r")
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
        self.iterators = {0: 0, 1: 0, 2: 0}
        self.canvas = self.h5["images"].shape[2]

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

    def get_example(self, split=0, iterate=True):
        """One padded example (host numpy): the split's next, in order and
        wrapping at the end, or with `iterate=False` one drawn at random.
        Besides the batch keys it carries the dataset index `ix`, the
        image's `filename` and `split_pos` (position, split size)."""
        ix_list = self.split_ix[split]
        if not len(ix_list):
            raise ValueError(f"split {split} is empty")
        if iterate:
            ri = self.iterators[split]
            self.iterators[split] = (ri + 1) % len(ix_list)
        else:
            ri = self.rng.randint(len(ix_list))
        ix = int(ix_list[ri])
        image = self.h5["images"][ix].transpose(1, 2, 0)  # (S, S, 3) uint8
        r0 = int(self.img_to_first_box[ix]) - 1  # 1-indexed inclusive
        r1 = int(self.img_to_last_box[ix])
        boxes, labels = self.boxes[r0:r1], self.labels[r0:r1]
        G, n = self.max_gt_boxes, len(boxes)
        if n > G:
            keep = np.sort(self.rng.choice(n, G, replace=False))
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

    def get_batch(self, batch_size=1, split=0):
        """A stacked batch of padded examples."""
        exs = [self.get_example(split) for _ in range(batch_size)]
        return {k: np.stack([e[k] for e in exs]) for k in BATCH_KEYS}

    def close(self):
        self.h5.close()


class PrefetchingLoader:
    """A background thread that keeps `depth` batches ready. A failure
    to read is raised by `next` in the consumer's thread."""

    def __init__(self, loader, batch_size, split=0, depth=2):
        self.q = queue.Queue(maxsize=depth)
        self._stop = threading.Event()

        def worker():
            while not self._stop.is_set():
                try:
                    item = loader.get_batch(batch_size, split)
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
        # join: a daemon thread mid-read at interpreter exit can deadlock
        # against h5py's own close
        self.thread.join(timeout=10.0)
