"""Visual Genome -> HDF5 preprocessing (twin of
densecap_tpu/data/preprocess.py, after the reference's preprocess.py,
with the same flags and output).

    python -m densecap_tpu_torch.data.preprocess \
        --region_data region_descriptions.json --image_dir VG_100K \
        --split_json info/densecap_splits.json \
        --h5_output VG-regions.h5 --json_output VG-regions-dicts.json

Writes the reference's schema, which `data.loader.DenseCapLoader` (and
the JAX package's loader) read:

  json: token_to_idx / idx_to_token / filename_to_idx / idx_to_filename
        (all 1-indexed, keys of the idx_ dicts as strings)
  h5:   images (N, 3, S, S) uint8, BGR, top-left aligned, zero pad
        image_heights/widths, original_heights/widths (N,) int32
        boxes (M, 4) int32 xcycwh (1-indexed)
        lengths (M,) int32
        labels (M, L) int32 (0-padded)
        img_to_first_box / img_to_last_box (N,) int32 (1-indexed incl.)
        box_to_img (M,) int32
        split (N,) int32 (0 train, 1 val, 2 test)

Host-side only: a pool of worker processes decodes and resizes the
images, and this process alone writes the h5 with the port's codec
(`utils/h5.py`), one canvas at a time into the `images` region allocated
up front (decoding is the expensive part).
"""

from __future__ import annotations

import argparse
import json
import os
import string
from collections import Counter
from math import floor
import multiprocessing

import numpy as np

from ..utils import h5

_REPLACEMENTS = {
    "½": "half", "—": "-", "™": "", "¢": "cent",
    "ç": "c", "û": "u", "é": "e", "°": " degree",
    "è": "e", "…": "",
}
_PUNCT_TABLE = str.maketrans("", "", string.punctuation)


def words_preprocess(phrase: str):
    """lowercase, replace odd unicode, strip punctuation, split."""
    for k, v in _REPLACEMENTS.items():
        phrase = phrase.replace(k, v)
    return phrase.lower().translate(_PUNCT_TABLE).split()


def split_filter_captions(data, max_token_length, verbose=True):
    """Tokenize regions in place; overlong captions get tokens=None."""
    kept = removed = 0
    for img in data:
        for region in img["regions"]:
            tokens = words_preprocess(region["phrase"])
            if 0 < max_token_length and len(tokens) <= max_token_length \
                    and len(tokens) > 0:
                region["tokens"] = tokens
                kept += 1
            else:
                region["tokens"] = None
                removed += 1
    if verbose:
        print(f"kept {kept} captions, dropped {removed} (length filter)")
    return data


def build_vocab(data, min_token_instances, verbose=True):
    counter = Counter()
    for img in data:
        for region in img["regions"]:
            if region["tokens"] is not None:
                counter.update(region["tokens"])
    vocab = {t for t, c in counter.items() if c >= min_token_instances}
    if len(vocab) < len(counter):
        vocab.add("<UNK>")
    if verbose:
        print(f"vocab: {len(vocab)} / {len(counter)} tokens")
    return vocab


def build_vocab_dict(vocab):
    token_to_idx, idx_to_token = {}, {}
    for i, token in enumerate(sorted(vocab), start=1):
        token_to_idx[token] = i
        idx_to_token[i] = token
    return token_to_idx, idx_to_token


def encode_caption(tokens, token_to_idx, max_len):
    out = np.zeros(max_len, dtype=np.int32)
    for i, tok in enumerate(tokens[:max_len]):
        out[i] = token_to_idx.get(tok, token_to_idx.get("<UNK>", 0))
    return out


def encode_captions(data, token_to_idx, max_len):
    rows, lengths = [], []
    for img in data:
        for region in img["regions"]:
            if region["tokens"] is None:
                continue
            rows.append(encode_caption(region["tokens"], token_to_idx,
                                       max_len))
            lengths.append(len(region["tokens"]))
    return (np.stack(rows).astype(np.int32),
            np.asarray(lengths, dtype=np.int32))


def encode_boxes(data, original_heights, original_widths, image_size):
    """Region (x, y, w, h) -> scaled, clamped int32 (xc, yc, w, h).

    Matches reference preprocess.py:147-184: scale about the 1-indexed
    origin, clamp into the canvas, centers via x + floor(w/2).
    """
    out = []
    for i, img in enumerate(data):
        H, W = int(original_heights[i]), int(original_widths[i])
        scale = float(image_size) / max(H, W)
        for region in img["regions"]:
            if region["tokens"] is None:
                continue
            x = round(scale * (region["x"] - 1) + 1)
            y = round(scale * (region["y"] - 1) + 1)
            w = round(scale * region["width"])
            h = round(scale * region["height"])
            x = max(x, 1)
            y = max(y, 1)
            x = min(x, image_size - 1)
            y = min(y, image_size - 1)
            w = min(w, image_size - x)
            h = min(h, image_size - y)
            out.append([x + floor(w / 2), y + floor(h / 2), w, h])
    return np.asarray(out, dtype=np.int32)


def build_img_idx_to_box_idxs(data):
    n = len(data)
    first = np.zeros(n, dtype=np.int32)
    last = np.zeros(n, dtype=np.int32)
    box_idx = 1
    for i, img in enumerate(data):
        first[i] = box_idx
        box_idx += sum(
            1 for r in img["regions"] if r["tokens"] is not None
        )
        last[i] = box_idx - 1
    return first, last


def build_filename_dict(data):
    filename_to_idx, idx_to_filename = {}, {}
    for i, img in enumerate(data, start=1):
        fn = f"{img['id']}.jpg"
        filename_to_idx[fn] = i
        idx_to_filename[i] = fn
    return filename_to_idx, idx_to_filename


def encode_splits(data, split_data):
    """Map images to split ints: 0 train / 1 val / 2 test."""
    lookup = {}
    if split_data:
        for name, code in (("train", 0), ("val", 1), ("test", 2)):
            for img_id in split_data.get(name, []):
                lookup[img_id] = code
    return np.asarray(
        [lookup.get(img["id"], 0) for img in data], dtype=np.int32
    )


def _load_and_resize(args):
    """Worker: decode, resize and BGR-order one image -> (i, H0, W0, H, W,
    (3, H, W) uint8)."""
    i, path, image_size = args
    from PIL import Image

    with Image.open(path) as im:
        im = im.convert("RGB")
        W0, H0 = im.size
        scale = float(image_size) / max(H0, W0)
        W, H = round(W0 * scale), round(H0 * scale)
        im = im.resize((W, H), Image.BILINEAR)
        arr = np.asarray(im, dtype=np.uint8)  # (H, W, 3) RGB
    bgr = arr[:, :, ::-1]
    return i, H0, W0, H, W, np.ascontiguousarray(bgr.transpose(2, 0, 1))


def add_images(data, h5_file, image_dir, image_size, num_workers=8):
    n = len(data)
    shape = (n, 3, image_size, image_size)
    image_dset = h5_file.create_dataset("images", shape, dtype=np.uint8)
    original_heights = np.zeros(n, dtype=np.int32)
    original_widths = np.zeros(n, dtype=np.int32)
    image_heights = np.zeros(n, dtype=np.int32)
    image_widths = np.zeros(n, dtype=np.int32)

    tasks = [
        (i, os.path.join(image_dir, f"{img['id']}.jpg"), image_size)
        for i, img in enumerate(data)
    ]
    # spawn: a forked child would inherit the caller's threads' locks
    with multiprocessing.get_context("spawn").Pool(num_workers) as pool:
        for i, H0, W0, H, W, chw in pool.imap_unordered(
            _load_and_resize, tasks, chunksize=8
        ):
            original_heights[i] = H0
            original_widths[i] = W0
            image_heights[i] = H
            image_widths[i] = W
            canvas = np.zeros(shape[1:], np.uint8)
            canvas[:, :H, :W] = chw
            image_dset[i] = canvas
            if i % 1000 == 0:
                print(f"writing image {i}/{n}")

    h5_file.create_dataset("image_heights", data=image_heights)
    h5_file.create_dataset("image_widths", data=image_widths)
    h5_file.create_dataset("original_heights", data=original_heights)
    h5_file.create_dataset("original_widths", data=original_widths)
    return original_heights, original_widths


def filter_images(data, split_data):
    """Keep only images present in the split file, as the reference
    does."""
    if not split_data:
        return data
    keep = set()
    for ids in split_data.values():
        keep.update(ids)
    return [img for img in data if img["id"] in keep]


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--region_data", required=True,
                   help="VG region_descriptions.json")
    p.add_argument("--image_dir", required=True)
    p.add_argument("--split_json", default=None,
                   help="info/densecap_splits.json")
    p.add_argument("--h5_output", default="VG-regions.h5")
    p.add_argument("--json_output", default="VG-regions-dicts.json")
    p.add_argument("--image_size", type=int, default=720)
    p.add_argument("--max_token_length", type=int, default=15)
    p.add_argument("--min_token_instances", type=int, default=15)
    p.add_argument("--max_images", type=int, default=-1)
    p.add_argument("--num_workers", type=int, default=8)
    args = p.parse_args(argv)

    with open(args.region_data) as f:
        data = json.load(f)
    split_data = None
    if args.split_json:
        with open(args.split_json) as f:
            split_data = json.load(f)
        data = filter_images(data, split_data)
    if args.max_images > 0:
        data = data[: args.max_images]

    split_filter_captions(data, args.max_token_length)
    vocab = build_vocab(data, args.min_token_instances)
    token_to_idx, idx_to_token = build_vocab_dict(vocab)
    # tokens left out of the vocabulary become <UNK> in encode_caption

    filename_to_idx, idx_to_filename = build_filename_dict(data)

    with h5.File(args.h5_output, "w") as f:
        oh, ow = add_images(data, f, args.image_dir, args.image_size,
                            args.num_workers)
        boxes = encode_boxes(data, oh, ow, args.image_size)
        f.create_dataset("boxes", data=boxes)
        captions, lengths = encode_captions(
            data, token_to_idx, args.max_token_length
        )
        f.create_dataset("labels", data=captions)
        f.create_dataset("lengths", data=lengths)
        first, last = build_img_idx_to_box_idxs(data)
        f.create_dataset("img_to_first_box", data=first)
        f.create_dataset("img_to_last_box", data=last)
        box_to_img = np.zeros(len(boxes), dtype=np.int32)
        for i in range(len(data)):
            box_to_img[first[i] - 1: last[i]] = i + 1
        f.create_dataset("box_to_img", data=box_to_img)
        f.create_dataset("split", data=encode_splits(data, split_data))

    info = {
        "token_to_idx": token_to_idx,
        "idx_to_token": {str(k): v for k, v in idx_to_token.items()},
        "filename_to_idx": filename_to_idx,
        "idx_to_filename": {str(k): v for k, v in idx_to_filename.items()},
    }
    with open(args.json_output, "w") as f:
        json.dump(info, f)
    print(f"wrote {args.h5_output} and {args.json_output}")


if __name__ == "__main__":
    main()
