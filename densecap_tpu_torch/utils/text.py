"""Token sequences to strings (twin of densecap_tpu/utils/text.py)."""

from __future__ import annotations

import numpy as np


def decode_sequence(seq, idx_to_token, vocab_size):
    """(N, T) int tokens -> N strings; a row stops at END (= V+1) or 0.

    idx_to_token maps int (or the str of an int) -> word.
    """
    end = vocab_size + 1
    out = []
    for row in np.asarray(seq):
        words = []
        for idx in row:
            idx = int(idx)
            if idx == end or idx == 0:
                break
            words.append(idx_to_token.get(idx, idx_to_token.get(str(idx),
                                                                "<UNK>")))
        out.append(" ".join(words))
    return out
