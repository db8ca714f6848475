"""Mean ms of a greedy decode call (`LanguageModel.greedy_decode`), by
CUDA events around each call in the traced window."""

from benchlib.readers import mean_span_ms


def read(run):
    return mean_span_ms(run, "decode_ms")
