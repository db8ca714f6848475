"""Mean device ms of the ViTDet trunk per forward (input, patch embedding,
the blocks, the neck): the program's `trunk` span in the traced window."""

from benchlib.vitdet import span_mean_ms


def read(run):
    return span_mean_ms(run, "trunk")
