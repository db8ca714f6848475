"""Mean device ms of GRiT's greedy decode loop per forward (every step's
layers through the cache and its vocab head): the program's
`textdec.decode` span in the traced window."""

from benchlib.vitdet import span_mean_ms


def read(run):
    return span_mean_ms(run, "textdec.decode")
