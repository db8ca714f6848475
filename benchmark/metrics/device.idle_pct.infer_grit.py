"""The share of the traced window in which no kernel, copy or memset ran
on the device."""

from benchlib.readers import idle_pct


def read(run):
    return idle_pct(run)
