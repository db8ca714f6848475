"""Device ms a forward in the windowed blocks' attention cores (the eight
`vit.attn.window` spans of a call, over the padded windows), in the
traced window."""

from benchlib.vitdet import per_call_ms


def read(run):
    return per_call_ms(run, "vit.attn.window")
