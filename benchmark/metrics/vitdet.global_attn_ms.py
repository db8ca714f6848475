"""Device ms a forward in the global blocks' attention cores (the four
`vit.attn.global` spans of a call, from q, k, v to the heads' output with
the relative-position terms), in the traced window."""

from benchlib.vitdet import per_call_ms


def read(run):
    return per_call_ms(run, "vit.attn.global")
