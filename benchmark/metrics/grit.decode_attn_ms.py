"""Device ms a forward in the decode steps' attention (each layer's
attention over the cache in each step, the `textdec.attn` spans of a
call), in the traced window; where the host paces the steps the spans
hold each attention's launch too (see `grit.decode_attn_roofline`)."""

from benchlib.grit import per_call_ms


def read(run):
    return per_call_ms(run, "textdec.attn")
