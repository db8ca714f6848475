"""Mean host ms a GRiT decode call spends blocked in its host reads (the
`decode.reads` counter's time, inside the `textdec.decode` span), in the
traced window: the text decoder's counterpart of `infer.decode_wait_ms`.
A program without that span gives None."""

from benchlib.program_spans import counter


def read(run):
    return counter(run, "textdec.decode", "decode.reads", "host_ms")
