"""Device ms a forward in the blocks' MLPs (the `vit.mlp` spans of a
call: LN2, fc1, GELU, fc2), in the traced window."""

from benchlib.vitdet import per_call_ms


def read(run):
    return per_call_ms(run, "vit.mlp")
