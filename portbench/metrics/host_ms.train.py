"""host_ms.train: the host's ms per step to enqueue the window's steps,
with no synchronisation inside the loop (the harness's clock over the
window's loop, before its closing synchronise)."""


def read(ctx):
    return ctx["host_ms_per_step"]
