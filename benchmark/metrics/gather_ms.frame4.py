"""gather_ms.frame4: rank 0's milliseconds per traced frame in the NCCL
all_gather of the frame's rows, from its own rows being done to the
gathered frame (waiting for slower ranks included)."""


def read(ctx):
    return ctx.extra.get("gather_ms")
