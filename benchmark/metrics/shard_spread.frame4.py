"""shard_spread.frame4: over the traced frames, the sum of the slowest
rank's rows time over the sum of the ranks' mean rows time (each rank's
span from the frame's barrier to its rows done, ending in a synchronise;
parallel/render.render_sharded_global, parallel/mesh).  The slowest part
sets the frame."""


def read(ctx):
    return ctx.extra.get("shard_spread")
