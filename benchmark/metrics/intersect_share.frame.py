"""intersect_share.frame: 100 x the wall inside the program's
`mcpt::closest` and `mcpt::anyhit` spans in the traced window over the
window's wall (models/integrator._intersect / _occluded: ray packing, the
octant sort, the traversal kernel's launch, the unsort and
finish_closest; harness/stages.py)."""

from benchmark.harness import stages

NAMES = ("mcpt::closest", "mcpt::anyhit")


def read(ctx):
    if "pixel_samples" not in ctx.work:
        return None
    return stages.wall_share(ctx, NAMES)
