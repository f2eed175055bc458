"""area_share.area: 100 x the self time of the program's
`mcpt::area.sample` and `mcpt::area.hit` spans in the traced window over
the window's wall (models/integrator.trace_radiance: the area light's
sample, models/lights.sample_area, and the BRDF ray's emitter hit,
lights.area_eval_hit, each with its merges; harness/stages.py).  None
where the window holds no such span: a program without them."""

from benchmark.harness import stages

NAMES = ("mcpt::area.sample", "mcpt::area.hit")


def read(ctx):
    if "pixel_samples" not in ctx.work:
        return None
    got = stages.window(ctx)
    if got is None or not any(r.name in NAMES for r, _, _ in got[2].values()):
        return None
    return stages.self_share(ctx, NAMES)
