"""shade_share.frame: 100 x the self time of the program's `mcpt::camera`,
`mcpt::trace` and `mcpt::bounce` spans in the traced window over the
window's wall (models/integrator.py: camera uniforms and rays; the primary
hit's background and emission; each bounce's light sampling, BRDF, MIS,
continuation and Russian roulette), each less the intersection spans
inside it (harness/stages.py)."""

from benchmark.harness import stages

NAMES = ("mcpt::camera", "mcpt::trace", "mcpt::bounce")


def read(ctx):
    if "pixel_samples" not in ctx.work:
        return None
    return stages.self_share(ctx, NAMES)
