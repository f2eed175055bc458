"""kernels_per_msample.frame: CUDA kernels in the traced window per million
pixel-samples rendered in it (the frame loop and shading glue:
models/integrator.render -> render_tile_radiance -> trace_radiance).  The
count does not depend on how the frame is cut into blocks, so larger
blocks or graph replay lower it."""

from benchmark.harness import trace


def read(ctx):
    samples = trace.per_unit_kernels(ctx, "pixel_samples")
    return None if samples is None else samples * 1e6
