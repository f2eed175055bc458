"""kernels_per_msample.area: CUDA kernels in the traced window per million
pixel-samples rendered in it, on an area-lit frame (models/integrator.
render -> render_tile_radiance -> trace_radiance: a 256 x 256 frame is one
block, run through every sample pass in turn, so the count per pass is
what batching samples or replaying a graph would lower)."""

from benchmark.harness import trace


def read(ctx):
    samples = trace.per_unit_kernels(ctx, "pixel_samples")
    return None if samples is None else samples * 1e6
