"""kernels_per_frame.preview: CUDA kernels per shaded preview frame in the
traced window (models/preview.render_preview -> preview_pixels: one
closest dispatch per 65,536-pixel chunk, a shadow any-hit per light, the
IBL products)."""

from benchmark.harness import trace


def read(ctx):
    return trace.per_unit_kernels(ctx, "frames")
