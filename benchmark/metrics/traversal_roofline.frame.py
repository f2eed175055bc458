"""traversal_roofline.frame: the traversal kernels' least time over their
device time, in %: closest_kernel + anyhit_kernel (csrc/traversal.cu)
summed over the traced window.  The least time is a bytes bound at the
H100's 3.35 TB/s (harness/roofline.traversal_bytes: each nominal ray read
and answered once, the scene's triangles once per nominal dispatch);
bytes bind, since the count holds no node tables or visits."""

from benchmark.harness import roofline


def read(ctx):
    if ctx.events is None or "rays_closest" not in ctx.work:
        return None
    device_s = sum(e.end_ns - e.start_ns for e in ctx.events if e.kind == "kernel" and (
        roofline.kernel_named(e.name, "closest_kernel")
        or roofline.kernel_named(e.name, "anyhit_kernel"))) / 1e9
    if device_s <= 0:
        return None
    w = ctx.work
    least = roofline.least_seconds_bytes(roofline.traversal_bytes(
        w["rays_closest"], w["rays_anyhit"], w["dispatches"], w["triangles"]))
    return 100.0 * least / device_s
