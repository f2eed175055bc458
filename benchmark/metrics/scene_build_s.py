"""scene_build_s: host seconds of Scene.build(device) on the card, ending
in a synchronise (the harness's `scene_build` span; models/scene.py, the
native SAH or LBVH builder, the environment's CDF, the upload)."""


def read(ctx):
    spans = ctx.spans.named("scene_build")
    return sum(s.seconds for s in spans) if spans else None
