"""backward_share.train: 100 x the wall of the program's
`mcpt::train.backward` spans (torch.autograd.grad: every sample replayed,
then the gathers' backward; parallel/render.make_train_step) over the wall
of its `mcpt::train.step` spans, in the traced window."""

from benchmark.harness import stages


def read(ctx):
    if "steps" not in ctx.work:
        return None
    got = stages.window(ctx)
    if got is None:
        return None
    _, _, spans = got
    step = stages.wall_ns(spans, ("mcpt::train.step",))
    if step <= 0:
        return None
    return 100.0 * stages.wall_ns(spans, ("mcpt::train.backward",)) / step
