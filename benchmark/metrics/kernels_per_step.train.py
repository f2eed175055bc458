"""kernels_per_step.train: CUDA kernels per train step in the traced
window, the forward and the replayed backward together
(parallel/render.make_train_step, torch.utils.checkpoint, autograd), with
the SGD update."""

from benchmark.harness import trace


def read(ctx):
    return trace.per_unit_kernels(ctx, "steps")
