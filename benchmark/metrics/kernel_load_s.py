"""kernel_load_s: seconds of this process in the program's kept
`mcpt::kernels.load` and `mcpt::native.load` spans (ops/kernels/build.
load_all: nvcc where a checkout has not built the CUDA libraries, else
their load; utils/native.load_native: g++ on the BVH builder likewise).
Read in every run, traced or not; on several cards: rank 0's."""

from benchmark.harness import stages

NAMES = ("mcpt::kernels.load", "mcpt::native.load")


def read(ctx):
    return stages.kept_seconds(NAMES)
