"""mc_path_tracer_tpu_torch — the PyTorch/CUDA port of mc_path_tracer_tpu.

The JAX package beside it is the reference: every module here mirrors the
module of the same name there and is held against it by the tests in
`tests/test_torch_*.py`.  Plain tensor code is PyTorch; BVH traversal
(`csrc/traversal.cu`), dense all-triangle intersection (`csrc/dense.cu`)
and the tone map (`csrc/tonemap.cu`) are hand-written CUDA kernels for
Hopper, built with nvcc at first use.  Entry points run on the card unless
given device="cpu"; on CPU tensors every kernel wrapper runs its plain
PyTorch version instead.

Layout:
  ops/       numerics: math conventions, threefry streams, samplers, BRDFs,
             environment CDFs, intersection, BVH build, tone mapping.
  ops/kernels/  the nvcc build and the kernel wrappers with their plain
             versions and launch counters.
  csrc/      CUDA sources and the native BVH builder (C++).
  models/    camera, film, materials, lights, mesh primitives, scene,
             integrator (with per-sample path replay under autograd),
             preview and debug views, material preview, engine (render
             modes, progressive session), interactive controllers and
             the terminal viewer, procedural geometry (L-systems, the 3D
             turtle, curves).
  parallel/  device meshes over torch.distributed, row-sharded rendering
             (render_sharded, render_sharded_global) and the
             inverse-rendering train step (MaterialGrads, make_train_step,
             one-device or sharded with a gradient all-reduce).
  utils/     host code: the native BVH library's binding, image IO (PNG and
             JPEG decoding without PIL), mesh attributes, glTF loading, the
             texture atlas, film and parameter checkpoints, profiling.
  configs.py the five verification configs.
  cli.py     the command line, `python3 -m mc_path_tracer_tpu_torch`.
  bench.py   the benchmark of the main path,
             `python3 -m mc_path_tracer_tpu_torch.bench`.

This package imports torch and numpy, never jax and nothing of the JAX
package.
"""

__version__ = "0.1.0"

_LAZY = {
    "PerspectiveCamera": ("mc_path_tracer_tpu_torch.models.camera", "PerspectiveCamera"),
    "Film": ("mc_path_tracer_tpu_torch.models.film", "Film"),
    "Scene": ("mc_path_tracer_tpu_torch.models.scene", "Scene"),
    "RenderConfig": ("mc_path_tracer_tpu_torch.models.integrator", "RenderConfig"),
    "render": ("mc_path_tracer_tpu_torch.models.integrator", "render"),
    "make_train_step": ("mc_path_tracer_tpu_torch.parallel.render", "make_train_step"),
    "render_sharded": ("mc_path_tracer_tpu_torch.parallel.render", "render_sharded"),
    "make_mesh": ("mc_path_tracer_tpu_torch.parallel.mesh", "make_mesh"),
    "render_preview": ("mc_path_tracer_tpu_torch.models.preview", "render_preview"),
    "render_debug": ("mc_path_tracer_tpu_torch.models.preview", "render_debug"),
    "preview_material": ("mc_path_tracer_tpu_torch.models.matpreview", "preview_material"),
    "InteractiveViewer": ("mc_path_tracer_tpu_torch.models.interactive", "InteractiveViewer"),
    "RenderStats": ("mc_path_tracer_tpu_torch.utils.profiling", "RenderStats"),
}

__all__ = [*_LAZY, "__version__"]


def __getattr__(name):
    if name in _LAZY:
        import importlib

        module, attr = _LAZY[name]
        return getattr(importlib.import_module(module), attr)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
