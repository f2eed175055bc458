"""Device meshes, row-sharded rendering and differentiable train steps
(port of mc_path_tracer_tpu/parallel)."""
