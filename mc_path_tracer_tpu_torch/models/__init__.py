"""Scene-level models: camera, film, materials, lights, mesh primitives,
scene, integrator."""
