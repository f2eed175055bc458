"""Host utilities of the port: the native BVH builder's binding, image IO
and mesh attribute helpers (numpy only)."""
