"""Differentiable train steps (port of mc_path_tracer_tpu/parallel).
Multi-device rendering waits for ROADMAP Queue 1, multi-device."""
