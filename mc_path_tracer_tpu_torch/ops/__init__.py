"""Numerics layer: math conventions, threefry streams, samplers, BRDFs, env
CDFs, intersection, BVH build, tone mapping."""
