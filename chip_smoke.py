"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py [--png PATH]

Builds the three CUDA sources of csrc/ (one nvcc each, in parallel), then
drives the port's paths and holds every kernel against its plain PyTorch
version on the card.  Every frame counts its kernel launches from 0 and
fails unless each dispatch went through the expected kernel:

  [scene] [kernel]  the bench scene (48,002 triangles); the traversal
                    kernel against its plain version on mixed rays and at
                    the bench frame's dispatch shapes, with counting passes
                    of the work those rays need: the binary walk's (the
                    bound) and the 4-wide walk's the kernel does
  [render]          bench path: 1920x1080, 4 spp, depth 5, through the
                    traversal kernel
  [parity]          kernel route against plain route on a 64x64 crop
  [tonemap]         the tone-map kernel against plain on the bench film
  [api]             the JAX package's public traversal routes
                    (ops/wide_bvh.intersect_wide / occluded_wide,
                    ops/intersect.intersect_bvh / occluded_bvh) on bench
                    block 15's 65,536 primary rays and 131,072 any-hit
                    lanes: one kernel launch each, bit-equal to the
                    integrator's dispatch (sorted and unsorted) and to the
                    plain version on every live lane, timed
  [sharded]         render_sharded of the bench frame on two shards of the
                    card (make_mesh(devices=["cuda:0"] * 2)), the shards
                    enqueued in turn: bit-equal to [render]'s frame, seconds
                    beside [render]'s, exact launches per shard (counted
                    around each shard's call), saved as a PNG
  [dense]           config2 (2,320 triangles, emissive quad): the dense
                    kernel against plain on 65,536 camera rays and 65,536
                    bounded shadow rays toward the quad
  [area]            area-light path: config2 at 256x256, 64 spp, depth 3,
                    rendered with accel="auto" (traversal) and "dense",
                    each frame then saved as a PNG through the tone-map
                    kernel; the two images agree; the 4-triangle area
                    scene under "auto" takes the dense kernel
  [configs]         configs 1, 3 and 4 at their configured size, spp and
                    depth, config5 at 1920x1080 x depth 5 cut to 4 spp,
                    each with the native BVH builder (LBVH for config5),
                    saved as PNGs
  [golden]          config4 and config5 at the goldens' sizes, key 42,
                    against the JAX package's CPU renders (tests/golden)
  [gltf]            a textured GLB written here (write_textured_glb),
                    loaded with Scene.load, one object moved, rendered at
                    512x512 x 16 spp x depth 4 under "auto" (the dense
                    kernel) and "pallas" (the traversal kernel): the
                    images agree, the kernel route agrees with the plain
                    route on a crop, the frame is saved as a PNG
  [images]          embedded JPEGs (baseline 4:2:0 with restart markers,
                    progressive, arithmetic sequential and progressive,
                    lossless, Adobe CMYK, YCCK, CMYK without an Adobe
                    marker) decoded by utils/jpeg.read_jpeg must hash as
                    PIL's decode; seconds per megapixel on the host per
                    kind; the textured GLB with a JPEG base colour rendered
                    under "auto" (dense) and "pallas" (traversal), agreeing
                    as in [gltf]
  [procedural]      a 187,500-triangle L-system tree (LSystem +
                    Turtle.to_mesh) on the bench floor, environment and sun,
                    at 1920x1080 x 4 spp x depth 5 through the traversal
                    kernel, saved as a PNG; host build seconds
  [reuse]           config2 with reuse_brdf_ray: one closest hit per
                    sample fewer; on config4, fewer any-hit lanes
  [progressive]     render_progressive on config4 adds up to the 1-spp
                    renders of its passes; a RenderSession restarts on
                    set_transform
  [grad]            train steps (make_train_step) at full width: config4 as
                    configured (traversal kernel), the bench scene at
                    1920x1080 cut to 1 spp, config2 under accel="dense" cut
                    to 8 spp; loss, gradient L1 norms, step seconds, peak
                    memory and the forward's and backward's launches
  [grad-check]      the backward replays every launch of the forward; on a
                    config4 crop the kernel route's gradients equal the
                    plain route's; replayed equal kept-graph gradients;
                    central differences along the bench scene's ls and
                    config4's environment texels
  [train]           five SGD steps on config4's albedo: the loss falls at
                    every step
  [sharded]         config4's train step on two shards of the card: its
                    gradients within 1e-5 of [grad]'s one-device step, exact
                    forward launches per shard (rows cut on the frame's
                    block grid), forward seconds
  [multiprocess]    two processes on the card joined by gloo (this script
                    re-run with --worker): render_sharded_global of config4
                    and a sharded train step per rank; rank 0's all-gathered
                    frame bit-equal to [configs]' config4, every rank's
                    gradients within 1e-5 of [grad]'s; whether gloo takes
                    CUDA tensors; then one NCCL rank (world size 1): its
                    step bit-equal to the one-device step
  [bench]           the benchmark (mc_path_tracer_tpu_torch.bench) in
                    --strided mode through bench.run: its JSON line, with
                    bench.py's keys and the card, block times and host CPUs
  [preview]         render_preview in every PREVIEW_MODE and render_debug:
                    the bench scene at 1920x1080 (traversal kernel), the
                    textured glTF scene at 512x512 under "auto" (dense
                    kernel) and "pallas" (traversal kernel); seconds of two
                    calls, launches, peak memory (the chunked shaded
                    preview under 4 GB); the kernel route against the plain
                    route on a 64x64 crop of the bench frame, and the glTF
                    scene's dense route against its traversal route:
                    G-buffer modes bit-equal, shaded and debug within 1e-6
  [matpreview]      preview_material() at its defaults, on the preview path
                    and path-traced (the 9,218-triangle ball: traversal)
  [cli]             python3 -m mc_path_tracer_tpu_torch as a subprocess:
                    the demo at its defaults, the rasterizer at 1920x1080,
                    wireframe, debug, the heat-map view with --out-hdr;
                    PNG sizes, the demo bright and not flat, the .npy
                    finite, the imports of one run (-X importtime)
  [interactive]     a headless InteractiveViewer at 96x64: accumulation
                    restarts on a key, a mouse move and an object drag;
                    frame() through the tone-map kernel, frame_to_ansi
                    (run_tty needs a terminal and is not run)
  [gate]            the on-card gate (python3 -m
                    mc_path_tracer_tpu_torch.tests_tpu, the twin of
                    tests_tpu.py) at its full size: every check passes or
                    is skipped for an asset golden; TESTS_TORCH_GPU.json
                    beside the PNGs
  [stream]          the traversal kernel on 1,003,520 triangles (the TPU
                    streaming kernel's contract) against plain
  [sort]            RenderConfig.sort_rays: the bench frame with sorted and
                    unsorted traversal dispatches in turns, three each,
                    bit-equal (and on two shards), seconds and launches; a
                    replayed train step meets the forward's hits; on bench
                    block 15 every dispatch of one sample timed unsorted and
                    sorted, the sort's own device ms and kernels, and one
                    sample's device kernels with and without it
  [device-time]     the kernels' device time at the shapes above, under
                    torch.profiler, after every frame has run
  [preview-trace]   one 1080p shaded preview under utils.profiling's
                    device_trace: wall, device busy time, idle share, the
                    costliest kernels, a Chrome trace
  [imports]         every module of the port imported, and no module of
                    JAX or of the JAX package loaded

Needs a CUDA GPU and nvcc; fails (non-zero exit, no result line) without
them and on any fault.  Every kernel must agree with its plain version on
every live lane.  Prints one line per phase, then a JSON line of the
kernels (launches on the main paths, error against the plain version,
times at the main paths' shapes beside the least time the card could take),
the card's name and power limit, and last {"ok": true, "device": {...}}.
Kernel times are given twice: "ms" is the CUDA-event mean over
back-to-back calls of the wrapper (host enqueue included where it is the
slower side), "device_ms" the device time of those calls by torch.profiler
(kernels and memsets, summed, per call), taken last so that no frame runs
after the profiler.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from mc_path_tracer_tpu_torch.bench import bench_camera, build_bench_scene, card

WIDTH, HEIGHT, SPP, DEPTH = 1920, 1080, 4, 5
RAYS_PER_SAMPLE = 1 + (DEPTH - 2) + 2 * (DEPTH - 1)   # bench.py's 12
CHECK_RAYS = 16384
CLOSEST_RAYS = 65536      # one block's closest-hit dispatch
ANYHIT_RAYS = 131072      # one block's fused shadow + visibility dispatch
CROP = 64
AREA_SIZE, AREA_SPP, AREA_DEPTH = 256, 64, 3     # config2 as configured
STREAM_RAYS = 2048
API_RAYS = 65536          # [api]: one block's primary rays, twice as many any-hit lanes
# the configs' triangle counts (procedural stand-ins where assets are absent)
CONFIG_TRIS = {1: 2304, 3: 4096, 4: 13826, 5: 96770}
CONFIG5_SPP = 4           # config5's 250 spp cut to fit the run's time
GOLDEN_RTOL, GOLDEN_ATOL, GOLDEN_MEAN_REL = 1e-3, 1e-5, 1e-4
GLTF_SIZE, GLTF_SPP, GLTF_DEPTH = 512, 16, 4
GLTF_TRIS = 2 + 1024 + 12  # floor quad, UV sphere, lamp box
REUSE_LANE_SPP = 2
PROG_W, PROG_H, PROG_TILE, PROG_SPP = 384, 128, 128, 4    # config4's frame
# (config, golden file, (width, height), spp, depth, share of pixels within
# GOLDEN_RTOL), key 42: the JAX package's CPU renders (tests/test_golden.py).
# config5 takes 0.97, not 0.99: its glossy metal spheres (roughness 0.08)
# and 256-texel-wide environment turn the last-bit differences of float32
# sin, cos, exp, log, acos and pow between XLA's CPU code and the port's
# libraries (tools/libm_drift.py) into per-pixel differences above 1e-3 on
# a few percent of pixels, alike on the CPU and the card; the frame mean
# holds GOLDEN_MEAN_REL
GOLDENS = ((4, "config4", (16, 16), 4, 2, 0.99),
           (5, "config5_96x54", (96, 54), 2, 3, 0.97))
# train steps ([grad], [grad-check], [train]): the seven gradient tensors in
# jax.tree.flatten order of (MaterialGrads, directional ls, env tex)
GRAD_NAMES = ("albedo", "roughness", "metallic", "fresnel", "emissive", "ls", "tex")
GRAD_BENCH_SPP = 1        # the bench frame's 4 spp cut to fit the run's time
GRAD_AREA_SPP = 8         # config2's 64 spp cut
GRAD_TARGET = 0.5         # mid-grey target radiance of the [grad] steps
GRAD_CROP = 32
GRAD_TOL = 1e-6           # gradient gap, as a share of the largest gradient
FD_EPS, FD_RTOL = 1e-2, 1e-3
TRAIN_STEPS, TRAIN_SPP, TRAIN_SCALE, TRAIN_LR = 5, 4, 1.2, 4.0
# [sharded] / [multiprocess]: two shards of the card (render_sharded,
# make_train_step(mesh=...)), and two processes on it joined by gloo
SHARDS = 2
GRAD_SHARD_TOL = 1e-5     # sharded gradients: only the order of the sum differs
WORKER_TIMEOUT = 600
# [sort]: bench frames per sort_rays setting, in turns; the mid-frame block
# whose dispatches are timed unsorted and sorted
SORT_RUNS = 3
SORT_BLOCK = 15
SORT_CROP = 256           # the replayed step's crop: one 65,536-pixel block
# [images]: JPEGs written by PIL 12.1.0 (libjpeg-turbo 3.1.3, the imaging
# package the JAX package decodes with), and the kinds PIL cannot write by
# tools/jpeg_fixtures.py (arithmetic-coded, lossless, YCCK, with
# tests/test_torch_images.py's writers): the base64 of the file, the
# SHA-256 of PIL's Image.open(...).convert("RGB") pixels, and the size
EMBEDDED_JPEGS = {
    # 128x96 baseline 4:2:0, quality 85, a restart marker every 4 MCUs
    "baseline": ((
    "/9j/4AAQSkZJRgABAQAAAQABAAD/2wBDAAUDBAQEAwUEBAQFBQUGBwwIBwcHBw8LCwkMEQ8SEhEPERETFhwXExQa"
    "FRERGCEYGh0dHx8fExciJCIeJBweHx7/2wBDAQUFBQcGBw4ICA4eFBEUHh4eHh4eHh4eHh4eHh4eHh4eHh4eHh4e"
    "Hh4eHh4eHh4eHh4eHh4eHh4eHh4eHh4eHh7/wAARCABgAIADASIAAhEBAxEB/8QAHwAAAQUBAQEBAQEAAAAAAAAA"
    "AAECAwQFBgcICQoL/8QAtRAAAgEDAwIEAwUFBAQAAAF9AQIDAAQRBRIhMUEGE1FhByJxFDKBkaEII0KxwRVS0fAk"
    "M2JyggkKFhcYGRolJicoKSo0NTY3ODk6Q0RFRkdISUpTVFVWV1hZWmNkZWZnaGlqc3R1dnd4eXqDhIWGh4iJipKT"
    "lJWWl5iZmqKjpKWmp6ipqrKztLW2t7i5usLDxMXGx8jJytLT1NXW19jZ2uHi4+Tl5ufo6erx8vP09fb3+Pn6/8QA"
    "HwEAAwEBAQEBAQEBAQAAAAAAAAECAwQFBgcICQoL/8QAtREAAgECBAQDBAcFBAQAAQJ3AAECAxEEBSExBhJBUQdh"
    "cRMiMoEIFEKRobHBCSMzUvAVYnLRChYkNOEl8RcYGRomJygpKjU2Nzg5OkNERUZHSElKU1RVVldYWVpjZGVmZ2hp"
    "anN0dXZ3eHl6goOEhYaHiImKkpOUlZaXmJmaoqOkpaanqKmqsrO0tba3uLm6wsPExcbHyMnK0tPU1dbX2Nna4uPk"
    "5ebn6Onq8vP09fb3+Pn6/90ABAAE/9oADAMBAAIRAxEAPwDT04HbktuIxilvdoTC8/3RjpSWAJCZUgn05x9Kddkh"
    "Tt6nnkV99L+OfkK+A8rvc+Y2CCc9elFk2X3jH4Ci9yxJwRuOOQRii0yWDFsEen9a/Hf+XJ/Y/wBs9VsyMckHAxxw"
    "DTL7JBPbHTHIx0pbIqRu6Z75/wAKbe5UMVbGRkCv2Nfxj+OH/DPLb0hCwAPHQk4NS2PD4BG36VHeD5skZ5xwen+c"
    "07TsuxUL27exr8bl/AP7HX8Q/9DWs1wg6dBgZ4FR3ykkkrgcg8f5/wA5qW14QMSCTxjGKhv95XKjJx1HQ19/T1rH"
    "5FL4Lnlt2AWIOD2zwKmsMb8ZKnPQVDc5MmCMAHjP9P5VPp5+ZcEj6HPNfjdRL2J/Y0PjPUrPd5Q457flVXUAEUke"
    "nOeTVu2HA3Hk+vOTmqmpbTGeACOhBr9kpfxz+OJ/AeXz4LZ6k88HFW7D7ysG4zyM96pzjEgUL7dTVzTeu7gAfn9P"
    "pX43X0pH9jw/iH//0cCyJSMNgY7Yp14rBc9h2Jplnzg4zgcGnXg+UjGRgf5/Kvzh39qfvq+A0rvO8k8445FFpuMv"
    "brwPWkvsGUgkep4oswN+WwG9OvFf1V/y5P4R+3qZ1iMqOgyDn86S/wDunaBnp1H86Wyc7QOnHJP1pt4Pl4+/2UCv"
    "5VX8Y/u56UzSvRgsGPTk54xUliMuP4iT0NR3YVXIGCP7o/nUlkcknAx/Ov6pn/BP4Rj8Z//SwrQ4Q55J6e1RXobB"
    "y3AHr/n/ACKnsvudcZAqC+IKHjp71+cQf74/fJX9maV426QnByB0PTmrGmjDjr7/AIVWu1O5iMYzlscZqzYZ3K3Y"
    "HOSMHFf1TVX7k/hGPxmZbkhQTxwSM9f89ar6h8wbADd8ZzirNoCYeduPxFVtQJVW55Pc1/K1J/vtD+7pv92aVx/r"
    "iecDnr1q5pwBwDgkc5Hv/wDqqnOMPnk89e1W9PUAggAbj361/VFf+CfwlT+M/9PTsicYKjJ7cdKfe/dJwcAfxd6Z"
    "YZPUYxwCe9Pu142jA5zX38v4x+QJfuzyu9LBm4IAOSBRYkkrjPPP3aS9IBJJ79T/APX/AAos8D5huBznOP61+Of8"
    "uT+yPtnqloSIMblx1+lNv8gNknpgnPFOsCAqhcc/ezzSX27YQSc9vw/z+lfsauq1j+OPsHllzt3j7/4Y59afZD5+"
    "P4uoqO5QmfbjHp64p9hgMcjAPoea/HJ6UT+x18eh/9TXs22ouTkYGSP8KgvwcZ6deOvtk1PZkGM5I6dx3qK++deo"
    "wDnJ+lffw0qn5DL4Dyq5J849Oehz1qzp3BXqfrmq9xkcEDPtzxU9gPn5xjgelfjdX+Cf2PH4z1Szz5RwucDOaq3/"
    "AEJHPPGP0qxb7dhGBzzj2qtqRwMe3BA4r9kor98fxxNe4eXT8M3pnPTmrVhktkAdu/8An2qtMW39Fxng+gqzp+Sw"
    "yfQdOD+Vfjde3sj+yKfxn//VwLFzs3gjaAcAjp/jTr7GwAk9CSAf8+tMsEGAB16nOKfetlOmPYV+cSt7Y/fF/DNG"
    "+BJPOCc8ikswPNGM5wBtPalvF+YksM5znFJaY3EqO/HFf1StaJ/CX/LwzrIZjDbsnORx0pLwfKSQCMc4OM06zLFA"
    "SCTjOO5pt9t2kkdB+Nfysv4x/dt/cNC8Y+ZjIz0JIz3/AM/lUlnw4Gfwzzio7rAk64OexqSxGGz17Hmv6pl/CP4R"
    "jrUP/9bDth8uVGRjsKi1IZQ/dz9fapLRCRgcY9RUeoKcc9B3z/KvziH8Y/fZW9maN0R5jDPPp6f5xVnThypPQjAN"
    "V7kjzGOenPTmp9OI3KGHUYxnAFf1RU/gn8IR+MzYOYTxwOc9PyqrfjKnJ+YHnnPardthgoOAR6nr+tVb4/fU4Py9"
    "QOlfyvRf74/u6X8M1LjJYsvXv3xVnTjhsYHPPUVVuf8AW9wOn/66s6ePnXGdxB4Nf1RW/gn8I0/jP//X1LLBiw3J"
    "IzilvcbSo/HP6cUmnsCMHhSfUcUXgbZsbk/Tivvn/GPyFfAeW3rfvDx05GCfSksAPkUfNjgc0uoYJBB/An2o04Hz"
    "Bv55BBOOmK/HE/3N0f2On756nafKgwck8E+3am327YSq5BXkmltAAvXjA6U2+Y+WxJIzx0IzX7Il++P45+weW3WN"
    "zMfl7Gn2AIbPUD/P9abegl9oO49B2p1icvkZAOe/vX45L+Cf2MtZn//Q17XPG3g4zmq9/wAxkheo4BPSrFmBtHDY"
    "GetQ32PLKknHTHevv4fxT8hl/DPLbr74IyMk+341Pp+FfIA4OfXNVrsEy4xkZzyKtacPmRcH5jzmvxur/BP7Hiv3"
    "h6la/KuAOo/r0qrqDgA4wPcVatsbDnPPB6Z561V1AjbhsjJ654/Kv2Siv3x/G8/4Z5fPw+dv1FWNP4YAuAp6Y9aq"
    "3Wd+7lu/T3q1pm7Knv2Ffjdf+Cf2RT+M/9HAsySijnFPu+Uz27gfyqOyHy7skMMdCP8A9VOu8mMnaOMnHY1+cP8A"
    "jH74l+7NPUNzPweBjHcf56fnTLMZZeMEdcU6+yGwOeRz60WZO8YYgq3OK/qlfwT+Ef8Al4Z1lnC4ON3OM029H7sh"
    "c9OQetLZZCnr93H0ovCSG5HGCciv5WX8Y/u7/l2aF0TuznkcE1JYKOpfg9Ru71FebQ5wSecYJqWyBDZ+bGAf8+9f"
    "1TP+Cfwivjsf/9LCtBtBzjPfNQ3xG3aAAfrU9kGKZwQcZI/pUOo7tpzn8a/OIfxj99l8BpXQw+MbSeGwf1qxYgiT"
    "HTHeq95ksdvByeM1PpwZWU4GD2B/Wv6oqfwT+EIfxDOt3zG25Qp7D0qtqTHaWQna3q36ZqxbbfKzxgdSKr6hjZzx"
    "gGv5Xor98f3dUt7M0bnAdifXr/n6Vb07hgeAeMVVuR+9zlR26dKt6eu/HAyTjaPX/P8ASv6orfwrn8J0/jP/2Q=="),
        "6eb71e2ba7ef4c77d72bba218502f30e303e564e5aea744ba839a4191506b60c", (96, 128)),
    # 112x80 progressive 4:2:0, quality 80
    "progressive": ((
    "/9j/4AAQSkZJRgABAQAAAQABAAD/2wBDAAYEBQYFBAYGBQYHBwYIChAKCgkJChQODwwQFxQYGBcUFhYaHSUfGhsj"
    "HBYWICwgIyYnKSopGR8tMC0oMCUoKSj/2wBDAQcHBwoIChMKChMoGhYaKCgoKCgoKCgoKCgoKCgoKCgoKCgoKCgo"
    "KCgoKCgoKCgoKCgoKCgoKCgoKCgoKCgoKCj/wgARCABQAHADASIAAhEBAxEB/8QAGgAAAgMBAQAAAAAAAAAAAAAA"
    "AQIAAwYEBf/EABYBAQEBAAAAAAAAAAAAAAAAAAYHBf/aAAwDAQACEAMQAAAB6JDrHc2ZDlH0UhRzjNkE5R9GrKjn"
    "GcdLDlH0VdlaOceYRB9O6JI9lVAkBVW8gvZVQrKCqvQ9bvZVzpYgKq+sRGExzskOUfRQhHOM4Qxyj6NGVHOM5YjH"
    "KPo0etHOPMII+nXyF7KuYxQVV6GUvZVQrKCqt7qzyVc9dtYOq+uVZhMc5ATlH0UIRzjOMrHKPoQyI5xnnrc5R9HX"
    "ZWjnH//EABcQAQEBAQAAAAAAAAAAAAAAAAACATH/2gAIAQEAAQUClS0pUpKVNQxbFKSlSkpUpLFpUrsp5SkpW1LF"
    "oVykoU1CVKQxaVKSlSkJ5Sks5aVK7KVcpCVNSlaVKSlXKSlbeyxaVKSlakJWpCeWlXKSlSksUpKVpUpKeUpCVqSz"
    "lv/EABcRAQEBAQAAAAAAAAAAAAAAAABBATH/2gAIAQMBAT8BioreK3iKiozreIqK3jOt4ioqK3iKit4zreP/xAAY"
    "EQEBAQEBAAAAAAAAAAAAAAAAQjIBAv/aAAgBAgEBPwGkqS5p3LzpSVJU7l50pKkuady86UlSXNO5edKSpLmncvOn"
    "/8QAFBABAAAAAAAAAAAAAAAAAAAAcP/aAAgBAQAGPwIM/8QAHhABAQEAAwADAQEAAAAAAAAAMQAQAREhIEFhcVH/"
    "2gAIAQEAAT8hOFOHEJThl36jgwnoZ4Fzlf3HjA9jf7av3LH8wnOMIYOfEI3H2WDLHnjAhz3K79wvvKWBlnzgbl53"
    "ceI4/DhEn1OEc/ec4bHjltOvDycsC986B+CDc7xn9kr9xyp4PkcOeBuHt07hfaU+8vHF/9oADAMBAAIAAwAAABDO"
    "wNn9lecVfH8GM2S3gqVMOCeSuf4smcH8Vf8A/8QAGREBAQEBAQEAAAAAAAAAAAAAARAAQSFR/9oACAEDAQE/ECwk"
    "O98MQcMc9QFhAoCsxwgMJHMRB//EABkRAQEBAQEBAAAAAAAAAAAAAAEQACAxIf/aAAgBAgEBPxBoeJDQ4VDAxi+4"
    "GBjwoc8z3GAwf//EACQQAAICAgICAwEAAwAAAAAAAAERACExQVFhcYGRofDBsdHx/9oACAEBAAE/EHRoNJzA7enG"
    "P+GpYEMRhoWhKkDbq4LsizozFzWtQh46McNZIsETKUw/mBYAD4qEWOHAKG8wcBV5GpzUMl7lnvgu4AfL5h0DqkY+"
    "iAzALVFa31H6DoSrbOCYRsUT1D/gq4NRDIFfviKgNdhT6nFyxskkwwWIEZcMsMVAQEnGZUFqO45RgAHMqtMOEVtu"
    "Ia4XM898wwL32/iWGh0P37ECwLPk3EAZL54jJh8QiKc4lCURCGYp1KnQoeJzEwhGUpFXDCAGkcwLG2/xhAkQKFNQ"
    "i104XK9mMiQitGVFeKjooE04JY2hqEVEzTjhGB9mYEGh8RgZJFTAck8ichN/vcVmERpwHY2YRBY38fswDqURO8Zi"
    "K2NBQTsVuZBO2YCUpEtQ/WpmehCvBb5uMCA8anv4lTp8wRRspiCUtnNy4sE1zABZNAWYJGPcAEE8c1DZn2ZgAoff"
    "mGC3oAxABB8ah2yXmCwdljuOsmvuGCtA6gFixMmWSUnF6P7gChvzmBV67mh4FXAAuv8AcZCQw/mKgi/f8jUuqSzG"
    "8ua9wsIZrGY5C1cenDKiOhEJFgbcJMT9R2Jrm8TDBO7gFnRS8RALLA7XqLQLru4AJCC2xuUBRp5qPcMh1qDeTNeY"
    "SZgnQjEGxyJxFqiYSqL86gUEH1EsFClxOHAhUQgO+ZkaeYJAhA3U/wCDmYdc49wwPiZrOfiWEEBRAAIyMzWQieOI"
    "aDB3mCgBBKzc0CVkz//Z"),
        "bdfe84602e1d825e267a60b3556dbbc7467ac5dba16b8e299fdb973a5874a660", (80, 112)),
    # 48x32 SOF9 4:2:0, DAC conditioning, a restart marker every 4 MCUs
    "arithmetic": ((
    "/9j/2wBDAAUDBAQEAwUEBAQFBQUGBwwIBwcHBw8LCwkMEQ8SEhEPERETFhwXExQaFRERGCEYGh0dHx8fExciJCIeJBwe"
    "Hx7/2wBDAQUFBQcGBw4ICA4eFBEUHh4eHh4eHh4eHh4eHh4eHh4eHh4eHh4eHh4eHh4eHh4eHh4eHh4eHh4eHh4eHh4e"
    "Hh7/4AAQSkZJRgABAQAAAQABAAD/yQARCAAgADADASIAAhEBAxEB/8wABgAxEAL/3QAEAAT/2gAMAwEAAgADAAA/ANKk"
    "LK6JguEkQGxtwJ3D5HtpeBy3yoJiGfn+x3mkM7tiLRnQm+87POOOjj5GtxKp37/ZGqjnA2ApuqEin+3lvXABfeDxco/W"
    "qKi2SoB+5e1OD6b3uQDqLAtesRRJms2HKi8P0e1BZYJzYRCyJzGFnKGn0NRyifb4lDkx/wDgMv3iBet07w0YbO7AQyvN"
    "dxPgX2sqlPGF9Pcqqac/q7R6LfweZ5pfiv21E/8APigEDX8HpdOZqepm/K/UJz3kfQ5x8h8KStG0iYJkXE8fapizwn0j"
    "bJ2oWWoWHDVJ1Qkdc3ezeyT/AJ/Loyaos3bDkBlDA40GKlt5dfgNkFUqy50A6m1LF8q5cL1vk15mLakLCyBsFZZJyBnJ"
    "6r3W+5P1nB6h0MGsus641fX84AStktGdzSmGRsbbl1H1JuHi/wBroTaTJDYfej1IAWUp0N3pHk8r181HrwPDynruBeXY"
    "ZygrQb+qdsVvWSW7tiQfEHFJthrSLgZS0Oc4JANQEIzJ+HtTR5knVQ+lhosmj5+8rPBHIVj/AKpTDuONMgRsgvDoZSqh"
    "1OYashNdOvLG2qiFx2toH2ShM8Eno/LA/9D/AM/ziLzHlC8QSJRW4f8AbhQ6v996G5zEEHcXeuRvzeViy93IBcuPc7kF"
    "7KWtOMwAqFQNOShI8zboWP2sgZDsZxZ/BFiw0q2XocqbMnMb3Ggdjn8oUlaOWoPO+0rwCntIwX0WbbY16OmlDbiagPRA"
    "K3+LuIp9Sesyg2VP6JTGFOBOFcXpDWN8yamFaFW00t1q7aMachHmvbPjQAhyZ5nDaUFET2BVN3bEz3ImeTVpcVVSJ5NT"
    "4m0uy70KUFwOosFTXpazvPKnk1T25wuT4DU2/f1gQFv3BSBrdCsZWRANZyHDFzWBxFPTK08+qEbJTDnhat+hWjTsQP/Z"
    ), "1895283d55d2081e410619482f2724f8f09251a43ec8397ef4b1a8d20162878e", (32, 48)),
    # 48x32 SOF10 4:2:0, spectral selection and successive approximation
    "arithmetic_progressive": ((
    "/9j/2wBDAAUDBAQEAwUEBAQFBQUGBwwIBwcHBw8LCwkMEQ8SEhEPERETFhwXExQaFRERGCEYGh0dHx8fExciJCIeJBwe"
    "Hx7/2wBDAQUFBQcGBw4ICA4eFBEUHh4eHh4eHh4eHh4eHh4eHh4eHh4eHh4eHh4eHh4eHh4eHh4eHh4eHh4eHh4eHh4e"
    "Hh7/4AAQSkZJRgABAQAAAQABAAD/ygARCAAgADADASIAAhEBAxEB/9oADAMBAAIAAwAAAAHSVm9mPhSKEkBxAU6c1gMj"
    "2I55bV61MV7Mmconk7ulYc3SPPXOs1j/2gAIAQEAAQUCF76/0zznBZEAciLOIXuNF/zjCIV0p/m1P+4NUpVC4dsE6rnZ"
    "7DQusZlqaOg5mNIGF79DH3O/kP/aAAgBAgABPwEVU3aOVdBNHRZNuhIRb7CeNO/5aP/aAAgBAwABPwE22L/ehz5byndA"
    "cBiUXWWEGyVmjh1LmeypnCe1oP/aAAgBAQAGPwJPGZd4sqYrrWrWm+h7hvVC/IPzIin7OMqzwiW/+ioHXwZXXqQuU4MW"
    "Y+rYev/aAAgBAQABPyG0hy0MZm4l7OxZwYDmpDt49UP6XcRlYgyVRceFRylrNt4H4bBCfKOTQCcSJq0EfJQPHWehj0oU"
    "eFRTIs9ifBgdjFpEbrfa8zpmP+IJSiL1j0yZsC/I9OVYHgshPQOTmx9Z1DktprKPdobN9AwaxJp+CxO83MpRXydO6cD/"
    "2gAMAwEAAgADAAAAEDM0xwMw/9oACAECAAE/EA5UyH0wAAA42ifto+odO+i2/g/GxPX/2gAIAQMAAT8QGiUVV6i2Y0f8"
    "P+OAJPBcJLN5WKYMfesY/9oACAEBAAE/EJEiXWhHXXfePbrKRO6hnOHAGgHvzlafGyvoNGLAU+RTw2I4tZdC9jMYBlfh"
    "/UaVOIDV16A2C2Gqpg3p3jbrtkX5ysRp7egDxjwJPlncHldLbORN1HJ/mSJMaCH1vBrNkEToHN9RKsxj1gR7re4qMiSp"
    "cqgz7zwJXpKbA3+PqlK5mzvd6QAVF6DafQmEB1DqSBKKp2KNadZQnfkavvZL6EssDDAaoH+JLwTsHrxPYCoUzuWYqLlg"
    "wA8xjqm73eZFjdzGY8rfMWUM2CtULGDJb7rs9t9dS4F/Q3DElSzDywIBPUN1zH7af2pShHO8uV3UnY/QQCvrst4DmcEB"
    "YHea1nt9Bvp2yLK8YhWA/9k="
    ), "1895283d55d2081e410619482f2724f8f09251a43ec8397ef4b1a8d20162878e", (32, 48)),
    # 48x32 SOF3 RGB, predictor 4, restart every 8 rows
    "lossless": ((
    "/9j/wwARCAAgADADAREAAhEAAxEA/8QAHwAAAQUBAQEBAQEAAAAAAAAAAAECAwQFBgcICQoL/8QAtRAAAgEDAwIEAwUF"
    "BAQAAAF9AQIDAAQRBRIhMUEGE1FhByJxFDKBkaEII0KxwRVS0fAkM2JyggkKFhcYGRolJicoKSo0NTY3ODk6Q0RFRkdI"
    "SUpTVFVWV1hZWmNkZWZnaGlqc3R1dnd4eXqDhIWGh4iJipKTlJWWl5iZmqKjpKWmp6ipqrKztLW2t7i5usLDxMXGx8jJ"
    "ytLT1NXW19jZ2uHi4+Tl5ufo6erx8vP09fb3+Pn6/8QAHwEAAwEBAQEBAQEBAQAAAAAAAAECAwQFBgcICQoL/8QAtREA"
    "AgECBAQDBAcFBAQAAQJ3AAECAxEEBSExBhJBUQdhcRMiMoEIFEKRobHBCSMzUvAVYnLRChYkNOEl8RcYGRomJygpKjU2"
    "Nzg5OkNERUZHSElKU1RVVldYWVpjZGVmZ2hpanN0dXZ3eHl6goOEhYaHiImKkpOUlZaXmJmaoqOkpaanqKmqsrO0tba3"
    "uLm6wsPExcbHyMnK0tPU1dbX2Nna4uPk5ebn6Onq8vP09fb3+Pn6/90ABAGA/9oADAMBAAIAAwAEAACn6b4B2cyYnVEv"
    "K3uq6yHGgudfyeX0WdY5Du9a7R6NvP4ezFnQ9RRtweleeZ3I+kZyc70mzy2zlbGbZqcbY5xK2N2ZjY930jqr3lZLz2Fz"
    "HYl/jOH9Al72HMxebsQzRareez97tOmzqOd1OHpZenc6LI5zL9Cwo61q3Foc30VvSoVb/SQ6j5770xtDAxs7e1+k7KTj"
    "+cjf51b6ju8bD4vQmjh1/QOky9XHwvN71u9wG/odrmzc/LQ7Tzqj5j7V0PpniNfM9L5ni+pp91ylyHK9FoxRdVkc9ld7"
    "oVfNfKZvSOty9n0P0/jPMK171LyOz5Xp43oOhdmp89znQ9F1tLB8ddreocv2cOnjRZuv0fO85nvs7fS2cjfxc3L1MXMy"
    "eis7Y2jk0Oq7nsYsDn8/gW9h0nR6PQZ3n9dPRI4+TSY2+O8+4Xp/fe7weT87TmduXG7LqE5Q9A7TlfP+Lb6Jva/kG9rb"
    "HN6POvqTYWR6bWqTdHLxlqfa6LCyOI7jQ4XB531PkOpr9lzTW+k8rucluV+tZz+Zm5GX2vRWuCoUtnQv8Liw9p6kWa9v"
    "nfN4JE52ToOw6zV2OHxKvVcvJJ2/mXMXe0kzOptM8Sq4Pc7fVdflanmlDjfVe0p+T+Q+i957DwtTk9DG0Ot25eVucdZ1"
    "+yxMXzr0Ln+0wUy4+qv5Pm0eT6PV3+1sdP5r1XHX+WklzmcLndd1V/zKrt2Iam7rVOdt6XovH6XC6HN7VrudDe8o6Di+"
    "257V57sr9LG6HfzPL+HwO29I9JzuB43ovQdPoVg8WyvP63X9Hu8Zegik6i66g3FwW2PYM7oaePzlG3xtDtOs8x8y7r0v"
    "0jyHH8p62r0Ca3V1cB0nZ8Jb830s6fp7npslPn8alX4fW6DpNbNn5rzbYx9jC0cpnR7Wnmd3YZldSmHDh3+P6xJOkSj5"
    "Q7c79MepvY2X5x9DZXd+O9PL0XnfnXG693qei9iycnxmxz3VbPe4/n2XYsR+udV1HK81g4qXd63lppYdfO9E2Mivn+gy"
    "ZfE8ztUvU4ZsPLr+fVeg9q7Ds8vlvMucvdDty4+FS0bV/heZxte9tTGb6L0VTk27uVh5Wr3dnl8bI6Wv6A6tlc9b890s"
    "HsM3s38xobvvHL+Vcg7Wuxb2RndFiTef9FQ9O8q6XnPWOHzMXre7i2uT0eV5lmz1ldljZzYta7s59biuX6Cp1PLegZNN"
    "tWzwWxu9DLZ3Zuq4viuHvafR5GLzV7T2e/6CPz7hsvYhzOY9I7LsfOsGLpejy05votT0jHx/OMPq+ob5FgXPQ9zG2+P7"
    "GTE5jm9jqun7HO5aXOI+uxMfzbsKlneS95Szprdfc0jRfP5N3m/e4jJl0Xd3y+di19693vNcbwfa9T61i0vOq2P28215"
    "h1OJb5rQ1uT9K0/ceEwuE43p+xucd5bmWszOgw+yz5c3V0btm1zFDG6SXTdsVOazu86blfPcHvr0PIUqXRddXm5nU42J"
    "lK27X3e0JOGpcXzlfS9D9g1sHxLJ7Ctg1vTNrzvZf2PkO7vWkwZub2ey6zg2YtPLZ2NPA9F5f0Tzy9yXK6/a7voPN8rx"
    "mf6t1rbfA9NymtzGBzPa9P6hymZiNdiXsNcym/U7roeUlxu4t59D/9DvOZ8Zd22iqazeK47Ubf2elIVz83S2E0tdvOVY"
    "NCjgY1W8XtF7ONb2du5h4+fPk2pFoPzqXSQQ8HQs2uO6Of1SK/59SnsYOPjejaKzri8d0HX9CmNfp2MPo9iXMy6E7et5"
    "+x5xqdTo9ZL0WdtcdwFno/Q9fGxuf6Pe9H5KN2rsakWTyl1d2lF12rs3dPFm4DOtXdnK6bSsZORzWdp602zbikmpZlrS"
    "xufytHv+qv8Am+dxVLS2tDSr1eL7novSOe5PHw+koOxbuVXd6rZ0s7S4qLMdibmhLx/oUvReRZ+1z0vUd5F5PzFno62r"
    "jdf5VF573Ox6bzXoXm/fcz67tOx/N7HnnQ1e56qLnuE5ft7/AKHzOX4nuWe/5/Rytip6Rgx8TaZQpU9GGxhwGfe5XqKv"
    "RWakmpoTcMt3m4PPu8uHIQdVvpp8lm53p2v2/L4nPYfK+d9L6dJVodZ1ep1PHcxidBkW27tfUxObyfQtDy7z/qO/6/DM"
    "LTjkyr+oU62WtXdj3M30Dzx/F9rk9XzXqPkPU8F1HNcjmVO56PQbnalLpsJK1nVhpV/Sd/L8zrVri9ZkXLnRrq4trgtv"
    "O08WlDvMhj6CPHt79fHxLeJzHZ2+68azaHYelbEfM8TdwK+dn9gnpWR1mR3fmOLUscdym1Q6/n/cOV7mlh1amNx1nt9f"
    "mq2v2PF6HB+tbu5wXTcv6H4Xcxpeiqbc1fTqGdL6HYfmRdd510/nt6fra8tHreI3fMJeK9L5Dq+b6Rl7d45+Bt7eJpee"
    "+j81s8XDwWj2/UVaHYcTgZXsfQ7VHOs8Npj2UpuY5Lo+v6fO5DKytzW6Tms2rr73E+g+kbMnjmj8+XqHrFmblPMNb1bv"
    "cM857jzj2rw7fw/XU2m8n57Nuadyh2XlPZeQ9x5v7f5R615R7dS9Fr+eZN3UwOVtbEXV811UmhT8ZMbvdbbfa42jwPS9"
    "L2d1Fz6WrPyWJzfqfVTee8d6CndcP23Ib+b0vNcTidFLS6xkPnXOx4XZZnoXHbPH7ujo7W0O5fV5+9Y3LORzcGF3Gp6j"
    "515559Q7bo/Y7fKYXnfc8x6vwHNwb2xg6Wf5Xpb3onD9BB0Kd/U5LMqelYN3x3dZ03O9NW6bgq3KT9tH6PxHX0YuO4y7"
    "fjmgop21/Qht8rzerp2Oeh3LGx5103LdtZ2MnMzMa1o7+TdyGwrM/X6TVz+D5Rc3K6/tvXOA5v536Ox32foZfDRLucfz"
    "HQ836h1HqnmPA8F6B0vpnnvFc51fXcvbztSCPtcT0Lyb1/x/sOXuycd02T2O9cTh+b4W9V7qb0bmMOrl2O12W+Wx6HXJ"
    "yG70XZcpj5fIdDn9JzHZen9PmcHW293J5uexgWtfXp8/ZqO0HJnw9/zr/M9Pfsa/mGvqavJZVep0Wxv53m2SvQ+n3NWC"
    "zzPCeh9R7n5nj+cnRegP84yNDq9CGbleVzej7iLluUoRbVpef7XqLvn3F6WzU4Pv7vpfFpk0L7bWtuR26+5g4nQZEnj/"
    "AFV3RynR9nD6inN+G4Hofp+BwOLr+r9Vs85n8zzPF52v3FmvztmjvbnX+Wee6e17DyfpXIVM7ntqjyyYfrFRbWf6Hn5v"
    "G9XUvYepWoWtnWmyvL63/9H2HzziryU7eXW5S5ezc/jL1iSvV6OUxr2x1vJ48WVoZvJXut6HP5nVlr+epHxbtWbmadvX"
    "65uXX29TL850c/o06elymbShZDtWben0GLzvK9fJ0Gx1DsirvdhBV24amTlQ7/d6GTnnScHb2++i09K2vLy4+c/c3rO2"
    "kfD8zn9reis5me7odnlI7+7TSvyfCt7z0dLHM38XTfv7eR5+zS2N230uh5Ty3jHc616aba15eY5NvXYXPSdhHZ3+gwc6"
    "7Jq8YkHV8x5lL6d7FWTy3N5nvN4q6G5fs5MfmK9P6Z2XO8pzGBkXOw3OU8uwDd259LoO5u+Pcnu6uVlelaHLYF3n/K9b"
    "ou/r+j9Ld825bg8DS6L3bosHyHL6jrul6HH5GDprGfyKS2tFK3OcVkWPbV1vHd3G75voy2ud838+4i36J1npmPS1n1cr"
    "boY0D8Hm33E7aXd4bT1J7/nW3k6ur0fY1sHhfNef2e43uQ1NDt4LFfA5R2tmS5m3laebf6F9Lz+Hp7/S891jeu8x5vlP"
    "V9LP5jYrybHo3K8rQ9R5KjiZvGcrD603sr/b6vE43ZdCzE5SvraPb+ex+TYWJ2WzrQdRzKQX73n9+r3vBS8zvzv1+gj0"
    "cyxSpLldXgZ/E3szINXqvQq3oNfovOeSrMqY/fddf5jnuj5uXn8/lI/UfYNPy7kL2jzFPmnWfQu7z4snmucs9VoYHTY0"
    "eF0HbdT1eNS8nx+J9XuT+Z9dsdUy7ueK8Pmep9s2vzmFu6vQc/j9LcXyTmcL0Knq42ZnaWh1Pnnay+x1djNXFXMb0O7p"
    "35r3IV9Xc7jluM83xKEHb9X2nO6nFN84j6Xtbmd12vH55maNzl6+l2GvHvc7w/A9Nr6fCUpOh6PZ6bR4WLquo5jkdGr1"
    "nIT+PaXV9v3OlueUcLqehW8LGmxeb5K/BuTdrpZmJpdbzedgdJu1ug47EzNbtu22q3A1qWxy3IYF3o/QH8fzrdnffq+f"
    "8Ytjcq7OXnvj9Om7XyblfLOYqdj6X18WRxVTpu0r6FzgsTE9Po9hmHGyO128e2z7Izo+X38TIocx09P0DiKXn3RN6Xq8"
    "+Dy2S/T63Ov0+s6TLOFs+bdtN0Gbylnc7bW88TzrYq9/6Lsu4nqOexcvcu4mPasWOgysbzzUk9Q8y3PF4+c9V9X6GjiU"
    "LUb+V4Sb0fpbKXuf5CfR2GcrzeRo3OfizaXM6Pe950PO8LZw9Pm5er2bnHYef6Dk7XkPWcv6zL0nnNG3q3auly/K5Vvr"
    "XXcdacmRv0O2qdZdwum5TuePxM/G3psXO4H0qTpzvdLH4znOX6Sn2HI7fK9zJ1OFy/OYerj9P2Zyrb+twT7kt3J7al2m"
    "R6FxWlk99k87xF3du81pUOpybFbraFHhewgbksz5Nv0Cd0fQ9QmRFw08vZ0OPfpdTZ5/k39H1Xa+bdZ5Z3Hl8fK9V6B2"
    "Seex9F1nn3msXoWdQyNK/dZSb3fVWsjhvOsLl+u7/wBZ6jl4HZ8zr+VLuQ0+K43H6X6FwbPhvrfMdfy89eLosnpsjV82"
    "sJ6HDqc71mLD5zw2ji95B3Obi5u9STgMWjd9b9D67h6E295jiPnq8vfi17dujSbXZd//0vRW8CySLaqRcVe4dMHqsnU0"
    "sfruDz+H9Qo7N3p8Xjcun2fNSc5gy6DdhmLc6rZyM+LWq87ydb0feTBfpsfkY+budNPNFn7Gvfu5Ol5x3FTp5dDL1uL9"
    "OTqOa2ugkg57oLBzt92d3VnqbdO/xrcro8Ha19uLA6PnNPmJuV0ndpD0uZnRVK2JS6no+bwMvZ19mikVinyOZc6Xq930"
    "Xh+vyd7kbV7l31Owp9jWz/E7NHTmdrW9DqZ35XLM6qHleYs7lXkNLovbd3zHnaPY4tCXmn9j0vEeYxdrc63gFwuv77m+"
    "q4jp+H3sDtMru/HLnA+iWMpuhvXMwzec6LvIuP8AN8XHr+r+rT8Vn8pNd9Cs+Xap0zNzEyOX08jQs7zb896lw07tLiou"
    "hf2PUbWbteXW+P1Ocr7tWbcu+f8AIb/q/Rxed8PDq9fgdBfvcBzDek5m4vodXSxYzYucbndltLxXN7nNa/J9dem7fOk4"
    "fuPSM3hePk76nY4DVo9ZnZ2jg97wW3wPUr2XNw1L+Ocf6Nf9i6zgPJPJ+89L6Onax+bz7PRRmLhNt6Wfcz4X2MmaOG3u"
    "U8TF52DU9D2Vjk4FmrgYFp3S2Ov6vG7WHa8i47E6jo8zna0GZUy+g57q9apZZ6DBFqJw/Ca/TXaNTE17neefXJtrZ5zo"
    "3rx6Wef2bfcQcpVxunjj6K3yXKXMyRN3W5rZzeuvpzlrj9vlO3xJuYt87V6r0zoPMPDU9IuR8130mtvZlbhr/RR5PLdH"
    "1NLTdFi8vV5/Vl0dvsNjk+Y1tTSi3LHPcPk7HoVh/k+/4xSv/Q+Zk5Pc3DlOeq9fdNXqE0qWrwTqOvw3e6G1xsk+XnYv"
    "Q7XbY55ph89v9Vv6XlfQ3e08x2ed61nb73m2DzHdep4Nbl+nyeW6BeizdTkcrP6rXsSYlFbVbNn5eDz/ANI7b0tnJ+bc"
    "1Luk01itmZjOi7q5n2sXE530Dt7/AB0KJk8x1uR2HKa3O0+G1+a7+32fn1zds8XjdNz3mup3vf4vnuP0PsvXc5iU7nFX"
    "6G5zndX6fOx2cCHAsTdv1slnzjnuRvaXb99U4LT7brOC4afoOIr3u453m+0up5zb3t3oc7sH8hieadNyvc1N3jfQcTpK"
    "XTpy/OJW6vm/V8Pq/nan0nsW75TzOfYrbutKnSLjc1ot05snzbnNvua+v610mL5c3MgSleu3fQOTox+l8/4xl9H3Wasu"
    "xXzebt6ay51ncxcm5FJ5z0PQbkHKQs6y/j7kHR8q3Q3sc5z0rkdbAvY/H7ljs8aTL083N5fpr3QwM4rV5Tueb1akjOlr"
    "bXnnVv6Xxvque0sa51FXe3MLS4vseV1q2Tdytlm9tU/MdDrOl5TltPa4N+jq9pD0nF5uLzHl2b1HUd3m9H5vu52Hn2On"
    "v8zzbOp7PS51dDS8zxTe9Cn7LwTmsfob3oGba4/0aHjOG3+pvYb7HpeTy/lq9r0Wbq53f8rneb6HbZfHYPq3U4dDp9jN"
    "z+lu1dOhmKzvfLTyCKp2Fve6zsI8HE2vMd/T63M5Pr+Zx+Wo6FTt9i9h8NseoOqeddfoHGTU9LhqG/BnVO50MPm7Gp2f"
    "aXuR8yydW33W30v/2Q=="
    ), "70c154581238b617840a668824f80b86ab5b8c8570bb96bfa7b4c87019f1f94b", (32, 48)),
    # 48x32 Adobe CMYK (transform 0) written by PIL, quality 85
    "cmyk": ((
    "/9j/7gAOQWRvYmUAZAAAAAAA/9sAQwAFAwQEBAMFBAQEBQUFBgcMCAcHBwcPCwsJDBEPEhIRDxERExYcFxMUGhURERgh"
    "GBodHR8fHxMXIiQiHiQcHh8e/8AAFAgAIAAwBEMRAE0RAFkRAEsRAP/EAB8AAAEFAQEBAQEBAAAAAAAAAAABAgMEBQYH"
    "CAkKC//EALUQAAIBAwMCBAMFBQQEAAABfQECAwAEEQUSITFBBhNRYQcicRQygZGhCCNCscEVUtHwJDNicoIJChYXGBka"
    "JSYnKCkqNDU2Nzg5OkNERUZHSElKU1RVVldYWVpjZGVmZ2hpanN0dXZ3eHl6g4SFhoeIiYqSk5SVlpeYmZqio6Slpqeo"
    "qaqys7S1tre4ubrCw8TFxsfIycrS09TV1tfY2drh4uPk5ebn6Onq8fLz9PX29/j5+v/aAA4EQwBNAFkASwAAPwDxfxrr"
    "kM8zvGftLGXy1lRyGiUuCpPzYfpjJP4jArxw+EdTe1dLSBzuk3KoG4MxPT5UJHCsRkcYJznOPqvUZYo3eO6hgJhgWRfM"
    "l+8AWbPcnlRx69Cea4n+17VZQ0rgYXBOcED15PuM46/z53w7p/8Aad5HJuO2WbfIFlAZFBAI2jkHAOdxxwDwMU7/AIQy"
    "6ku41uIrhllBJtz8wIbCbjjOM7c5zycZzkmsDV7gQr5dy0cb/eEkYDOuFAJPpgnPzHB46AkBP7ZiWFjG8YK8CQcHIy2B"
    "n0zX0L8KvCSR2sUd7BCk5QLbxliI1wSSqkZDZxgHAHKntVeDwdfoVjjgkeNyWMhkQqhySwX+IHjAyRxyffldVmWGDbJL"
    "b71XeQFJG7JJIxgnAwcE/wARPTmpH1mAgs0ihlAG0KQSMcE9iPwNfSnhvRzZaYLeJxvjYiRTg4I3EswY5wcAd+g4OMrM"
    "ngjUpJguy7fb8qIkRO8YzleeOQrZxkHB4zk8zqjTShnlaGGQxmV1L+YqSAFlBHAI5OAOPlHBzksOuWypndEueWYvjbz3"
    "/UY+tc74w1p7NBDJcKShDlGG5lA42naCcHkkE7TvznFPi8J3rlLeN5HUKpmPlF8EKNxXv03Hvgkc8c8nqd7bNumcl13M"
    "xRuHU5UAH5eBg8ZweGzuzy19WhAaRgqnJCfNt4ycA/jgfga+a/ij4hS6vpdPMioyBlIUBnYjOB93kdsNjtwM5qK18Dz2"
    "bR3MkPlQs0bDIwiEdWwAckAgADJy3Q8Zx/EFzHb2JYzbbf7PsRplDbg33hgAhRk4xyOFxnu+XXEmDRK+5wGHXJYeme3I"
    "P5V4rKV1R0W3khiJkZpGkjbJyNvyD5j0yc55yOlfXFx4JsIre2lto4UiVjEZELMI4+x3BiOB8599w9CPpq6j8x3STy1i"
    "ErbfmHJbqCeuST1wevQ8V5HHrc7ySJKzliA4UgAs3fgjPsPbH4+n/C/w7Pf7TdLbhFjU7X+91UKDkY64ODwB0B6B9n4F"
    "j8syQxBopCxmQQht4PykcAZbGMDnAGOvTnr272PJE32qKZ1IdLi5dNrHaTzzleegwPmXrimza624K7EMuAjF8Yxznntn"
    "OT3zX074C0KO1tIzcZJVS2XCAcNtBI6gjHQAktzgkZp954HBZBA6GbYyhlaMkFD0XtyA547nHUmuW1bUXhSa0uI1SRCD"
    "ERKuMNuOzBwegPQZbkZGeUh1zg71OzIOCGGQ3r+OPyrr9anjstNdYyJLVwwVVkwWYjaSG5DcknOeowepw218DxfLJcBW"
    "kkbkSPwykM43Ek7ckew3ADPUnlJ5rV2DwTkrIRtCxsUZvvMfu5wMjuDwPSll1xuVjJCqP4R0PC8DHOM+/BP0rwr4t+I3"
    "aa5iT5LeYKZJTIyiJyUzll6jB49AFGBiiXwfAhi8u3wVkKqU4Mi4JA+6f7xGF7nPpjn9XvVsoRNueaXJVykBKsWzhSGC"
    "4BGVyB0xxyKF1iQ790mcqCc9FPc9fbqfTHrXzn4zu7a8vyrLG23a0qKSzA4x0IyMgngfKPT5cUyf4f6fdQqksBCRKnml"
    "0KgMSBwcbiqgYwRjAHYZrmLm7htpbh133IMMjl4hhSoDENgnPHXOD7dxSx+ILiJyUkyWLbQpB4APUdASefr9aPA+ktfG"
    "Ub5JIpJHCHgrOu8nhgQd/wAuOmOcZ5xV1fHSLcNFmRCWEMZAVsrxuyoz0wB8wz83r1+qtQdGwIog0LI+SuC0ZDAYxwdp"
    "UAEA9cDAyMwnQiYw/wApwN7dRg9uePfp6fl9MfDPQJ7OCLVC9xFI8Y2RMm6RUBwF9sjGeueenQxQeOLaEXR89oCThJSx"
    "WQ91GSQoB2knOfXPOK5rWbqSzkFpEWVXAQFBgb1wepOenBGOMkY7059DlcxfuxIAPmXAKj1Pqeox/k17jbxXNppioHVp"
    "doKIzBM4AClgM5bpkg88An+Ko7nxnaMYlVxG+AVkCYZ0AYkZzg7cgbuBgjpytcjdylYwIol8u53CTzXBcsFwAuMZQdQO"
    "cAkjqcOj0WYBiV3DPKk5APA/DOCcfX61598R9dkW034AEcZVBCdjYOfU5znjPpjOWXNJpnjDTYGMsix7XVE3DDuWOFwx"
    "JyDxkAY4I69TzV/LHbzXk2JYmnXyRjceSAThgCCARtJ9O/alutHuXARS2QS2DlVwOePX3PPSvlz4m+IBJ9qsbhpFMLM4"
    "ALLgk5UK27JIJBGAfvZJ3E1NqHj6yldhC/lhI2jjVyCRxn5jkYztX5cnHU81zusSWXlOZJXWcrtkfHz9dq/eHI5RsED5"
    "gCD2plvoEygb13EsGYqOD24/M8/0rz1ElvLrFxE8s7jzkkRVRNo6EtwWPy9+fl4POKU+NdMgj4IjLq+V+cADbt2bRlj2"
    "6Dpu56kcrq80VtLPcW/mTZkfzAkxAfj1wC2CpAxjAByDxSf2Lcu397aV5+U985zwPz9vpXv/AMKvDUjkqyCMb8yOGzIG"
    "C4OxiAVztGRz3yCM5+RpviBLFc4n2tah1UFXZsFcBjjcSo5ByMbtpxnPH1XqlwjhRvSRxCf3UiMoYLgNjeNozk/KBzjn"
    "mvXU8Po0WY8iXBOCAMg9O2D0P0yM19GeEdHs4smztGJ/doV3lJI8jLMDjP8ADgfj75qzeN72NFhW789WLSowHzKwUlW+"
    "UdCQ3T1xt544+9uJHh8lUTbJEJApkIZWPy5wxG75VOccgqBzzUqaHAzFzD5ZACsOxGRkcnqMjr+fq/xDqUVrpqSRBlkn"
    "lcmTzSpVc+6nHABPYc84BFWovHV4llARflJbQLt+fhO+0YUkYLM3TuDz1rA1a7gWRYpBth+bjBcAqmMjPbCtzk5CEHIO"
    "KifQoTO4MAKyk546+5yQOgA/P6V83/FfxTs1G9Fxcs0gPIHz/JnBfjrkdjzxjGejn8b39vGJbmdIo2iAbdksQCFQEBDk"
    "4AyR1CkY4Irl7ydY7G4z5b3EbLJG/wB4qmxQdx4AHX5u/HpikGh28jFY4yzBiRjoM8nGW6c/gT9K8Bu75J9UKRASOu1V"
    "YTlS6hlKgDHyjg5PsDwQBVe38aXf2oW8Nw9pNFHgyRNvUkpuLEFsHA556dsD7vM6m8cCzs0nmxs6iVwjb03qV2988liT"
    "kccehqSTRYfKMjxiZHbO1htIAOMZx/8Ar7+/a+CtHa8uJ5pbOIySOiWwXLZdSvzMcKduTkcbckZ6ZMo8X30Ns88d8ot/"
    "usZQxGSuMAsM4AO04HPB7EnndZuBM+8yRRKEP2dJF67Mrwuc5Abn6jjtTf7HgeQRtATJ1AXA6HPQH2yOa//Z"
    ), "5f6dcaf346103d7b9a7effbf37d2d33aa9d64f9fded801190b5ecd17dfdd4117", (32, 48)),
    # 48x32 Adobe YCCK (transform 2), 4:2:0 with full-size K
    "ycck": ((
    "/9j/7gAOQWRvYmUAZAAAAAAC/9sAQwADAgIDAgIDAwMDBAMDBAUIBQUEBAUKBwcGCAwKDAwLCgsLDQ4SEA0OEQ4LCxAW"
    "EBETFBUVFQwPFxgWFBgSFBUU/9sAQwEDBAQFBAUJBQUJFA0LDRQUFBQUFBQUFBQUFBQUFBQUFBQUFBQUFBQUFBQUFBQU"
    "FBQUFBQUFBQUFBQUFBQUFBQU/8AAFAgAIAAwBAEiAAIRAQMRAQQiAP/EAB8AAAEFAQEBAQEBAAAAAAAAAAABAgMEBQYH"
    "CAkKC//EALUQAAIBAwMCBAMFBQQEAAABfQECAwAEEQUSITFBBhNRYQcicRQygZGhCCNCscEVUtHwJDNicoIJChYXGBka"
    "JSYnKCkqNDU2Nzg5OkNERUZHSElKU1RVVldYWVpjZGVmZ2hpanN0dXZ3eHl6g4SFhoeIiYqSk5SVlpeYmZqio6Slpqeo"
    "qaqys7S1tre4ubrCw8TFxsfIycrS09TV1tfY2drh4uPk5ebn6Onq8fLz9PX29/j5+v/EAB8BAAMBAQEBAQEBAQEAAAAA"
    "AAABAgMEBQYHCAkKC//EALURAAIBAgQEAwQHBQQEAAECdwABAgMRBAUhMQYSQVEHYXETIjKBCBRCkaGxwQkjM1LwFWJy"
    "0QoWJDThJfEXGBkaJicoKSo1Njc4OTpDREVGR0hJSlNUVVZXWFlaY2RlZmdoaWpzdHV2d3h5eoKDhIWGh4iJipKTlJWW"
    "l5iZmqKjpKWmp6ipqrKztLW2t7i5usLDxMXGx8jJytLT1NXW19jZ2uLj5OXm5+jp6vLz9PX29/j5+v/aAA4EAQACEQMR"
    "BBEAPwD3TSPFEENratB5bFMRcYXcfvHaQNvRSDjd1b6DWj+IdpaxrMZw0kKgxhH2krsbAYYU5yOMdeevNfIsXxDuhJJL"
    "PMIyzEsdxQSJleV8sDgtzxkHbyAeaw9W+LwW2uGiZ0ckyKZZA5kJPLE5wMccgA5A5JIFfzHgOC/rEkrf09/l8vmftuM4"
    "PjlGBcE9l8l18um5+q0+D8TTlW9pTmpSvP34t2XwptSvLr1tpb1DHcGYiK5VScYVPjlOOi96K0evTdPbQ/qCfAeFp0KU"
    "KVF1IOmk+RJ8rSlo1Pqo6a2fvPfYirwGlKCnKNSgkoe7FxVPS3Lbfq9L23Wiuz6W8TfFi1WSZiYJlEbHZhC6s27Zgdl4"
    "PbuD6muKv/iXaDUo4I0xDEE/ckAoSRnp0Aye46kHPy8fLGofEy9u0ZMuw2FV+bdM5B56kkYwORjIGAAelXSPHF1cXaP9"
    "oCW5RRO8gDAEgZ2sMnH7sc9s8f7P7zk/AkMNDnlvbX00/wCD59PI/kniXh+tmOK9lDbW39f1f8/5npcC4qbjTvKM5SjG"
    "Unz2lFW5ruz11V9+vkjCHBmKrYOrWc5OVRy/exb2Ut/XfbpddT+nq3BOFpyVRqKtLnenLTSa30smtXo76u9zGpwRQ9la"
    "VNe2Um6UKbs5JXto0kn723W2u+v2BofiO21uOE3UhaMiRjOZsMyg5wQTgYRcnryf4iefTNA8VxT3EdnMWExQw+YSZNx2"
    "Y3jBA4OST3x3yRXxd4V8U3k0ck5EcM6sHy8RUyDBIBHAzuxyBkg9TnafVbXx1d6fZpFJdeRBxyjERsQg3YUHJ4AI3DAO"
    "eSTmvpqnCzi/ZJry0frb+umx+jcGeFqclUqK1++vX56an801OEK2Br1vZK02oqNOELx5rdGlr7zSXWy6W00hwTUpUvrU"
    "YJ0laSg/dslJNRtv0slf7rXP6XqcD4aMqdG86mHkuVpS0jZq7W+lk9Oj7WulhOCcFXqxqrD+0qtXUdOaKbfLe6013tbZ"
    "djidb8MPa3EDpg87yC7ENwxI45wRjocZODyOeI8S+CpoUMYjdZUhwreW6sHf7qkZ5J5wSQDkewP2f4j8MW1xtjDZUL5M"
    "luGZByCd2MDAAGcHHUdDmvOvFHgu3u5nt2kS28wbVJHl+4JOMk9QBnqxGODn8vyDN1NwfLb+vQ7uOPFiUpOlCXu9uuvp"
    "v1Wunc9CPGNOOHqwq3lFLluktLtJPVWur7vprscdHj2jiYyqe0p8lSd50Yyi4uMVve2y93ZdPW38yx4zxNGEqkpK8U5w"
    "qNKT0aVr933127F4DjStRbqRjVqWbcmpOfZOyvZebtrZO+tj47u/BF/qFwFBefcS7IzBNyg87VIPbdkDByRx2rqtB+Ek"
    "7W0kZ8pFiYkYjZGHylWA7AgKBwPUV9N6J8LYmTJgUo+AJQp2DJZCqsegLHPTP+z6eq+E/hdaWtxFJKvlB1Mj9N6vt3bQ"
    "rEE4GQARjkcDmv1f/WuOHhy2Wi/rS3ytv5bH5rw7xDPMMVeS0/prX1fR+R/T9HjLCUoTcmo3tCEoxclfdJu68vibVk/U"
    "S43oTrUaq57zjGL9+M07zTSel2m5Pr2P5lxHHFarVg+ec3FNypqdptq0lJruk0t/mzL/AFyr1KDpqneSlFK0fcnFStfm"
    "je13a7vdq9r6HzZ4Z+H9za2UUjSqX2rIU6gqw+UuNpyAOfqOM8VuR+BJ2sjdQSSEhWBieNkWQDdxnIwRwAFxzxwTmvr7"
    "TvhjFLpkflW8kMyuoJ25DKF2BjnJB6+vY56gU9b8G6dpULwRNC3zfOiqq9QoHt0D+vX+EdLwfE0as7RTu9/v6/1v6H9M"
    "0uNaeUYN2/rTbbf8+p/TE+J6HtpUlSlFtuCnJWfmlqrPsuz1e52z40w8K86VWMFFpPmjOMnB3i2/NPV6376rQ/leXHVX"
    "DYmUakozg4Pqlyu/Pbonsvx07qPGuLxfLObaqRVoOTbvZtvRefJa9ttbn//Z"
    ), "5106318508a404c85c49401b2bc1a5a250fe0173e98ac517c5920027b4c83107", (32, 48)),
    # 48x32 4 components without an Adobe marker (CMYK)
    "cmyk_no_adobe": ((
    "/9j/2wBDAAUDBAQEAwUEBAQFBQUGBwwIBwcHBw8LCwkMEQ8SEhEPERETFhwXExQaFRERGCEYGh0dHx8fExciJCIeJBwe"
    "Hx7/wAAUCAAgADAEQxEATREAWREASxEA/8QAHwAAAQUBAQEBAQEAAAAAAAAAAAECAwQFBgcICQoL/8QAtRAAAgEDAwIE"
    "AwUFBAQAAAF9AQIDAAQRBRIhMUEGE1FhByJxFDKBkaEII0KxwRVS0fAkM2JyggkKFhcYGRolJicoKSo0NTY3ODk6Q0RF"
    "RkdISUpTVFVWV1hZWmNkZWZnaGlqc3R1dnd4eXqDhIWGh4iJipKTlJWWl5iZmqKjpKWmp6ipqrKztLW2t7i5usLDxMXG"
    "x8jJytLT1NXW19jZ2uHi4+Tl5ufo6erx8vP09fb3+Pn6/9oADgRDAE0AWQBLAAA/APF/GusXl1eyyM1ntZFEr7QVVT0Y"
    "DHI24H5da8fuPA2pwyxzrHLkttDsW2SgA5yTxu2nJ7fdGRgivqu4uF8p4JI48SEZcRny2IORyeBx2Pr1AXNcPHrtq6Mh"
    "ZemdoxlT2x7ZH8z3rB0m2e7Ig3fao4m3IgPOd5GQSPlwWz68jGKz7rwW8XmF7oh2dH2xw4Uup3csDkA5yRzjjgkCsXXL"
    "y5igBhO9lj2yRvkqVZSAQP4eD3PQ855zYi1pX24i4Clcs/O0jHAI/L19hX0J8NPB580SxRFI0KzCZwGHPzDG0jr8xGeM"
    "kdeBWhc+ErwxqtvGzmT926vOdxALMdyg7R07g5J6LmuP1N7SK4ZQxLsoe2yrYcfdUEthgAo2jaDzjHQVBHq8O4mRgu35"
    "lKx8DoOD179j2719FeF9HS2hDXDsA7fNJEhHmb1GW47kDOBwBjAJziK08BXQS0R1jaDKiRCMgAgcqVznOOGxjDAZXFc1"
    "qJihLGRJpo/L3J5OCsrZxuG3rzxgc9AAQeXTa9EWlZSwkwSp6HPPUH07j271iePtettNhKJJHB5cgWQeZsCHay9hkHHH"
    "yj2wSSKjg8H3H2qORhDIjMBgHe5I+bdwEJ6egGT1AwK5m91J5TK13HIqCIfMqhmXADAglc9SwwcZBOeMU59Yj8plBdWA"
    "PP3VHbHfH+etfNnxR8UIZrkNs8so8h87g7MgHnJ6rnj3GDwQbFv4PnSN4ZLaVGLlPLhRtmDsBBGQec4JJP3SSOSRzGpP"
    "/wAS+Jk2khELNNMx8x0wCTjOPvhuvTnIzUcmsIWV1lUjaDudhuzzyDjt2+vHv4hPDJPdtHdGL5NoQqxA6jHzMBwcjkZz"
    "696+sU8DKzKgJuEYvPA7EEJwNysSeSDkbhgYHOOh+qb9khluNqxXAht3yjBVUbMngKQdy7iCNuSOc8gV5MddIBbiNhiN"
    "wAcnngjA9O3qfxHqvwt8MSzX5kdCEtchl8tWXdhcnbnJGSpGB0AB6kUr/De1uZwbqzjjiRB5MpwpBwDgLtxtBQHgnn1J"
    "rkL6aNQY0fyP3e4qJCWZPlGQSSWIOD0OFPcDNC+JJY4z5UzM7N86jkEdM5znOG719QeDfDqW04jnhuBGqCGUNEAyoUDH"
    "dkAnPUdefeo4/BNpFMbm7EceHLOdw2sTkqSSeQfnGOPuHPIrntRkik8svLIUaVljCpgABELKFIB6EdDx0705tbmdPKh3"
    "NxgDHIHAPQdenPv6Gun1e5eK0upbaZ1RS5QKhCrnawzwQTk4GOcc8itA+CrMC+jnijUtGSHCth+oDZPIUnACjgEEYHFc"
    "vq00zwrDBuc3RD7IyfKUE4xuyB255ABBz71xrUx8hkdjhhlSR8vfH19SeTnrXiXxR14wxhLS+kQiRfnUbnbBOemATwMs"
    "RjHPrUUHgC0NtLIYIURsMsQlBABxtzkMCTuAXd6/8CPPXNw7vMbhxJ5cZlQvKdxBC8cqSTkNweeR605/EEwkRRI7MMgs"
    "V/PHQ9jnH/1h82eKtY8y+VPMYhTuXeu1ZVfAbr/urkYPI4HRqgl+HymYfKE8t8xlo1VcEjIw2TkhmxwfvcA845iaeNIJ"
    "7iO6Lndidxghlyc4A6nOMAcAnlSeBIviAhDyW3DDYYk5x1yPoPy60/wV4aubm5NxITNvVGLIwyoPJDOc9CC3JxkA+1X4"
    "/Htne4BlglZXB2wsdny5AA+b5mJ3dOeFJz2+qdaundDCXVFebKO5AD7M/KQT0yCMjvx0IqBtBmgydroCOrgZ5/DgDj26"
    "4r6c+F3hqOKFFtY1kyocgJgRg78rIxBUZUtkdAQ3Q8VBJ41sWut32hIk3uAsuSSxwGGCx+vbovauX8Q31t9rL/aVuJhG"
    "hRZUEiEANuBO35SeRgHAwDwCBT10ScRY8ssdo5TjA7dv8817lHaR6fpLwSIE+XDshEZYblCjABbaScexOeBzU8XjixdJ"
    "IUkkn2MpjmLhnG0Dcirz03MMDkHJwRjHLX95LOn2qTBkcna9sPLVFJwxcHjIyQPqew5Y2hzhldlVMghk2kKcngk8dcDr"
    "7V55488TC2WWKeeAXBwnIySAfvFgdw/3SGweh+8afJ43tcyzxXAebeJHUElJAGznGMZ7jAOOc9hXOXflG7ZxJut/O+8j"
    "KAQGUkcEFsYKkHPTvkU1dDl+WN4yqbSqkgblyMfX9fSvlbxnrcl1Kk1xMscjHJlVmD9AQpLnC4G4cYyfcYqGXxzbP5cb"
    "NCZJtjKsxKBAQ5I698Mc5PopAFcvqVwzSfabZ5o0ZA6NIAS3AC4xwGx1JLAZHqKemhyruYB9qZBKAMT93np247fXrXn1"
    "jBHdXkySWz+Wx3TKxZikgbjGwkEnr93POORmi68ZI9sJFlgeMlUdQMNs+VWyFAIK8+hAxwpBrndUv3jYRyRswkUxgRN/"
    "rcH7xHrwAOrZzxzmiLRmWQqUkDckE9N3JHU4Ofyznrmvfvhd4UPnCSTzBESFRI0C9dpX7p+XG3png4GeK+Rz4nvZIoRc"
    "pcBCxzGykBdwB2g9d3VTx/dBwTz9TXl2Eie4Cj5kSJiD5m3IwqljntySeM57CvXP7LhVn8sxkgcMCDnBxn6d+vr2r6U8"
    "HaTbW1upnc+bCAI43dVAIP3B/CD8/OCcY44xUN34r1E3bJLctI/miOMJglk25bdjgEliOcHnnOQRx+pyrJNgSsqDMLpE"
    "QFMYbIYnqxJAGeR0HJ4p8WlW4iDLGFGwsxboDnjGfTA/p3zD4r1WO3sZpba98qMfJySYwC4A2nPOMKAP4d3GM/MqeOrp"
    "ZrsqVCT52Rtu3IdpG0Ywu7JDEc5APfrg6zeO5mvEvfNVnyg2MHCFWxnOQBtbPBycNjPAA2hRFIQQSU6sMYPPU55xgYB/"
    "pXzn8X/E+6VoIJFkSCd5HcqQqDDKCBj5Rwo64AJz1O2WPx7qIuVWfz4zuEfXAJzkEKTyV+UccjJ9c1ympXwiiljSGeFC"
    "is0TgblyMg49PlAB4644GMMbQbcxkx7G43e+MYxkdM8+35YrwDxBK9xezSF22FmIHLFQH6HJ74OOmO46kQJ4xvJ08kTy"
    "W8iNuZolCeaMKfmz15JHK9AODkAc5rV3CbQeTKHjiIkX5QSrDHQAbgSeNgGRg5/hxIdHhjbeUWRWGAGOdvXp+Xr3PTFd"
    "f4K0ffq29IGLId6GCFSvBJyM8H7p54OM43Y5uW/jPz1lLvKIUXeInkZsqsigs3GSfvEE5BJA9xy3ia4eFS91cOSYVDur"
    "ZAkAYiPChiMnDAgngEYOBugk0XyyuFUuTjeqgYJU8D9Ppj8K/9k="
    ), "21909a8545604a4668f6029fcdd0ad393adc3934e103993c60fb869dbed207f8", (32, 48)),
}
DECODE_REPS = 20
# [procedural]: a bracketed 3D L-system tree (six generations, 15,625
# segments as six-sided tubes) on the bench scene's floor, environment and
# sun, rendered at the bench frame's size
TREE_RULE = 'F -> F[&+!"F][&-!"F][^\\!"F]F'
TREE_GENERATIONS, TREE_SIDES, TREE_TRIS = 6, 6, 187500
# [bench]: bench.py's keys and the port's three beside them
BENCH_KEYS = ("metric", "value", "unit", "vs_baseline", "traced_mrays_s", "rays_per_sample",
              "frame_s", "spp_timed", "card", "block_s", "host_cpus")
PREVIEW_RTOL = 1e-6       # shaded and debug, one route against another
PREVIEW_PEAK_GB = 4.0     # the chunked 1080p shaded preview's peak memory
CLI_SIZE = 512            # the command line's default --size
CLI_HEAT_SPP = 4          # the heat-map run's default 64 spp cut to fit the run's time
CLI_TIMEOUT = 300
KERNELS = {   # name: (source, TPU kernel it replaces)
    "closest": ("mc_path_tracer_tpu_torch/csrc/traversal.cu",
                "mc_path_tracer_tpu/ops/pallas/traversal_kernel.py:892"),
    "anyhit": ("mc_path_tracer_tpu_torch/csrc/traversal.cu",
               "mc_path_tracer_tpu/ops/pallas/traversal_kernel.py:892"),
    "dense_closest": ("mc_path_tracer_tpu_torch/csrc/dense.cu",
                      "mc_path_tracer_tpu/ops/pallas/intersect_kernel.py:69"),
    "dense_anyhit": ("mc_path_tracer_tpu_torch/csrc/dense.cu",
                     "mc_path_tracer_tpu/ops/pallas/intersect_kernel.py:115"),
    "tonemap": ("mc_path_tracer_tpu_torch/csrc/tonemap.cu",
                "mc_path_tracer_tpu/ops/pallas/tonemap_kernel.py:22"),
}
# least-time model: published H100 SXM peaks (fp32 outside the tensor
# cores, HBM3), and the fp32 operations (add, sub, mul, div, min, max;
# compares not counted) of one box test and one Moller-Trumbore test as
# csrc/traversal.cu and csrc/mt.cuh write them.  A triangle test costs what
# its exit path costs: 14 to mt.cuh's det split (pvec, det), 24 to its u
# exit (tvec, the u numerator, the two products of its bounds), 46 in full
# as the reference writes it.  `full_test_bound_ms` charges 46 to every
# test, as the first kernels' rows did.
PEAK_FLOPS = 67e12
PEAK_BYTES = 3.35e12
SLAB_FLOPS = 22
MT_FLOPS = 46
MT_EXIT_FLOPS = (14, 24, MT_FLOPS)


def log(msg: str) -> None:
    print(msg, flush=True)


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations over the fp32 rate, in ms."""
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / PEAK_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py runs only on a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name_limit = card()
    log(f"[device] {name_limit} | torch {torch.__version__} | "
        f"CUDA {torch.version.cuda} | {torch.cuda.get_device_name(0)}")
    return name_limit


def phase_build():
    from mc_path_tracer_tpu_torch.ops.kernels import build

    t0 = time.perf_counter()
    built = build.load_all(["traversal", "dense", "tonemap"])
    log(f"[build] {len(built)} libraries in {time.perf_counter() - t0:.2f} s (parallel nvcc)")
    for _, info in built.values():
        log(f"[build] {info.path.name}: {info.seconds:.2f} s nvcc")
        for line in info.log.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build]   {line.strip()}")


def build_scene(label: str, scene, device, n_tris: int):
    """scene.build(device), timed; fails unless the native builder ran and
    the triangle count is the expected one."""
    t0 = time.perf_counter()
    sd = scene.build(device)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    t = sd.tris.num_triangles
    log(f"[scene] {label}: {t} triangles, {sd.bvh.num_nodes} nodes, {scene.builder} "
        f"BVH builder, {sd.lights.area.count} emissive triangles, built in {seconds:.2f} s")
    if t != n_tris:
        raise AssertionError(f"{label} has {t} triangles, expected {n_tris}")
    if scene.builder != "native":
        raise AssertionError(f"{label}: the native BVH builder did not run ({scene.builder})")
    return sd


def phase_scene(device):
    return build_scene("bench scene", build_bench_scene(), device, 48002)


def _camera_rays(camera, width, height, px, py, device):
    from mc_path_tracer_tpu_torch.models import camera as camera_mod

    cam = dataclasses.replace(camera, aspect=width / height).params(device)
    lens_u = torch.zeros((px.shape[0], 2), device=device)
    return camera_mod.gen_camera_rays(cam, width, height, px, py, lens_u)


def _bounce_rays(sd, ro, rd, gen, device):
    """Rays leaving the closest hits of (ro, rd) in random directions of the
    upper hemisphere, offset as the integrator offsets extension rays, plus
    the hit mask and the hit record."""
    from mc_path_tracer_tpu_torch.ops import intersect
    from mc_path_tracer_tpu_torch.ops.kernels import traversal

    _, tri_id = traversal.closest_plain(intersect.pack_rays(ro, rd), sd.tris.geo)
    h = intersect.finish_closest(sd.tris, tri_id, ro, rd)
    d = torch.randn(ro.shape, generator=gen, device=device)
    d = d / d.norm(dim=-1, keepdim=True)
    d = torch.where((d * h.normal).sum(-1, keepdim=True) < 0, -d, d)
    return h.position + h.normal * 1e-3, d, h


def _time_ms(fn, reps: int):
    """Mean CUDA-event time of `reps` calls after one warm-up call, and the
    warm-up call's output."""
    out = fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, out


def phase_device_times(later: list, name_limit) -> None:
    """The device times the kernel phases asked for, (label, fn, reps, stats
    dict, key) each, taken after every frame: each goes into its dict."""
    for label, fn, reps, out, key in later:
        out[key] = _device_ms(fn, reps)
        log(f"[device-time] {label}: {out[key]:.4f} ms per call, {reps} calls ({name_limit})")


def _device_ms(fn, reps: int) -> float:
    """Device time per call of `fn` under torch.profiler (the sum of the
    self device time of every kernel and memset it ran), after one warm-up
    call: the kernel's own time, without the host work of the wrapper."""
    fn()
    torch.cuda.synchronize()
    # a profiler session now and then records no device activity at all
    # (seen once in ~20 runs, on the first session): try up to three
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = sum(max(getattr(e, "self_device_time_total", 0.0), 0.0)
                 for e in prof.key_averages())
        if us > 0.0:
            return us / 1e3 / reps
        log(f"[device-time] torch.profiler saw no device time (attempt {attempt + 1} of 3)")
    raise AssertionError("torch.profiler saw no device time")


def _check_closest(label, rays, kernel, plain):
    """tri_id agreement on every live lane, t rel <= 1e-5 where the ids
    agree, dead lanes miss; returns the max abs t error."""
    (t_k, id_k), (t_p, id_p) = kernel, plain
    live = rays[:, 6] > 0.5
    if not live.any():
        raise AssertionError(f"no live lanes to compare ({label})")
    id_agree = (id_k[live] == id_p[live]).float().mean().item()
    both = (id_k == id_p) & (id_p >= 0)
    t_err = (t_k[both] - t_p[both]).abs()
    t_rel = (t_err / t_p[both].abs().clamp(min=1e-20)).max().item() if both.any() else 0.0
    dead_ok = bool((id_k[~live] == -1).all())
    hit_frac = (id_p[live] >= 0).float().mean().item()
    log(f"[kernel] {label}: closest tri_id agreement {id_agree:.6f} of {int(live.sum())} "
        f"live lanes ({hit_frac:.3f} hit), t max rel {t_rel:.3e}, dead lanes miss: {dead_ok}")
    if id_agree < 1.0 or t_rel > 1e-5 or not dead_ok:
        raise AssertionError(f"closest kernel disagrees with its plain version ({label})")
    return t_err.max().item() if both.any() else 0.0


def _check_anyhit(label, rays, occ_k, occ_p):
    """Occlusion agreement on every live lane, dead lanes unoccluded;
    returns the max abs difference (0 or 1)."""
    live = rays[:, 6] > 0.5
    if not live.any():
        raise AssertionError(f"no live lanes to compare ({label})")
    agree = (occ_k[live] == occ_p[live]).float().mean().item()
    dead_ok = bool((~occ_k[~live]).all())
    occ_frac = occ_p[live].float().mean().item()
    log(f"[kernel] {label}: any-hit agreement {agree:.6f} of {int(live.sum())} live lanes "
        f"({occ_frac:.3f} occluded), dead lanes miss: {dead_ok}")
    if agree < 1.0 or not dead_ok:
        raise AssertionError(f"any-hit kernel disagrees with its plain version ({label})")
    return (occ_k[live].float() - occ_p[live].float()).abs().max().item()


def walk_counts(rays, nodes, geo, any_hit: bool) -> tuple[int, int, int]:
    """(nodes visited, triangles tested, the tests' flops by exit path)
    summed over the live rays: the binary skip-link walk of the first
    traversal kernel replayed with torch in its order and arithmetic (boxes
    pruned against the best t, leaves tested in index order, any-hit
    stopping at its first hit within t_max).  The bound keeps this count,
    so kernel rows stay comparable across designs."""
    from mc_path_tracer_tpu_torch.ops.intersect import early_exits, moller_trumbore
    from mc_path_tracer_tpu_torch.ops.math import K_HUGE

    n = nodes.shape[0]
    meta = nodes[:, 6].contiguous().view(torch.int32).long()
    skip = nodes[:, 7].contiguous().view(torch.int32).long()
    first, count = meta >> 4, meta & 15
    live = rays[:, 6] > 0.5
    o, d, t_max = rays[live, 0:3], rays[live, 3:6], rays[live, 7]
    g = torch.where(d.abs() > 1e-12, d, torch.where(d >= 0, 1e-12, -1e-12))
    inv = 1.0 / g
    idx = torch.zeros(o.shape[0], dtype=torch.long, device=rays.device)
    t_best = torch.full((o.shape[0],), K_HUGE, device=rays.device)
    visits = tests = flops = 0
    while idx.numel():
        visits += idx.numel()
        box = nodes[idx]
        t0 = (box[:, 0:3] - o) * inv
        t1 = (box[:, 3:6] - o) * inv
        tnear = torch.minimum(t0, t1).amax(dim=1)
        tfar = torch.maximum(t0, t1).amin(dim=1)
        hit_box = (tnear <= tfar) & (tfar >= 0.0) & (tnear <= t_best)
        c = torch.where(hit_box, count[idx], 0)
        done = torch.zeros_like(hit_box)
        for k in range(int(c.max().item())):
            m = (k < c) & ~done
            tests += int(m.sum().item())
            row = geo[torch.where(m, first[idx] + k, 0)]
            tri = (o, d, row[:, 0:3], row[:, 3:6], row[:, 6:9])
            valid, t, _, _ = moller_trumbore(*tri)
            flops += _exit_flops(*early_exits(*tri)[:2], m)
            if any_hit:
                done = done | (m & valid & (t <= t_max))
            else:
                t_best = torch.where(m & valid & (t < t_best), t, t_best)
        nxt = torch.where(hit_box & (count[idx] == 0), idx + 1, skip[idx])
        keep = (nxt < n) & ~done
        idx, o, d, inv, t_max, t_best = (x[keep] for x in (nxt, o, d, inv, t_max, t_best))
    return visits, tests, flops


def _exit_flops(det_exit, u_exit, tested) -> int:
    """The flops of the `tested` triangle tests by the path each leaves
    mt.cuh's test on."""
    paths = (det_exit & tested, u_exit & tested, ~det_exit & ~u_exit & tested)
    return sum(f * int(m.sum().item()) for f, m in zip(MT_EXIT_FLOPS, paths))


def wide_walk(label, rays, sd, any_hit: bool, kernel_out) -> dict:
    """The 4-wide walk's counts (ops/kernels/traversal.walk_plain, the
    kernel's walk replayed with torch); fails unless the replay gives the
    kernel's answer on every lane."""
    from mc_path_tracer_tpu_torch.ops.kernels import traversal

    out, stats = traversal.walk_plain(rays, sd.bvh, sd.tris.geo, any_hit=any_hit)
    same = (torch.equal(out, kernel_out) if any_hit
            else torch.equal(out[1], kernel_out[1]) and torch.equal(out[0], kernel_out[0]))
    log(f"[kernel] {label}: 4-wide walk (depth {sd.bvh.wide_depth}, {sd.bvh.wide.shape[0]} "
        f"wide nodes): {stats}, replay equals kernel: {same}")
    if not same:
        raise AssertionError(f"the torch replay of the walk differs from the kernel ({label})")
    return stats


def phase_kernel_check(sd, device, later: list, name_limit):
    """The traversal kernel against its plain version on the same rays: a
    mixed set with masked lanes and bounded t_max, then the bench frame's
    dispatch shapes, timed, with the counting passes for the bound."""
    from mc_path_tracer_tpu_torch.models.film import tile_order
    from mc_path_tracer_tpu_torch.ops import intersect
    from mc_path_tracer_tpu_torch.ops.kernels import traversal

    gen = torch.Generator(device=device).manual_seed(0)
    bvh, geo = sd.bvh, sd.tris.geo
    cam = bench_camera()

    # 16,384 camera rays at random pixels + 16,384 bounce rays from their hits
    pix = torch.randint(0, WIDTH * HEIGHT, (CHECK_RAYS,), generator=gen, device=device)
    ro_c, rd_c = _camera_rays(cam, WIDTH, HEIGHT, (pix % WIDTH).float(),
                              (pix // WIDTH).float(), device)
    ro_b, rd_b, h = _bounce_rays(sd, ro_c, rd_c, gen, device)
    ro = torch.cat([ro_c, ro_b])
    rd = torch.cat([rd_c, rd_b])
    live = torch.rand(ro.shape[0], generator=gen, device=device) > 0.1
    live[CHECK_RAYS:] &= h.hit
    bounded = torch.rand(ro.shape[0], generator=gen, device=device) < 0.3
    t_max = torch.where(
        bounded, torch.rand(ro.shape[0], generator=gen, device=device) * 5.0, 1e32)
    rays = intersect.pack_rays(ro, rd, live, t_max)
    label = f"{2 * CHECK_RAYS} mixed rays"
    closest = traversal.trace_closest(rays, bvh, geo)
    occ = traversal.trace_anyhit(rays, bvh, geo)
    errs = {
        "closest": [_check_closest(label, rays, closest, traversal.closest_plain(rays, geo))],
        "anyhit": [_check_anyhit(label, rays, occ, traversal.anyhit_plain(rays, geo))],
    }
    wide_walk(label, rays, sd, False, closest)
    wide_walk(label, rays, sd, True, occ)

    # the main path's shapes: one tile-order block of camera rays, its
    # first-bounce extension rays (closest, 65,536 rays), and its shadow
    # rays toward the directional light + visibility rays (any-hit, 131,072
    # rays); each timed, and the timed calls' outputs held against plain
    pxi, pyi = tile_order(WIDTH, HEIGHT)
    blk = slice(15 * CLOSEST_RAYS, 16 * CLOSEST_RAYS)
    px = torch.from_numpy(pxi[blk].astype(np.float32)).to(device)
    py = torch.from_numpy(pyi[blk].astype(np.float32)).to(device)
    ro_c, rd_c = _camera_rays(cam, WIDTH, HEIGHT, px, py, device)
    ro_b, rd_b, h = _bounce_rays(sd, ro_c, rd_c, gen, device)
    closest_rays = intersect.pack_rays(ro_b, rd_b, h.hit)
    light = torch.tensor([0.4, 1.0, 0.2], device=device)
    light = (light / light.norm()).expand_as(ro_b)
    shadow_o = h.position + h.normal * 0.01
    anyhit_rays = intersect.pack_rays(
        torch.cat([shadow_o, ro_b]), torch.cat([light, rd_b]),
        torch.cat([h.hit, h.hit]))
    out = {}
    for name, rays, fn, plain, check, out_bytes in (
        ("closest", closest_rays, traversal.trace_closest, traversal.closest_plain,
         _check_closest, 8),
        ("anyhit", anyhit_rays, traversal.trace_anyhit, traversal.anyhit_plain,
         _check_anyhit, 1),
    ):
        k_ms, k_out = _time_ms(lambda: fn(rays, bvh, geo), 20)
        p_ms, p_out = _time_ms(lambda: plain(rays, geo), 2)
        label = f"{rays.shape[0]} path rays"
        errs[name].append(check(label, rays, k_out, p_out))
        visits, tests, tri_flops = walk_counts(rays, sd.bvh.packed, geo, name == "anyhit")
        wide_walk(label, rays, sd, name == "anyhit", k_out)
        nbytes = ((rays.numel() + sd.bvh.packed.numel() + geo.numel()) * 4
                  + rays.shape[0] * out_bytes)
        b_ms, b_by = bound(nbytes, visits * SLAB_FLOPS + tri_flops)
        full_ms, _ = bound(nbytes, visits * SLAB_FLOPS + tests * MT_FLOPS)
        log(f"[kernel] {name} {rays.shape[0]} rays: kernel {k_ms:.4f} ms, plain {p_ms:.3f} ms, "
            f"bound {b_ms:.5f} ms ({b_by}: binary walk {visits} node visits, {tests} triangle "
            f"tests of {tri_flops} flops, {nbytes} bytes; {full_ms:.5f} ms with every test "
            f"in full) ({name_limit})")
        out[name] = dict(max_abs_err=max(errs[name]), ms=k_ms, plain_ms=p_ms,
                         bound_ms=b_ms, bound_by=b_by, full_test_bound_ms=full_ms)
        later.append((f"{name} {label}", lambda f=fn, r=rays: f(r, bvh, geo), 20,
                      out[name], "device_ms"))
    return out


def _reset():
    from mc_path_tracer_tpu_torch.ops.kernels import reset_launches

    torch.cuda.synchronize()
    reset_launches()


def _launches():
    from mc_path_tracer_tpu_torch.ops.kernels import LAUNCHES

    torch.cuda.synchronize()
    return dict(LAUNCHES)


def phase_render(sd, device, name_limit):
    """The bench path; returns its launch counts, film and seconds."""
    from mc_path_tracer_tpu_torch.models.integrator import RenderConfig, render

    cfg = RenderConfig(spp=SPP, max_depth=DEPTH)
    _reset()
    t0 = time.perf_counter()
    film = render(sd, bench_camera(), WIDTH, HEIGHT, cfg, device=device)
    launches = _launches()
    frame_s = time.perf_counter() - t0
    img = film.radiance_mean()
    finite = bool(torch.isfinite(img).all())
    mean = img.mean().item()
    spread = img.std().item()
    log(f"[render] {WIDTH}x{HEIGHT} {SPP} spp depth {DEPTH}: frame {frame_s:.3f} s, "
        f"{WIDTH * HEIGHT * SPP * RAYS_PER_SAMPLE / frame_s / 1e6:.3f} Mrays/s at "
        f"{RAYS_PER_SAMPLE} rays/sample ({name_limit}); launches {launches}; "
        f"image mean {mean:.5f} std {spread:.5f}")
    if not finite or mean <= 0.0 or spread <= 0.0:
        raise AssertionError("rendered image is not finite, dark or uniform")
    if launches["closest"] == 0 or launches["anyhit"] == 0 or launches["plain"] != 0:
        raise AssertionError(f"bench path did not run through the kernel: {launches}")
    return launches, film, frame_s


def phase_route_parity(sd):
    from mc_path_tracer_tpu_torch.models.integrator import RenderConfig

    _crop_parity("parity", sd, bench_camera(), WIDTH, HEIGHT,
                 RenderConfig(spp=SPP, max_depth=DEPTH))


def phase_api(sd, device, name_limit) -> dict:
    """The JAX package's public traversal routes on the bench scene:
    ops/wide_bvh.intersect_wide / occluded_wide and ops/intersect.
    intersect_bvh / occluded_bvh on bench block 15's API_RAYS primary rays
    and the 2 x API_RAYS any-hit lanes of their hits (shadow rays toward
    the sun, visibility rays along random bounce directions with a random
    t_max on a third of them), each call counted from 0 (one kernel launch,
    no plain call) and timed; every output bit-equal to the integrator's
    own dispatch, unsorted ("bvh", the route of accel "wide" / "bvh") and
    sorted (the default), and to the plain version on every live lane.
    Returns the four calls' launches."""
    from mc_path_tracer_tpu_torch.models.film import tile_order
    from mc_path_tracer_tpu_torch.models.integrator import _intersect, _occluded
    from mc_path_tracer_tpu_torch.ops import intersect
    from mc_path_tracer_tpu_torch.ops.kernels import traversal
    from mc_path_tracer_tpu_torch.ops.wide_bvh import WideBVH, intersect_wide, occluded_wide

    gen = torch.Generator(device=device).manual_seed(1)
    pxi, pyi = tile_order(WIDTH, HEIGHT)
    blk = slice(15 * API_RAYS, 16 * API_RAYS)
    px = torch.from_numpy(pxi[blk].astype(np.float32)).to(device)
    py = torch.from_numpy(pyi[blk].astype(np.float32)).to(device)
    ro, rd = _camera_rays(bench_camera(), WIDTH, HEIGHT, px, py, device)
    ro_b, rd_b, h = _bounce_rays(sd, ro, rd, gen, device)
    light = torch.tensor([0.4, 1.0, 0.2], device=device)
    so = torch.cat([h.position + h.normal * 0.01, ro_b])
    sdir = torch.cat([(light / light.norm()).expand_as(ro_b), rd_b])
    smask = torch.cat([h.hit, h.hit])
    bounded = torch.rand(so.shape[0], generator=gen, device=device) < 1 / 3
    t_max = torch.where(bounded, 0.5 + 20 * torch.rand(so.shape[0], generator=gen,
                                                         device=device), 1e32)
    wide = WideBVH(sd.bvh, sd.tris.geo)
    calls = {
        "intersect_wide": (lambda: intersect_wide(wide, sd.tris, ro, rd), "closest"),
        "intersect_bvh": (lambda: intersect.intersect_bvh(sd.bvh, sd.tris, ro, rd), "closest"),
        "occluded_wide": (lambda: occluded_wide(wide, so, sdir, smask, t_max), "anyhit"),
        "occluded_bvh": (lambda: intersect.occluded_bvh(sd.bvh, sd.tris, so, sdir, mask=smask,
                                                        t_max=t_max), "anyhit"),
    }
    want = {"closest": {r: _intersect(sd, r, ro, rd) for r in ("bvh", "sorted")},
            "anyhit": {r: _occluded(sd, r, so, sdir, smask, t_max) for r in ("bvh", "sorted")}}
    plain = {"closest": traversal.closest_plain(intersect.pack_rays(ro, rd), sd.tris.geo)[1],
             "anyhit": traversal.anyhit_plain(intersect.pack_rays(so, sdir, smask, t_max),
                                              sd.tris.geo)}
    total = {}
    for name, (fn, kind) in calls.items():
        _reset()
        out = fn()
        got = _launches()
        _expect(f"[api] {name}", got, {kind: 1})
        ms, _ = _time_ms(fn, 20)
        same = {r: _same(out, w) for r, w in want[kind].items()}
        if kind == "closest":
            live = torch.ones_like(out.hit)
            plain_eq = bool(torch.equal(out.tri_id, plain[kind]))
            hits = out.hit.float().mean().item()
        else:
            live = smask
            plain_eq = bool(torch.equal(out[live], plain[kind][live])) and not out[~live].any()
            hits = out[live].float().mean().item()
        log(f"[api] {name}: {out[0].shape[0] if kind == 'closest' else out.shape[0]} rays "
            f"({int(live.sum())} live, {hits:.3f} hit), {ms:.4f} ms per call (CUDA events, 20 "
            f"calls) ({name_limit}); launches {got}; bit-equal to the integrator's dispatch "
            f"unsorted {same['bvh']}, sorted {same['sorted']}; equal to the plain version on "
            f"every live lane {plain_eq}")
        if not all(same.values()) or not plain_eq:
            raise AssertionError(f"[api] {name} differs from the integrator's dispatch or plain")
        for k, v in got.items():
            total[k] = total.get(k, 0) + v
    return total


def phase_gate(device, out_dir: Path, name_limit) -> dict:
    """The gate twin (mc_path_tracer_tpu_torch.tests_tpu.run) at its full
    size: every check passes, or is skipped for an asset golden with its
    reason; its JSON goes beside the PNGs.  Returns its launches."""
    from mc_path_tracer_tpu_torch import tests_tpu

    _reset()
    t0 = time.perf_counter()
    result = tests_tpu.run(device, name_limit, out_dir / "TESTS_TORCH_GPU.json")
    got = _launches()
    skipped = {k: result["checks"][k]["skipped"] for k in result["summary"]["skipped"]}
    log(f"[gate] {json.dumps(result['summary'])} in {time.perf_counter() - t0:.1f} s "
        f"({name_limit}); launches {got}; skipped: {skipped}")
    if not result["ok"] or any(not r.startswith("asset golden") for r in skipped.values()):
        raise AssertionError(f"[gate] failed: {result['summary']}")
    return got


def phase_tonemap(film, later: list, name_limit):
    """The tone-map kernel against its plain version on the bench frame's
    film: bit equality required."""
    from mc_path_tracer_tpu_torch.ops.kernels import tonemap

    ld, samples = film.ld.contiguous(), film.samples.contiguous()
    k_ms, k_out = _time_ms(lambda: tonemap.tonemap(ld, samples, 1.0), 50)
    p_ms, p_out = _time_ms(lambda: tonemap.tonemap_plain(ld, samples, 1.0), 10)
    diff = (k_out.int() - p_out.int()).abs().max().item()
    equal = bool(torch.equal(k_out, p_out))
    h, w = samples.shape
    nbytes = h * w * (12 + 4 + 3)
    b_ms, b_by = bound(nbytes, h * w * 22)
    log(f"[tonemap] {w}x{h} film: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, bound "
        f"{b_ms:.5f} ms ({b_by}: {nbytes} bytes), bit-equal {equal} ({name_limit})")
    if not equal:
        raise AssertionError(f"tone-map kernel differs from plain (max {diff})")
    out = dict(max_abs_err=float(diff), ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by)
    later.append((f"tonemap {w}x{h}", lambda: tonemap.tonemap(ld, samples, 1.0), 50, out,
                  "device_ms"))
    return out


def config2_scene(device):
    from mc_path_tracer_tpu_torch import configs

    scene, cam, cfg, size = configs.config2_mis_area_light()
    if size != (AREA_SIZE, AREA_SIZE) or (cfg.spp, cfg.max_depth) != (AREA_SPP, AREA_DEPTH):
        raise AssertionError(f"config2 changed: {size} {cfg}")
    return build_scene("config2", scene, device, 2320), cam, cfg


def _first_occluder(rays, geo):
    """Index of the first triangle within t_max per ray, -1 if none: the
    triangle tests an index-order any-hit needs."""
    from mc_path_tracer_tpu_torch.ops.intersect import moller_trumbore
    from mc_path_tracer_tpu_torch.ops.kernels.traversal import PLAIN_PAIRS

    first = torch.full((rays.shape[0],), -1, dtype=torch.long, device=rays.device)
    step = max(1, PLAIN_PAIRS // geo.shape[0])
    for s in range(0, rays.shape[0], step):
        c = rays[s : s + step]
        valid, t, _, _ = moller_trumbore(c[:, None, 0:3], c[:, None, 3:6],
                                         geo[None, :, 0:3], geo[None, :, 3:6],
                                         geo[None, :, 6:9])
        occ = valid & (t <= c[:, 7:8])
        first[s : s + step] = torch.where(occ.any(-1), occ.int().argmax(-1), -1)
    return first


def _mt_paths(rays, geo, last=None) -> tuple[int, int, int]:
    """How the (live ray, triangle) tests leave csrc/mt.cuh's test:
    (stopped at the det test, stopped at the u numerator, run in full),
    over every triangle, or over triangles 0..last[i] of live ray i."""
    from mc_path_tracer_tpu_torch.ops.intersect import early_exits
    from mc_path_tracer_tpu_torch.ops.kernels.traversal import PLAIN_PAIRS

    live = rays[rays[:, 6] > 0.5]
    if last is None:
        last = torch.full((live.shape[0],), geo.shape[0] - 1, device=rays.device)
    ids = torch.arange(geo.shape[0], device=rays.device)
    culled = rejected = total = 0
    step = max(1, PLAIN_PAIRS // geo.shape[0])
    v0, e1, e2 = geo[None, :, 0:3], geo[None, :, 3:6], geo[None, :, 6:9]
    for s in range(0, live.shape[0], step):
        c = live[s : s + step]
        tested = ids[None, :] <= last[s : s + step, None]
        det_exit, u_exit, _, _, _ = early_exits(c[:, None, 0:3], c[:, None, 3:6], v0, e1, e2)
        culled += int((det_exit & tested).sum().item())
        rejected += int((u_exit & tested).sum().item())
        total += int(tested.sum().item())
    return culled, rejected, total - culled - rejected


def phase_dense(sd, cam, device, later: list, name_limit):
    """The dense kernel against its plain version at config2's path shapes:
    the 65,536 camera rays of the frame and 65,536 bounded shadow rays from
    their hits toward points sampled on the quad (t_max short of the point,
    as the integrator sets it); the traversal kernel timed on the same rays
    for the crossover DENSE_ACCEL_MAX_TRIS assumes."""
    from mc_path_tracer_tpu_torch.models import lights as lights_mod
    from mc_path_tracer_tpu_torch.models.film import tile_order
    from mc_path_tracer_tpu_torch.models.integrator import SHADOW_OFFSET
    from mc_path_tracer_tpu_torch.ops import intersect
    from mc_path_tracer_tpu_torch.ops.kernels import dense, traversal

    gen = torch.Generator(device=device).manual_seed(1)
    geo, bvh = sd.tris.geo, sd.bvh
    pxi, pyi = tile_order(AREA_SIZE, AREA_SIZE)
    px = torch.from_numpy(pxi.astype(np.float32)).to(device)
    py = torch.from_numpy(pyi.astype(np.float32)).to(device)
    ro, rd = _camera_rays(cam, AREA_SIZE, AREA_SIZE, px, py, device)
    camera_rays = intersect.pack_rays(ro, rd)
    _, tri_id = traversal.closest_plain(camera_rays, geo)
    h = intersect.finish_closest(sd.tris, tri_id, ro, rd)
    u3 = torch.rand((ro.shape[0], 3), generator=gen, device=device)
    wl, dist, _, _ = lights_mod.sample_area(sd.lights.area, sd.tris, h.position, u3)
    shadow_rays = intersect.pack_rays(
        h.position + h.normal * SHADOW_OFFSET, wl, h.hit,
        dist * (1.0 - 1e-3) - 2.0 * SHADOW_OFFSET)
    n_tris = geo.shape[0]
    out = {}
    for name, rays, fn, plain, check, trav in (
        ("dense_closest", camera_rays, dense.dense_closest, traversal.closest_plain,
         _check_closest, lambda r: traversal.trace_closest(r, bvh, geo)),
        ("dense_anyhit", shadow_rays, dense.dense_anyhit, traversal.anyhit_plain,
         _check_anyhit, lambda r: traversal.trace_anyhit(r, bvh, geo)),
    ):
        k_ms, k_out = _time_ms(lambda: fn(rays, geo), 20)
        p_ms, p_out = _time_ms(lambda: plain(rays, geo), 2)
        t_ms, t_out = _time_ms(lambda: trav(rays), 20)
        label = f"{rays.shape[0]} config2 rays"
        err = check(label + " (dense)", rays, k_out, p_out)
        check(label + " (traversal)", rays, t_out, p_out)
        wide_walk(label + " (traversal)", rays, sd, name == "dense_anyhit", t_out)
        # closest hits test every triangle; index-order any-hit stops at
        # the first occluder
        if name == "dense_closest":
            last, out_bytes = None, 8
        else:
            first = _first_occluder(rays, geo)[rays[:, 6] > 0.5]
            last, out_bytes = torch.where(first >= 0, first, n_tris - 1), 1
        paths = _mt_paths(rays, geo, last)
        tests = sum(paths)
        flops = sum(f * n for f, n in zip(MT_EXIT_FLOPS, paths))
        nbytes = (rays.numel() + geo.numel()) * 4 + rays.shape[0] * out_bytes
        b_ms, b_by = bound(nbytes, flops)
        full_ms, _ = bound(nbytes, tests * MT_FLOPS)
        # without FMA pairing each operation issues alone: half the peak rate
        ceiling_ms = 2 * flops / PEAK_FLOPS * 1e3
        log(f"[dense] {label}: of {tests} triangle tests {paths[0]} stop at the det test, "
            f"{paths[1]} at the u numerator, {paths[2]} run in full: {flops} flops")
        log(f"[dense] {name} {rays.shape[0]} rays x {n_tris} triangles: kernel {k_ms:.4f} ms, "
            f"traversal kernel {t_ms:.4f} ms, plain {p_ms:.3f} ms, bound {b_ms:.5f} ms "
            f"({b_by}: {flops} flops by exit path; non-FMA ceiling {ceiling_ms:.5f} ms; "
            f"{full_ms:.5f} ms with every test in full) ({name_limit})")
        out[name] = dict(max_abs_err=err, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
                         full_test_bound_ms=full_ms)
        later.append((f"{name} {label}", lambda f=fn, r=rays: f(r, geo), 20, out[name],
                      "device_ms"))
        later.append((f"{name} {label}, traversal kernel", lambda f=trav, r=rays: f(r), 20,
                      out[name], "traversal_device_ms"))
    return out


def phase_area(sd, cam, cfg, device, png: Path, name_limit):
    """The area-light path: config2 rendered with accel="auto" (2,320
    triangles > DENSE_ACCEL_MAX_TRIS: the traversal kernel) and "dense",
    each saved as a PNG through the tone-map kernel, launches counted around
    render + save; the two images must agree."""
    from mc_path_tracer_tpu_torch.models.integrator import render
    from mc_path_tracer_tpu_torch.ops import rng

    per_sample = {"closest": 4 * AREA_SPP, "anyhit": 2 * AREA_SPP}
    images, launches = {}, {}
    for accel, (c_name, a_name) in (("auto", ("closest", "anyhit")),
                                    ("dense", ("dense_closest", "dense_anyhit"))):
        run_cfg = dataclasses.replace(cfg, accel=accel)
        _reset()
        t0 = time.perf_counter()
        film = render(sd, cam, AREA_SIZE, AREA_SIZE, run_cfg, key=rng.prng_key(0))
        torch.cuda.synchronize()
        frame_s = time.perf_counter() - t0
        path = png.with_name(f"{png.stem}_{accel}{png.suffix}")
        film.save_png(str(path))
        got = _launches()
        images[accel] = film.radiance_mean()
        img = images[accel]
        log(f"[area] config2 {AREA_SIZE}x{AREA_SIZE} {AREA_SPP} spp depth {AREA_DEPTH} "
            f"accel={accel}: frame {frame_s:.3f} s ({name_limit}); launches {got}; "
            f"image mean {img.mean().item():.5f}; wrote {path}")
        _expect(f"accel={accel}", got,
                {c_name: per_sample["closest"], a_name: per_sample["anyhit"], "tonemap": 1})
        _check_image(f"config2 accel={accel}", img)
        launches[accel] = got
    a, b = images["auto"], images["dense"]
    diff = (a - b).abs()
    agree = _agree(a, b, 1e-3)
    mean_rel = abs(a.mean().item() - b.mean().item()) / b.mean().item()
    log(f"[area] traversal vs dense route: {agree:.6f} of pixels within rel 1e-3, "
        f"max abs diff {diff.max().item():.3e}, means {a.mean().item():.6f} / "
        f"{b.mean().item():.6f} (rel {mean_rel:.2e})")
    if agree < 0.99:
        raise AssertionError("the traversal and dense routes disagree on config2")
    return launches


def phase_area_scene(device):
    """tests/test_arealight.py's 4-triangle area scene under accel="auto":
    a CUDA scene of at most DENSE_ACCEL_MAX_TRIS triangles takes the dense
    kernel only."""
    from mc_path_tracer_tpu_torch.models.camera import PerspectiveCamera
    from mc_path_tracer_tpu_torch.models.integrator import RenderConfig, render
    from mc_path_tracer_tpu_torch.models.primitives import plane
    from mc_path_tracer_tpu_torch.models.scene import Scene

    s = Scene()
    s.set_environment_color((0, 0, 0), ls=0.0)
    p, n, uv, idx = plane(20.0)
    s.add_mesh(p, idx, normals=n, uvs=uv, material_id=s.add_material(albedo=(0.7, 0.5, 0.3)))
    q = np.array([[-0.5, 2, -0.5], [0.5, 2, -0.5], [0.5, 2, 0.5], [-0.5, 2, 0.5]], np.float32)
    s.add_mesh(q, np.array([[0, 1, 2], [0, 2, 3]]),
               normals=np.tile([[0, -1, 0]], (4, 1)).astype(np.float32),
               material_id=s.add_material(albedo=(0, 0, 0), emissive=(4.0, 3.0, 2.0)))
    cam = PerspectiveCamera(position=np.array([0.6, 3.0, 2.5]), target=np.zeros(3),
                            fov_deg=35.0)
    sd = build_scene("area scene", s, device, 4)
    _reset()
    img = render(sd, cam, 64, 64, RenderConfig(spp=4, max_depth=3)).radiance_mean()
    got = _launches()
    log(f"[area] area scene 64x64 4 spp accel=auto: launches {got}, "
        f"image mean {img.mean().item():.5f}")
    others = {k: v for k, v in got.items() if k not in ("dense_closest", "dense_anyhit") and v}
    if not got["dense_closest"] or not got["dense_anyhit"] or others:
        raise AssertionError(f"the area scene did not take the dense kernel alone: {got}")


def phase_stream(device, later: list, name_limit):
    """The traversal kernel at the size the TPU's streaming kernel exists
    for: tests_tpu.py's ten 224x224 UV spheres (1,003,520 triangles) built
    through the port's Scene, 2,048 random rays, against plain."""
    from mc_path_tracer_tpu_torch.models.primitives import uv_sphere
    from mc_path_tracer_tpu_torch.models.scene import Scene
    from mc_path_tracer_tpu_torch.ops import intersect
    from mc_path_tracer_tpu_torch.ops.kernels import traversal

    s = Scene()
    s.set_environment_color((0.5, 0.5, 0.5), ls=1.0)
    mb = s.add_material(albedo=(0.7, 0.7, 0.7), roughness=0.6)
    rng = np.random.default_rng(3)
    for _ in range(10):
        c = rng.uniform(-6, 6, 3)
        c[1] = abs(c[1])
        p, nn, uvs, idx = uv_sphere(1.2, center=tuple(c), rings=224, segments=224)
        s.add_mesh(p, idx, normals=nn, uvs=uvs, material_id=mb)
    sd = build_scene("stream scene", s, device, 1003520)
    ro = torch.from_numpy(rng.uniform(-8, 8, (STREAM_RAYS, 3)).astype(np.float32)).to(device)
    rd = torch.from_numpy(rng.normal(size=(STREAM_RAYS, 3)).astype(np.float32)).to(device)
    rd = rd / rd.norm(dim=-1, keepdim=True)
    rays = intersect.pack_rays(ro, rd)
    bvh, geo = sd.bvh, sd.tris.geo
    for name, fn, plain, check, out_bytes in (
        ("closest", traversal.trace_closest, traversal.closest_plain, _check_closest, 8),
        ("anyhit", traversal.trace_anyhit, traversal.anyhit_plain, _check_anyhit, 1),
    ):
        k_ms, k_out = _time_ms(lambda: fn(rays, bvh, geo), 20)
        p_ms, p_out = _time_ms(lambda: plain(rays, geo), 1)
        label = f"{STREAM_RAYS} rays, {geo.shape[0]} triangles"
        check(label, rays, k_out, p_out)
        visits, tests, tri_flops = walk_counts(rays, sd.bvh.packed, geo, name == "anyhit")
        wide_walk(label, rays, sd, name == "anyhit", k_out)
        nbytes = ((rays.numel() + sd.bvh.packed.numel() + geo.numel()) * 4
                  + rays.shape[0] * out_bytes)
        b_ms, b_by = bound(nbytes, visits * SLAB_FLOPS + tri_flops)
        log(f"[stream] {name} {STREAM_RAYS} rays x {geo.shape[0]} triangles "
            f"({sd.bvh.num_nodes} nodes): kernel {k_ms:.4f} ms, plain {p_ms:.3f} ms, "
            f"bound {b_ms:.5f} ms ({b_by}: binary walk {visits} node visits, {tests} "
            f"triangle tests of {tri_flops} flops, {nbytes} bytes) ({name_limit})")
        later.append((f"stream {name} {label}", lambda f=fn: f(rays, bvh, geo), 20,
                      {}, "device_ms"))


def _device_kernels(prof) -> int:
    """Device kernels a torch.profiler session ran (tools/profile_torch_block's
    count: entries with device time and no host time)."""
    return sum(e.count for e in prof.key_averages()
               if getattr(e, "self_device_time_total", 0.0) > 0 and e.cpu_time_total == 0)


def _kernels_per_call(fn) -> int:
    """Device kernels one call of fn runs, under torch.profiler after a
    warm-up call (up to three sessions: now and then one records no device
    activity)."""
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        n = _device_kernels(prof)
        if n:
            return n
    raise AssertionError("torch.profiler saw no device kernels")


class _Recorder:
    """traversal.trace_closest / trace_anyhit wrapped, while in a `with`,
    to keep (kind, rays, output) of every call."""

    def __init__(self):
        from mc_path_tracer_tpu_torch.ops.kernels import traversal

        self.traversal, self.calls = traversal, []

    def _wrap(self, kind, fn):
        def recorded(rays, bvh, geo):
            out = fn(rays, bvh, geo)
            kept = tuple(x.clone() for x in out) if isinstance(out, tuple) else out.clone()
            self.calls.append((kind, rays.clone(), kept))
            return out
        return recorded

    def __enter__(self):
        self.inner = self.traversal.trace_closest, self.traversal.trace_anyhit
        self.traversal.trace_closest = self._wrap("closest", self.inner[0])
        self.traversal.trace_anyhit = self._wrap("anyhit", self.inner[1])
        return self

    def __exit__(self, *exc):
        self.traversal.trace_closest, self.traversal.trace_anyhit = self.inner


def _same(a, b) -> bool:
    if isinstance(a, tuple):
        return all(torch.equal(x, y) for x, y in zip(a, b))
    return torch.equal(a, b)


def phase_sort(device, name_limit) -> dict:
    """RenderConfig.sort_rays on the card (the traversal over octant-sorted,
    dead-last lanes, the JAX package's default): the bench frame with
    sort_rays on and off in turns, SORT_RUNS each, bit-equal, seconds and
    launches (one sort_perm per traversal dispatch), and the sorted frame
    on SHARDS shards of the card bit-equal to them; a replayed train step
    whose backward meets the forward's hits bit for bit; then, on bench
    block SORT_BLOCK, each dispatch of sample 0 (caller order, captured with
    sort_rays off) timed unsorted and sorted (device ms, kernel only), the
    sort's own device ms and kernels per dispatch, and one sample's device
    kernels with and without the sort.  Runs after every other frame and
    before [device-time]: its last part uses torch.profiler.  Returns the
    sorted and unsorted frames' launches: {path: launches}."""
    from mc_path_tracer_tpu_torch.models.film import tile_order
    from mc_path_tracer_tpu_torch.models.integrator import (
        PIXEL_CHUNK,
        RenderConfig,
        camera_params,
        render_tile_radiance,
    )
    from mc_path_tracer_tpu_torch.ops import rng
    from mc_path_tracer_tpu_torch.ops.intersect import _unsorted
    from mc_path_tracer_tpu_torch.ops.kernels import traversal
    from mc_path_tracer_tpu_torch.parallel.mesh import make_mesh
    from mc_path_tracer_tpu_torch.parallel.render import render_sharded

    sd = phase_scene(device)
    cam = bench_camera()
    per = _blocks(WIDTH, HEIGHT) * SPP * (DEPTH - 1)
    seconds, frames, launches = {True: [], False: []}, {}, {}
    for i in range(SORT_RUNS):
        for sort in (True, False) if i % 2 == 0 else (False, True):
            film, s, got = _frame(sd, cam, WIDTH, HEIGHT,
                                  RenderConfig(spp=SPP, max_depth=DEPTH, sort_rays=sort))
            _expect(f"[sort] bench frame sort_rays={sort}", got, {"closest": per, "anyhit": per})
            if got["sort"] != (2 * per if sort else 0):
                raise AssertionError(f"[sort] sort_rays={sort}: {got['sort']} sorted dispatches")
            if sort in frames and not torch.equal(frames[sort], film.ld):
                raise AssertionError(f"[sort] two bench frames with sort_rays={sort} differ")
            seconds[sort].append(s)
            frames[sort], launches[sort] = film.ld, got
    equal = bool(torch.equal(frames[True], frames[False]))
    sharded = render_sharded(sd, dataclasses.replace(cam, aspect=WIDTH / HEIGHT).params(device),
                             WIDTH, HEIGHT, RenderConfig(spp=SPP, max_depth=DEPTH),
                             rng.prng_key(0), make_mesh(devices=[device] * SHARDS))
    sharded_equal = bool(torch.equal(sharded, frames[True]))
    log(f"[sort] bench {WIDTH}x{HEIGHT} {SPP} spp depth {DEPTH}, in turns: sort_rays on "
        f"{', '.join(f'{s:.3f}' for s in seconds[True])} s, off "
        f"{', '.join(f'{s:.3f}' for s in seconds[False])} s ({name_limit}); launches on "
        f"{launches[True]}, off {launches[False]}; frames bit-equal {equal}; the sorted "
        f"frame on {SHARDS} shards bit-equal to the one-device frame {sharded_equal}")
    if not equal or not sharded_equal:
        raise AssertionError("[sort] the sorted, unsorted and sharded bench frames differ")
    del frames, sharded

    # the backward's replay meets the forward's hits: every dispatch of a
    # replayed 2-spp step on a one-block crop, forward and replay, matched
    # by their rays
    px, py = _crop(WIDTH, HEIGHT, SORT_CROP, device)
    target = torch.full((px.shape[0], 3), GRAD_TARGET, device=device)
    with _Recorder() as rec:
        step = _train_step(sd, cam, WIDTH, HEIGHT, px, py,
                           RenderConfig(spp=2, max_depth=DEPTH), target)
    forward, replay = rec.calls[: len(rec.calls) // 2], rec.calls[len(rec.calls) // 2:]
    matched = sum(any(k == k2 and torch.equal(r, r2) and _same(o, o2) for k2, r2, o2 in forward)
                  for k, r, o in replay)
    log(f"[sort] replayed 2-spp train step on a {SORT_CROP}x{SORT_CROP} crop: {len(forward)} "
        f"forward and "
        f"{len(replay)} replayed traversal dispatches, {matched} replayed dispatches with the "
        f"rays and hits of a forward one (launches forward {step['forward']}, backward "
        f"{step['backward']})")
    if len(forward) != 2 * 2 * (DEPTH - 1) or matched != len(replay) or \
            step["forward"] != step["backward"]:
        raise AssertionError("[sort] the replay did not meet the forward's hits")

    # block SORT_BLOCK, sample 0: each dispatch unsorted and sorted
    pxi, pyi = tile_order(WIDTH, HEIGHT)
    blk = slice(SORT_BLOCK * PIXEL_CHUNK, (SORT_BLOCK + 1) * PIXEL_CHUNK)
    px = torch.from_numpy(pxi[blk].astype(np.float32)).to(device)
    py = torch.from_numpy(pyi[blk].astype(np.float32)).to(device)
    params = camera_params(cam, WIDTH, HEIGHT, device)

    def sample(sort):
        with torch.no_grad():
            return render_tile_radiance(sd, params, WIDTH, HEIGHT, px, py, rng.prng_key(0),
                                        RenderConfig(spp=1, max_depth=DEPTH, sort_rays=sort))

    with _Recorder() as rec:
        sample(False)
    bvh, geo = sd.bvh, sd.tris.geo
    bounce = {"closest": 0, "anyhit": 1}
    dispatches, sort_kernels = [], 0
    for kind, rays, out in rec.calls:
        fn = traversal.trace_closest if kind == "closest" else traversal.trace_anyhit
        rd, live = rays[:, 3:6], rays[:, 6] > 0.5
        perm = traversal.sort_perm(rd, live)
        sorted_rays = rays[perm]
        got = fn(sorted_rays, bvh, geo)
        back = (tuple(_unsorted(x, perm) for x in got) if kind == "closest"
                else _unsorted(got, perm))
        if not _same(back, out):
            raise AssertionError(f"[sort] block {SORT_BLOCK}: a sorted {kind} dispatch differs")
        ref = out[1] if kind == "closest" else out

        def overhead(rd=rd, live=live, rays=rays, ref=ref):
            p = traversal.sort_perm(rd, live)
            rays[p]
            _unsorted(ref, p)

        unsorted_ms = _device_ms(lambda f=fn, r=rays: f(r, bvh, geo), 20)
        sorted_ms = _device_ms(lambda f=fn, r=sorted_rays: f(r, bvh, geo), 20)
        sort_ms = _device_ms(overhead, 20)
        kernels = _kernels_per_call(overhead)
        sort_kernels += kernels
        label = "primary" if kind == "closest" and bounce[kind] == 0 else f"bounce {bounce[kind]}"
        bounce[kind] += 1
        dispatches.append(dict(kind=kind, label=label, rays=rays.shape[0],
                               live=int(live.sum()), unsorted_ms=unsorted_ms,
                               sorted_ms=sorted_ms, sort_ms=sort_ms, sort_kernels=kernels))
        log(f"[sort] block {SORT_BLOCK} sample 0 {kind} {label}: {rays.shape[0]} rays "
            f"({int(live.sum())} live), device ms unsorted {unsorted_ms:.4f}, sorted "
            f"{sorted_ms:.4f} (kernel only); the sort (key, sort, gather, scatter) "
            f"{sort_ms:.4f} ms in {kernels} device kernels ({name_limit})")
    per_sample = {sort: _kernels_per_call(lambda s=sort: sample(s)) for sort in (True, False)}
    log(f"[sort] block {SORT_BLOCK}, one sample: {per_sample[True]} device kernels with "
        f"sort_rays, {per_sample[False]} without ({per_sample[True] - per_sample[False]} for "
        f"the sort; {sort_kernels} counted dispatch by dispatch) ({name_limit})")
    return {"sort_frame": launches[True], "unsorted_frame": launches[False]}


def _frame(scene, cam, width, height, cfg, key=0, device="cuda"):
    """One render of `scene` (a Scene, built on `device`, or a SceneData)
    with the launch counts set to 0 just before and read just after:
    (film, seconds, launches)."""
    from mc_path_tracer_tpu_torch.models.integrator import render
    from mc_path_tracer_tpu_torch.ops import rng

    _reset()
    t0 = time.perf_counter()
    film = render(scene, cam, width, height, cfg, key=rng.prng_key(key), device=device)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return film, seconds, _launches()


def _expect(label, got, want):
    """Fail unless the kernel launches and plain calls are exactly `want`
    (others 0); sort_perm calls ("sort") are checked where they are asked
    for, in [sort]."""
    wrong = {k: got[k] for k in got if k != "sort" and got[k] != want.get(k, 0)}
    if wrong:
        raise AssertionError(f"{label}: launches {got}, expected {want}")


def _check_image(label, img):
    if not bool(torch.isfinite(img).all()) or img.mean().item() <= 0.0:
        raise AssertionError(f"{label}: image is not finite, or dark")


def _agree(a, b, rel):
    """Share of pixels whose every channel is within rel of b (+1e-6)."""
    return ((a - b).abs() <= rel * b.abs() + 1e-6).all(dim=-1).float().mean().item()


def _blocks(width, height):
    from mc_path_tracer_tpu_torch.models.integrator import PIXEL_CHUNK

    return -(-width * height // PIXEL_CHUNK)


def _shard_blocks(width, height, shards) -> list[int]:
    """Blocks of each of `shards` equal row ranges of a width x height
    frame, cut on the whole frame's block grid (render_tile_radiance's
    `first`, as a sharded train step cuts them): a block that a shard's
    edge cuts runs in both shards."""
    from mc_path_tracer_tpu_torch.models.integrator import PIXEL_CHUNK

    rows = width * height // shards
    return [len({0, *range(-(g * rows) % PIXEL_CHUNK, rows, PIXEL_CHUNK)})
            for g in range(shards)]


def phase_configs(device, out_dir: Path, name_limit):
    """Configs 1, 3 and 4 at their configured size, spp and depth, and
    config5 at 1920x1080 x depth 5 cut to CONFIG5_SPP spp, each through the
    traversal kernel (every one has more than DENSE_ACCEL_MAX_TRIS
    triangles) and saved as a PNG through the tone-map kernel; config5 must
    be built by the native LBVH.  Returns the built Scenes by number and
    config4's accumulated radiance."""
    from mc_path_tracer_tpu_torch import configs
    from mc_path_tracer_tpu_torch.utils import native

    scenes = {}
    for n in (1, 3, 4, 5):
        scene, cam, cfg, (w, h) = configs.ALL_CONFIGS[n]()
        if n == 5:
            if scene.bvh_method != native.LBVH:
                raise AssertionError("config5 does not ask for the LBVH builder")
            log(f"[configs] config5: cut from {cfg.spp} spp to {CONFIG5_SPP} spp to fit the "
                f"run's time; {w}x{h} and depth {cfg.max_depth} as configured")
            cfg = dataclasses.replace(cfg, spp=CONFIG5_SPP)
        sd = build_scene(f"config{n}", scene, device, CONFIG_TRIS[n])
        film, seconds, got = _frame(sd, cam, w, h, cfg)
        path = out_dir / f"config{n}.png"
        _reset()
        film.save_png(str(path))
        saved = _launches()
        img = film.radiance_mean()
        per = _blocks(w, h) * cfg.spp * (cfg.max_depth - 1)
        log(f"[configs] config{n}: {CONFIG_TRIS[n]} triangles, {w}x{h} {cfg.spp} spp depth "
            f"{cfg.max_depth}: frame {seconds:.3f} s ({name_limit}); launches {got}; "
            f"image mean {img.mean().item():.5f}; wrote {path} (launches {saved})")
        _expect(f"config{n}", got, {"closest": per, "anyhit": per})
        _expect(f"config{n} PNG", saved, {"tonemap": 1})
        _check_image(f"config{n}", img)
        scenes[n] = (scene, cam)
        if n == 4:
            frame4 = film.ld
    return scenes, frame4


def phase_golden(scenes, device):
    """Config4 at 16x16 x 4 spp x depth 2 and config5 at 96x54 x 2 spp x
    depth 3, key 42, on the card through the kernels, against the JAX
    package's CPU renders in tests/golden/."""
    from mc_path_tracer_tpu_torch.models.integrator import RenderConfig

    for n, name, (w, h), spp, depth, min_share in GOLDENS:
        scene, cam = scenes[n]
        film, seconds, got = _frame(scene, cam, w, h, RenderConfig(spp=spp, max_depth=depth),
                                    key=42, device=device)
        img = film.radiance_mean()
        want = torch.from_numpy(np.load(Path(__file__).parent / "tests" / "golden" / f"{name}.npy"))
        got_img = img.cpu()
        close = torch.isclose(got_img, want, rtol=GOLDEN_RTOL, atol=GOLDEN_ATOL)
        share = close.all(dim=-1).float().mean().item()
        share_1e2 = torch.isclose(got_img, want, rtol=1e-2, atol=GOLDEN_ATOL).all(
            dim=-1).float().mean().item()
        mean_rel = abs(got_img.mean().item() - want.mean().item()) / want.mean().item()
        log(f"[golden] {name}: {share:.6f} of pixels within rtol {GOLDEN_RTOL:g} / atol "
            f"{GOLDEN_ATOL:g} (at least {min_share}), {share_1e2:.6f} within rtol 1e-2, max "
            f"abs diff {(got_img - want).abs().max().item():.3e}, frame mean rel "
            f"{mean_rel:.3e}; launches {got}")
        per = _blocks(w, h) * spp * (depth - 1)
        _expect(name, got, {"closest": per, "anyhit": per})
        if share < min_share or mean_rel > GOLDEN_MEAN_REL:
            raise AssertionError(f"{name} misses its golden")


def textured_scene(scene_cls, path):
    """The glTF test scene through a package's Scene API: the GLB loaded,
    the sphere moved by set_transform, a dim environment and a sun."""
    s = scene_cls()
    s.set_environment_color((0.25, 0.3, 0.4), ls=1.0)
    s.load(str(path))
    s.set_transform(1, translation=(0.2, 0.1, -0.2), rotation_deg=(0.0, 35.0, 10.0),
                    scale=1.1)
    s.add_directional_light((0.5, 1.0, 0.3), color=(1.0, 0.95, 0.9), ls=1.5)
    return s


def textured_camera(camera_cls):
    return camera_cls(position=np.array([2.2, 2.4, 4.0]),
                      target=np.array([0.0, 0.6, 0.0]), fov_deg=40.0)


def phase_gltf(device, out_dir: Path, name_limit) -> None:
    """The textured glTF path: the GLB written by write_textured_glb loaded
    with Scene.load, one object moved, rendered under "auto" (the dense
    kernel) and accel="pallas" (the traversal kernel); the two images
    agree, the kernel route agrees with the plain route on a crop, and the
    frame is saved through the tone-map kernel."""
    from mc_path_tracer_tpu_torch.models.camera import PerspectiveCamera
    from mc_path_tracer_tpu_torch.models.integrator import RenderConfig
    from mc_path_tracer_tpu_torch.models.scene import Scene

    path = write_textured_glb(out_dir / "textured.glb")
    t0 = time.perf_counter()
    scene = textured_scene(Scene, path)
    load_s = time.perf_counter() - t0
    sd = build_scene("textured glTF", scene, device, GLTF_TRIS)
    log(f"[gltf] {path} ({path.stat().st_size} bytes): loaded in {load_s:.3f} s, "
        f"{len(scene.objects)} objects, {sd.atlas.count} textures in a "
        f"{tuple(sd.atlas.data.shape)} atlas, {sd.lights.area.count} emissive triangles")
    cam = textured_camera(PerspectiveCamera)
    size, spp, depth = GLTF_SIZE, GLTF_SPP, GLTF_DEPTH
    blocks = _blocks(size, size)
    # area light: per sample 1 + (depth - 1) + (depth - 2) closest, depth - 1 any-hit
    closest = blocks * spp * (2 * depth - 2)
    anyhit = blocks * spp * (depth - 1)
    images = {}
    for accel, names in (("auto", ("dense_closest", "dense_anyhit")),
                         ("pallas", ("closest", "anyhit"))):
        cfg = RenderConfig(spp=spp, max_depth=depth, accel=accel)
        film, seconds, got = _frame(sd, cam, size, size, cfg)
        img = film.radiance_mean()
        log(f"[gltf] {size}x{size} {spp} spp depth {depth} accel={accel}: frame {seconds:.3f} s "
            f"({name_limit}); launches {got}; image mean {img.mean().item():.5f}")
        _expect(f"gltf accel={accel}", got, {names[0]: closest, names[1]: anyhit})
        _check_image(f"gltf accel={accel}", img)
        images[accel] = img
        if accel == "auto":
            png = out_dir / "textured.png"
            _reset()
            film.save_png(str(png))
            saved = _launches()
            _expect("gltf PNG", saved, {"tonemap": 1})
            log(f"[gltf] wrote {png} through the tone-map kernel (launches {saved})")
    agree = _agree(images["pallas"], images["auto"], 1e-3)
    log(f"[gltf] traversal vs dense route: {agree:.6f} of pixels within rel 1e-3, max abs "
        f"diff {(images['pallas'] - images['auto']).abs().max().item():.3e}")
    if agree < 0.99:
        raise AssertionError("the traversal and dense routes disagree on the glTF scene")
    _crop_parity("gltf", sd, cam, size, size, RenderConfig(spp=spp, max_depth=depth))


def _crop_parity(label, sd, cam, width, height, cfg) -> None:
    """The kernel route ("auto") against the plain route ("brute") on the
    central CROP x CROP pixels."""
    from mc_path_tracer_tpu_torch.models.integrator import camera_params, render_tile_radiance
    from mc_path_tracer_tpu_torch.ops import rng

    device = sd.tris.v0.device
    px, py = _crop(width, height, CROP, device)
    params = camera_params(cam, width, height, device)
    out = {accel: render_tile_radiance(sd, params, width, height, px, py, rng.prng_key(0),
                                       dataclasses.replace(cfg, accel=accel))
           for accel in ("auto", "brute")}
    agree = _agree(out["auto"], out["brute"], 1e-3)
    log(f"[{label}] {CROP}x{CROP} crop, kernel vs plain route: {agree:.6f} of pixels within "
        f"rel 1e-3, max abs diff {(out['auto'] - out['brute']).abs().max().item():.3e}")
    if not bool(torch.isfinite(out["auto"]).all()) or agree < 0.99:
        raise AssertionError(f"{label}: kernel route and plain route disagree")


def _count_lanes(fn):
    """Run fn() with the two traversal entry points wrapped to add up the
    lanes they are given (rays dispatched, and live ones); the wrappers
    still count their own launches."""
    from mc_path_tracer_tpu_torch.ops.kernels import traversal

    lanes = {"closest": [0, 0], "anyhit": [0, 0]}
    originals = traversal.trace_closest, traversal.trace_anyhit

    def counting(name, original):
        def wrapped(rays, *args):
            lanes[name][0] += rays.shape[0]
            lanes[name][1] += int((rays[:, 6] > 0.5).sum().item())
            return original(rays, *args)
        return wrapped

    traversal.trace_closest = counting("closest", originals[0])
    traversal.trace_anyhit = counting("anyhit", originals[1])
    try:
        fn()
    finally:
        traversal.trace_closest, traversal.trace_anyhit = originals
    return lanes


def phase_reuse(sd2, cam2, cfg2, two_sample: dict, scenes, device, name_limit) -> None:
    """reuse_brdf_ray on config2 at its configured size (traversal kernel):
    one closest hit per sample fewer than the two-sample estimator, the
    same any-hit dispatches (config2's area light bounds the shadow rays
    either way).  On config4 (no area light) the shared trace replaces the
    fused 2R-lane any-hit of every bounce but the last: fewer any-hit
    lanes.  The kernel route agrees with the plain route on a crop."""
    from mc_path_tracer_tpu_torch.models.integrator import RenderConfig, render
    from mc_path_tracer_tpu_torch.ops import rng

    cfg = dataclasses.replace(cfg2, reuse_brdf_ray=True)
    film, seconds, got = _frame(sd2, cam2, AREA_SIZE, AREA_SIZE, cfg)
    img = film.radiance_mean()
    log(f"[reuse] config2 {AREA_SIZE}x{AREA_SIZE} {cfg.spp} spp depth {cfg.max_depth} "
        f"reuse_brdf_ray=True: frame {seconds:.3f} s ({name_limit}); launches {got} "
        f"(two-sample: {two_sample}); image mean {img.mean().item():.5f}")
    _expect("reuse config2", got, {"closest": 3 * cfg.spp, "anyhit": 2 * cfg.spp})
    _check_image("reuse config2", img)
    if got["closest"] >= two_sample["closest"] or got["anyhit"] > two_sample["anyhit"]:
        raise AssertionError("reuse_brdf_ray made no fewer dispatches than two samples")
    scene4, cam4 = scenes[4]
    counts = {}
    for reuse in (False, True):
        c4 = RenderConfig(spp=REUSE_LANE_SPP, max_depth=3, reuse_brdf_ray=reuse)
        counts[reuse] = _count_lanes(lambda: render(scene4, cam4, PROG_W, PROG_H, c4,
                                                    key=rng.prng_key(0), device=device))
    per = {k: {e: [x / (REUSE_LANE_SPP * 2) for x in v] for e, v in c.items()}
           for k, c in counts.items()}
    log(f"[reuse] config4 {PROG_W}x{PROG_H} {REUSE_LANE_SPP} spp depth 3, lanes per sample per NEE "
        f"bounce [dispatched, live]: two-sample {per[False]}, reuse {per[True]}")
    if counts[True]["anyhit"][0] >= counts[False]["anyhit"][0]:
        raise AssertionError("reuse_brdf_ray made no fewer any-hit lanes on config4")
    _crop_parity("reuse", sd2, cam2, AREA_SIZE, AREA_SIZE,
                 dataclasses.replace(cfg, spp=8))


def phase_progressive(scenes, device, name_limit) -> None:
    """render_progressive on config4 at 384x128, PROG_SPP passes of 1 spp,
    128-pixel tiles: its final film equals the sum of `render` frames of
    1 spp with the passes' keys fold_in(key, p).  A RenderSession restarts
    at one pass after set_transform."""
    from mc_path_tracer_tpu_torch.models.engine import RenderSession
    from mc_path_tracer_tpu_torch.models.integrator import (
        RenderConfig,
        render,
        render_progressive,
    )
    from mc_path_tracer_tpu_torch.ops import rng

    scene, cam = scenes[4]
    w, h, tile = PROG_W, PROG_H, PROG_TILE
    cfg = RenderConfig(spp=PROG_SPP, max_depth=3)
    key = rng.prng_key(0)
    _reset()
    t0 = time.perf_counter()
    steps = 0
    for film in render_progressive(scene, cam, w, h, cfg, key=key, tile=tile, device=device):
        steps += 1
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    got = _launches()
    tiles = -(-w // tile) * -(-h // tile)
    per = PROG_SPP * tiles * (cfg.max_depth - 1)
    log(f"[progressive] config4 {w}x{h} {PROG_SPP} passes x {tiles} tiles of {tile}: "
        f"{steps} steps in {seconds:.3f} s ({name_limit}); launches {got}")
    _expect("progressive", got, {"closest": per, "anyhit": per})
    ref = torch.zeros_like(film.ld)
    for p in range(PROG_SPP):
        ref = ref + render(scene, cam, w, h, dataclasses.replace(cfg, spp=1),
                           key=rng.fold_in(key, p), device=device).ld
    agree = _agree(film.ld, ref, 1e-5)
    log(f"[progressive] final film vs the sum of {PROG_SPP} 1-spp renders keyed fold_in(key, "
        f"p): {agree:.6f} of pixels within rel 1e-5, max abs diff "
        f"{(film.ld - ref).abs().max().item():.3e}; samples {film.samples.min().item():g}.."
        f"{film.samples.max().item():g}")
    if agree < 0.999 or not bool((film.samples == PROG_SPP).all()):
        raise AssertionError("render_progressive does not add up to render")
    session = RenderSession(scene=scene, camera=cam, width=w, height=h, cfg=cfg, tile=tile,
                            device=device)
    for _ in range(tiles + 1):
        before = session.step()
    scene.set_transform(1, translation=(0.0, 0.3, 0.0))
    after = session.step()
    log(f"[progressive] RenderSession: samples max {before.samples.max().item():g} before "
        f"set_transform, {after.samples.max().item():g} after (version {scene.version}), "
        f"{int((after.samples > 0).sum().item())} pixels sampled")
    if before.samples.max().item() != 2 or after.samples.max().item() != 1 or \
            int((after.samples > 0).sum().item()) != tile * tile:
        raise AssertionError("RenderSession did not restart on set_transform")
    scene.set_transform(1, translation=(0.0, 0.0, 0.0))


def _crop(width, height, size, device):
    """Pixel coordinates (px, py) of the central size x size crop."""
    x0, y0 = (width - size) // 2, (height - size) // 2
    ys, xs = torch.meshgrid(torch.arange(size), torch.arange(size), indexing="ij")
    return (xs.reshape(-1) + x0).float().to(device), (ys.reshape(-1) + y0).float().to(device)


def _frame_pixels(width, height, device):
    """Every pixel of the frame in render()'s 32x16 tile order."""
    from mc_path_tracer_tpu_torch.models.film import tile_order

    pxi, pyi = tile_order(width, height)
    return (torch.from_numpy(pxi.astype(np.float32)).to(device),
            torch.from_numpy(pyi.astype(np.float32)).to(device))


def _train_step(sd, cam, width, height, px, py, cfg, target, replay=True, mesh=None):
    """One make_train_step step (key 0, on `mesh` if given) with the launch
    counts set to 0 and the peak memory reset just before: {loss, grads (the
    7 tensors in GRAD_NAMES order), seconds, peak_gb, forward, backward
    launches}."""
    from mc_path_tracer_tpu_torch import make_train_step
    from mc_path_tracer_tpu_torch.models.integrator import camera_params
    from mc_path_tracer_tpu_torch.ops import rng

    step = make_train_step(cfg, width, height, cfg.spp, replay=replay, mesh=mesh)
    params = camera_params(cam, width, height, sd.tris.v0.device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset()
    t0 = time.perf_counter()
    loss, (mat, ls, tex) = step(sd, params, px, py, target, rng.prng_key(0))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    total = _launches()
    forward = {k: step.forward_launches[k] for k in total}
    grads = [*mat, ls, tex]
    if not bool(torch.isfinite(loss)) or not all(bool(torch.isfinite(g).all()) for g in grads):
        raise AssertionError("a train step gave a loss or a gradient that is not finite")
    return dict(loss=loss.item(), grads=grads, seconds=seconds, forward_s=step.forward_seconds,
                peak_gb=torch.cuda.max_memory_allocated() / 1e9, forward=forward,
                backward={k: total[k] - forward[k] for k in total})


def _l1(grads) -> str:
    return ", ".join(f"{n} {g.abs().sum().item():.6g}" for n, g in zip(GRAD_NAMES, grads))


def _grad_gap(a, b) -> float:
    """The largest gap between two gradient lists, each tensor's gap as a
    share of b's largest magnitude (bench_scaling.grad_gap)."""
    from mc_path_tracer_tpu_torch.bench_scaling import grad_gap

    return grad_gap(a, b)


def phase_grad(sd2, cam2, cfg2, device, name_limit) -> dict:
    """Train steps at full width: config4 as configured (traversal kernel),
    the bench scene at 1920x1080 cut to 1 spp (materials, ls and the HDR
    environment's texels) and config2 under accel="dense" cut to 8 spp (the
    area light's emissive gradient), each against a mid-grey target.  The
    forward's launches must be the render's; returns the steps and scenes
    by label."""
    from mc_path_tracer_tpu_torch import configs
    from mc_path_tracer_tpu_torch.models.integrator import RenderConfig

    scene4, cam4, cfg4, (w4, h4) = configs.config4_roughness_sweep()
    sd4 = build_scene("config4", scene4, device, CONFIG_TRIS[4])
    sdb = build_scene("bench scene", build_bench_scene(), device, 48002)
    cases = (
        ("config4", sd4, cam4, w4, h4, cfg4, "as configured",
         ("closest", "anyhit"), ("albedo", "roughness", "tex")),
        ("bench", sdb, bench_camera(), WIDTH, HEIGHT,
         RenderConfig(spp=GRAD_BENCH_SPP, max_depth=DEPTH),
         f"spp cut from {SPP} to {GRAD_BENCH_SPP} to fit the run",
         ("closest", "anyhit"), ("albedo", "roughness", "metallic", "fresnel", "ls", "tex")),
        ("config2 dense", sd2, cam2, AREA_SIZE, AREA_SIZE,
         dataclasses.replace(cfg2, spp=GRAD_AREA_SPP, accel="dense"),
         f"spp cut from {AREA_SPP} to {GRAD_AREA_SPP}",
         ("dense_closest", "dense_anyhit"), ("albedo", "roughness", "emissive")),
    )
    out = {}
    for label, sd, cam, w, h, cfg, cut, (c_name, a_name), reached in cases:
        px, py = _frame_pixels(w, h, device)
        rec = _train_step(sd, cam, w, h, px, py, cfg, torch.full((w * h, 3), GRAD_TARGET,
                                                                  device=device))
        log(f"[grad] {label} {w}x{h} {cfg.spp} spp depth {cfg.max_depth} ({cut}): step "
            f"{rec['seconds']:.3f} s ({name_limit}), peak {rec['peak_gb']:.3f} GB, loss "
            f"{rec['loss']:.6g}; gradient L1 norms: {_l1(rec['grads'])}; launches forward "
            f"{rec['forward']}, backward {rec['backward']}")
        if label == "config2 dense":
            per = {c_name: 4 * cfg.spp, a_name: 2 * cfg.spp}   # as [area]
        else:
            per = dict.fromkeys((c_name, a_name), _blocks(w, h) * cfg.spp * (cfg.max_depth - 1))
        _expect(f"{label} train step forward", rec["forward"], per)
        for name in reached:
            if rec["grads"][GRAD_NAMES.index(name)].abs().sum().item() <= 0.0:
                raise AssertionError(f"{label}: no gradient reached {name}")
        out[label] = (rec, sd, cam, w, h, cfg)
    return out


def phase_grad_check(steps: dict, device, name_limit) -> None:
    """The gradient path's checks on the card: the backward replays every
    kernel launch of the forward and calls no plain version; on a config4
    crop the kernel route's gradients equal the plain route's; config4's
    replayed step equals the same step keeping every sample's graph; and a
    central difference of the loss matches the gradient along the bench
    scene's directional ls and along config4's environment texels (the
    radiance is linear in both and the loss quadratic)."""
    from mc_path_tracer_tpu_torch.parallel.render import scene_params, with_params

    for label, (rec, *_) in steps.items():
        if rec["backward"] != rec["forward"] or rec["forward"]["plain"] != 0:
            raise AssertionError(f"{label}: the backward did not replay the forward's "
                                 f"launches: forward {rec['forward']}, backward {rec['backward']}")
    log("[grad-check] every backward replayed the forward's kernel launches, no plain call")

    rec4, sd4, cam4, w4, h4, cfg4 = steps["config4"]
    px, py = _crop(w4, h4, GRAD_CROP, device)
    target = torch.full((px.shape[0], 3), GRAD_TARGET, device=device)
    crop_cfg = dataclasses.replace(cfg4, spp=1)
    routes = {accel: _train_step(sd4, cam4, w4, h4, px, py,
                                 dataclasses.replace(crop_cfg, accel=accel), target)
              for accel in ("auto", "brute")}
    gap = _grad_gap(routes["auto"]["grads"], routes["brute"]["grads"])
    log(f"[grad-check] config4 {GRAD_CROP}x{GRAD_CROP} crop, 1 spp: kernel vs plain route "
        f"gradients, largest gap {gap:.3e} of the largest gradient; losses "
        f"{routes['auto']['loss']:.9g} / {routes['brute']['loss']:.9g}; launches "
        f"{routes['auto']['forward']} / {routes['brute']['forward']} (forward)")
    if gap > GRAD_TOL or routes["auto"]["forward"]["plain"] != 0 or \
            routes["brute"]["forward"]["closest"] != 0:
        raise AssertionError("config4: the kernel route's gradients differ from the plain route's")

    # in turns: [grad]'s replayed step (the run's first train step), kept
    # graphs, replayed again
    px, py = _frame_pixels(w4, h4, device)
    target = torch.full((w4 * h4, 3), GRAD_TARGET, device=device)
    kept = _train_step(sd4, cam4, w4, h4, px, py, cfg4, target, replay=False)
    again = _train_step(sd4, cam4, w4, h4, px, py, cfg4, target)
    gap = max(_grad_gap(rec4["grads"], kept["grads"]), _grad_gap(again["grads"], kept["grads"]))
    log(f"[grad-check] config4 {w4}x{h4} {cfg4.spp} spp: replayed vs kept graphs, largest gap "
        f"{gap:.3e} of the largest gradient; peak {rec4['peak_gb']:.3f} GB replayed, "
        f"{kept['peak_gb']:.3f} GB kept, {again['peak_gb']:.3f} GB replayed again; step "
        f"{rec4['seconds']:.3f} s replayed (the run's first step), {kept['seconds']:.3f} s kept, "
        f"{again['seconds']:.3f} s replayed again; backward launches {kept['backward']} kept "
        f"({name_limit})")
    if gap > GRAD_TOL or kept["backward"]["closest"] != 0 or kept["forward"] != rec4["forward"] \
            or again["backward"] != rec4["backward"]:
        raise AssertionError("config4: replayed gradients differ from kept-graph gradients")

    def central_difference(label, sd, cam, w, h, cfg, field, direction):
        """d loss / d x along `direction` of parameter `field` ("ls" or
        "tex"), from the step's gradient and from a central difference."""
        px, py = _crop(w, h, GRAD_CROP * 2, device)
        target = torch.full((px.shape[0], 3), GRAD_TARGET, device=device)
        rec = _train_step(sd, cam, w, h, px, py, cfg, target)
        grad = (rec["grads"][GRAD_NAMES.index(field)] * direction).sum().item()
        losses = []
        for sign in (1.0, -1.0):
            params = list(scene_params(sd))   # (MaterialGrads, ls, tex)
            i = 1 if field == "ls" else 2
            params[i] = params[i] + sign * FD_EPS * direction
            losses.append(_train_step(with_params(sd, tuple(params)), cam, w, h, px, py, cfg,
                                      target)["loss"])
        fd = (losses[0] - losses[1]) / (2 * FD_EPS)
        rel = abs(grad - fd) / abs(fd)
        log(f"[grad-check] {label} {GRAD_CROP * 2}x{GRAD_CROP * 2} crop {cfg.spp} spp depth "
            f"{cfg.max_depth}: d loss along {field}: gradient {grad:.9g}, central difference "
            f"{fd:.9g} (eps {FD_EPS}), rel {rel:.3e}")
        if not rel <= FD_RTOL:
            raise AssertionError(f"{label}: the {field} gradient misses its finite difference")

    recb, sdb, camb, wb, hb, cfgb = steps["bench"]
    central_difference("bench", sdb, camb, wb, hb, cfgb, "ls", torch.ones_like(
        sdb.lights.directional.ls))
    central_difference("config4", sd4, cam4, w4, h4, dataclasses.replace(cfg4, spp=4), "tex",
                       sd4.lights.env.tex)


def phase_train(steps: dict, device, name_limit) -> None:
    """TRAIN_STEPS SGD steps on config4's albedo toward the same scene and
    key rendered with albedo scaled by TRAIN_SCALE, at 384x128 x
    TRAIN_SPP spp x depth 3: the loss must fall at every step."""
    from mc_path_tracer_tpu_torch.models.integrator import camera_params, render_tile_radiance
    from mc_path_tracer_tpu_torch.ops import rng
    from mc_path_tracer_tpu_torch.parallel.render import scene_params, with_params

    _, sd4, cam4, w, h, cfg4 = steps["config4"]
    cfg = dataclasses.replace(cfg4, spp=TRAIN_SPP)
    px, py = _frame_pixels(w, h, device)
    mat, ls, tex = scene_params(sd4)
    with torch.no_grad():
        want = with_params(sd4, (mat._replace(albedo=mat.albedo * TRAIN_SCALE), ls, tex))
        target = render_tile_radiance(want, camera_params(cam4, w, h, device), w, h, px, py,
                                      rng.prng_key(0), cfg) / cfg.spp
    sd, losses, seconds = sd4, [], []
    for _ in range(TRAIN_STEPS):
        rec = _train_step(sd, cam4, w, h, px, py, cfg, target)
        losses.append(rec["loss"])
        seconds.append(rec["seconds"])
        albedo = sd.materials.albedo - TRAIN_LR * rec["grads"][0]
        sd = sd._replace(materials=sd.materials._replace(albedo=albedo))
    before = [round(x, 6) for x in sd4.materials.albedo[1].tolist()]
    after = [round(x, 6) for x in sd.materials.albedo[1].tolist()]
    log(f"[train] config4 {w}x{h} {cfg.spp} spp depth {cfg.max_depth}, albedo toward x"
        f"{TRAIN_SCALE}, SGD lr {TRAIN_LR}: losses {[f'{x:.9g}' for x in losses]}; seconds per "
        f"step {[f'{x:.3f}' for x in seconds]} ({name_limit}); sphere 1 albedo {before} -> "
        f"{after}")
    if not all(b < a for a, b in zip(losses, losses[1:])):
        raise AssertionError("the loss did not fall at every SGD step")


# ---------------------------------------------------------------------------
# Test assets: a PNG encoder with a chosen row filter and a GLB writer.  The
# [gltf] phase and tests/test_torch_gltf.py load the same file from here.
# ---------------------------------------------------------------------------

def phase_bench(name_limit) -> None:
    """The benchmark's block loop in --strided mode, through bench.run (the
    function its main calls): the result line and its keys, and every
    block through the traversal kernel."""
    from mc_path_tracer_tpu_torch import bench

    _reset()
    out = bench.run(strided=True, log=lambda msg: log(f"[bench] {msg}"))
    got = _launches()
    log(f"[bench] {json.dumps(out)}")
    missing = [k for k in BENCH_KEYS if k not in out]
    # the warm-up, the timed blocks and the re-measured ones, each a block
    per = SPP * (DEPTH - 1)
    log(f"[bench] strided: {out['value']:.3f} Mrays/s, frame {out['frame_s']:.3f} s "
        f"({name_limit}); launches {got}")
    if missing or not np.isfinite(out["value"]) or out["value"] <= 0.0:
        raise AssertionError(f"bench line is missing {missing} or has no rate: {out}")
    if got["plain"] or got["closest"] != got["anyhit"] or got["closest"] % per or \
            got["closest"] < per * (1 + len(out["block_s"])):
        raise AssertionError(f"bench blocks did not run through the kernel: {got}")


def _preview_frame(sd, cam, width, height, mode, accel):
    """preview_pixels over every pixel in row-major order, [H, W, 3]."""
    from mc_path_tracer_tpu_torch.models.preview import preview_pixels

    device = sd.tris.v0.device
    ys, xs = torch.meshgrid(torch.arange(height, device=device),
                            torch.arange(width, device=device), indexing="ij")
    px, py = xs.reshape(-1).float(), ys.reshape(-1).float()
    return preview_pixels(sd, cam, width, height, px, py, mode, accel).reshape(height, width, 3)


def _preview_run(label, fn, width, height, want, name_limit):
    """fn() twice, each with the launch counts set to 0 and the peak memory
    reset just before: checks the launches and the image; returns it."""
    seconds, peaks = [], []
    for _ in range(2):
        _reset()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        img = fn()
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        peaks.append(torch.cuda.max_memory_allocated() / 1e9)
        got = _launches()
        _expect(label, got, want)
    log(f"[preview] {label} {width}x{height}: {seconds[0]:.3f} s first, {seconds[1]:.3f} s "
        f"second ({name_limit}); launches {got}; peak {max(peaks):.3f} GB; mean "
        f"{img.mean().item():.5f}")
    if tuple(img.shape) != (height, width, 3) or not bool(torch.isfinite(img).all()):
        raise AssertionError(f"{label}: image is not finite or has the wrong shape")
    if label.endswith("shaded") and max(peaks) > PREVIEW_PEAK_GB:
        raise AssertionError(f"{label}: peak {max(peaks):.3f} GB over {PREVIEW_PEAK_GB} GB")
    if label.endswith("shaded") and img.std().item() <= 0.0:
        raise AssertionError(f"{label}: the shaded preview is flat")
    return img


def _views_agree(label, a, b, mode) -> None:
    """G-buffer modes bit-equal, shaded and debug within PREVIEW_RTOL."""
    gap = ((a - b).abs() / b.abs().clamp(min=1e-30)).max().item()
    log(f"[preview] {label} {mode}: max abs diff {(a - b).abs().max().item():.3e}, max rel "
        f"{gap:.3e}, bit-equal {torch.equal(a, b)}")
    ok = torch.equal(a, b) if mode not in ("shaded", "debug") else bool(
        ((a - b).abs() <= PREVIEW_RTOL * b.abs()).all())
    if not ok:
        raise AssertionError(f"{label} {mode}: the two routes disagree")


def phase_preview(device, out_dir: Path, name_limit) -> None:
    """render_preview in every PREVIEW_MODE and render_debug at full width:
    the bench scene at 1920x1080 (traversal kernel), then the textured glTF
    scene at 512x512 under "auto" (dense kernel) and accel="pallas"
    (traversal kernel).  Seconds of two calls, launches, peak memory; the
    kernel route against the plain route on a crop of the bench frame, and
    the glTF scene's dense route against its traversal route."""
    from mc_path_tracer_tpu_torch.models.camera import PerspectiveCamera
    from mc_path_tracer_tpu_torch.models.film import Film
    from mc_path_tracer_tpu_torch.models.integrator import camera_params
    from mc_path_tracer_tpu_torch.models.preview import (
        PREVIEW_MODES,
        preview_pixels,
        render_debug,
        render_preview,
    )
    from mc_path_tracer_tpu_torch.models.scene import Scene

    modes = (*PREVIEW_MODES, "debug")

    def taps(mode, closest, anyhit):
        """Per chunk: one closest hit; shaded one any-hit per sun, debug one."""
        return {closest: 1, anyhit: 1 if mode in ("shaded", "debug") else 0}

    sd = build_scene("bench scene", build_bench_scene(), device, 48002)
    cam = camera_params(bench_camera(), WIDTH, HEIGHT, device)
    chunks = _blocks(WIDTH, HEIGHT)
    def view(mode):
        """The view as a user asks for it: render_preview or render_debug."""
        if mode == "debug":
            return render_debug(sd, bench_camera(), WIDTH, HEIGHT)
        return render_preview(sd, bench_camera(), WIDTH, HEIGHT, mode)

    for mode in modes:
        want = {k: v * chunks for k, v in taps(mode, "closest", "anyhit").items()}
        img = _preview_run(f"bench {mode}", lambda: view(mode).ld,  # noqa: B023
                           WIDTH, HEIGHT, want, name_limit)
        if mode == "shaded":
            Film(ld=img, samples=torch.ones(img.shape[:2], device=device)).save_png(
                str(out_dir / "preview_shaded.png"))
    px, py = _crop(WIDTH, HEIGHT, CROP, device)
    for mode in modes:
        a, b = (preview_pixels(sd, cam, WIDTH, HEIGHT, px, py, mode, accel)
                for accel in ("auto", "brute"))
        _views_agree(f"bench {CROP}x{CROP} crop, kernel vs plain route", a, b, mode)
    del sd

    scene = textured_scene(Scene, write_textured_glb(out_dir / "textured.glb"))
    sd = build_scene("textured glTF", scene, device, GLTF_TRIS)
    cam = camera_params(textured_camera(PerspectiveCamera), GLTF_SIZE, GLTF_SIZE, device)
    chunks = _blocks(GLTF_SIZE, GLTF_SIZE)
    for mode in modes:
        images = {}
        for accel, names in (("auto", ("dense_closest", "dense_anyhit")),
                             ("pallas", ("closest", "anyhit"))):
            want = {k: v * chunks for k, v in taps(mode, *names).items()}
            images[accel] = _preview_run(
                f"gltf accel={accel} {mode}",
                lambda: _preview_frame(sd, cam, GLTF_SIZE, GLTF_SIZE, mode, accel),  # noqa: B023
                GLTF_SIZE, GLTF_SIZE, want, name_limit)
        _views_agree("gltf dense vs traversal route", images["auto"], images["pallas"], mode)


def phase_preview_trace(device, name_limit) -> None:
    """One 1080p shaded preview of the bench scene under
    utils.profiling.device_trace (torch.profiler, CPU + CUDA, a Chrome trace
    into a temporary directory): the device busy time (the kernels' own
    rows of the profile, so no time is counted twice under the aten op that
    launched it), the idle share against the fastest of two unprofiled
    calls, and the costliest kernels.  Runs after every frame, as the
    profiler slows what follows it."""
    from torch.autograd import DeviceType

    from mc_path_tracer_tpu_torch.models.preview import render_preview
    from mc_path_tracer_tpu_torch.utils.profiling import device_trace

    sd = build_scene("bench scene", build_bench_scene(), device, 48002)

    def shaded():
        render_preview(sd, bench_camera(), WIDTH, HEIGHT, "shaded")
        torch.cuda.synchronize()

    shaded()
    walls = []
    for _ in range(2):
        t0 = time.perf_counter()
        shaded()
        walls.append(time.perf_counter() - t0)
    with tempfile.TemporaryDirectory() as log_dir:
        t0 = time.perf_counter()
        with device_trace(log_dir) as prof:
            render_preview(sd, bench_camera(), WIDTH, HEIGHT, "shaded")
        traced = time.perf_counter() - t0
        trace_bytes = (Path(log_dir) / "trace.json").stat().st_size
    kernels = [(e.key, e.self_device_time_total, e.count) for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy = sum(us for _, us, _ in kernels) / 1e6
    log(f"[preview-trace] bench shaded {WIDTH}x{HEIGHT}: unprofiled {walls[0]:.3f}, "
        f"{walls[1]:.3f} s; under device_trace {traced:.3f} s (writing a {trace_bytes}-byte "
        f"Chrome trace included); device busy {busy:.4f} s in {sum(c for *_, c in kernels)} "
        f"kernels, idle share {1.0 - busy / min(walls):.3f} of the fastest unprofiled call "
        f"({name_limit})")
    for key, us, count in sorted(kernels, key=lambda e: -e[1])[:6]:
        log(f"[preview-trace]   {us / 1e3:9.3f} ms device  x{count:<5d} {key[:90]}")
    if busy <= 0.0:
        raise AssertionError("device_trace recorded no device time")


def phase_matpreview(device, out_dir: Path, name_limit) -> None:
    """preview_material() at its defaults (256 px) on the preview path and
    path-traced at its 16 spp (depth 4): the 9,218-triangle ball takes the
    traversal kernel."""
    from mc_path_tracer_tpu_torch.models.matpreview import preview_material

    size, spp, depth = 256, 16, 4
    per = _blocks(size, size) * spp * (depth - 1)
    for path_traced, want in ((False, {"closest": _blocks(size, size)}),
                              (True, {"closest": per, "anyhit": per})):
        _reset()
        t0 = time.perf_counter()
        film = preview_material(path_traced=path_traced)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        name = "path-traced" if path_traced else "preview"
        film.save_png(str(out_dir / f"matpreview_{name}.png"))
        got = _launches()
        img = film.radiance_mean()
        log(f"[matpreview] {name} {size}x{size}: {seconds:.3f} s ({name_limit}); launches "
            f"{got}; image mean {img.mean().item():.5f} std {img.std().item():.5f}")
        _expect(f"matpreview {name}", got, {**want, "tonemap": 1})
        _check_image(f"matpreview {name}", img)
        if img.std().item() <= 0.0:
            raise AssertionError(f"matpreview {name}: the image is flat")


def _read_png(path: Path) -> np.ndarray:
    from mc_path_tracer_tpu_torch.utils.image import read_png

    return read_png(path.read_bytes(), str(path))


def phase_cli(out_dir: Path, name_limit) -> None:
    """python3 -m mc_path_tracer_tpu_torch as a subprocess: the demo at its
    defaults (512x512 x 64 spp x depth 5), the rasterizer at 1920x1080, the
    wireframe and debug views, and the heat-map view with --out-hdr (spp
    cut to CLI_HEAT_SPP).  Each exits 0 and writes a PNG of its size; the
    demo's is bright and not flat, the .npy finite.  The rasterizer runs
    under -X importtime, whose list of imports must hold no module of JAX
    or of the JAX package."""
    root = Path(__file__).resolve().parent
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        p for p in (str(root), os.environ.get("PYTHONPATH", "")) if p)}
    size = (CLI_SIZE, CLI_SIZE)
    runs = (("demo", [], size),
            ("rasterizer", ["--mode", "rasterizer", "--size", f"{WIDTH}x{HEIGHT}"],
             (WIDTH, HEIGHT)),
            ("wireframe", ["--mode", "wireframe"], size),
            ("debug", ["--mode", "debug"], size),
            ("heatmap", ["--view", "heatmap", "--spp", str(CLI_HEAT_SPP),
                         "--out-hdr", str(out_dir / "cli_heatmap.npy")], size))
    for name, extra, (w, h) in runs:
        png = out_dir / f"cli_{name}.png"
        flags = ["-X", "importtime"] if name == "rasterizer" else []
        cmd = [sys.executable, *flags, "-m", "mc_path_tracer_tpu_torch", "--demo",
               "--out", str(png), *extra]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=root, env=env, capture_output=True, text=True,
                              timeout=CLI_TIMEOUT)
        wall = time.perf_counter() - t0
        line = proc.stdout.strip().splitlines()[-1] if proc.stdout.strip() else ""
        log(f"[cli] {name}: exit {proc.returncode}, wall {wall:.3f} s ({name_limit}): {line}")
        if proc.returncode != 0:
            raise AssertionError(f"cli {name} failed:\n{proc.stderr[-4000:]}")
        img = _read_png(png)
        if img.shape != (h, w, 3):
            raise AssertionError(f"cli {name}: {png} is {img.shape}, expected {(h, w, 3)}")
        if name == "demo":
            log(f"[cli] demo PNG max {img.max()}, mean {img.mean():.3f}, std {img.std():.3f}")
            if img.max() <= 200 or img.std() <= 0.0:
                raise AssertionError("cli demo: the PNG is dark or flat")
        if name == "heatmap":
            hdr = np.load(out_dir / "cli_heatmap.npy")
            log(f"[cli] heatmap .npy {hdr.shape} {hdr.dtype}, mean {hdr.mean():.5f}")
            if hdr.shape != (h, w, 3) or not np.isfinite(hdr).all():
                raise AssertionError("cli heatmap: the .npy is not finite or has the wrong shape")
        if name == "rasterizer":
            imported = [ln.rsplit("|", 1)[-1].strip() for ln in proc.stderr.splitlines()
                        if ln.startswith("import time:")]
            ref = [m for m in imported if m in ("jax", "jaxlib", "mc_path_tracer_tpu")
                   or m.startswith(("jax.", "jaxlib.", "mc_path_tracer_tpu."))]
            log(f"[cli] rasterizer imported {len(imported)} modules, of JAX or the JAX "
                f"package: {ref}")
            if not imported or ref:
                raise AssertionError(f"the command line imported reference modules: {ref[:5]}")


def phase_interactive(device, name_limit) -> None:
    """A headless InteractiveViewer at its default 96x64 (64 spp, depth 3,
    one pass a step) on the demo scene: passes accumulate; a key event and
    a mouse event each restart accumulation at one pass; an
    ObjectEditSession drag bumps the scene version and restarts it too;
    frame() goes through the tone-map kernel and frame_to_ansi draws it.
    run_tty needs a terminal and is not run."""
    from mc_path_tracer_tpu_torch.cli import demo_scene
    from mc_path_tracer_tpu_torch.models.interactive import (
        InteractiveViewer,
        ObjectEditSession,
        frame_to_ansi,
    )
    from mc_path_tracer_tpu_torch.models.scene import Scene

    scene = demo_scene(Scene())
    scene.add_directional_light((0.4, 1.0, 0.2), ls=5.0)
    viewer = InteractiveViewer(scene, device=device)
    w, h, depth = viewer.width, viewer.height, viewer.cfg.max_depth

    def samples():
        return viewer.session.film.samples.max().item()

    _reset()
    t0 = time.perf_counter()
    for _ in range(3):
        viewer.step()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = [samples()]
    moved = [viewer.handle_events(keys=["w"])]
    viewer.step()
    counts.append(samples())
    moved.append(viewer.handle_events(mouse=(20.0, -10.0)))
    viewer.step()
    counts.append(samples())
    version = scene.version
    ObjectEditSession(scene, obj_id=1).rotate_drag(0.0, 0.0, 0.4, 0.1)
    viewer.step()
    counts.append(samples())
    frame = viewer.frame()
    ansi = frame_to_ansi(frame)
    got = _launches()
    steps = 6
    log(f"[interactive] {w}x{h} depth {depth}: 3 passes in {seconds:.3f} s ({name_limit}); "
        f"samples after 3 passes, a key, a mouse move, an object drag: {counts}; moved {moved}; "
        f"scene version {version} -> {scene.version}; frame {frame.shape}, {ansi.count(chr(10)) + 1} "
        f"ANSI rows; launches {got}; run_tty needs a terminal: not run")
    per = steps * _blocks(w, h) * (depth - 1)
    _expect("interactive", got, {"closest": per, "anyhit": per, "tonemap": 1})
    if counts != [3.0, 1.0, 1.0, 1.0] or moved != [True, True] or scene.version <= version:
        raise AssertionError("the viewer did not restart accumulation on a move or an edit")
    if frame.shape != (h, w, 3) or ansi.count("\n") != h // 2 - 1 or "\x1b[38;2;" not in ansi:
        raise AssertionError("the viewer's frame or its ANSI rendering is wrong")


# ---------------------------------------------------------------------------
# Multi-device, image-format and procedural paths: row-sharded frames and
# steps, two processes on the card, JPEG textures, a procedural scene
# ---------------------------------------------------------------------------

def phase_sharded(sd, film, render_s, device, out_dir: Path, name_limit) -> dict:
    """render_sharded of the bench frame on SHARDS shards of the card: the
    frame must be bit-equal to [render]'s one-device frame (pixel-keyed
    noise; the per-pixel arithmetic does not depend on the row split); it
    is saved as a PNG through the tone-map kernel.  Returns its launches
    and each shard's: {path: launches}."""
    from mc_path_tracer_tpu_torch.bench_scaling import shard_launches
    from mc_path_tracer_tpu_torch.models.film import Film
    from mc_path_tracer_tpu_torch.models.integrator import RenderConfig
    from mc_path_tracer_tpu_torch.ops import rng
    from mc_path_tracer_tpu_torch.parallel.mesh import make_mesh
    from mc_path_tracer_tpu_torch.parallel.render import render_sharded

    mesh = make_mesh(devices=[device] * SHARDS)
    cam = dataclasses.replace(bench_camera(), aspect=WIDTH / HEIGHT).params(device)
    cfg = RenderConfig(spp=SPP, max_depth=DEPTH)
    _reset()
    t0 = time.perf_counter()
    frame, shards = shard_launches(
        lambda: render_sharded(sd, cam, WIDTH, HEIGHT, cfg, rng.prng_key(0), mesh))
    launches = _launches()
    seconds = time.perf_counter() - t0
    equal = bool(torch.equal(frame, film.ld))
    per = _blocks(WIDTH, HEIGHT // SHARDS) * SPP * (DEPTH - 1)
    log(f"[sharded] bench {WIDTH}x{HEIGHT} {SPP} spp depth {DEPTH} on {SHARDS} shards of "
        f"{device}: frame {seconds:.3f} s against [render]'s {render_s:.3f} s ({name_limit}); "
        f"launches {launches}, per shard {shards}; bit-equal to the one-device frame {equal}, "
        f"max abs diff {(frame - film.ld).abs().max().item():.3e}")
    _expect("sharded bench frame", launches, {"closest": SHARDS * per, "anyhit": SHARDS * per})
    for i, got in enumerate(shards):
        _expect(f"sharded bench frame, shard {i}", got, {"closest": per, "anyhit": per})
    if not equal:
        raise AssertionError("the sharded bench frame differs from the one-device frame")
    png = out_dir / "bench_sharded.png"
    _reset()
    Film(ld=frame, samples=torch.full((HEIGHT, WIDTH), float(SPP), device=device)).save_png(
        str(png))
    saved = _launches()
    _expect("sharded PNG", saved, {"tonemap": 1})
    log(f"[sharded] wrote {png} through the tone-map kernel (launches {saved})")
    return {"sharded": {k: launches[k] + saved[k] for k in launches},
            **{f"sharded_shard{i}": got for i, got in enumerate(shards)}}


def phase_sharded_step(steps: dict, device, name_limit) -> dict:
    """The config4 train step as configured on SHARDS shards of the card,
    against [grad]'s one-device config4 step: gradients within
    GRAD_SHARD_TOL of the largest; each shard's forward launches the
    one-device step's per-sample dispatches over the blocks of its rows
    (cut on the frame's grid).  Returns the forward's launches and each
    shard's: {path: launches}."""
    from mc_path_tracer_tpu_torch.bench_scaling import shard_launches
    from mc_path_tracer_tpu_torch.parallel.mesh import make_mesh

    rec4, sd4, cam4, w, h, cfg4 = steps["config4"]
    px, py = _frame_pixels(w, h, device)
    target = torch.full((w * h, 3), GRAD_TARGET, device=device)
    mesh = make_mesh(devices=[device] * SHARDS)
    rec, shards = shard_launches(
        lambda: _train_step(sd4, cam4, w, h, px, py, cfg4, target, mesh=mesh))
    gap = _grad_gap(rec["grads"], rec4["grads"])
    log(f"[sharded] config4 train step {w}x{h} {cfg4.spp} spp depth {cfg4.max_depth} on "
        f"{SHARDS} shards: step {rec['seconds']:.3f} s (forward {rec['forward_s']:.3f} s) "
        f"({name_limit}), peak {rec['peak_gb']:.3f} GB, loss {rec['loss']:.9g} (one device "
        f"{rec4['loss']:.9g}); gradients against [grad]'s one-device step: largest gap "
        f"{gap:.3e} of the largest; launches forward {rec['forward']}, per shard {shards}, "
        f"backward {rec['backward']}")
    per = [n * cfg4.spp * (cfg4.max_depth - 1) for n in _shard_blocks(w, h, SHARDS)]
    _expect("sharded config4 step forward", rec["forward"],
            {"closest": sum(per), "anyhit": sum(per)})
    for i, got in enumerate(shards):
        _expect(f"sharded config4 step forward, shard {i}", got,
                {"closest": per[i], "anyhit": per[i]})
    if gap > GRAD_SHARD_TOL or rec["backward"] != rec["forward"]:
        raise AssertionError("the sharded config4 step differs from the one-device step")
    return {"sharded_step": rec["forward"],
            **{f"sharded_step_shard{i}": got for i, got in enumerate(shards)}}


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def phase_multiprocess(frame4, steps: dict, out_dir: Path, name_limit) -> dict:
    """Two processes on the card joined by gloo (this script re-run with
    --worker): each renders its rows of config4 with render_sharded_global
    and runs one sharded train step; rank 0 all-gathers the rows.  The
    frame must be bit-equal to [configs]' one-device config4 frame and every
    rank's all-reduced gradients within GRAD_SHARD_TOL of [grad]'s."""
    rec4 = steps["config4"][0]
    port, world = _free_port(), 2
    outs = [out_dir / f"worker{r}.npz" for r in range(world)]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, __file__, "--worker", str(r), str(world),
                               str(port), str(out)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r, out in enumerate(outs)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=WORKER_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    for r, text in enumerate(logs):
        for line in text.strip().splitlines()[-12:]:
            log(f"[multiprocess] rank {r}: {line}")
    if [p.returncode for p in procs] != [0] * world:
        raise AssertionError(f"a worker failed: exit codes {[p.returncode for p in procs]}")
    launches = {}
    for r, out in enumerate(outs):
        got = np.load(out, allow_pickle=False)
        grads = [torch.from_numpy(got[f"g{i}"]) for i in range(len(GRAD_NAMES))]
        gap = _grad_gap(grads, [g.cpu() for g in rec4["grads"]])
        rank_launches = json.loads(str(got["launches"]))
        for k, v in rank_launches.items():
            launches[k] = launches.get(k, 0) + v
        log(f"[multiprocess] rank {r}: rows {got['rows'].shape[0]}, render "
            f"{float(got['render_s']):.3f} s, step {float(got['step_s']):.3f} s, loss "
            f"{float(got['loss']):.9g}; gradients against [grad]'s one-device step: largest gap "
            f"{gap:.3e} of the largest; gloo with CUDA tensors: {str(got['gloo_cuda'])}; "
            f"launches {rank_launches} ({name_limit})")
        if gap > GRAD_SHARD_TOL:
            raise AssertionError(f"rank {r}'s all-reduced gradients differ from one device")
        if r == 0:
            frame = torch.from_numpy(got["frame"]).reshape(frame4.shape)
            equal = bool(torch.equal(frame, frame4.cpu()))
            log(f"[multiprocess] rank 0 gathered {tuple(frame.shape)}: bit-equal to the "
                f"one-device config4 frame {equal}; both ranks in {wall:.3f} s wall")
            if not equal:
                raise AssertionError("the two-process config4 frame differs from one device")
    return launches


def phase_nccl(steps: dict, device, name_limit) -> None:
    """One NCCL rank (world size 1) runs the config4 train step on a mesh of
    the card: the all-reduce over one rank must leave [grad]'s one-device
    step bit-equal."""
    import torch.distributed as dist

    from mc_path_tracer_tpu_torch.parallel.mesh import make_mesh

    rec4, sd4, cam4, w, h, cfg4 = steps["config4"]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{_free_port()}",
                            world_size=1, rank=0)
    try:
        mesh = make_mesh(devices=[device])
        px, py = _frame_pixels(w, h, device)
        rec = _train_step(sd4, cam4, w, h, px, py, cfg4,
                          torch.full((w * h, 3), GRAD_TARGET, device=device), mesh=mesh)
        backend = dist.get_backend()
    finally:
        dist.destroy_process_group()
    equal = rec["loss"] == rec4["loss"] and all(
        torch.equal(a, b) for a, b in zip(rec["grads"], rec4["grads"]))
    log(f"[multiprocess] {backend} world size 1, config4 step on {mesh.devices}: "
        f"{rec['seconds']:.3f} s ({name_limit}), loss {rec['loss']:.9g}; bit-equal to the "
        f"one-device step {equal}; largest gap "
        f"{_grad_gap(rec['grads'], rec4['grads']):.3e}")
    if not equal:
        raise AssertionError("the NCCL world-size-1 step differs from the one-device step")


def worker(rank: int, world: int, port: int, out: str, device="cuda:0") -> int:
    """One rank of [multiprocess]: config4 through render_sharded_global and
    one sharded train step on a one-shard mesh of the card, the ranks joined
    by gloo; rank 0 all-gathers the rows (staged through the host here)."""
    import torch.distributed as dist

    from mc_path_tracer_tpu_torch import configs
    from mc_path_tracer_tpu_torch.models.integrator import camera_params
    from mc_path_tracer_tpu_torch.ops import rng
    from mc_path_tracer_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    from mc_path_tracer_tpu_torch.parallel.mesh import init_distributed, make_mesh
    from mc_path_tracer_tpu_torch.parallel.render import make_train_step, render_sharded_global

    device = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    init_distributed(f"localhost:{port}", world, rank, backend="gloo")
    try:
        mesh = make_mesh(devices=[device])
        # does gloo take CUDA tensors?  all_reduce is what make_train_step
        # calls; all_gather is only probed (the rows below go through the host)
        probe = {}
        for name, fn in (
                ("all_reduce", lambda t: dist.all_reduce(t)),
                ("all_gather", lambda t: dist.all_gather([torch.empty_like(t)] * world, t))):
            try:
                fn(torch.ones(4, device=device))
                probe[name] = "yes"
            except RuntimeError as e:   # an unsupported device is refused before any message
                probe[name] = f"no ({str(e).splitlines()[0][:80]})"
        scene, cam, cfg, (w, h) = configs.config4_roughness_sweep()
        sd = scene.build(device)
        params = camera_params(cam, w, h, device)
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        rows = render_sharded_global(sd, params, w, h, cfg, rng.prng_key(0), mesh)
        torch.cuda.synchronize()
        render_s = time.perf_counter() - t0
        gathered = [torch.empty_like(rows.cpu()) for _ in range(world)]
        dist.all_gather(gathered, rows.cpu())
        px, py = _frame_pixels(w, h, device)
        step = make_train_step(cfg, w, h, cfg.spp, mesh=mesh)
        t0 = time.perf_counter()
        loss, (mat, ls, tex) = step(sd, params, px, py,
                                    torch.full((w * h, 3), GRAD_TARGET, device=device),
                                    rng.prng_key(0))
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t0
        launches = dict(LAUNCHES)
        print(f"rank {rank}: backend {dist.get_backend()}, mesh of {mesh.size} shards, "
              f"rows {rows.shape[0]}, render {render_s:.3f} s, step {step_s:.3f} s, "
              f"launches {launches}, gloo with CUDA tensors {probe}", flush=True)
        np.savez(out, rows=rows.cpu().numpy(), frame=torch.cat(gathered).numpy(),
                 loss=loss.cpu().numpy(), render_s=render_s, step_s=step_s,
                 gloo_cuda=json.dumps(probe), launches=json.dumps(launches),
                 **{f"g{i}": g.cpu().numpy() for i, g in enumerate([*mat, ls, tex])})
    finally:
        dist.destroy_process_group()
    return 0


def phase_images(device, out_dir: Path, name_limit) -> dict:
    """The embedded JPEGs decoded on this host must hash as PIL's decode;
    the test GLB re-written with the baseline JPEG as its base colour
    texture renders at GLTF_SIZE x GLTF_SIZE under "auto" (the dense
    kernel) and "pallas" (the traversal kernel), and the two agree as in
    [gltf].  Returns the two frames' launches."""
    import base64
    import hashlib

    from mc_path_tracer_tpu_torch.models.camera import PerspectiveCamera
    from mc_path_tracer_tpu_torch.models.integrator import RenderConfig
    from mc_path_tracer_tpu_torch.models.scene import Scene
    from mc_path_tracer_tpu_torch.utils.jpeg import read_jpeg

    files = {}
    for name, (b64, sha, (h, w)) in EMBEDDED_JPEGS.items():
        data = base64.b64decode(b64)
        t0 = time.perf_counter()
        for _ in range(DECODE_REPS):
            img = read_jpeg(data, name)
        per_mp = (time.perf_counter() - t0) / DECODE_REPS / (h * w / 1e6)
        got = hashlib.sha256(img.tobytes()).hexdigest()
        log(f"[images] {name} JPEG {w}x{h} ({len(data)} bytes): SHA-256 of the decode "
            f"{got}, PIL's {sha}: equal {got == sha}; {per_mp:.3f} s per megapixel on this "
            f"host's CPU (mean of {DECODE_REPS})")
        if got != sha or img.shape != (h, w, 3):
            raise AssertionError(f"the {name} JPEG does not decode as PIL decodes it")
        files[name] = data
    images = glb_images()
    images[0] = files["baseline"]
    path = write_textured_glb(out_dir / "textured_jpeg.glb", images)
    scene = textured_scene(Scene, path)
    sd = build_scene("JPEG-textured glTF", scene, device, GLTF_TRIS)
    cam = textured_camera(PerspectiveCamera)
    size, spp, depth = GLTF_SIZE, GLTF_SPP, GLTF_DEPTH
    blocks = _blocks(size, size)
    closest, anyhit = blocks * spp * (2 * depth - 2), blocks * spp * (depth - 1)
    frames, launches = {}, {}
    for accel, names in (("auto", ("dense_closest", "dense_anyhit")),
                         ("pallas", ("closest", "anyhit"))):
        film, seconds, got = _frame(sd, cam, size, size,
                                    RenderConfig(spp=spp, max_depth=depth, accel=accel))
        img = film.radiance_mean()
        log(f"[images] JPEG-textured glTF {size}x{size} {spp} spp depth {depth} accel={accel}: "
            f"frame {seconds:.3f} s ({name_limit}); launches {got}; image mean "
            f"{img.mean().item():.5f}")
        _expect(f"JPEG glTF accel={accel}", got, {names[0]: closest, names[1]: anyhit})
        _check_image(f"JPEG glTF accel={accel}", img)
        frames[accel] = img
        launches = {k: launches.get(k, 0) + v for k, v in got.items()}
    agree = _agree(frames["pallas"], frames["auto"], 1e-3)
    log(f"[images] traversal vs dense route: {agree:.6f} of pixels within rel 1e-3, max abs "
        f"diff {(frames['pallas'] - frames['auto']).abs().max().item():.3e}")
    if agree < 0.99:
        raise AssertionError("the traversal and dense routes disagree on the JPEG glTF scene")
    return launches


def tree_scene(scene_cls, lsystem_cls, turtle_cls, primitives):
    """The [procedural] scene through a package's API: the L-system tree as
    one mesh on plane(40.0), under the bench scene's environment and sun."""
    tree = lsystem_cls(seed=3).set_axiom("F").add_rule(TREE_RULE).build(TREE_GENERATIONS)
    turtle = turtle_cls(step=0.12, angle=28.0, radius=0.05, radius_decay=0.8,
                        step_decay=0.9).interpret(tree)
    p, n, uv, idx = turtle.to_mesh(sides=TREE_SIDES)
    env = (np.random.default_rng(0).uniform(0.1, 2.0, size=(64, 128, 3)) ** 2).astype(
        np.float32)
    s = scene_cls()
    s.set_environment_hdr(env, ls=1.0)
    s.add_directional_light((0.4, 1.0, 0.2), color=(1.0, 0.95, 0.8), ls=3.0)
    fp, fn, fuv, fidx = primitives.plane(40.0)
    s.add_mesh(fp, fidx, normals=fn, uvs=fuv,
               material_id=s.add_material(albedo=(0.7, 0.7, 0.7), roughness=0.9))
    s.add_mesh(p, idx, normals=n, uvs=uv,
               material_id=s.add_material(albedo=(0.45, 0.32, 0.2), roughness=0.7))
    return s


def tree_camera(camera_cls):
    return camera_cls(position=np.array([6.0, 4.5, 10.0]), target=np.array([0.0, 3.2, 0.0]),
                      fov_deg=45.0)


def phase_procedural(device, out_dir: Path, name_limit) -> dict:
    """A procedural tree (LSystem + Turtle.to_mesh, TREE_TRIS triangles)
    rendered at WIDTH x HEIGHT x SPP x DEPTH through the traversal kernel
    and saved as a PNG.  Returns its launches."""
    from mc_path_tracer_tpu_torch.models import primitives
    from mc_path_tracer_tpu_torch.models.camera import PerspectiveCamera
    from mc_path_tracer_tpu_torch.models.integrator import RenderConfig
    from mc_path_tracer_tpu_torch.models.procedural import LSystem, Turtle
    from mc_path_tracer_tpu_torch.models.scene import Scene

    t0 = time.perf_counter()
    scene = tree_scene(Scene, LSystem, Turtle, primitives)
    host_s = time.perf_counter() - t0
    sd = build_scene("procedural tree", scene, device, TREE_TRIS + 2)
    cfg = RenderConfig(spp=SPP, max_depth=DEPTH)
    film, seconds, got = _frame(sd, tree_camera(PerspectiveCamera), WIDTH, HEIGHT, cfg)
    img = film.radiance_mean()
    per = _blocks(WIDTH, HEIGHT) * SPP * (DEPTH - 1)
    log(f"[procedural] L-system tree, {TREE_GENERATIONS} generations of {TREE_RULE!r}: "
        f"{TREE_TRIS} tree triangles + 2 floor, built on the host in {host_s:.3f} s; "
        f"{WIDTH}x{HEIGHT} {SPP} spp depth {DEPTH}: frame {seconds:.3f} s ({name_limit}); "
        f"launches {got}; image mean {img.mean().item():.5f} std {img.std().item():.5f}")
    _expect("procedural frame", got, {"closest": per, "anyhit": per})
    _check_image("procedural frame", img)
    png = out_dir / "procedural.png"
    _reset()
    film.save_png(str(png))
    saved = _launches()
    _expect("procedural PNG", saved, {"tonemap": 1})
    log(f"[procedural] wrote {png} through the tone-map kernel (launches {saved})")
    return {k: got[k] + saved[k] for k in got}


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def encode_png(img: np.ndarray, filter_type: int = 0, palette=None) -> bytes:
    """PNG bytes of a uint8 image [H, W, C] (C = 1 grey, 3 RGB, 4 RGBA),
    or of palette indices [H, W] with `palette` [N, 3]; 8 bits per sample,
    every row filtered with `filter_type` (0 None, 1 Sub, 2 Up, 3 Average,
    4 Paeth)."""
    import struct
    import zlib

    from mc_path_tracer_tpu_torch.utils.image import PNG_SIGNATURE

    img = np.asarray(img, np.uint8)
    if palette is not None:
        ctype, img = 3, img[..., None]
    else:
        img = img[..., None] if img.ndim == 2 else img
        ctype = {1: 0, 3: 2, 4: 6}[img.shape[2]]
    h, w, c = img.shape
    rows = img.reshape(h, w * c).astype(np.int32)
    prior = np.vstack([np.zeros((1, w * c), np.int32), rows[:-1]])
    left = np.hstack([np.zeros((h, c), np.int32), rows[:, :-c]])
    upleft = np.hstack([np.zeros((h, c), np.int32), prior[:, :-c]])
    pred = {0: 0, 1: left, 2: prior, 3: (left + prior) // 2,
            4: _paeth(left, prior, upleft)}[filter_type]
    filtered = ((rows - pred) & 0xFF).astype(np.uint8)
    raw = np.hstack([np.full((h, 1), filter_type, np.uint8), filtered])

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    out = [PNG_SIGNATURE, chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))]
    if palette is not None:
        out.append(chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes()))
    out += [chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)), chunk(b"IEND", b"")]
    return b"".join(out)


def glb_images() -> list[bytes]:
    """The test scene's five textures, one per filter type and covering the
    RGB, RGBA, palette and grey colour types: base colour (RGB, Sub),
    metallic-roughness (RGBA, Paeth: G roughness, B metallic), normal map
    (RGB, Average), emissive (palette, Up), occlusion (grey, None)."""
    rng = np.random.default_rng(7)
    y, x = np.mgrid[0:32, 0:32]
    checker = ((x // 8 + y // 8) % 2).astype(bool)
    base = np.where(checker[..., None], [200, 60, 40], [40, 160, 220])
    base = np.clip(base + rng.integers(-20, 21, base.shape), 0, 255)
    mr = np.stack([np.full_like(x, 255), 80 + 5 * x, 40 + 6 * y, 255 - 2 * x], -1)
    bump = np.stack([128 + 60 * np.sin(x / 3.0), 128 + 60 * np.cos(y / 4.0),
                     np.full(x.shape, 230.0)], -1)
    pal = np.array([[255, 240, 200], [255, 180, 90], [120, 200, 255], [30, 30, 30]])
    idx = ((np.arange(16)[:, None] // 4 + np.arange(16)[None] // 4) % 4)
    ao = 150 + 100 * np.exp(-((x - 16.0) ** 2 + (y - 16.0) ** 2) / 120.0)
    return [encode_png(base.astype(np.uint8), 1), encode_png(mr.astype(np.uint8), 4),
            encode_png(bump.astype(np.uint8), 3), encode_png(idx, 2, palette=pal),
            encode_png(ao.astype(np.uint8), 0)]


def write_textured_glb(path, images: list[bytes] | None = None) -> Path:
    """Write the textured test scene as a GLB and return its path.

    Three meshes under a root node with translation, rotation and scale:
    a floor quad (node matrix; positions and normals interleaved in one
    strided buffer view; TANGENT given), a 1,024-triangle UV sphere and an
    emissive box lamp (no TANGENT; uint32 indices).  Five embedded PNG
    textures (glb_images(), or `images` in their place): the floor uses base
    colour, metallic-roughness, normal and occlusion maps; the sphere base
    colour (the same image and slot as the floor's, so decoded once), normal
    and metallic-roughness maps; the lamp an emissive map."""
    import json
    import struct

    from mc_path_tracer_tpu_torch.models.primitives import box, plane, uv_sphere

    images = glb_images() if images is None else images
    blob = bytearray()
    views, accessors = [], []

    def view(data: bytes, stride: int = 0) -> int:
        while len(blob) % 4:
            blob.append(0)
        views.append({"buffer": 0, "byteOffset": len(blob), "byteLength": len(data),
                      **({"byteStride": stride} if stride else {})})
        blob.extend(data)
        return len(views) - 1

    def accessor(arr, kind, view_idx=None, offset=0, count=None) -> int:
        arr = np.ascontiguousarray(arr)
        ctype = {np.dtype(np.float32): 5126, np.dtype(np.uint16): 5123,
                 np.dtype(np.uint32): 5125}[arr.dtype]
        if view_idx is None:
            view_idx = view(arr.tobytes())
        accessors.append({"bufferView": view_idx, "byteOffset": offset,
                          "componentType": ctype, "type": kind,
                          "count": int(count if count is not None else arr.shape[0])})
        return len(accessors) - 1

    def mesh(name, p, n, uv, idx, material, tangents=None, interleave=False):
        p, n, uv = (np.asarray(a, np.float32) for a in (p, n, uv))
        if interleave:
            v = view(np.hstack([p, n]).tobytes(), stride=24)
            attrs = {"POSITION": accessor(p, "VEC3", v, 0, len(p)),
                     "NORMAL": accessor(n, "VEC3", v, 12, len(p))}
        else:
            attrs = {"POSITION": accessor(p, "VEC3"), "NORMAL": accessor(n, "VEC3")}
        attrs["TEXCOORD_0"] = accessor(uv, "VEC2")
        if tangents is not None:
            attrs["TANGENT"] = accessor(np.asarray(tangents, np.float32), "VEC4")
        dtype = np.uint16 if len(p) < 65536 and interleave else np.uint32
        ind = accessor(np.asarray(idx).reshape(-1).astype(dtype), "SCALAR")
        return {"name": name, "primitives": [{"attributes": attrs, "indices": ind,
                                              "material": material, "mode": 4}]}

    fp, fn, fuv, fidx = plane(8.0)
    # tangents along +x with a flipped handedness on two vertices
    ftan = np.tile([[1.0, 0.0, 0.0, 1.0]], (len(fp), 1))
    ftan[:2, 3] = -1.0
    sp, sn, suv, sidx = uv_sphere(0.8, rings=16, segments=32)
    bp, bn, buv, bidx = box((0.8, 0.2, 0.8))
    meshes = [mesh("floor", fp, fn, fuv, fidx, 0, tangents=ftan, interleave=True),
              mesh("ball", sp, sn, suv, sidx, 1),
              mesh("lamp", bp, bn, buv, bidx, 2)]
    image_json = [{"bufferView": view(data), "name": name,
                   "mimeType": "image/jpeg" if data.startswith(b"\xff\xd8") else "image/png"}
                  for data, name in zip(images, ("base", "mr", "normal", "emissive", "ao"))]
    half = np.radians(20.0) / 2
    gltf = {
        "asset": {"version": "2.0", "generator": "chip_smoke.write_textured_glb"},
        "scene": 0,
        "scenes": [{"nodes": [0]}],
        "nodes": [
            {"name": "root", "translation": [0.0, 0.05, 0.0],
             "rotation": [0.0, float(np.sin(half)), 0.0, float(np.cos(half))],
             "scale": [1.1, 1.1, 1.1], "children": [1, 2, 3]},
            {"name": "floor", "mesh": 0,
             "matrix": [1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1, 0, 0.0, -0.05, 0.0, 1]},
            {"name": "ball", "mesh": 1, "translation": [0.3, 0.8, 0.0],
             "scale": [1.0, 1.2, 1.0]},
            {"name": "lamp", "mesh": 2, "translation": [-0.5, 2.6, 0.3],
             "rotation": [1.0, 0.0, 0.0, 0.0]},
        ],
        "meshes": meshes,
        "materials": [
            {"name": "floor", "pbrMetallicRoughness": {
                "baseColorFactor": [0.9, 0.9, 0.9, 1.0], "metallicFactor": 0.3,
                "roughnessFactor": 0.9, "baseColorTexture": {"index": 0},
                "metallicRoughnessTexture": {"index": 1}},
             "normalTexture": {"index": 2}, "occlusionTexture": {"index": 4}},
            {"name": "ball", "pbrMetallicRoughness": {
                "baseColorFactor": [1.0, 0.9, 0.8, 1.0], "metallicFactor": 0.6,
                "roughnessFactor": 0.4, "baseColorTexture": {"index": 0},
                "metallicRoughnessTexture": {"index": 1}},
             "normalTexture": {"index": 2}},
            {"name": "lamp", "pbrMetallicRoughness": {"baseColorFactor": [0, 0, 0, 1]},
             "emissiveFactor": [8.0, 7.0, 6.0], "emissiveTexture": {"index": 3}},
        ],
        "textures": [{"source": k} for k in range(5)],
        "images": image_json,
        "accessors": accessors,
        "bufferViews": views,
        "buffers": [{"byteLength": len(blob)}],
    }
    text = json.dumps(gltf).encode()
    text += b" " * (-len(text) % 4)
    blob.extend(b"\0" * (-len(blob) % 4))
    body = (struct.pack("<II", len(text), 0x4E4F534A) + text
            + struct.pack("<II", len(blob), 0x004E4942) + bytes(blob))
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(struct.pack("<III", 0x46546C67, 2, 12 + len(body)) + body)
    return path


def phase_imports():
    """Every module of the port imported (its command line's __main__
    aside, which [cli] ran), then no module of JAX or of the JAX package
    may be loaded."""
    import importlib
    import pkgutil

    import mc_path_tracer_tpu_torch as pkg

    names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")
             if not m.name.endswith(".__main__")]
    for name in names:
        importlib.import_module(name)
    log(f"[imports] {len(names)} modules of the port imported")
    loaded = sorted(m for m in sys.modules
                    if m in ("jax", "jaxlib", "mc_path_tracer_tpu")
                    or m.startswith(("jax.", "jaxlib.", "mc_path_tracer_tpu.")))
    log(f"[imports] modules of JAX or the JAX package loaded: {loaded}")
    if loaded:
        raise AssertionError(f"the port loaded reference modules: {loaded[:5]}")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--png", default="out/config2.png",
                        help="config2's frames go to <stem>_auto.png and <stem>_dense.png; "
                        "the other phases write their PNGs and the test GLB beside them")
    parser.add_argument("--worker", nargs=4, metavar=("RANK", "WORLD", "PORT", "OUT"),
                        help="run one rank of [multiprocess] (the script starts these itself)")
    args = parser.parse_args()
    if args.worker:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: chip_smoke.py runs only on a GPU")
        rank, world, port, out = args.worker
        return worker(int(rank), int(world), int(port), out)
    png = Path(args.png)
    name_limit = phase_device()
    png.parent.mkdir(parents=True, exist_ok=True)
    out_dir = png.parent
    device = torch.device("cuda", 0)
    phase_build()
    sd = phase_scene(device)
    later = []   # device timings, taken after the frames
    stats = phase_kernel_check(sd, device, later, name_limit)
    bench_launches, film, render_s = phase_render(sd, device, name_limit)
    phase_route_parity(sd)
    stats["tonemap"] = phase_tonemap(film, later, name_limit)
    new_paths = phase_sharded(sd, film, render_s, device, out_dir, name_limit)
    new_paths["api"] = phase_api(sd, device, name_limit)
    del sd, film
    sd2, cam2, cfg2 = config2_scene(device)
    stats.update(phase_dense(sd2, cam2, device, later, name_limit))
    area_launches = phase_area(sd2, cam2, cfg2, device, png, name_limit)
    phase_area_scene(device)
    scenes, frame4 = phase_configs(device, out_dir, name_limit)
    phase_golden(scenes, device)
    phase_gltf(device, out_dir, name_limit)
    new_paths["images"] = phase_images(device, out_dir, name_limit)
    new_paths["procedural"] = phase_procedural(device, out_dir, name_limit)
    phase_reuse(sd2, cam2, cfg2, area_launches["auto"], scenes, device, name_limit)
    phase_progressive(scenes, device, name_limit)
    steps = phase_grad(sd2, cam2, cfg2, device, name_limit)
    phase_grad_check(steps, device, name_limit)
    phase_train(steps, device, name_limit)
    new_paths.update(phase_sharded_step(steps, device, name_limit))
    new_paths["multiprocess"] = phase_multiprocess(frame4, steps, out_dir, name_limit)
    phase_nccl(steps, device, name_limit)
    del scenes, sd2, steps, frame4
    phase_bench(name_limit)
    phase_preview(device, out_dir, name_limit)
    phase_matpreview(device, out_dir, name_limit)
    phase_cli(out_dir, name_limit)
    phase_interactive(device, name_limit)
    new_paths["gate"] = phase_gate(device, out_dir, name_limit)
    phase_stream(device, later, name_limit)
    new_paths.update(phase_sort(device, name_limit))
    phase_device_times(later, name_limit)
    phase_preview_trace(device, name_limit)
    phase_imports()
    launches = {"closest": bench_launches["closest"], "anyhit": bench_launches["anyhit"],
                "dense_closest": area_launches["dense"]["dense_closest"],
                "dense_anyhit": area_launches["dense"]["dense_anyhit"],
                "tonemap": area_launches["dense"]["tonemap"]}
    kernels = [
        {"name": name, "route": "cuda", "source": source, "replaces": replaces,
         "launches": launches[name], "max_abs_err": stats[name]["max_abs_err"],
         "ms": stats[name]["ms"], "device_ms": stats[name]["device_ms"],
         "plain_ms": stats[name]["plain_ms"],
         "bound_ms": stats[name]["bound_ms"], "bound_by": stats[name]["bound_by"],
         "full_test_bound_ms": stats[name].get("full_test_bound_ms", stats[name]["bound_ms"]),
         "library_ms": None,
         # launches on this slice's paths, each counted from 0 around its run
         "new_path_launches": {path: got.get(name, 0) for path, got in new_paths.items()}}
        for name, (source, replaces) in KERNELS.items()
    ]
    print(json.dumps({"kernels": kernels}))
    print(name_limit)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
