"""traversal_roofline.area: traversal_roofline.frame's reading (its reader,
loaded here) on an area-lit frame: the least time of closest_kernel
(camera, BRDF and extension rays) + anyhit_kernel (the bounded shadow
rays), csrc/traversal.cu, over their device time in the traced window, in
%.  The least time is the bytes bound of harness/roofline.traversal_bytes
at the H100's 3.35 TB/s on the area estimator's work count
(drivers/area_frames.area_work); bytes bind."""

from pathlib import Path

from benchmark.harness import manifest

read = manifest.load_module(Path(__file__).with_name("traversal_roofline.frame.py")).read
