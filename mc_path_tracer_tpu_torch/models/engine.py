"""RenderEngine facade and the progressive render session (port of
mc_path_tracer_tpu/models/engine.py).

`RenderEngine.render` dispatches on the render mode; the port has the path
tracer only, and the rasterizer preview, wireframe and debug modes raise
NotImplementedError (ROADMAP Queue 1, preview and debug).  `RenderSession`
advances one progressive (pass, tile) step per `step()` and restarts from a
cleared film whenever the scene's `version` changed since the last step:
any scene edit clears the accumulation.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from mc_path_tracer_tpu_torch.device import DEFAULT_DEVICE
from mc_path_tracer_tpu_torch.models.film import Film, make_film
from mc_path_tracer_tpu_torch.models.integrator import (
    RenderConfig,
    render as pt_render,
    render_progressive,
)
from mc_path_tracer_tpu_torch.ops import rng

MODE_RASTERIZER = "rasterizer"
MODE_PATH_TRACER = "path_tracer"
MODE_DEBUG = "debug"
MODE_WIREFRAME = "wireframe"
PREVIEW_TODO = "is not ported yet (ROADMAP Queue 1, preview and debug)"


class RenderEngine:
    """Stateless dispatch facade over the render modes."""

    def render(self, scene, camera, width: int, height: int, mode: str = MODE_PATH_TRACER,
               cfg: RenderConfig = RenderConfig(), key=None, device=DEFAULT_DEVICE) -> Film:
        if mode in (MODE_RASTERIZER, MODE_WIREFRAME, MODE_DEBUG):
            raise NotImplementedError(f"render mode {mode!r} {PREVIEW_TODO}")
        if mode == MODE_PATH_TRACER:
            return pt_render(scene, camera, width, height, cfg, key=key, device=device)
        raise ValueError(f"unknown render mode {mode!r}")


@dataclass
class RenderSession:
    """Progressive session with edit-restart semantics: step() advances one
    (pass, tile) step; a changed `scene.version` restarts accumulation from
    a cleared film, keyed by the new version."""

    scene: object
    camera: object
    width: int
    height: int
    cfg: RenderConfig = field(default_factory=RenderConfig)
    tile: int = 256
    spp_per_pass: int = 1
    device: object = DEFAULT_DEVICE
    _film: Film | None = None
    _observed_version: int = -1
    _gen: object = None

    def _restart(self):
        self._observed_version = getattr(self.scene, "version", 0)
        self._film = make_film(self.width, self.height, self.device)
        self._gen = render_progressive(
            self.scene, self.camera, self.width, self.height, self.cfg,
            key=rng.prng_key(self._observed_version), tile=self.tile,
            spp_per_pass=self.spp_per_pass, device=self.device,
        )

    def step(self) -> Film:
        version = getattr(self.scene, "version", 0)
        if self._gen is None or version != self._observed_version:
            self._restart()
        try:
            self._film = next(self._gen)
        except StopIteration:
            pass  # converged at cfg.spp: keep returning the final film
        return self._film

    @property
    def film(self) -> Film:
        if self._film is None:
            self._film = make_film(self.width, self.height, self.device)
        return self._film
