"""Interactive layer: fly camera, arcball object editing, and a terminal
display loop on top of RenderSession (port of
mc_path_tracer_tpu/models/interactive.py).

The controllers are an input API (drive them from any event source) plus a
true-colour terminal viewer (half-block ANSI cells) that runs the
progressive session live in a tty.  Every controller edits the scene or
camera through the scene's notify chain: any edit bumps `scene.version`
and accumulation restarts.
"""

from __future__ import annotations

import sys
import time
from dataclasses import dataclass, field

import numpy as np

from mc_path_tracer_tpu_torch.device import DEFAULT_DEVICE
from mc_path_tracer_tpu_torch.models.camera import PerspectiveCamera
from mc_path_tracer_tpu_torch.models.engine import RenderSession
from mc_path_tracer_tpu_torch.models.integrator import RenderConfig

# key constants (characters)
KEY_FORWARD, KEY_BACK, KEY_LEFT, KEY_RIGHT = "w", "s", "a", "d"
KEY_UP, KEY_DOWN = "e", "q"


@dataclass
class FlyCamera:
    """Yaw/pitch WASD fly camera: process_keyboard moves along the look /
    right / up frame scaled by velocity * dt; process_mouse applies
    sensitivity-scaled yaw and pitch, the pitch clamped short of the poles.
    `camera()` materialises a PerspectiveCamera for the renderer."""

    position: np.ndarray = field(
        default_factory=lambda: np.array([0.0, 1.0, 5.0], np.float64))
    yaw_deg: float = -90.0          # looking down -z
    pitch_deg: float = 0.0
    velocity: float = 2.5
    sensitivity: float = 0.1
    fov_deg: float = 45.0

    @property
    def front(self) -> np.ndarray:
        cy, sy = np.cos(np.radians(self.yaw_deg)), np.sin(np.radians(self.yaw_deg))
        cp, sp = np.cos(np.radians(self.pitch_deg)), np.sin(np.radians(self.pitch_deg))
        f = np.array([cy * cp, sp, sy * cp])
        return f / np.linalg.norm(f)

    @property
    def right(self) -> np.ndarray:
        r = np.cross(self.front, np.array([0.0, 1.0, 0.0]))
        n = np.linalg.norm(r)
        return r / (n if n > 1e-8 else 1.0)

    def process_keyboard(self, key: str, dt: float = 1 / 30) -> bool:
        """Move for one held-key tick; returns True if the pose changed."""
        step = self.velocity * dt
        moves = {
            KEY_FORWARD: self.front, KEY_BACK: -self.front,
            KEY_LEFT: -self.right, KEY_RIGHT: self.right,
            KEY_UP: np.array([0.0, 1.0, 0.0]),
            KEY_DOWN: np.array([0.0, -1.0, 0.0]),
        }
        if key not in moves:
            return False
        self.position = self.position + moves[key] * step
        return True

    def process_mouse(self, dx: float, dy: float) -> bool:
        """Mouse look: dx / dy pixels -> yaw / pitch (y up the screen)."""
        if dx == 0 and dy == 0:
            return False
        self.yaw_deg += dx * self.sensitivity
        self.pitch_deg = float(
            np.clip(self.pitch_deg + dy * self.sensitivity, -89.0, 89.0))
        return True

    def camera(self, aspect: float = 1.0) -> PerspectiveCamera:
        return PerspectiveCamera(
            position=self.position.astype(np.float64),
            target=(self.position + self.front).astype(np.float64),
            fov_deg=self.fov_deg, aspect=aspect,
        )


def _arcball_vec(x: float, y: float) -> np.ndarray:
    """Normalised screen coordinates ([-1, 1]^2, y up) onto the unit sphere
    (Shoemake arcball: inside the disk -> sphere, outside -> rim)."""
    d2 = x * x + y * y
    if d2 <= 1.0:
        return np.array([x, y, np.sqrt(1.0 - d2)])
    inv = 1.0 / np.sqrt(d2)
    return np.array([x * inv, y * inv, 0.0])


@dataclass
class Arcball:
    """Accumulating arcball rotation."""

    rotation: np.ndarray = field(default_factory=lambda: np.eye(3))

    def drag(self, x0: float, y0: float, x1: float, y1: float) -> np.ndarray:
        """Compose the rotation of a drag from (x0, y0) to (x1, y1) in
        normalised coordinates; returns the updated accumulated matrix."""
        a = _arcball_vec(x0, y0)
        b = _arcball_vec(x1, y1)
        axis = np.cross(a, b)
        s = np.linalg.norm(axis)
        c = float(np.clip(np.dot(a, b), -1.0, 1.0))
        if s < 1e-9:
            return self.rotation
        axis = axis / s
        angle = np.arctan2(s, c)
        k = np.array([
            [0, -axis[2], axis[1]],
            [axis[2], 0, -axis[0]],
            [-axis[1], axis[0], 0],
        ])
        r = np.eye(3) + np.sin(angle) * k + (1 - np.cos(angle)) * (k @ k)
        self.rotation = (r @ self.rotation).astype(np.float64)
        return self.rotation


@dataclass
class ObjectEditSession:
    """Arcball rotate / pan of one scene object: drags rotate it about its
    centroid through Scene.set_transform (version bump, progressive
    restart); pans translate it in the camera plane."""

    scene: object
    obj_id: int
    arcball: Arcball = field(default_factory=Arcball)
    pan_scale: float = 2.0

    def rotate_drag(self, x0, y0, x1, y1):
        rot = self.arcball.drag(x0, y0, x1, y1)
        self.scene.set_transform(self.obj_id, rotation=rot)

    def pan_drag(self, dx, dy, camera: PerspectiveCamera | None = None):
        if camera is not None:
            eye = np.asarray(camera.position, np.float64)
            f = np.asarray(camera.target, np.float64) - eye
            f /= np.linalg.norm(f)
            r = np.cross(f, np.asarray(camera.up, np.float64))
            r /= np.linalg.norm(r)
            u = np.cross(r, f)
        else:
            r, u = np.array([1.0, 0, 0]), np.array([0, 1.0, 0])
        o = self.scene.objects[self.obj_id]
        t = o.translation + (r * dx + u * dy) * self.pan_scale
        self.scene.set_transform(self.obj_id, translation=t)


def frame_to_ansi(img: np.ndarray) -> str:
    """An [H, W, 3] uint8 frame as true-colour half-block cells (two pixels
    per character row: foreground the upper, background the lower)."""
    h = img.shape[0] - (img.shape[0] % 2)
    rows = []
    for y in range(0, h, 2):
        top, bot = img[y], img[y + 1]
        cells = [
            f"\x1b[38;2;{t[0]};{t[1]};{t[2]}m\x1b[48;2;{b[0]};{b[1]};{b[2]}m▀"
            for t, b in zip(top, bot)
        ]
        rows.append("".join(cells) + "\x1b[0m")
    return "\n".join(rows)


class InteractiveViewer:
    """Progressive path-traced view driven by keyboard and mouse events.

    Headless: feed events through `handle_events` and pull frames with
    `frame()`; `run_tty` adds raw-terminal input and ANSI display for live
    use (`python -m mc_path_tracer_tpu_torch --demo --interactive`)."""

    def __init__(self, scene, width=96, height=64, cfg=None, fly=None,
                 spp_per_pass=1, device=DEFAULT_DEVICE):
        self.scene = scene
        self.fly = fly or FlyCamera()
        self.width, self.height = width, height
        self.cfg = cfg or RenderConfig(spp=64, max_depth=3)
        self.session = RenderSession(
            scene=scene, camera=self._camera(), width=width, height=height,
            cfg=self.cfg, tile=max(width, height),
            spp_per_pass=spp_per_pass, device=device,
        )

    def _camera(self):
        return self.fly.camera(aspect=self.width / self.height)

    def handle_events(self, keys=(), mouse=(0.0, 0.0), dt=1 / 30) -> bool:
        """Apply one input tick; returns True if the camera moved (the
        session restarts accumulation on its next step)."""
        moved = False
        for k in keys:
            moved |= self.fly.process_keyboard(k, dt)
        moved |= self.fly.process_mouse(*mouse)
        if moved:
            # camera edits restart accumulation without a scene rebuild
            self.scene.notify(content=False)
            self.session.camera = self._camera()
        return moved

    def step(self):
        return self.session.step()

    def frame(self) -> np.ndarray:
        """The current tone-mapped uint8 frame: Reinhard of Ld / max(samples,
        1), quantised, which is the tone-map kernel's function
        (Film.to_uint8; its plain version for a film on the CPU)."""
        return self.session.film.to_uint8(1.0)

    def run_tty(self, max_seconds=60.0, out=sys.stdout):
        """Live loop: raw keys (wasdeq move, arrows look, x quits), one
        progressive pass per frame, ANSI half-block display."""
        import select
        import termios
        import tty

        fd = sys.stdin.fileno()
        old = termios.tcgetattr(fd)
        t_end = time.time() + max_seconds
        try:
            tty.setcbreak(fd)
            out.write("\x1b[2J")
            while time.time() < t_end:
                keys = []
                mouse = [0.0, 0.0]
                while select.select([sys.stdin], [], [], 0)[0]:
                    ch = sys.stdin.read(1)
                    if ch == "x":
                        return
                    if ch == "\x1b":          # arrow keys -> mouse look
                        # a lone ESC has no continuation bytes: poll before
                        # reading so it is a no-op instead of a stdin block
                        seq = ""
                        while (len(seq) < 2
                               and select.select([sys.stdin], [], [], 0)[0]):
                            seq += sys.stdin.read(1)
                        look = {"[A": (0, 40), "[B": (0, -40),
                                "[C": (40, 0), "[D": (-40, 0)}.get(seq)
                        if look:
                            mouse[0] += look[0]
                            mouse[1] += look[1]
                    else:
                        keys.append(ch)
                self.handle_events(keys, tuple(mouse))
                self.step()
                out.write("\x1b[H" + frame_to_ansi(self.frame()) + "\n")
                spp = float(self.session.film.samples.max())
                out.write(f"[wasdeq move, arrows look, x quit] spp={spp:.0f}\n")
                out.flush()
        finally:
            termios.tcsetattr(fd, termios.TCSADRAIN, old)
