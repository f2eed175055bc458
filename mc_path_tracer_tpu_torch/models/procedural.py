"""Procedural geometry (port of mc_path_tracer_tpu/models/procedural.py):
parametric, stochastic and context-sensitive L-systems, the 3D turtle and
curve utilities.

Host numpy, as in the JAX package, whose module this copies so that the
port imports nothing of it:
  - LSystem / LRule / LModule: rules written as
    "lctx < pred > rctx : cond -> succ : prob", where pred may carry
    parameters `A(x,y)`; conditions and successor argument lists are
    arithmetic expressions over the bound parameters, evaluated in a
    restricted namespace (`eval_expr`).  Stochastic rules draw from
    np.random.default_rng(seed), so a seed gives the JAX module's string.
  - Turtle: a 3D turtle with a heading / left / up frame interpreting
      F (draw step) f (move) + - (yaw) & ^ (pitch) \\ / (roll) | (turn
      around) ! (shrink radius) " (scale step) [ ] (push/pop state),
    emitting polylines or generalized-cylinder meshes (`to_mesh`) that
    Scene.add_mesh takes.
  - bezier_eval (de Casteljau), subdiv_open (corner cutting) and tube_mesh
    (a circle swept along a polyline).
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass, field

import numpy as np

# ---------------------------------------------------------------------------
# Expression evaluation (exprtk stand-in, restricted namespace)
# ---------------------------------------------------------------------------

_SAFE_FUNCS = {
    "sin": math.sin, "cos": math.cos, "tan": math.tan, "sqrt": math.sqrt,
    "abs": abs, "min": min, "max": max, "pow": pow, "exp": math.exp,
    "log": math.log, "floor": math.floor, "ceil": math.ceil, "pi": math.pi,
}
_EXPR_RE = re.compile(r"^[\w\s+\-*/%().,<>=!&|]+$")


def eval_expr(expr: str, env: dict) -> float:
    expr = expr.strip()
    if not expr:
        return 0.0
    if not _EXPR_RE.match(expr):
        raise ValueError(f"unsafe expression: {expr!r}")
    return eval(expr, {"__builtins__": {}}, {**_SAFE_FUNCS, **env})  # noqa: S307


# ---------------------------------------------------------------------------
# LModule / LRule / LSystem
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class LModule:
    """One symbol with numeric parameters (LModule.{h,cpp})."""

    symbol: str
    params: tuple = ()

    def __str__(self):
        if not self.params:
            return self.symbol
        return f"{self.symbol}({','.join(f'{p:g}' for p in self.params)})"


def parse_modules(s: str) -> list[LModule]:
    """Parse a module string like 'F(1)[+F][-F]A(1,2)' into modules."""
    out = []
    i = 0
    while i < len(s):
        c = s[i]
        if c.isspace():
            i += 1
            continue
        if i + 1 < len(s) and s[i + 1] == "(":
            j = s.index(")", i + 1)
            params = tuple(
                float(x) for x in s[i + 2 : j].split(",") if x.strip()
            )
            out.append(LModule(c, params))
            i = j + 1
        else:
            out.append(LModule(c))
            i += 1
    return out


@dataclass
class LRule:
    """Production rule 'lctx < pred > rctx : cond -> succ : prob'
    (LRule.{h,cpp} grammar)."""

    predecessor: str                 # e.g. "A(x,y)"
    successor: str                   # e.g. "F(x)[+A(x*0.7,y)]"
    condition: str = ""              # e.g. "x > 0.1"
    probability: float = 1.0
    left_context: str = ""           # symbol required before pred
    right_context: str = ""          # symbol required after pred

    _sym: str = field(init=False)
    _param_names: tuple = field(init=False)

    def __post_init__(self):
        m = re.match(r"\s*(\w)\s*(?:\(([^)]*)\))?\s*$", self.predecessor)
        if not m:
            raise ValueError(f"bad predecessor {self.predecessor!r}")
        self._sym = m.group(1)
        self._param_names = tuple(
            p.strip() for p in (m.group(2) or "").split(",") if p.strip()
        )

    @classmethod
    def parse(cls, text: str) -> "LRule":
        """Parse the reference's one-line grammar
        '[lc <] pred [> rc] [: cond] -> succ [: prob]'."""
        prob = 1.0
        lhs, _, rhs = text.partition("->")
        succ = rhs.strip()
        m = re.match(r"(.*):\s*([0-9.eE+-]+)\s*$", succ)
        if m:
            succ, prob = m.group(1).strip(), float(m.group(2))
        cond = ""
        if ":" in lhs:
            lhs, _, cond = lhs.partition(":")
        lc = rc = ""
        if "<" in lhs:
            lc, _, lhs = lhs.partition("<")
        if ">" in lhs:
            lhs, _, rc = lhs.partition(">")
        return cls(
            predecessor=lhs.strip(), successor=succ, condition=cond.strip(),
            probability=prob, left_context=lc.strip(), right_context=rc.strip(),
        )

    def matches(self, mods: list[LModule], i: int, rng) -> dict | None:
        mod = mods[i]
        if mod.symbol != self._sym:
            return None
        if len(self._param_names) != len(mod.params):
            return None
        if self.left_context:
            if i == 0 or mods[i - 1].symbol != self.left_context:
                return None
        if self.right_context:
            if i + 1 >= len(mods) or mods[i + 1].symbol != self.right_context:
                return None
        env = dict(zip(self._param_names, mod.params))
        if self.condition and not eval_expr(self.condition, env):
            return None
        if self.probability < 1.0 and rng.random() >= self.probability:
            return None
        return env

    def produce(self, env: dict) -> list[LModule]:
        out = []
        s = self.successor
        i = 0
        while i < len(s):
            c = s[i]
            if c.isspace():
                i += 1
                continue
            if i + 1 < len(s) and s[i + 1] == "(":
                depth, j = 1, i + 2
                while depth:
                    if s[j] == "(":
                        depth += 1
                    elif s[j] == ")":
                        depth -= 1
                    j += 1
                args = s[i + 2 : j - 1]
                # split top-level commas
                parts, d, start = [], 0, 0
                for k, ch in enumerate(args):
                    if ch == "(":
                        d += 1
                    elif ch == ")":
                        d -= 1
                    elif ch == "," and d == 0:
                        parts.append(args[start:k])
                        start = k + 1
                parts.append(args[start:])
                params = tuple(eval_expr(p, env) for p in parts if p.strip())
                out.append(LModule(c, params))
                i = j
            else:
                out.append(LModule(c))
                i += 1
        return out


@dataclass
class LSystem:
    """Axiom + rules, iterated n generations (LSystem.h:19-31)."""

    axiom: list[LModule] = field(default_factory=list)
    rules: list[LRule] = field(default_factory=list)
    seed: int = 0

    def set_axiom(self, s: str):
        self.axiom = parse_modules(s)
        return self

    def add_rule(self, rule: str | LRule):
        self.rules.append(rule if isinstance(rule, LRule) else LRule.parse(rule))
        return self

    def build(self, generations: int) -> list[LModule]:
        rng = np.random.default_rng(self.seed)
        state = list(self.axiom)
        for _ in range(generations):
            nxt: list[LModule] = []
            for i in range(len(state)):
                replaced = False
                for rule in self.rules:
                    env = rule.matches(state, i, rng)
                    if env is not None:
                        nxt.extend(rule.produce(env))
                        replaced = True
                        break
                if not replaced:
                    nxt.append(state[i])
            state = nxt
        return state

    def __str__(self):
        return "".join(str(m) for m in self.axiom)


# ---------------------------------------------------------------------------
# Turtle
# ---------------------------------------------------------------------------


@dataclass
class TurtleState:
    position: np.ndarray
    heading: np.ndarray  # forward
    left: np.ndarray
    up: np.ndarray
    radius: float
    step: float


def _rot(axis: np.ndarray, deg: float) -> np.ndarray:
    a = math.radians(deg)
    c, s = math.cos(a), math.sin(a)
    x, y, z = axis
    return np.array(
        [
            [c + x * x * (1 - c), x * y * (1 - c) - z * s, x * z * (1 - c) + y * s],
            [y * x * (1 - c) + z * s, c + y * y * (1 - c), y * z * (1 - c) - x * s],
            [z * x * (1 - c) - y * s, z * y * (1 - c) + x * s, c + z * z * (1 - c)],
        ],
        np.float64,
    )


class Turtle:
    """3D turtle interpreter (Turtle.cpp:151-288 command set).

    Commands: F draw-forward, f move-forward, +/- yaw, &/^ pitch, \\ / roll,
    | turn-around, ! multiply radius, " multiply step, [ push, ] pop.
    Module parameter 0 (if present) overrides the step/angle magnitude.
    """

    def __init__(self, step=1.0, angle=25.0, radius=0.05,
                 radius_decay=0.9, step_decay=0.9):
        self.default_step = step
        self.default_angle = angle
        self.radius_decay = radius_decay
        self.step_decay = step_decay
        self.state = TurtleState(
            position=np.zeros(3),
            heading=np.array([0.0, 1.0, 0.0]),
            left=np.array([1.0, 0.0, 0.0]),
            up=np.array([0.0, 0.0, 1.0]),
            radius=radius,
            step=step,
        )
        self.stack: list[TurtleState] = []
        self.segments: list[tuple[np.ndarray, np.ndarray, float, float]] = []
        self.polylines: list[list[np.ndarray]] = []
        self._current_line: list[np.ndarray] = []

    def _turn(self, axis_name: str, deg: float):
        st = self.state
        axis = {"up": st.up, "left": st.left, "heading": st.heading}[axis_name]
        r = _rot(axis / np.linalg.norm(axis), deg)
        st.heading = r @ st.heading
        st.left = r @ st.left
        st.up = r @ st.up

    def interpret(self, modules) -> "Turtle":
        if isinstance(modules, str):
            modules = parse_modules(modules)
        for mod in modules:
            c = mod.symbol
            p0 = mod.params[0] if mod.params else None
            st = self.state
            if c == "F":
                step = p0 if p0 is not None else st.step
                new_pos = st.position + st.heading * step
                r2 = st.radius
                self.segments.append((st.position.copy(), new_pos.copy(), st.radius, r2))
                if not self._current_line:
                    self._current_line.append(st.position.copy())
                self._current_line.append(new_pos.copy())
                st.position = new_pos
            elif c == "f":
                step = p0 if p0 is not None else st.step
                st.position = st.position + st.heading * step
                self._flush_line()
            elif c == "+":
                self._turn("up", p0 if p0 is not None else self.default_angle)
            elif c == "-":
                self._turn("up", -(p0 if p0 is not None else self.default_angle))
            elif c == "&":
                self._turn("left", p0 if p0 is not None else self.default_angle)
            elif c == "^":
                self._turn("left", -(p0 if p0 is not None else self.default_angle))
            elif c == "\\":
                self._turn("heading", p0 if p0 is not None else self.default_angle)
            elif c == "/":
                self._turn("heading", -(p0 if p0 is not None else self.default_angle))
            elif c == "|":
                self._turn("up", 180.0)
            elif c == "!":
                st.radius *= p0 if p0 is not None else self.radius_decay
            elif c == '"':
                st.step *= p0 if p0 is not None else self.step_decay
            elif c == "[":
                self.stack.append(TurtleState(
                    st.position.copy(), st.heading.copy(), st.left.copy(),
                    st.up.copy(), st.radius, st.step,
                ))
            elif c == "]":
                self.state = self.stack.pop()
                self._flush_line()
            # other symbols (A, B, X...) are growth placeholders: no-op
        self._flush_line()
        return self

    def _flush_line(self):
        if len(self._current_line) > 1:
            self.polylines.append(self._current_line)
        self._current_line = []

    def to_mesh(self, sides: int = 6):
        """Generalized-cylinder mesh over all drawn segments: (positions,
        normals, uvs, indices) ready for Scene.add_mesh."""
        vs, ns, uvs, idx = [], [], [], []
        for p0, p1, r0, r1 in self.segments:
            d = p1 - p0
            ln = np.linalg.norm(d)
            if ln < 1e-9:
                continue
            d = d / ln
            a = np.array([0.0, 0.0, 1.0]) if abs(d[1]) > 0.9 else np.array([0.0, 1.0, 0.0])
            t = np.cross(d, a)
            t /= np.linalg.norm(t)
            b = np.cross(d, t)
            base = len(vs)
            for k in range(sides):
                ang = 2 * math.pi * k / sides
                rad = t * math.cos(ang) + b * math.sin(ang)
                vs.append(p0 + rad * r0)
                ns.append(rad)
                uvs.append([k / sides, 0.0])
                vs.append(p1 + rad * r1)
                ns.append(rad)
                uvs.append([k / sides, 1.0])
            for k in range(sides):
                k2 = (k + 1) % sides
                a0, a1 = base + 2 * k, base + 2 * k + 1
                b0, b1 = base + 2 * k2, base + 2 * k2 + 1
                idx.append([a0, b0, a1])
                idx.append([a1, b0, b1])
        if not vs:
            return (np.zeros((0, 3), np.float32), np.zeros((0, 3), np.float32),
                    np.zeros((0, 2), np.float32), np.zeros((0, 3), np.int64))
        return (
            np.asarray(vs, np.float32),
            np.asarray(ns, np.float32),
            np.asarray(uvs, np.float32),
            np.asarray(idx, np.int64),
        )


# ---------------------------------------------------------------------------
# Curves (Curve.cpp / Bezier.cpp equivalents)
# ---------------------------------------------------------------------------


def bezier_eval(control: np.ndarray, t: np.ndarray) -> np.ndarray:
    """De Casteljau evaluation of a Bezier curve; control [K, 3], t [N]."""
    pts = np.broadcast_to(control[None], (len(t),) + control.shape).copy()
    while pts.shape[1] > 1:
        pts = pts[:, :-1] * (1 - t[:, None, None]) + pts[:, 1:] * t[:, None, None]
    return pts[:, 0]


def subdiv_open(points: np.ndarray, iterations: int = 1) -> np.ndarray:
    """Open-curve corner-cutting subdivision (Curve::subdiv_open,
    Curve.cpp:103-139): each iteration inserts midpoints and smooths the
    interior vertices, keeping endpoints fixed."""
    pts = np.asarray(points, np.float64)
    for _ in range(iterations):
        mids = 0.5 * (pts[:-1] + pts[1:])
        out = [pts[0]]
        for i in range(len(mids)):
            out.append(mids[i])
            if i + 1 < len(mids):
                out.append(0.5 * (mids[i] + mids[i + 1]))
        out.append(pts[-1])
        pts = np.asarray(out)
    return pts.astype(np.float32)


def tube_mesh(polyline: np.ndarray, radius: float = 0.05, sides: int = 6):
    """Sweep a circle along a polyline -> path-traceable tube mesh."""
    t = Turtle()
    for p0, p1 in zip(polyline[:-1], polyline[1:]):
        t.segments.append((np.asarray(p0, np.float64), np.asarray(p1, np.float64),
                           radius, radius))
    return t.to_mesh(sides=sides)
