"""How often float32 transcendental functions differ in the last bits
between math libraries: torch on the CPU against torch on the card (when
one is present) and against JAX on the CPU (when JAX is installed).

    python3 tools/libm_drift.py

Prints, per function, the share of 200,000 seeded inputs on which two
libraries return different float32 results.  These differences are why the
port's renders of glossy scenes match the JAX package's to rounding, not
bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

N = 200_000


def inputs():
    rng = np.random.default_rng(0)
    d = rng.normal(size=(N, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    x = rng.uniform(0.0, 1.0, N).astype(np.float32)
    return d, x


def cases(lib, d, x):
    """name -> lib's result; `lib` maps a function name to a callable."""
    return {
        "atan2": lib["atan2"](d[:, 2], d[:, 0]),
        "asin": lib["asin"](d[:, 1]),
        "acos": lib["acos"](x),
        "sin": lib["sin"](x * 6.0),
        "cos": lib["cos"](x * 6.0),
        "exp": lib["exp"](x),
        "log": lib["log"](x + 0.1),
        "pow 5": lib["pow5"](x),
        "sqrt": lib["sqrt"](x),
    }


def torch_lib(device):
    def wrap(f):
        return lambda *a: f(*(torch.from_numpy(v).to(device) for v in a)).cpu().numpy()

    return {"atan2": wrap(torch.atan2), "asin": wrap(torch.asin), "acos": wrap(torch.acos),
            "sin": wrap(torch.sin), "cos": wrap(torch.cos), "exp": wrap(torch.exp),
            "log": wrap(torch.log), "pow5": wrap(lambda v: torch.pow(v, 5.0)),
            "sqrt": wrap(torch.sqrt)}


def jax_lib():
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    def wrap(f):
        return lambda *a: np.asarray(f(*(jnp.asarray(v) for v in a)))

    return {"atan2": wrap(jnp.arctan2), "asin": wrap(jnp.arcsin), "acos": wrap(jnp.arccos),
            "sin": wrap(jnp.sin), "cos": wrap(jnp.cos), "exp": wrap(jnp.exp),
            "log": wrap(jnp.log), "pow5": wrap(lambda v: jnp.power(v, 5.0)),
            "sqrt": wrap(jnp.sqrt)}


def main() -> int:
    d, x = inputs()
    base = cases(torch_lib("cpu"), d, x)
    others = {}
    if torch.cuda.is_available():
        others[f"torch on {torch.cuda.get_device_name(0)}"] = cases(torch_lib("cuda"), d, x)
    try:
        others["JAX on the CPU"] = cases(jax_lib(), d, x)
    except ImportError:
        pass
    for label, got in others.items():
        shares = ", ".join(f"{k} {float((got[k] != base[k]).mean()):.4f}" for k in base)
        print(f"{label} vs torch on the CPU, share of differing float32 results: {shares}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
