"""Hand-written CUDA kernels: the nvcc build (`build`) and one wrapper module
per kernel with its plain PyTorch version (`traversal`, `dense`, `tonemap`).

A wrapper runs the plain version only because its tensors lie on the CPU;
on a CUDA tensor it launches the kernel or raises.  LAUNCHES counts kernel
launches per entry point, where the wrapper launches, plain-version calls
("plain"), so a run can show which path it took, and the permutations
`traversal.sort_perm` builds for the sorted traversal dispatches ("sort":
plain PyTorch, several device launches each, none of them a kernel of
this package), and the any-hit dispatches of the integrator that carry a
t_max ("anyhit_bounded": the area light's shadow rays, counted on every
route, the CPU's plain version included; "anyhit" still counts each
any-hit kernel launch).
"""

from __future__ import annotations

import torch

LAUNCHES = {
    "closest": 0, "anyhit": 0,               # csrc/traversal.cu
    "dense_closest": 0, "dense_anyhit": 0,   # csrc/dense.cu
    "tonemap": 0,                            # csrc/tonemap.cu
    "plain": 0,                              # plain-version calls
    "sort": 0,                               # traversal.sort_perm calls
    "anyhit_bounded": 0,                     # integrator any-hits with a t_max
}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def launch(fn, counter: str, *args) -> None:
    """Call a C entry point that launches a kernel and returns
    cudaGetLastError(); raise on a refused launch, else count it."""
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{fn.__name__} launch failed with CUDA error {err}")
    LAUNCHES[counter] += 1


def check_rows(*named: tuple[str, torch.Tensor, int]) -> None:
    """Each (name, tensor, width): a contiguous float32 [n, width] tensor on
    the first tensor's device, which is the CPU or a CUDA device, with n
    within int32."""
    device = named[0][1].device
    for name, x, width in named:
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")
        if x.dim() != 2 or x.shape[1] != width:
            raise ValueError(f"{name} must be [n, {width}], got {tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if x.device != device:
            raise ValueError(f"{name} is on {x.device}, {named[0][0]} on {device}")
        if x.shape[0] >= 2**31:
            raise ValueError(f"{name} has {x.shape[0]} rows; kernel sizes must fit int32")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {device}")
