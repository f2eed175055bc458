"""Tone map to 8 bits: the CUDA kernel's wrapper (`tonemap`) and its plain
PyTorch version (`tonemap_plain`).

The kernel (csrc/tonemap.cu) replaces the TPU display kernel,
mc_path_tracer_tpu/ops/pallas/tonemap_kernel.py `tonemap_pallas` with its
`_kernel`.  Contract:
  tonemap(ld [H,W,3] f32, samples [H,W] f32, exposure) -> uint8 [H,W,3]
      = quantize(reinhard(ld, samples, exposure)), bit for bit.
On CPU tensors the wrapper runs the plain version; on CUDA tensors it
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from mc_path_tracer_tpu_torch.ops import tonemap as tonemap_ops
from mc_path_tracer_tpu_torch.ops.kernels import LAUNCHES, build, launch

_P = ctypes.c_void_p
# the C entry point of csrc/tonemap.cu: pointers and the stream as void*
ARGTYPES = {"mcpt_tonemap": [_P, _P, ctypes.c_float, ctypes.c_longlong, _P, _P]}


def _check(ld: torch.Tensor, samples: torch.Tensor) -> None:
    for name, x in (("ld", ld), ("samples", samples)):
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if ld.dim() != 3 or ld.shape[2] != 3:
        raise ValueError(f"ld must be [H, W, 3], got {tuple(ld.shape)}")
    if tuple(samples.shape) != tuple(ld.shape[:2]):
        raise ValueError(f"samples must be {tuple(ld.shape[:2])}, got {tuple(samples.shape)}")
    if samples.device != ld.device:
        raise ValueError(f"samples is on {samples.device}, ld on {ld.device}")
    if ld.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no tone map for device {ld.device}")


def tonemap(ld: torch.Tensor, samples: torch.Tensor, exposure: float = 1.0) -> torch.Tensor:
    """Accumulated radiance [H, W, 3] and sample counts [H, W] -> display
    RGB, uint8 [H, W, 3], on the input's device."""
    _check(ld, samples)
    if ld.device.type == "cpu":
        return tonemap_plain(ld, samples, exposure)
    out = torch.empty(ld.shape, dtype=torch.uint8, device=ld.device)
    n = samples.numel()
    if n:
        lib = build.bind("tonemap", ARGTYPES)
        with torch.cuda.device(ld.device):
            stream = torch.cuda.current_stream().cuda_stream
            launch(lib.mcpt_tonemap, "tonemap", ld.data_ptr(), samples.data_ptr(),
                   float(exposure), n, out.data_ptr(), stream)
    return out


def tonemap_plain(ld: torch.Tensor, samples: torch.Tensor, exposure: float = 1.0) -> torch.Tensor:
    """The kernel's function in plain PyTorch: quantize(reinhard(...))."""
    LAUNCHES["plain"] += 1
    return tonemap_ops.quantize(tonemap_ops.reinhard(ld, samples, float(exposure)))
