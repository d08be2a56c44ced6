"""Device description and timing shared by the benches and checks.

On a CUDA device a time is CUDA events around ``iters`` calls after
warm-up calls (the device's clock); on the CPU it is the host clock, which
says how fast PyTorch's CPU kernels are and nothing of a card.
"""
from __future__ import annotations

import subprocess
import time
from typing import Callable, Dict

import torch

# H100 SXM dense bf16 tensor-core peak (NVIDIA's data sheet, 700 W)
H100_PEAK_TFLOPS = 989.0


def device_info(device) -> Dict[str, str]:
    """The device's name and, on a card, its power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return {"device": "cpu"}
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    smi = subprocess.run(
        ["nvidia-smi", f"--id={idx}", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], stdout=subprocess.PIPE, text=True,
        check=True).stdout.strip()
    return {"device": torch.cuda.get_device_name(idx), "nvidia_smi": smi}


def time_ms(fn: Callable[[], object], device, iters: int = 5,
            warmup: int = 1) -> float:
    """Mean ms of ``fn()`` over ``iters`` calls after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) * 1e3 / iters
