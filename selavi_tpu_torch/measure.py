"""Measuring on the card: kernel times from CUDA events, the card's peak
rates, and its name and power limit as ``nvidia-smi`` reports them.

Every function here needs a CUDA card; none falls back to the CPU.
"""

from __future__ import annotations

import subprocess

import torch

# NVIDIA H100 SXM data sheet, dense rates: bf16 on the tensor cores, fp32
# on the CUDA cores (no TF32).
BF16_TENSOR_PEAK_FLOPS = 989e12
FP32_PEAK_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12


def cuda_ms(fn, reps: int = 50, warmup: int = 5) -> float:
    """Mean milliseconds per call of ``fn`` on the current stream."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def memory_bandwidth(device=0) -> float:
    """Bytes/s of the card from its memory clock and bus width (HBM is
    double data rate); the H100 SXM data sheet rate if torch lacks them."""
    props = torch.cuda.get_device_properties(device)
    clock_khz = getattr(props, "memory_clock_rate", 0)
    bus_bits = getattr(props, "memory_bus_width", 0)
    if clock_khz and bus_bits:
        return 2.0 * clock_khz * 1e3 * bus_bits / 8
    return HBM_BYTES_PER_S


def _query_first_card(fields: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def card_description() -> str:
    """``name, power.limit`` of the first card, as nvidia-smi prints it."""
    return _query_first_card("name,power.limit")


def sm_clocks() -> str:
    """``clocks.sm, clocks.max.sm`` of the first card, as nvidia-smi prints
    them: the SM clock now and its maximum."""
    return _query_first_card("clocks.sm,clocks.max.sm")
