"""Environment probe: what this machine offers the port.

No JAX counterpart. ``python -m mem_tpu_torch.utils.env`` prints the probe
as JSON: torch and CUDA versions, the nvcc path and version, the device's
name, capability and count, and ``nvidia-smi``'s name and power limit.
"""
from __future__ import annotations

import json
import subprocess

NVIDIA_SMI_QUERY = ["nvidia-smi", "--query-gpu=name,power.limit",
                    "--format=csv,noheader"]


def _run(cmd) -> str | None:
    try:
        out = subprocess.run(cmd, capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip() if out.returncode == 0 else None


def nvidia_smi() -> str | None:
    """``name, power.limit`` of the first card as nvidia-smi prints them."""
    out = _run(NVIDIA_SMI_QUERY)
    return out.splitlines()[0].strip() if out else None


def probe() -> dict:
    import torch

    from mem_tpu_torch.kernels.build import find_nvcc

    nvcc = find_nvcc()
    nvcc_version = _run([nvcc, "--version"]) if nvcc else None
    info = {
        "torch": torch.__version__,
        "torch_cuda": torch.version.cuda,
        "cuda_available": torch.cuda.is_available(),
        "nvcc": nvcc,
        "nvcc_version": nvcc_version.splitlines()[-1] if nvcc_version else None,
        "device_count": torch.cuda.device_count() if torch.cuda.is_available() else 0,
        "device_name": None,
        "capability": None,
        "nvidia_smi": nvidia_smi(),
    }
    if info["cuda_available"]:
        info["device_name"] = torch.cuda.get_device_name(0)
        info["capability"] = list(torch.cuda.get_device_capability(0))
    return info


if __name__ == "__main__":
    print(json.dumps(probe()))
