"""System telemetry for /system-status (torch counterpart of
``chatterbox_tpu/serve/telemetry.py``): psutil CPU/RAM, and per-GPU memory
from ``torch.cuda`` (the device's free and total memory, and what this
process's allocator holds)."""
from __future__ import annotations

from typing import Any, Dict, List

import torch


def cpu_status() -> Dict[str, Any]:
    try:
        import psutil

        ram = psutil.virtual_memory()
        return {
            # interval=None: non-blocking (delta since previous call) — a
            # 100 ms sleep here would stall the serving event loop
            "utilization_percent": psutil.cpu_percent(interval=None),
            "ram_gb": {
                "total": round(ram.total / 1024**3, 2),
                "used": round(ram.used / 1024**3, 2),
                "free": round(ram.free / 1024**3, 2),
                "percent_used": ram.percent,
            },
        }
    except ImportError:
        return {"error": "psutil library not installed."}
    except Exception as exc:  # pragma: no cover
        return {"error": f"Could not retrieve CPU/RAM stats: {exc}"}


def gpu_status() -> List[Dict[str, Any]]:
    """One entry per visible CUDA device (an empty list without CUDA)."""
    out: List[Dict[str, Any]] = []
    if not torch.cuda.is_available():
        return out
    for i in range(torch.cuda.device_count()):
        info: Dict[str, Any] = {"device_id": i, "platform": "gpu",
                                "device_kind": torch.cuda.get_device_name(i)}
        try:
            free, total = torch.cuda.mem_get_info(i)
            stats = torch.cuda.memory_stats(i)
            info["memory_gb"] = {
                "used": round((total - free) / 1024**3, 2),
                "total": round(total / 1024**3, 2),
                "free": round(free / 1024**3, 2),
                "allocated": round(stats.get("allocated_bytes.all.current", 0) / 1024**3, 2),
                "reserved": round(stats.get("reserved_bytes.all.current", 0) / 1024**3, 2),
            }
        except RuntimeError:
            info["memory_gb"] = None
        out.append(info)
    return out
