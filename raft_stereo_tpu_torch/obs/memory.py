"""Device memory telemetry: counterpart of `raft_stereo_tpu/obs/memory.py`
on PyTorch's caching allocator.

`torch.cuda.memory_stats` reads the allocator's counters on the host and
`torch.cuda.mem_get_info` asks the CUDA runtime for the card's free and total
bytes; neither launches device work or waits on a stream, so sampling once
per serving batch keeps the request path free of new synchronizations.
The block keeps the JAX package's keys: `bytes_in_use` is the allocator's
allocated bytes, `peak_bytes_in_use` their peak, `bytes_limit` the card's
total memory, and `live_buffer_count` / `live_buffer_bytes` the
allocator's active blocks (JAX counts live arrays there). `platform` names
where the numbers come from. Without a card (or before CUDA is
initialized) the block says "cpu", `available` is false and every number
is 0: callers always get the same typed shape.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch


def sample_device_memory() -> List[Dict[str, Any]]:
    """Per-card allocator stats; empty when no card is in use. Never
    raises — telemetry must not take down the path it observes."""
    try:
        if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
            return []
        out: List[Dict[str, Any]] = []
        for idx in range(torch.cuda.device_count()):
            stats = torch.cuda.memory_stats(idx)
            _, total = torch.cuda.mem_get_info(idx)
            out.append({
                "device": str(idx),
                "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
                "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", 0)),
                "bytes_limit": int(total),
                "live_buffer_count": int(stats.get("active.all.current", 0)),
                "live_buffer_bytes": int(stats.get("active_bytes.all.current", 0)),
            })
        return out
    except Exception:  # noqa: BLE001 - telemetry is best-effort
        return []


def memory_block(devices: Optional[List[Dict[str, Any]]] = None) -> Dict[str, Any]:
    """The typed `memory` block of /healthz: the per-card view summed;
    complete either way, zeros with available=false without a card."""
    if devices is None:
        devices = sample_device_memory()
    keys = ("bytes_in_use", "peak_bytes_in_use", "bytes_limit", "live_buffer_count", "live_buffer_bytes")
    block: Dict[str, Any] = {
        "platform": "cuda" if devices else "cpu",
        "available": bool(devices),
        "device_count": len(devices),
    }
    block.update({k: sum(int(d.get(k, 0)) for d in devices) for k in keys})
    return block


def set_memory_gauges(registry, prefix: str = "raft") -> Dict[str, Any]:
    """Sample and publish the memory block into prom gauges. Returns the
    sampled block so callers can also keep it (healthz serves the last
    per-batch sample)."""
    block = memory_block()
    registry.gauge(
        f"{prefix}_device_memory_bytes_in_use",
        "Sum of per-device allocator bytes_in_use (0 when unavailable)",
    ).set(block["bytes_in_use"])
    registry.gauge(
        f"{prefix}_device_memory_peak_bytes_in_use",
        "Sum of per-device allocator peak_bytes_in_use",
    ).set(block["peak_bytes_in_use"])
    registry.gauge(
        f"{prefix}_device_memory_bytes_limit",
        "Sum of per-device total memory",
    ).set(block["bytes_limit"])
    registry.gauge(
        f"{prefix}_live_buffer_count", "Active caching-allocator blocks"
    ).set(block["live_buffer_count"])
    registry.gauge(
        f"{prefix}_live_buffer_bytes", "Bytes of active caching-allocator blocks"
    ).set(block["live_buffer_bytes"])
    registry.gauge(
        f"{prefix}_device_memory_available",
        "1 when a CUDA card reports allocator stats, 0 on the CPU",
    ).set(1.0 if block["available"] else 0.0)
    return block
