"""System info (port of reference gopsutil/ SystemInfo).

Uptime, platform, memory — via /proc and the platform module (no
third-party deps; gopsutil equivalent for Linux hosts).
"""

from __future__ import annotations

import os
import platform
from typing import Dict


def _meminfo() -> Dict[str, int]:
    out = {}
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                parts = line.split()
                if parts[0] in ("MemTotal:", "MemFree:", "MemAvailable:"):
                    out[parts[0].rstrip(":")] = int(parts[1]) * 1024
    except OSError:
        pass
    return out


def uptime() -> int:
    try:
        with open("/proc/uptime") as f:
            return int(float(f.read().split()[0]))
    except OSError:
        return 0


def system_info() -> dict:
    mem = _meminfo()
    return {
        "OS": platform.system(),
        "platform": platform.platform(),
        "kernelVersion": platform.release(),
        "machine": platform.machine(),
        "pythonVersion": platform.python_version(),
        "memTotal": mem.get("MemTotal", 0),
        "memFree": mem.get("MemFree", 0),
        "hostUptime": uptime(),
        "numCPU": os.cpu_count() or 0,
    }
