"""Run provenance and device-memory observability (counterpart of
``zipvoice_tpu/utils/provenance.py``).

The reference stamps env/git info into saved params
(reference zipvoice/utils/common.py:569-582) and logs the CUDA memory
high-water mark during training (train_zipvoice.py:578-581).  Here a JSON
provenance blob is written into the exp dir, and ``device_memory_stats``
reads the CUDA caching allocator's counters (``torch.cuda.memory_stats``).
"""

import getpass
import json
import os
import platform
import socket
import subprocess
import sys
import time
from typing import Dict, Optional


def collect_provenance(extra: Optional[Dict] = None) -> Dict:
    info = {
        "argv": sys.argv,
        "python": sys.version.split()[0],
        "platform": platform.platform(),
        "hostname": socket.gethostname(),
        "user": getpass.getuser(),
        "cwd": os.getcwd(),
        "time": time.strftime("%Y-%m-%d %H:%M:%S"),
        "env": {
            k: v for k, v in os.environ.items()
            if k.startswith(("CUDA_", "TORCH_", "ZIPVOICE_"))
        },
    }
    try:
        import torch

        info["torch"] = torch.__version__
        info["cuda"] = torch.version.cuda
        if torch.cuda.is_available():
            info["device"] = torch.cuda.get_device_name(0)
            info["device_count"] = torch.cuda.device_count()
    except Exception:  # noqa: BLE001
        pass
    try:
        sha = subprocess.run(
            ["git", "rev-parse", "HEAD"],
            cwd=os.path.dirname(os.path.dirname(
                os.path.dirname(os.path.abspath(__file__)))),
            capture_output=True, text=True, timeout=5,
        ).stdout.strip()
        if sha:
            info["git_sha"] = sha
    except Exception:  # noqa: BLE001
        pass
    if extra:
        info.update(extra)
    return info


def write_provenance(exp_dir, extra: Optional[Dict] = None) -> Dict:
    info = collect_provenance(extra)
    try:
        path = os.path.join(str(exp_dir), "env.json")
        with open(path, "w") as f:
            json.dump(info, f, indent=2, default=str)
    except OSError:
        pass
    return info


def device_memory_stats(device=None) -> Optional[Dict[str, int]]:
    """Current and peak allocated bytes of the CUDA caching allocator on
    ``device`` (the current card by default), under the JAX package's key
    names, or None without CUDA."""
    import torch

    if not torch.cuda.is_available():
        return None
    stats = torch.cuda.memory_stats(device)
    return {
        "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
        "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", 0)),
        "bytes_reserved": int(stats.get("reserved_bytes.all.current", 0)),
        "bytes_limit": int(torch.cuda.get_device_properties(
            device if device is not None else torch.cuda.current_device()
        ).total_memory),
    }
