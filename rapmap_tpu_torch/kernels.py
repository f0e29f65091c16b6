"""Build, load and count the hand-written CUDA kernels of `csrc/`.

Each `csrc/<name>.cu` is compiled by nvcc into its own plain-C shared
library under the checkout's build/kernels/ and loaded with ctypes (no
PyTorch headers, so a build takes seconds). The library file name carries a
hash of its source, so an edited source never loads a stale build.
`build_all()` starts one nvcc per source, all at once, and waits for them.

Every kernel wrapper adds one to `LAUNCHES[<kernel>]` where it launches its
kernel, and nowhere else, so a run can show that its path went through the
kernels (chip_smoke.py zeroes the counts before the main path).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
_BUILD = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "build", "kernels"
)
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
]

# kernel name -> launches since the last reset_launches()
LAUNCHES: dict[str, int] = {
    "bitonic_sort_pairs": 0,
    "anchor_walk": 0,           # csrc/walk.cu, packed extension, strand-paired lanes
    "anchor_walk_lanes": 0,     # csrc/walk.cu, packed extension, explicit lanes
    "anchor_walk_charwise": 0,  # csrc/walk.cu, charwise extension, either lane kind
    "banded_scores": 0,         # csrc/align.cu, the mapping score of record rows
    "pseudo_walk": 0,           # csrc/walk.cu, no extension, strand-paired lanes
    "pseudo_walk_lanes": 0,     # csrc/walk.cu, no extension, explicit lanes
    "extend_packed_anchors": 0,  # csrc/walk.cu, the extension alone, anchor-parallel
    "sharded_walk": 0,          # csrc/walk.cu, sharded index, strand-paired lanes
    "sharded_walk_lanes": 0,    # csrc/walk.cu, sharded index, explicit lanes
    "sharded_trip": 0,          # csrc/walk.cu, one shard's trip of the split sharded walk
}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def sources() -> list[str]:
    """Kernel source names (csrc/<name>.cu)."""
    return sorted(f[:-3] for f in os.listdir(_CSRC) if f.endswith(".cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _lib_path(name: str) -> str:
    with open(os.path.join(_CSRC, f"{name}.cu"), "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:12]
    return os.path.join(_BUILD, f"lib{name}-{digest}.so")


def build_all(names: list[str] | None = None) -> dict[str, str]:
    """Compile every missing kernel library in parallel -> {name: .so path}.
    Raises with the compiler's output if any build fails."""
    names = sources() if names is None else names
    os.makedirs(_BUILD, exist_ok=True)
    out = {n: _lib_path(n) for n in names}
    todo = [n for n in names if not os.path.exists(out[n])]
    procs = []
    for n in todo:
        tmp = f"{out[n]}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(_CSRC, f"{n}.cu")]
        procs.append((n, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )))
    errors = []
    for n, tmp, p in procs:
        log, _ = p.communicate(timeout=600)
        if p.returncode != 0:
            errors.append(f"nvcc {n}.cu failed ({p.returncode}):\n{log}")
            if os.path.exists(tmp):
                os.remove(tmp)
            continue
        os.replace(tmp, out[n])
    if errors:
        raise RuntimeError("\n".join(errors))
    return out


def library(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built at first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(build_all([name])[name])
            _libs[name] = lib
        return lib
