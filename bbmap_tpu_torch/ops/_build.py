"""Build the port's CUDA sources at first use and load them with ctypes.

Each ``csrc/<name>.cu`` compiles with nvcc for ``sm_90a`` into a shared
library with a plain C interface under ``build/torch_kernels/`` at the
repository root (listed in ``.gitignore``). The library's file name
carries a hash of its source and of the headers beside it
(``csrc/*.cuh``), so an edited source rebuilds and an unchanged one loads
the library already built. ``build_all`` starts one nvcc for each source
at once. Nothing is downloaded: the build uses the sources in this
checkout and the installed CUDA toolkit.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, List

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]
SOURCES = ("msa_dp", "msa_dp_warp", "msa_dp_pipe", "msa_dp_band",
           "msa_walk", "msa_fill_walk", "banded_edit", "rescue_scan",
           "quality_offsets", "ref_retention", "gapless_score", "slot_pack",
           "chain_candidates")
# Libraries built from a source with other flags, by name: (source, extra
# nvcc flags). The "_dpx" builds turn dp_cell's DPX form on in mappings
# that keep the plain form (chip_smoke.py times them beside the default);
# "banded_edit_clocks" is the counting build of the containment kernels
# (each run's clock64() cycles, banded_contained_clocks; chip_smoke.py's
# clocks a row); no path of the package loads them.
VARIANTS = {**{f"{src}_dpx": (src, ("-DBBMAP_DPX_DEFAULT=1",))
               for src in ("msa_dp", "msa_dp_warp", "msa_dp_band",
                           "msa_fill_walk")},
            "banded_edit_clocks": ("banded_edit",
                                   ("-DBBMAP_CONTAINED_CLOCKS=1",))}

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                       "the CUDA toolkit is installed")


def _source(name: str):
    """(source name, extra nvcc flags) of library ``name``."""
    return VARIANTS.get(name, (name, ()))


def library_path(name: str) -> Path:
    src, flags = _source(name)
    h = hashlib.sha256((CSRC / f"{src}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(flags).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build_all(names: Iterable[str] = SOURCES) -> List[Path]:
    """Compile every library of ``names`` (a source, or a name of
    ``VARIANTS``) that has no library of the same source hash yet, one
    nvcc process each, all started together. Returns the library paths."""
    outs = [library_path(n) for n in names]
    procs = []
    for name, out in zip(names, outs):
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        src, flags = _source(name)
        cmd = [nvcc_path(), *NVCC_FLAGS, *flags, "-o", str(tmp),
               str(CSRC / f"{src}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    failed = []
    for name, out, tmp, proc in procs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu:\n{err}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return outs


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless a library of the same source
    hash exists. Returns the library path."""
    return build_all([name])[0]


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; cached per process."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            _libs[name] = lib
        return lib
