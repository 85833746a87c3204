"""Build the port's native sources into shared libraries and load them.

Each `csrc/*.cu` file has a plain C interface and is compiled on first use
by `nvcc` for Hopper (`sm_90a`) into `_build/` beside the sources (listed in
.gitignore), then loaded with ctypes. The library name carries a hash of the
source, the shared headers (`csrc/*.cuh`) and the flags, so an edited source
or header rebuilds and an unchanged one loads the existing library. `build` starts one `nvcc` per missing source, all at
once, and waits for all of them. `build_host` does the same for the host
C++ sources in `csrc/host/` with the host compiler (`$CXX`, else g++).
Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

HOST_DIR = CSRC_DIR / "host"
GXX_FLAGS = ("-O2", "-fPIC", "-std=c++17", "-shared")

_loaded: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """nvcc from CUDA_HOME, else from PATH, else the toolkit's usual home."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def library_path(source: str, csrc: Path = CSRC_DIR) -> Path:
    """Where `source` (a file name in `csrc`) builds to. The name hashes the
    source, every header beside it (`*.cuh`, which any source may include)
    and the flags, so an edited header rebuilds every kernel."""
    src = csrc / source
    digest = hashlib.sha256(src.read_bytes())
    for header in sorted(csrc.glob("*.cuh")):
        digest.update(header.name.encode() + b"\0" + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{src.stem}-{digest.hexdigest()[:16]}.so"


def build(sources: list[str]) -> dict[str, Path]:
    """Compile every source whose library is missing, in parallel. Returns
    {source: library path}; raises with nvcc's output if any build fails.
    The compiler's resource report (-Xptxas -v) goes to `<library>.log`."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = {s: library_path(s) for s in sources}
    running = []
    for source, lib in out.items():
        if lib.exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(CSRC_DIR / source)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running.append((source, lib, tmp, proc))
    failures = []
    for source, lib, tmp, proc in running:
        log, _ = proc.communicate()
        lib.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            os.unlink(tmp)
            failures.append(f"nvcc failed for {source} "
                            f"(exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, lib)
    if failures:
        raise RuntimeError("\n".join(failures))
    return out


def cache_size() -> int:
    """Kernel libraries loaded so far in this process: the port's build
    cache. Each holds every template instance of its kernel, so growth is
    the port's counterpart of a compile (the control loop's
    `fused_program_compiles_total` counts it)."""
    return len(_loaded)


def load(source: str) -> ctypes.CDLL:
    """The loaded library of `source`, built first if needed."""
    if source not in _loaded:
        _loaded[source] = ctypes.CDLL(str(build([source])[source]))
    return _loaded[source]


def host_compiler() -> str:
    """The host C++ compiler: $CXX, else g++ from PATH."""
    return os.environ.get("CXX") or shutil.which("g++") or "g++"


def build_host(source: str, force: bool = False) -> Path:
    """The library of `source` (a file name in csrc/host/), compiled with
    the host compiler if it is missing (or `force`). Raises with the
    compiler's output if the build fails."""
    src = HOST_DIR / source
    digest = hashlib.sha256(src.read_bytes() + " ".join(GXX_FLAGS).encode())
    lib = BUILD_DIR / f"lib{src.stem}-{digest.hexdigest()[:16]}.so"
    if lib.exists() and not force:
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    proc = subprocess.run([host_compiler(), *GXX_FLAGS, "-o", tmp, str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"{host_compiler()} failed for {source} (exit "
                           f"{proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)
    return lib
