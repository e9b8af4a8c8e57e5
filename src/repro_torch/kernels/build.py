"""Build the port's CUDA kernels (`src/repro_torch/csrc/*.cu`) with nvcc and
load them with ctypes.

Each source compiles, in parallel with the others, to its own shared
library with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o lib<name>.so <name>.cu

The two conv sources compile once per tile of the persistent kernels' menu
(`repro_torch.tuning.blocks.TILE_MENU`), each into a library of its own,
`lib<name>_<rows>x<cols>.so` built with `-DREPRO_TILE_ROWS=<rows>
-DREPRO_TILE_COLS=<cols>` (csrc/staging.cuh's `LibTile`), so every menu
tile adds a library that builds in parallel, not time to one build.

into `build/repro_torch/<digest>/` at the repository root (listed in
`.gitignore`), where `<digest>` hashes the sources and the flags, so a
changed source rebuilds and an unchanged one is reused. The build happens
at first use. With no `nvcc`, or a failed build, it raises.

Every C entry point takes the stream to launch on as its last argument
and returns `cudaGetLastError()`; `launch` calls one on the current stream
of a device and raises on a non-zero return with CUDA's message for it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from functools import lru_cache
from pathlib import Path

import torch

from repro_torch.tuning.blocks import TILE_MENU

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
DEFAULT_CUDA_HOME = "/usr/local/cuda"
SOURCES = ("conv_pass", "fused_separable", "karatsuba_matmul", "karatsuba_matmul_i8",
           "mitchell_matmul")
#: sources built once per persistent tile of the menu
TILED_SOURCES = ("conv_pass", "fused_separable")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")


def library_name(source: str, tile: tuple[int, int] | None = None) -> str:
    """The library of `source` built for persistent `tile` (None: the
    menu's first, which also holds the tiled kernels every library has);
    the source's own name for the sources without a tile."""
    if source not in TILED_SOURCES:
        return source
    rows, cols = TILE_MENU["persistent"][0] if tile is None else tile
    return f"{source}_{rows}x{cols}"


#: library name -> (source, extra nvcc flags)
LIBRARIES: dict[str, tuple[str, tuple[str, ...]]] = {
    **{library_name(src, tile): (src, (f"-DREPRO_TILE_ROWS={tile[0]}",
                                       f"-DREPRO_TILE_COLS={tile[1]}"))
       for src in TILED_SOURCES for tile in TILE_MENU["persistent"]},
    **{src: (src, ()) for src in SOURCES if src not in TILED_SOURCES},
}


def find_nvcc() -> str:
    """Path of nvcc: on PATH, else under CUDA_HOME or DEFAULT_CUDA_HOME."""
    found = shutil.which("nvcc")
    if found:
        return found
    for home in (os.environ.get("CUDA_HOME"), DEFAULT_CUDA_HOME):
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME, DEFAULT_CUDA_HOME); "
                       "the CUDA kernels cannot be built")


def source_digest() -> str:
    """Hash of every file in csrc/, of the nvcc flags and of the libraries."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update(repr(sorted(LIBRARIES.items())).encode())
    for path in sorted(CSRC.iterdir()):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build() -> dict[str, Path]:
    """Compile every source not yet built for this digest, all nvcc
    processes at once; -> {name: path of lib<name>.so}. The compiler's
    output (registers, shared memory, spills) is kept in <name>.log."""
    nvcc = find_nvcc()
    out_dir = BUILD_ROOT / source_digest()
    out_dir.mkdir(parents=True, exist_ok=True)
    libs = {name: out_dir / f"lib{name}.so" for name in LIBRARIES}
    jobs = []
    for name, lib in libs.items():
        if lib.exists():
            continue
        source, flags = LIBRARIES[name]
        tmp = out_dir / f"lib{name}.{os.getpid()}.tmp.so"
        cmd = [nvcc, *NVCC_FLAGS, *flags, "-o", str(tmp), str(CSRC / f"{source}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((name, proc, tmp, lib))
    failed = []
    for name, proc, tmp, lib in jobs:          # wait for all before raising
        log = proc.communicate()[0]
        (out_dir / f"{name}.log").write_text(log)
        if proc.returncode == 0:
            os.replace(tmp, lib)
        else:
            tmp.unlink(missing_ok=True)
            failed.append(f"{name}.cu (exit {proc.returncode}):\n{log}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return libs


@lru_cache(maxsize=None)
def load_library(name: str) -> ctypes.CDLL:
    """The built library `lib<name>.so`, building it first if needed; a
    tiled source's name is its first tile's library."""
    name = library_name(name) if name in TILED_SOURCES else name
    if name not in LIBRARIES:
        raise ValueError(f"unknown kernel library {name!r}; have {tuple(LIBRARIES)}")
    return ctypes.CDLL(str(build()[name]))


@lru_cache(maxsize=None)
def _entry_point(library: str, name: str, argtypes: tuple):
    """The C entry point `name` of `lib<library>.so` with its ctypes
    argument types set (the stream last) and an int (cudaError_t) result."""
    lib = load_library(library)
    fn = getattr(lib, name)
    fn.argtypes = [*argtypes, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.repro_error_string.argtypes = [ctypes.c_int]
    lib.repro_error_string.restype = ctypes.c_char_p
    return fn


def launch(library: str, name: str, argtypes: tuple, device: torch.device,
           *args) -> None:
    """Call entry point `name` of `lib<library>.so` with `args` (ctypes
    `argtypes`) and the current stream of `device`; raise if it returns a
    CUDA error."""
    fn = _entry_point(library, name, tuple(argtypes))
    stream = torch.cuda.current_stream(device).cuda_stream
    if device.index is None or device.index == torch.cuda.current_device():
        err = fn(*args, stream)
    else:
        with torch.cuda.device(device):
            err = fn(*args, stream)
    if err:
        msg = load_library(library).repro_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {err} ({msg})")


__all__ = ["BUILD_ROOT", "CSRC", "DEFAULT_CUDA_HOME", "LIBRARIES", "NVCC_FLAGS", "SOURCES",
           "TILED_SOURCES", "build", "find_nvcc", "launch", "library_name", "load_library",
           "source_digest"]
