"""Build the CUDA kernels with nvcc and bind them with ctypes.

Each `csrc/<name>.cu` compiles on its own into `build/lib<name>_<hash>.so`
(a plain C interface, no PyTorch headers, so a build takes seconds). The
hash covers the source, the shared headers `csrc/*.cuh` and the flags, so
an edited source or header is rebuilt and a stale library is never loaded. `build_all` starts one nvcc per source at
once. Nothing is built when a module is imported: the first launch on a
CUDA tensor builds what is missing.

Every exported C function launches on the stream it is given, allocates
nothing and returns `cudaGetLastError()`; `check` turns a non-zero code
into an exception. Each wrapper counts its launches through
`count_launch`; a launch a CUDA graph captures counts on each replay
(`CapturedLaunches`).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD = _PKG.parent / "build"
SOURCES = ("splat", "blend", "maploss", "slots")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict[str, ctypes.CDLL] = {}
BUILD_LOG: dict[str, str] = {}

_VP, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_LL = ctypes.c_longlong
# exported symbol -> ctypes argument types (pointers and the stream as
# c_void_p: a default int argument would cut a 64-bit pointer; a None
# pointer is NULL, as the tile-id operand takes it)
_SPLAT_BWD = (_VP,) * 6 + (_I,) * 4 + (_VP, _VP)
SIGNATURES = {
    "splat": {
        "vtgs_splat_fwd": (_VP,) * 4 + (_I,) * 4 + (_VP, _VP),
        "vtgs_splat_bwd_pose": _SPLAT_BWD,
        "vtgs_splat_bwd_vals_rows": _SPLAT_BWD,
        "vtgs_splat_bwd_all": _SPLAT_BWD,
    },
    "blend": {
        "vtgs_blend_fwd": (_VP,) * 3 + (_I,) * 5 + (_VP, _VP),
        "vtgs_blend_bwd": (_VP,) * 5 + (_I,) * 5 + (_VP, _VP),
    },
    "maploss": {
        "vtgs_map_loss_fwd": (_VP,) * 5 + (_I,) * 9 + (_F, _F) + (_VP,) * 9,
        "vtgs_map_loss_bwd": (_VP, _VP, _F, _F, _VP, _VP, _I, _I, _VP, _VP,
                              _VP),
    },
    "slots": {
        "vtgs_slot_gather": (_VP,) * 3 + (_I, _I, _VP, _VP),
        "vtgs_slot_inverse": (_VP,) * 3 + (_I, _LL, _VP, _VP),
    },
}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    for header in sorted(CSRC.glob("*.cuh")):
        src += header.read_bytes()
    h = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD / f"lib{name}_{h}.so"


def build_all(names=SOURCES) -> float:
    """Compile every missing library, one nvcc per source, all at once.
    Returns the wall seconds; nvcc's output (register and shared-memory
    use per kernel) lands in BUILD_LOG."""
    t0 = time.time()
    BUILD.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        BUILD_LOG[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}.cu:\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed\n" + "\n".join(failed))
    return time.time() - t0


def library(name: str) -> ctypes.CDLL:
    lib = _LIBS.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build_all((name,))
        lib = ctypes.CDLL(str(path))
        for fn, argtypes in SIGNATURES[name].items():
            f = getattr(lib, fn)
            f.argtypes = list(argtypes)
            f.restype = ctypes.c_int
        lib.vtgs_error_string.argtypes = [ctypes.c_int]
        lib.vtgs_error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        msg = lib.vtgs_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def stream_of(t) -> int:
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream


def require(cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(what)


_CAPTURES: list[dict] = []     # the tallies of the open graph captures


def count_launch(wrapper) -> None:
    """Count one launch of `wrapper`'s kernel in its `launches` attribute,
    where it runs now; where a CUDA graph captures it, in the tally of the
    open `CapturedLaunches`, which counts it on each replay."""
    import torch
    if not torch.cuda.is_current_stream_capturing():
        wrapper.launches += 1
    elif _CAPTURES:
        tally = _CAPTURES[-1]
        tally[wrapper] = tally.get(wrapper, 0) + 1
    else:
        raise RuntimeError(f"{wrapper!r}: a kernel launch captured into a "
                           f"CUDA graph outside `CapturedLaunches` would "
                           f"go uncounted")


class CapturedLaunches:
    """The kernel launches a CUDA graph holds: capture inside `with`, then
    `replay(graph)` replays it and adds its launches to each wrapper's
    `launches`, as launching them one by one would."""

    def __init__(self):
        self.tally: dict = {}

    def __enter__(self):
        _CAPTURES.append(self.tally)
        return self

    def __exit__(self, *exc):
        _CAPTURES.pop()
        return False

    def replay(self, graph) -> None:
        graph.replay()
        for wrapper, n in self.tally.items():
            wrapper.launches += n
