"""nvcc build of the port's CUDA kernels, loaded with ctypes.

Every `csrc/*.cu` source compiles, with a plain C interface and no
PyTorch headers, into an object for Hopper; the nvcc processes of all
sources run at once, then one link makes the shared library:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
         -Xcompiler -fPIC -Xptxas -v -c csrc/<name>.cu -o <name>.o
    nvcc -shared -o _build/libiiv_kernels-<hash>.so *.o

The library lands in `iivision_tpu_torch/_build/` (or, where the package
directory is not writable, in `~/.cache/iivision_tpu_torch/native/`, see
`sim/_build.py`), named by a hash of the sources (headers `csrc/*.cuh`
included) and flags, so an edited kernel never loads a stale binary;
ptxas's per-kernel register and shared-memory report is kept beside it as
`<name>.log`.  The build runs at first use (a few seconds), never at
import.  A failed build raises.
"""

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time

from iivision_tpu_torch.sim._build import writable_build_dir

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# (name, argtypes) of every C entry point; each returns a cudaError_t
SIGNATURES = {
    "iiv_editdist_tile": [_P, _I, _P, _I, _I, _P, _I, _P, _P],
    "iiv_dist_pairs": [_P, _P, _L, _I, _P, _P, _P],
    "iiv_lane_dist": [_P, _L, _L, _P, _L, _L, _L, _L, _I, _I, _P, _P, _P],
    "iiv_subop_bench": [_P, _P, _P, _P, _I, _I, _P, _P, _P, _P],
    "iiv_encode_body": [_P, _P, _P, _I, _I, _P, _P, _I, _I, _I, _I, _I, _I,
                        _P, _I, _P, _P, _I, _I, _I, _I, _I, _I, _P, _I, _I,
                        _P, _P, _I, _P],
    "iiv_body_max_clusters": [_I, _P],
    "iiv_threefry_uniform": [_P, _I, _P, _I, _I, _I, _P, _P, _P],
}


def sources():
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def headers():
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh")))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found on PATH or under %s: the port's "
                       "CUDA kernels cannot be built" % home)


def library_path() -> str:
    """Where this source hash's library is, or is to be built: in
    BUILD_DIR if it is there already or BUILD_DIR is writable, else under
    the user's cache directory."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources() + headers():
        with open(src, "rb") as f:
            h.update(os.path.basename(src).encode() + b"\0" + f.read())
    fname = "libiiv_kernels-%s.so" % h.hexdigest()[:16]
    in_package = os.path.join(BUILD_DIR, fname)
    if os.path.exists(in_package):
        return in_package
    return os.path.join(writable_build_dir(BUILD_DIR), fname)


def build() -> dict:
    """Compile the kernels if this source hash has no library yet.

    Returns {"path", "seconds", "built", "log"}: `built` is False when an
    existing library was reused, `log` holds nvcc's ptxas report."""
    out = library_path()
    log_path = out[:-3] + ".log"
    if os.path.exists(out):
        log = open(log_path).read() if os.path.exists(log_path) else ""
        return dict(path=out, seconds=0.0, built=False, log=log)
    t0 = time.time()
    with tempfile.TemporaryDirectory(dir=os.path.dirname(out)) as tmp:
        nvcc = _nvcc()
        objs = [os.path.join(tmp, os.path.basename(src)[:-3] + ".o")
                for src in sources()]
        procs = [subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", src, "-o", obj],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src, obj in zip(sources(), objs)]
        logs = [p.communicate()[0] for p in procs]
        log = "".join(logs)
        failed = [(src, p.returncode) for src, p in zip(sources(), procs)
                  if p.returncode != 0]
        if failed:
            raise RuntimeError("nvcc failed on %s:\n%s" % (failed, log))
        lib = os.path.join(tmp, "lib.so")
        proc = subprocess.run([nvcc, "-shared", "-o", lib, *objs],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError("nvcc link failed (%d):\n%s%s" % (
                proc.returncode, proc.stdout, proc.stderr))
        os.replace(lib, out)
    with open(log_path, "w") as f:
        f.write(log)
    return dict(path=out, seconds=time.time() - t0, built=True, log=log)


@functools.lru_cache(None)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built first if needed), with argtypes
    and restype declared for every entry point."""
    lib = ctypes.CDLL(build()["path"])
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.iiv_error_string.argtypes = [ctypes.c_int]
    lib.iiv_error_string.restype = ctypes.c_char_p
    return lib


def launch(name: str, *args) -> None:
    """Call C entry point `name`; raise if it reports a CUDA error (the
    entry points return cudaGetLastError() right after their launch)."""
    lib = library()
    err = getattr(lib, name)(*args)
    if err != 0:
        raise RuntimeError("%s: CUDA error %d (%s)" % (
            name, err, lib.iiv_error_string(err).decode()))


COUNT_LOCK = threading.Lock()
# (wrapper, attr) of every kernel launch counter, as `counter` made them:
# the one list that `trace.counters` and the chip smoke read
COUNTERS = []


def counter(wrapper, *attrs: str) -> None:
    """Give a kernel wrapper its launch counters (default `launches`), each
    at 0, and list them in COUNTERS."""
    for attr in attrs or ("launches",):
        setattr(wrapper, attr, 0)
        COUNTERS.append((wrapper, attr))


def count(wrapper, attr: str = "launches") -> None:
    """Add one to a kernel wrapper's launch counter.  The shards of a mesh
    launch from threads of their own, so the read-modify-write holds one
    lock: no launch goes uncounted."""
    with COUNT_LOCK:
        setattr(wrapper, attr, getattr(wrapper, attr) + 1)


def stream_ptr(device) -> int:
    """PyTorch's current CUDA stream on `device`, as an integer handle."""
    import torch

    return torch.cuda.current_stream(device).cuda_stream
