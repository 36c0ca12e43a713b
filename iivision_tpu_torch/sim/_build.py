"""g++ build of the port's host-side C++ helpers (the port's counterpart of
iivision_tpu/sim/_build.py).

Each source under `sim/csrc/` compiles at first use, never at import, into
`iivision_tpu_torch/_build/` (gitignored), named by a hash of the source,
the flags and the host's CPU features, so an edited source or another CPU
never loads a stale binary.  Where the package directory is not writable
(a wheel installed into a read-only site-packages) the build lands in
`~/.cache/iivision_tpu_torch/native/` instead (`XDG_CACHE_HOME` is
honoured): a second place to build in, under the same hashed names.  A
build lands in a temp file and is renamed into place, so concurrent
processes never load a half-written library.  A failed build raises.
"""

import hashlib
import os
import platform
import subprocess
import tempfile

CSRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "_build")
_FAST_FLAGS = ["-O3", "-march=native", "-funroll-loops"]
_BASE_FLAGS = ["-O3"]


def cache_dir() -> str:
    """Where builds go when the package directory is not writable."""
    root = os.environ.get("XDG_CACHE_HOME",
                          os.path.join(os.path.expanduser("~"), ".cache"))
    return os.path.join(root, "iivision_tpu_torch", "native")


def writable_build_dir(preferred: str) -> str:
    """`preferred` (created if it can be) when it is writable, else
    `cache_dir()` (created)."""
    try:
        os.makedirs(preferred, exist_ok=True)
    except OSError:
        pass
    if os.path.isdir(preferred) and os.access(preferred, os.W_OK):
        return preferred
    fallback = cache_dir()
    os.makedirs(fallback, exist_ok=True)
    return fallback


def host_tag() -> str:
    """Short token of this host's ISA and CPU feature set: -march=native
    binaries built on one CPU can fault on another."""
    feat = b""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            for line in f:
                if line.startswith((b"flags", b"Features")):
                    feat = line
                    break
    except OSError:
        pass
    return "%s-%s" % (platform.machine(),
                      hashlib.sha256(feat).hexdigest()[:8])


def _compile(src: str, out: str, flags) -> None:
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(out))
    os.close(fd)
    try:
        subprocess.check_call(["g++", *flags, "-shared", "-fPIC", src,
                               "-o", tmp])
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def build_so(name: str, native_isa: bool = False) -> str:
    """Compile `sim/csrc/<name>.cpp` if needed; return the library path.

    native_isa=True first tries -march=native (the integer resize
    convolution nearly halves with it) and falls back to plain -O3."""
    src = os.path.join(CSRC_DIR, name + ".cpp")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    build_dir = writable_build_dir(BUILD_DIR)
    last_err = None
    for flags in ([_FAST_FLAGS, _BASE_FLAGS] if native_isa
                  else [_BASE_FLAGS]):
        fhash = hashlib.sha256(" ".join(flags).encode()).hexdigest()[:8]
        fname = "lib%s-%s-%s-%s.so" % (name, digest, fhash, host_tag())
        # a library already in the package directory is used where it lies
        for found in (os.path.join(BUILD_DIR, fname),
                      os.path.join(build_dir, fname)):
            if os.path.exists(found):
                return found
        out = os.path.join(build_dir, fname)
        try:
            _compile(src, out, flags)
            return out
        except subprocess.CalledProcessError as e:
            last_err = e
    raise last_err
