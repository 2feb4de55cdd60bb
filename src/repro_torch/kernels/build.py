"""Build the port's CUDA sources into plain-C shared libraries, at first use.

Each ``csrc/*.cu`` source is compiled by ``nvcc`` for Hopper (``sm_90a``)
into a shared library with a C interface, loaded with ``ctypes``.  Nothing
includes PyTorch's headers, so a build takes seconds.  Libraries land in
``build/kernels/`` at the root of the checkout (listed in ``.gitignore``),
named by a hash of the source and the flags, so an edited source rebuilds
and an unchanged one is loaded as it is.  Nothing builds at import.

Each source has its own flags (:data:`SOURCE_FLAGS`), its own library and
its own build log; the shared header ``csrc/sm90.cuh`` (wgmma, TMA and
mbarrier helpers of the bf16 attention kernels) is part of every source's
hash.  Those kernels encode their TMA tensor maps on the host with
``cuTensorMapEncodeTiled``, looked up at run time with
``cudaGetDriverEntryPoint``, so no library links ``-lcuda``.

The tick loop's flags are part of its numerics: ``-fmad=false`` stops
nvcc from contracting ``a*b+c`` into one fused multiply-add (the JAX
reference rounds the product first); ``-ftz=true`` flushes float32
subnormals to zero, as XLA does on the CPU and the TPU.  The RG-LRU scan
is built with ``-fmad=false`` too, and without the flush: it equals its
plain version (eager PyTorch on the card, which keeps IEEE subnormals) bit
for bit.  The attention kernels (forward and backward, float32 and bf16)
and the WKV recurrence (both routes, and its backward) claim no
bit-exactness, only a stated tolerance
against their plain versions, so they keep nvcc's default contraction and
IEEE subnormals.  No source gets ``--use_fast_math`` (correctly rounded
division and ``expf`` / ``logf``, as the references have).
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"

_BASE_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: The tick loop's flags (bit-exact float32: no contraction, FTZ).  Its
#: source holds 8 kernels (one per partition count, each with every
#: controller's and environment's body), which nvcc optimizes in parallel
#: over every core (``-split-compile=0``; the registers and the results
#: are the same).
NVCC_FLAGS = _BASE_FLAGS + ("-fmad=false", "-ftz=true", "-split-compile=0")

#: nvcc flags per ``csrc`` source.
SOURCE_FLAGS = {
    "tick_loop.cu": NVCC_FLAGS,
    "flash_attention.cu": _BASE_FLAGS,
    "flash_attention_bwd.cu": _BASE_FLAGS,
    "flash_attention_sm90.cu": _BASE_FLAGS,
    "flash_attention_bwd_sm90.cu": _BASE_FLAGS,
    "wkv.cu": _BASE_FLAGS,
    "wkv_bwd.cu": _BASE_FLAGS,
    "wkv_bwd_chunk.cu": _BASE_FLAGS,
    "rglru.cu": _BASE_FLAGS + ("-fmad=false",),
}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on the
    ``PATH``, else ``/usr/local/cuda/bin/nvcc``."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        candidates.append(Path(found))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels are built on the machine with the "
                       "card")


def build(source: str) -> tuple[Path, str]:
    """Compile ``csrc/<source>`` (if its library is not built yet) and
    return (library path, nvcc's output including ``-Xptxas -v``, then its
    wall time: :func:`nvcc_seconds`)."""
    src = CSRC / source
    flags = SOURCE_FLAGS[source]
    text = src.read_bytes() + b"".join(
        h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(text + " ".join(flags).encode()).hexdigest()
    stem = f"{src.stem}-{digest[:16]}"
    lib = BUILD_DIR / f"{stem}.so"
    log = BUILD_DIR / f"{stem}.log"
    if lib.is_file() and log.is_file():
        return lib, log.read_text()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # Compile to a private name and rename into place, so concurrent
    # builders (test workers) never load a half-written library.
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        t0 = time.perf_counter()
        proc = subprocess.run([nvcc_path(), *flags, "-o", tmp, str(src)],
                              capture_output=True, text=True, timeout=900)
        out = proc.stdout + proc.stderr
        out += f"\n{_NVCC_WALL} {time.perf_counter() - t0:.1f} s\n"
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src} "
                               f"(exit {proc.returncode}):\n{out}")
        log.write_text(out)
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib, out


_NVCC_WALL = "nvcc wall time:"


def nvcc_seconds(log: str):
    """The wall time of the nvcc run that wrote ``log`` (seconds), or None
    for a log without it."""
    m = re.search(re.escape(_NVCC_WALL) + r" ([0-9.]+) s", log)
    return None if m is None else float(m.group(1))


def ptxas_report(log: str) -> dict[str, str]:
    """Per kernel entry (mangled name): ptxas's registers / spills / shared
    memory lines from a ``-Xptxas -v`` build log."""
    report: dict[str, list[str]] = {}
    current = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            current = m.group(1)
            report[current] = []
            continue
        if current and ("registers" in line or "stack frame" in line):
            report[current].append(line.split(":", 1)[-1].strip())
    return {k: "; ".join(v) for k, v in report.items()}


def tick_loop_grouped_instance(name: str):
    """P of a mangled ``tick_loop_grouped_kernel`` entry name."""
    m = re.search(r"tick_loop_grouped_kernelILi(\d+)E", name)
    return None if m is None else int(m.group(1))


@functools.lru_cache(maxsize=None)
def _load(source: str):
    path, log = build(source)
    return ctypes.CDLL(str(path)), log


#: ctypes argument types of ``tick_loop_set_group`` (csrc/tick_loop.cu)
#: after its first two (the descriptor buffer and the index).
TICK_LOOP_GROUP_ARGTYPES = (
    [ctypes.c_int] * 3 + [ctypes.c_void_p] * 15 + [ctypes.c_int] * 3
    + [ctypes.c_float, ctypes.POINTER(ctypes.c_float), ctypes.c_int,
       ctypes.c_int, ctypes.POINTER(ctypes.c_int),
       ctypes.POINTER(ctypes.c_float), ctypes.c_void_p, ctypes.c_void_p,
       ctypes.POINTER(ctypes.c_int), ctypes.c_int])


def bind_tick_loop(lib, launch: str = "tick_loop_grouped_launch"):
    """Set the ctypes signatures of the tick-loop library's C interface
    (``launch`` names its launch function: the card's, or a host build's)
    and return ``lib``."""
    fn = lib.tick_loop_set_group
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int] + TICK_LOOP_GROUP_ARGTYPES
    fn.restype = ctypes.c_int
    fn = getattr(lib, launch)
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.tick_loop_group_bytes.restype = ctypes.c_int
    lib.tick_loop_max_groups.restype = ctypes.c_int
    return lib


def load_tick_loop() -> ctypes.CDLL:
    """The tick-loop library, built and loaded once per process."""
    lib, _ = _load("tick_loop.cu")
    bind_tick_loop(lib)
    lib.tick_loop_error_string.argtypes = [ctypes.c_int]
    lib.tick_loop_error_string.restype = ctypes.c_char_p
    return lib


def flash_attention_instance(name: str):
    """(dtype, hd) of a mangled ``flash_fwd_kernel`` entry name (the
    float32 path): dtype ``"float32"`` or ``"bfloat16"``."""
    m = re.search(r"flash_fwd_kernelI(f|13__nv_bfloat16)Li(\d+)E", name)
    return None if m is None else (
        "float32" if m.group(1) == "f" else "bfloat16", int(m.group(2)))


def load_flash_attention() -> ctypes.CDLL:
    """The flash-attention library (float32 path), built and loaded once
    per process."""
    lib, _ = _load("flash_attention.cu")
    fn = lib.flash_attention_launch
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 5
                   + [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_longlong),
                                           ctypes.c_int, ctypes.c_int,
                                           ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.flash_attention_error_string.argtypes = [ctypes.c_int]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def flash_attention_bwd_instance(name: str):
    """(kernel, dtype, hd) of a mangled ``flash_bwd_dq_kernel`` /
    ``flash_bwd_dkdv_kernel`` entry name: kernel ``"dq"`` or ``"dkdv"``,
    dtype ``"float32"`` or ``"bfloat16"``."""
    m = re.search(r"flash_bwd_(dq|dkdv)_kernelI(f|13__nv_bfloat16)Li(\d+)E",
                  name)
    return None if m is None else (
        m.group(1), "float32" if m.group(2) == "f" else "bfloat16",
        int(m.group(3)))


def load_flash_attention_bwd() -> ctypes.CDLL:
    """The flash-attention backward library (float32 path), built and
    loaded once per process."""
    lib, _ = _load("flash_attention_bwd.cu")
    fn = lib.flash_attention_bwd_launch
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 9
                   + [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_longlong),
                                           ctypes.c_int, ctypes.c_int,
                                           ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.flash_attention_bwd_error_string.argtypes = [ctypes.c_int]
    lib.flash_attention_bwd_error_string.restype = ctypes.c_char_p
    return lib


def flash_attention_sm90_instance(name: str):
    """(kernel, hd) of a mangled entry name of the bf16 attention kernels:
    kernel ``"fwd"``, ``"dq"`` or ``"dkdv"``."""
    m = re.search(r"flash_(fwd|bwd_dq|bwd_dkdv)_sm90_kernelILi(\d+)E", name)
    return None if m is None else (m.group(1).replace("bwd_", ""),
                                   int(m.group(2)))


def load_flash_attention_sm90() -> ctypes.CDLL:
    """The bf16 flash-attention forward library (wgmma + TMA), built and
    loaded once per process."""
    lib, _ = _load("flash_attention_sm90.cu")
    fn = lib.flash_attention_sm90_launch
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 5
                   + [ctypes.c_int] * 5
                   + [ctypes.POINTER(ctypes.c_longlong)] * 2
                   + [ctypes.c_int, ctypes.c_int, ctypes.c_float,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.flash_attention_sm90_error_string.argtypes = [ctypes.c_int]
    lib.flash_attention_sm90_error_string.restype = ctypes.c_char_p
    return lib


def load_flash_attention_bwd_sm90() -> ctypes.CDLL:
    """The bf16 flash-attention backward library (wgmma + TMA), built and
    loaded once per process."""
    lib, _ = _load("flash_attention_bwd_sm90.cu")
    fn = lib.flash_attention_bwd_sm90_launch
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_int]
                   + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
                   + [ctypes.POINTER(ctypes.c_longlong)] * 2
                   + [ctypes.c_int, ctypes.c_int, ctypes.c_float,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.flash_attention_bwd_sm90_error_string.argtypes = [ctypes.c_int]
    lib.flash_attention_bwd_sm90_error_string.restype = ctypes.c_char_p
    return lib


def hgmma_count(source: str):
    """How many ``HGMMA`` (wgmma) instructions the built library of
    ``source`` holds, from ``cuobjdump --dump-sass``; None where the
    toolkit has no ``cuobjdump``."""
    tool = Path(nvcc_path()).parent / "cuobjdump"
    if not tool.is_file():
        return None
    path, _ = build(source)
    proc = subprocess.run([str(tool), "--dump-sass", str(path)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"cuobjdump failed on {path}: {proc.stderr}")
    return sum("HGMMA." in line for line in proc.stdout.splitlines())


def wkv_instance(name: str):
    """(route, r/k/v dtype, w dtype, columns a block) of a mangled entry
    name of ``wkv.cu``: route ``"step"`` (``wkv_kernel``, a block over all
    64 columns) or ``"chunk"`` (``wkv_chunk_kernel``, bf16 r/k/v), each
    dtype ``"float32"`` or ``"bfloat16"``."""
    m = re.search(r"wkv_chunk_kernelI(f|13__nv_bfloat16)Li(\d+)E", name)
    if m is not None:
        return ("chunk", "bfloat16",
                "float32" if m.group(1) == "f" else "bfloat16",
                int(m.group(2)))
    pair = _type_pair("wkv_kernel", name)
    return None if pair is None else ("step", *pair, 64)


def _type_pair(kernel: str, name: str):
    """(first, second) template type arguments of a mangled ``kernel<T,
    TW>`` entry name, each ``"float32"`` or ``"bfloat16"`` (a repeated type
    is a substitution, ``S<n>_``); None for another entry."""
    m = re.search(kernel + r"I(f|13__nv_bfloat16)(f|S\d*_|13__nv_bfloat16)E",
                  name)
    if m is None:
        return None
    first = "float32" if m.group(1) == "f" else "bfloat16"
    second = m.group(2)
    return (first, first if second.startswith("S") else
            "float32" if second == "f" else "bfloat16")


def load_wkv() -> ctypes.CDLL:
    """The WKV library, built and loaded once per process."""
    lib, _ = _load("wkv.cu")
    fn = lib.wkv_launch
    fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 8
                   + [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_longlong),
                                           ctypes.c_int, ctypes.c_int,
                                           ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.wkv_error_string.argtypes = [ctypes.c_int]
    lib.wkv_error_string.restype = ctypes.c_char_p
    return lib


def wkv_bwd_instance(name: str):
    """The instance of a mangled entry name of the WKV backward: (r/k/v
    dtype, w dtype) of ``wkv_bwd_kernel`` (``wkv_bwd.cu``, the step route);
    (r/k/v dtype, w dtype, pass) of the chunked route's kernels
    (``wkv_bwd_chunk.cu``): pass ``"state/<columns a block>"`` for
    ``wkv_bwd_state_kernel``, ``"chunk"`` for ``wkv_bwd_chunk_kernel``;
    each dtype ``"float32"`` or ``"bfloat16"``; None for another entry."""
    m = re.search(r"wkv_bwd_state_kernelI(f|13__nv_bfloat16)Li(\d+)E", name)
    if m is not None:
        return ("bfloat16", "float32" if m.group(1) == "f" else "bfloat16",
                f"state/{m.group(2)}")
    m = re.search(r"wkv_bwd_chunk_kernelI(f|13__nv_bfloat16)E", name)
    if m is not None:
        return ("bfloat16", "float32" if m.group(1) == "f" else "bfloat16",
                "chunk")
    return _type_pair("wkv_bwd_kernel", name)


def load_wkv_bwd() -> ctypes.CDLL:
    """The WKV backward library, built and loaded once per process."""
    lib, _ = _load("wkv_bwd.cu")
    fn = lib.wkv_bwd_launch
    fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 16
                   + [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_longlong),
                                           ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.wkv_bwd_error_string.argtypes = [ctypes.c_int]
    lib.wkv_bwd_error_string.restype = ctypes.c_char_p
    return lib


def load_wkv_bwd_chunk() -> ctypes.CDLL:
    """The chunked WKV backward library (``wkv_bwd_chunk.cu``), built and
    loaded once per process."""
    lib, _ = _load("wkv_bwd_chunk.cu")
    fn = lib.wkv_bwd_chunk_launch
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 16
                   + [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_longlong),
                                           ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.wkv_bwd_chunk_error_string.argtypes = [ctypes.c_int]
    lib.wkv_bwd_chunk_error_string.restype = ctypes.c_char_p
    return lib


def rglru_instance(name: str):
    """(dtype, channels a block) of a mangled ``rglru_kernel`` entry name:
    dtype ``"float32"`` or ``"bfloat16"``, 16 or 32 channels."""
    m = re.search(r"rglru_kernelI(f|13__nv_bfloat16)Li(\d+)E", name)
    return None if m is None else (
        "float32" if m.group(1) == "f" else "bfloat16", int(m.group(2)))


def rglru_bwd_instance(name: str):
    """(dtype of a, h and g, channels a block) of a mangled
    ``rglru_bwd_kernel`` entry name: dtype ``"float32"`` or
    ``"bfloat16"``, 16 or 32 channels."""
    m = re.search(r"rglru_bwd_kernelI(f|13__nv_bfloat16)Li(\d+)E", name)
    return None if m is None else (
        "float32" if m.group(1) == "f" else "bfloat16", int(m.group(2)))


def load_rglru() -> ctypes.CDLL:
    """The RG-LRU scan library (forward and backward), built and loaded
    once per process."""
    lib, _ = _load("rglru.cu")
    fn = lib.rglru_launch
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 3
                   + [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_longlong),
                                           ctypes.c_int, ctypes.c_int,
                                           ctypes.c_void_p])
    fn.restype = ctypes.c_int
    fn = lib.rglru_bwd_launch
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 5
                   + [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_longlong),
                                           ctypes.c_int, ctypes.c_int,
                                           ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.rglru_error_string.argtypes = [ctypes.c_int]
    lib.rglru_error_string.restype = ctypes.c_char_p
    return lib


def build_all() -> dict[str, str]:
    """Build every source at once, one nvcc each, all started together;
    returns each source's build log."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(len(SOURCE_FLAGS)) as pool:
        return dict(zip(SOURCE_FLAGS, pool.map(build_log, SOURCE_FLAGS)))


def build_log(source: str) -> str:
    """nvcc's output for ``source`` (building it first if needed)."""
    return _load(source)[1]


def cuda_error_string(lib, err: int, kernel: str = "tick_loop") -> str:
    """The text of a CUDA error code, from ``<kernel>_error_string``."""
    fn = getattr(lib, f"{kernel}_error_string")
    return f"CUDA error {err}: {fn(err).decode()}"
