"""nvcc build and ctypes binding of the port's CUDA kernels.

Each ``csrc/*.cu`` file is compiled by its own nvcc process (all started
together) into a shared library with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o _build/<stem>-<hash>.so csrc/<stem>.cu

No PyTorch header is involved, so a build takes seconds to a few minutes.
The library name carries a hash of the sources and flags, so an edited
source is rebuilt and a stale library is never loaded. Nothing is built or
loaded at import; the first launch builds.

Every C entry point takes pointers and the CUDA stream as ``void*`` and ints
as ``int``, launches on that stream, and returns ``cudaGetLastError()``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
SOURCES = ("field_kernels", "ec_kernels", "g1_kernels", "miller_loop", "final_exp",
           "ntt_kernels")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine "
                       "with the CUDA toolkit")


def library_path(stem: str) -> Path:
    h = hashlib.sha256()
    for f in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{stem}.cu"]:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{stem}-{h.hexdigest()[:16]}.so"


def build_all(verbose: bool = False) -> float:
    """Compile every source whose library is missing, in parallel.

    Returns the seconds spent. Raises with nvcc's output if a build fails.
    verbose adds -Xptxas -v and prints, for each kernel, the registers,
    stack frame and spills ptxas reports (ptxas_summary); otherwise nvcc's
    output is printed only when there is some.
    """
    t0 = time.perf_counter()
    missing = [s for s in SOURCES if not library_path(s).exists()]
    if not missing:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = []
    for stem in missing:
        out = library_path(stem)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, *(("-Xptxas", "-v") if verbose else ()),
               "-o", str(tmp), str(CSRC / f"{stem}.cu")]
        procs.append((stem, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    errors = []
    for stem, out, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode == 0 and verbose:
            for line in ptxas_summary(log):
                print(f"[nvcc {stem}] {line}", flush=True)
        elif log.strip():
            print(f"[nvcc {stem}]\n{log.rstrip()}", flush=True)
        if proc.returncode != 0:
            errors.append(f"nvcc failed on {stem}.cu (exit {proc.returncode})")
            continue
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("; ".join(errors))
    return time.perf_counter() - t0


def ptxas_summary(log: str):
    """One line per __global__ kernel from ptxas -v output: registers,
    stack frame and spills (device functions of their own, the tower
    products, have stack lines but no register line; their spills are
    summed onto the kernel compiled with them)."""
    kernels, extra, current, entry = {}, {}, None, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry = m.group(1)
            kernels[entry] = {"regs": None}
            continue
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            current = m.group(1)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill "
                      r"loads", line)
        if m and current is not None:
            vals = tuple(int(v) for v in m.groups())
            if current in kernels:
                kernels[current]["frame"] = vals
            elif entry is not None:
                e = extra.setdefault(entry, [0, 0])
                e[0] += vals[1]
                e[1] += vals[2]
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and entry is not None:
            kernels[entry]["regs"] = int(m.group(1))
    out = []
    for name, k in kernels.items():
        frame, spill, fill = k.get("frame", (0, 0, 0))
        es, el = extra.get(name, (0, 0))
        out.append(f"{_kernel_name(name)}: {k['regs']} registers, {frame} bytes "
                   f"stack frame, {spill} bytes spill stores, {fill} bytes spill loads"
                   + (f"; its device functions {es} bytes spill stores, {el} bytes spill "
                      f"loads" if es or el else ""))
    return out


def _kernel_name(mangled: str) -> str:
    """The `..._kernel` identifier inside a mangled name (its length prefix
    read as the mangling writes it), else the name as it is."""
    for i in range(len(mangled)):
        for j in range(i + 1, min(i + 4, len(mangled))):
            if not mangled[i:j].isdigit():
                break
            cand = mangled[j:j + int(mangled[i:j])]
            if cand.endswith("_kernel") and cand[:1].isalpha() and len(cand) == int(mangled[i:j]):
                args = re.findall(r"L[ib](\d+)E", mangled[j + int(mangled[i:j]):])
                return cand + (f"<{', '.join(args)}>" if args else "")
    return mangled


@functools.cache
def library(stem: str) -> ctypes.CDLL:
    build_all()
    return ctypes.CDLL(str(library_path(stem)))


class Kernel:
    """One C entry point of a kernel library, with a count of its launches.

    ``launches`` grows by one for each launch the wrapper makes, and at no
    other place; callers read and reset it to see which kernels ran.
    """

    def __init__(self, name: str, source: str, symbol: str, argtypes):
        self.name = name
        self.source = source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self._fn = None

    def __call__(self, device: torch.device, *args):
        fn = self._fn or self._bind()
        index = device.index
        if index is None or index == torch.cuda.current_device():
            rc = fn(*args, current_stream_handle(index))
        else:
            with torch.cuda.device(device):
                rc = fn(*args, current_stream_handle(index))
        if rc != 0:
            raise RuntimeError(f"{self.symbol}: CUDA error {rc} "
                               f"({cuda_error_string(rc)})")
        self.launches += 1

    def _bind(self):
        fn = getattr(library(self.source), self.symbol)
        fn.argtypes = self.argtypes + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        self._fn = fn
        return fn


def current_stream_handle(index) -> int:
    """The cudaStream_t of the current stream of device `index` (None: the
    current device), as an int, without making a torch.cuda.Stream (the
    call torch's generated kernels make)."""
    return torch._C._cuda_getCurrentRawStream(
        torch.cuda.current_device() if index is None else index)


def cuda_error_string(rc: int) -> str:
    fn = library("field_kernels").ctt_error_string
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_char_p
    return fn(rc).decode()


P = ctypes.c_void_p
I = ctypes.c_int

# Every kernel of the port, by the name chip_smoke.py and PERF.md use.
KERNELS = {
    k.name: k for k in (
        Kernel("mont_mul", "field_kernels", "ctt_mont_prod", [I, P, I, I] + [P] * 4 + [I] * 4
               + [P, I]),
        Kernel("ec_add", "ec_kernels", "ctt_ec_add", [P] + [P] * 9 + [I]),
        Kernel("ec_double_k", "ec_kernels", "ctt_ec_double_k", [P] + [P] * 6 + [I, I]),
        Kernel("ec_scalar_mul", "ec_kernels", "ctt_ec_scalar_mul", [P] + [P] * 7 + [I, I]),
        Kernel("flush_scan", "ec_kernels", "ctt_flush_scan", [P, P, P, P, P, P, I, I]),
        Kernel("merge_scan", "ec_kernels", "ctt_merge_scan", [P] + [P] * 7 + [I, I]),
        Kernel("bucket_reduce", "ec_kernels", "ctt_bucket_reduce", [P] + [P] * 9 + [I, I]),
        Kernel("scaled_doubles", "ec_kernels", "ctt_scaled_doubles", [P] + [P] * 6 + [I, I]),
        Kernel("chain_fwd", "field_kernels", "ctt_chain_fwd", [I, P, P, P, P, I, I]),
        Kernel("fermat_inv", "field_kernels", "ctt_fermat_inv", [I, P, P, P, P, I]),
        Kernel("chain_bwd_inv", "field_kernels", "ctt_chain_bwd_inv",
               [I, P, P, P, P, P, I, I]),
        Kernel("g1_decompress", "g1_kernels", "ctt_g1_decompress", [P] * 5 + [I]),
        Kernel("miller_loop", "miller_loop", "ctt_miller_loop", [P] * 6 + [I]),
        Kernel("final_exp", "final_exp", "ctt_final_exp", [P] * 3 + [I]),
        Kernel("ntt_bfly", "ntt_kernels", "ctt_ntt_bfly", [I, P, P, P, P, I, I, I, I]),
        Kernel("ntt_stages", "ntt_kernels", "ctt_ntt_stages",
               [I, P, P, P, P, P, P, I, P, I] + [I] * 6),
    )
}


def reset_launch_counts():
    for k in KERNELS.values():
        k.launches = 0


def launch_counts() -> dict:
    return {name: k.launches for name, k in KERNELS.items()}


def ptr(t: torch.Tensor):
    return ctypes.c_void_p(t.data_ptr())
