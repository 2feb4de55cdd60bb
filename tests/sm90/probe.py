"""A short first call on the card after a change to the attention kernels
(``src/repro_torch/kernels/csrc/*_sm90.cu``, ``sm90.cuh``,
``flash_attention*.cu``) or the RG-LRU kernels (``rglru.cu``):

    python3 tests/sm90/probe.py

1. build — nvcc builds the four attention sources and rglru.cu; ptxas
   registers, spills and stack per kernel, any warning, and the HGMMA
   count of each bf16 library.
2. probe — ``probe.cu``: TMA-loaded swizzled tiles into wgmma (both
   operands in shared memory; A in registers with an MN-major B) against
   ``torch.matmul``.
3. fwd / bwd — the kernels against their plain versions on 17 small cases
   (ragged T, Tq != Tk, windows, GQA 16/8, 14/2, 10/1 at hd 256, a
   key/value view of a longer cache holding NaN past Tk); the backward run
   twice for bit equality, at hd 256 on both routes (bf16 and float32).
4. rglru — the forward and backward RG-LRU kernels against their plain
   versions, bit for bit.
5. timing — one median of 5 (CUDA events) of the forward at qwen3-0.6b's
   and recurrentgemma-2b's heads and of the backward at both, each beside
   ``scaled_dot_product_attention``.

Each step prints its result and goes on when one fails; ``chip_smoke.py``
is the full check.  Needs a CUDA card; imports nothing of JAX.
"""
import ctypes
import os
import statistics
import subprocess
import sys
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    attention_bwd_ref, attention_ref, flash_attention_bhtd,
    flash_attention_bwd_bhtd)

DEV = torch.device("cuda")


def step(name, fn):
    t0 = time.time()
    try:
        fn()
        print(f"== {name} ok ({time.time() - t0:.1f} s)", flush=True)
    except Exception:
        print(f"== {name} FAILED", flush=True)
        traceback.print_exc()
        sys.stdout.flush()


def builds():
    for src in ("flash_attention_sm90.cu", "flash_attention_bwd_sm90.cu",
                "flash_attention.cu", "flash_attention_bwd.cu", "rglru.cu"):
        _, log = build.build(src)
        for name, line in build.ptxas_report(log).items():
            print(src, name[-60:], line, flush=True)
        print("\n".join(x for x in log.splitlines() if "arning" in x))
        if "sm90" in src:
            print(src, "HGMMA", build.hgmma_count(src), flush=True)


def probe():
    lib_path = os.path.join(build.BUILD_DIR, "probe_sm90.so")
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    p = subprocess.run([build.nvcc_path(), *build._BASE_FLAGS,
                        f"-I{build.CSRC}", "-o", lib_path,
                        os.path.join(HERE, "probe.cu")],
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stdout + p.stderr
    lib = ctypes.CDLL(lib_path)
    lib.probe_launch.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 4
    stream = torch.cuda.current_stream().cuda_stream
    g = torch.Generator().manual_seed(0)
    a = torch.randn(64, 128, generator=g).bfloat16().to(DEV)
    b = torch.randn(64, 128, generator=g).bfloat16().to(DEV)
    out = torch.zeros(64, 64, device=DEV)
    err = lib.probe_launch(0, a.data_ptr(), b.data_ptr(), out.data_ptr(),
                           stream)
    torch.cuda.synchronize()
    print("probe_ss: launch", err, "max |err|",
          float((out - a.float() @ b.float().T).abs().max()), flush=True)
    a2 = torch.randn(64, 64, generator=g).bfloat16().to(DEV)
    out2 = torch.zeros(64, 128, device=DEV)
    err = lib.probe_launch(1, a2.data_ptr(), b.data_ptr(), out2.data_ptr(),
                           stream)
    torch.cuda.synchronize()
    print("probe_rs: launch", err, "max |err|",
          float((out2 - a2.float() @ b.float()).abs().max()), flush=True)


def fwd():
    g = torch.Generator().manual_seed(1)
    for B, Tq, Tk, H, Hkv, hd, causal, window, extra in [
            (1, 128, 128, 2, 1, 128, True, 0, 0),
            (2, 200, 200, 16, 8, 128, True, 0, 0),
            (1, 70, 130, 14, 2, 64, True, 0, 0),
            (2, 384, 384, 14, 2, 64, False, 0, 0),
            (2, 1000, 1000, 10, 1, 256, True, 0, 0),
            (1, 2048, 2048, 10, 1, 256, True, 2048, 0),
            (2, 200, 200, 16, 8, 128, True, 64, 0),
            (2, 150, 150, 16, 8, 128, True, 0, 100)]:
        q = torch.randn(B, Tq, H, hd, generator=g).bfloat16().to(DEV)
        kc, vc = [torch.randn(B, Tk + extra, Hkv, hd, generator=g)
                  .bfloat16().to(DEV) for _ in range(2)]
        kc[:, Tk:] = float("nan")
        vc[:, Tk:] = float("nan")
        args = (q.transpose(1, 2), kc[:, :Tk].transpose(1, 2),
                vc[:, :Tk].transpose(1, 2))
        kw = dict(causal=causal, window=window, return_lse=True)
        o, lse = flash_attention_bhtd(*args, **kw)
        torch.cuda.synchronize()
        ro, rl = attention_ref(*args, **kw)
        print("fwd", (B, Tq, Tk, H, Hkv, hd, causal, window, extra),
              "o", float((o.float() - ro.float()).abs().max()),
              "lse", float((lse - rl).abs().max()), flush=True)


def bwd():
    g = torch.Generator().manual_seed(2)
    for B, T, H, Hkv, hd, causal, window, dt in [
            (1, 128, 16, 8, 128, True, 0, torch.bfloat16),
            (2, 200, 16, 8, 128, True, 64, torch.bfloat16),
            (1, 256, 14, 2, 64, False, 0, torch.bfloat16),
            (2, 1000, 16, 8, 128, True, 0, torch.bfloat16),
            (1, 384, 14, 2, 64, False, 128, torch.bfloat16),
            (2, 200, 10, 1, 256, True, 64, torch.bfloat16),
            (1, 256, 10, 1, 256, False, 0, torch.bfloat16),
            (2, 4096, 10, 1, 256, True, 2048, torch.bfloat16),
            (2, 200, 10, 1, 256, True, 64, torch.float32),
            (1, 2048, 10, 1, 256, True, 0, torch.float32)]:
        q, k, v, do = [torch.randn(B, T, h, hd, generator=g).to(dt)
                       .to(DEV).transpose(1, 2) for h in (H, Hkv, Hkv, H)]
        kw = dict(causal=causal, window=window)
        o, lse = flash_attention_bhtd(q, k, v, return_lse=True, **kw)
        got = flash_attention_bwd_bhtd(q, k, v, o, lse, do, **kw)
        again = flash_attention_bwd_bhtd(q, k, v, o, lse, do, **kw)
        torch.cuda.synchronize()
        want = attention_bwd_ref(q, k, v, o, lse, do, **kw)
        errs = [float((a.float() - b.float()).abs().max())
                / float(b.float().abs().max()) for a, b in zip(got, want)]
        print("bwd", (B, T, H, Hkv, hd, causal, window, dt),
              "dq dk dv max |err| of max", errs, "bit-equal twice",
              all(torch.equal(a, b) for a, b in zip(got, again)), flush=True)


def rglru():
    from repro_torch.kernels.rglru import (rglru_bwd_ref, rglru_ref,
                                           rglru_scan, rglru_scan_bwd)

    g = torch.Generator().manual_seed(4)
    for B, T, C, dt in [(1, 1, 2560, torch.float32),
                        (2, 200, 2560, torch.float32),
                        (2, 4096, 2560, torch.float32),
                        (1, 37, 300, torch.bfloat16)]:
        a = (torch.rand(B, T, C, generator=g) * 0.1 + 0.9).to(DEV, dt)
        b, gr = [torch.randn(B, T, C, generator=g).to(DEV, dt)
                 for _ in range(2)]
        h = rglru_scan(a, b)
        da, db = rglru_scan_bwd(a, h, gr)
        torch.cuda.synchronize()
        rda, rdb = rglru_bwd_ref(a, h, gr)
        print("rglru", (B, T, C, dt), "fwd bit-equal",
              torch.equal(h, rglru_ref(a, b)), "bwd bit-equal",
              torch.equal(da, rda) and torch.equal(db, rdb), "max |err|",
              float((da - rda).abs().max()), float((db - rdb).abs().max()),
              flush=True)
        if T == 4096:
            print("time rglru bwd", (B, T, C),
                  f"{median_ms(lambda: rglru_scan_bwd(a, h, gr)):.4f} ms",
                  flush=True)


def median_ms(fn, reps=5):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def timing():
    g = torch.Generator().manual_seed(3)
    for B, T, H, Hkv, hd, w in [(1, 2048, 16, 8, 128, 0),
                                (8, 2048, 16, 8, 128, 0),
                                (1, 32768, 16, 8, 128, 0),
                                (1, 2048, 10, 1, 256, 2048),
                                (8, 2048, 10, 1, 256, 2048)]:
        q, k, v = [torch.randn(B, T, h, hd, generator=g).bfloat16().to(DEV)
                   .transpose(1, 2) for h in (H, Hkv, Hkv)]
        ms = median_ms(lambda: flash_attention_bhtd(q, k, v, window=w))
        sdpa = median_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True))
        print("time fwd", (B, T, H, Hkv, hd), f"{ms:.4f} ms, sdpa",
              f"{sdpa:.4f} ms", flush=True)
        if T == 2048:
            do = torch.randn_like(q)
            o, lse = flash_attention_bhtd(q, k, v, return_lse=True,
                                          window=w)
            ms = median_ms(lambda: flash_attention_bwd_bhtd(
                q, k, v, o, lse, do, window=w))
            print("time bwd", (B, T, H, Hkv, hd), f"{ms:.4f} ms",
                  flush=True)


if __name__ == "__main__":
    print(sys.version, torch.__version__, torch.version.cuda, flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    step("build", builds)
    step("probe", probe)
    step("fwd", fwd)
    step("bwd", bwd)
    step("rglru", rglru)
    step("timing", timing)
