"""A short first call on the card after a change to the attention kernels
(``src/repro_torch/kernels/csrc/*_sm90.cu``, ``sm90.cuh``,
``flash_attention*.cu``), the RG-LRU kernels (``rglru.cu``), the WKV
kernels (``wkv.cu``) or the tick loop's grouped launch (``tick_loop.cu``):

    python3 tests/sm90/probe.py [step ...]

runs every step below, or only the named ones (build, probe, fwd, bwd,
f32, rglru, wkv, timing, tick, cells, tp_fault; ``cells`` and
``tp_fault`` are not among the default steps).

1. build — nvcc builds every source; ptxas registers, spills and stack per
   kernel, any warning, and the HGMMA count of each bf16 attention library
   and of wkv.cu.
2. probe — ``probe.cu``: TMA-loaded swizzled tiles into wgmma (both
   operands in shared memory; A in registers with an MN-major B) against
   ``torch.matmul``.
3. fwd / bwd — the kernels against their plain versions on 17 small cases
   (ragged T, Tq != Tk, windows, GQA 16/8, 14/2, 10/1 at hd 256, a
   key/value view of a longer cache holding NaN past Tk); the backward run
   twice for bit equality, at hd 256 on both routes (bf16 and float32).
4. rglru — the forward and backward RG-LRU kernels against their plain
   versions, bit for bit, each on both of its paths (the TMA ring, the
   direct path) and both block widths, timed at the model's shapes.
4b. wkv — kernel 4 on both routes (the chunked kernel at 32 and 64
   columns a block, the step kernel) against its plain version at
   chip_smoke.py phase 13's tolerances (chunk-boundary T, extreme decays),
   then every route timed at rwkv6-7b's heads (B 8 and 1 x T 2,048,
   decode) by CUDA events and by device time.  ``wkv_profile`` (not a
   default step): the chunked kernel built with -DWKV_PROFILE, the median
   cycles of each phase of a chunk by warp.  ``wkv_bwd_profile`` (not a
   default step): the WKV backward's chunk pass built with
   -DWKV_BWD_PROFILE, the same for its chunks, and each kernel's SASS
   instruction count.
5. timing — one median of 5 (CUDA events) of the forward at qwen3-0.6b's
   and recurrentgemma-2b's heads and of the backward at both, each beside
   ``scaled_dot_product_attention``.
5b. f32 — the float32 (FMA) kernels alone: their build (registers,
   spills), 10 cases against the plain versions (the backward twice, bit
   for bit), then each timed at qwen3's, qwen2's and recurrentgemma's heads
   (B 1 x T 2,048; the backward also at B 2 x T 4,096, window 2,048) beside
   its bound, its plain version and SDPA in float32.  With ``PROBE_SRC`` it
   times another tree's kernels: run it for the parent and this tree,
   alternating, in one call.  ``f32_shares`` (not a default step): each
   kernel's device time with its shares forced to 1 and 2 in turn.

6. tick — the tick-loop launch of a sweep (its groups in one launch)
   against each group's own launch on the Figure 2, fig_dvfs and
   GreenDataFlow grids, bit for bit, both timed.
7. cells — kernel 1's time on the tune, dvfs-tune and learned-tune cells
   and the 20 RUN_GOLDEN cells, each in its own launch.  The package comes
   from ``PROBE_SRC`` (default: this tree's ``src``), so two trees are
   compared in one call: unpack the other (``git archive``) into the
   ignored ``build/`` and run ``PROBE_SRC=build/<tree>/src python3
   tests/sm90/probe.py cells`` and this tree's, alternating.
8. tp_fault (not a default step) — chip_smoke.py phase 24(e)'s olmo-1b
   steps at tp 2 (two gloo ranks on the one card) against tp 1's, run
   clean, then with a fault planted in the ranks' processes only: "1"
   the model axis's gradient all-reduce taken away (``copy_to_model``'s
   backward passes the rank's partial gradient on), "2" one doubled
   (``reduce_from_model``'s backward sums the replicated gradient over
   the axis once more: 2 g at tp 2): each run's loss and grad-norm
   distance from tp 1, the readings between which 24(e)'s grad-norm
   tolerance sits.

Each step prints its result and goes on when one fails (the exit code
is then 1); ``chip_smoke.py``
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
sys.path.insert(0, os.environ.get("PROBE_SRC", os.path.join(ROOT, "src")))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    attention_bwd_ref, attention_ref, flash_attention_bhtd,
    flash_attention_bwd_bhtd)

DEV = torch.device("cuda")


FAILED = []


def step(name, fn):
    t0 = time.time()
    try:
        fn()
        print(f"== {name} ok ({time.time() - t0:.1f} s)", flush=True)
    except Exception:
        print(f"== {name} FAILED", flush=True)
        FAILED.append(name)
        traceback.print_exc()
        sys.stdout.flush()


def builds():
    logs = build.build_all()
    for src, log in logs.items():
        print(src, "nvcc", build.nvcc_seconds(log), "s", flush=True)
        for name, line in build.ptxas_report(log).items():
            if src != "tick_loop.cu" or "grouped" in name:
                print(src, name[-60:], line, flush=True)
        print("\n".join(x for x in log.splitlines() if "arning" in x))
        if "sm90" in src or src == "wkv.cu":
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
    import importlib

    from repro_torch.kernels.rglru import (rglru_bwd_ref, rglru_ref,
                                           rglru_scan, rglru_scan_bwd)

    sys.path.insert(0, ROOT)
    import chip_smoke as cs

    mod = importlib.import_module("repro_torch.kernels.rglru.rglru")
    g = torch.Generator().manual_seed(5)
    bad = []
    plan = mod.kernel_plan
    for B, T, C, dt in [(1, 1, 2560, torch.float32),
                        (8, 1, 2560, torch.bfloat16),
                        (1, 200, 2560, torch.float32),
                        (2, 4096, 2560, torch.float32),
                        (8, 2048, 2560, torch.float32),
                        (1, 2048, 2560, torch.float32),
                        (2, 300, 100, torch.bfloat16),
                        (2, 2048, 2560, torch.bfloat16)]:
        a = (torch.rand(B, T, C, generator=g) * 0.1 + 0.9).to(DEV, dt)
        b = torch.randn(B, T, C, generator=g).to(DEV, dt)
        want = rglru_ref(a, b)
        for force in (None, "direct", 16, 32):
            orig = mod.kernel_plan
            if force is not None:
                w0, t0 = orig(a, b, torch.empty_like(a), 132)
                mod.kernel_plan = (
                    (lambda *x: (w0, False)) if force == "direct"
                    else (lambda *x, f=force: (f, t0)))
            try:
                h = rglru_scan(a, b)
                torch.cuda.synchronize()
                ms = median_ms(lambda: rglru_scan(a, b))
                dev_ms = cs.kernel_device_ms(lambda: rglru_scan(a, b))
            finally:
                mod.kernel_plan = orig
            nbytes = 3 * a.numel() * a.element_size()
            bad += [] if torch.equal(h, want) else [(B, T, C, dt, force)]
            print("rglru fwd", (B, T, C, dt), "plan",
                  plan(a, b, torch.empty_like(a), 132),
                  "forced", force, "bit-equal", torch.equal(h, want),
                  f"{ms:.4f} ms (events), {dev_ms} ms (device, 20 calls "
                  f"queued), bound "
                  f"{nbytes / 3.35e12 * 1e3:.4f} ms", flush=True)
    # a strided a: a channel slice of a wider tensor
    a = (torch.rand(2, 300, 2568, generator=g) * 0.1 + 0.9).to(DEV)[..., :2560]
    b = torch.randn(2, 300, 2560, generator=g).to(DEV)
    print("rglru fwd strided a, plan", plan(a, b, torch.empty_like(a), 132),
          "bit-equal",
          torch.equal(rglru_scan(a, b), rglru_ref(a, b)), flush=True)
    # the backward on both paths (the TMA ring, the direct path) and both
    # widths, bit for bit; T at a float32 tile (64 steps at 32 channels)
    # +- 1; timed at the trainer's shape
    g = torch.Generator().manual_seed(4)
    bwd_plan = mod.bwd_plan
    for B, T, C, dt in [(1, 1, 2560, torch.float32),
                        (2, 63, 2560, torch.float32),
                        (2, 65, 2560, torch.float32),
                        (2, 200, 2560, torch.float32),
                        (2, 4096, 2560, torch.float32),
                        (1, 37, 300, torch.bfloat16),
                        (2, 700, 2560, torch.bfloat16)]:
        a = (torch.rand(B, T, C, generator=g) * 0.1 + 0.9).to(DEV, dt)
        b, gr = [torch.randn(B, T, C, generator=g).to(DEV, dt)
                 for _ in range(2)]
        h = rglru_scan(a, b)
        rda, rdb = rglru_bwd_ref(a, h, gr)
        own = bwd_plan(a, h, gr, rda, rdb, 132)
        for force in (None, "direct", 16, 32):
            if force is not None:
                mod.bwd_plan = (
                    (lambda *x: (own[0], False)) if force == "direct"
                    else (lambda *x, f=force: (f, own[1])))
            try:
                da, db = rglru_scan_bwd(a, h, gr)
                torch.cuda.synchronize()
                ok = torch.equal(da, rda) and torch.equal(db, rdb)
                ms = median_ms(lambda: rglru_scan_bwd(a, h, gr))
                dev_ms = cs.kernel_device_ms(lambda: rglru_scan_bwd(a, h,
                                                                    gr))
            finally:
                mod.bwd_plan = bwd_plan
            nbytes = 3 * a.numel() * a.element_size() + 2 * 4 * a.numel()
            bad += [] if ok else [("bwd", B, T, C, dt, force)]
            print("rglru bwd", (B, T, C, dt), "plan", own, "forced", force,
                  "bit-equal", ok, "max |err|",
                  float((da - rda).abs().max()),
                  float((db - rdb).abs().max()),
                  f"{ms:.4f} ms (events), {dev_ms} ms (device, 20 calls "
                  f"queued), bound {nbytes / 3.35e12 * 1e3:.4f} ms",
                  flush=True)
        bad += [] if torch.equal(h, rglru_ref(a, b)) else [(B, T, C, dt)]
    assert not bad, f"not bit-equal: {bad}"


def wkv():
    """Kernel 4 on both routes against its plain version at phase 13's
    tolerances (chunk-boundary Ts, extreme decays, S0, w in float32 and
    bf16, every column width of the chunked route), then each route timed
    at rwkv6-7b's heads: B 8 and B 1 x T 2,048 and decode."""
    import importlib

    from repro_torch.kernels.rwkv6 import wkv_bhtd, wkv_ref

    sys.path.insert(0, ROOT)
    import chip_smoke as cs

    mod = importlib.import_module("repro_torch.kernels.rwkv6.rwkv6")
    plan = mod.wkv_plan
    g = torch.Generator().manual_seed(6)

    def inputs(B, T, H, with_s0, x_range=None, wdt=torch.float32):
        r, k, v = [(torch.randn(B, T, H, 64, generator=g) * 0.5).to(
            DEV, torch.bfloat16).transpose(1, 2) for _ in range(3)]
        x = (-6.0 + 2.0 * torch.randn(B, T, H, 64, generator=g)
             if x_range is None else x_range[0] + (x_range[1] - x_range[0])
             * torch.rand(B, T, H, 64, generator=g))
        w = torch.exp(-torch.exp(x)).to(DEV, wdt).transpose(1, 2)
        u = (torch.randn(H, 64, generator=g) * 0.5).to(DEV)
        S0 = ((torch.randn(B, H, 64, 64, generator=g) * 0.2).to(DEV)
              if with_s0 else None)
        return r, k, v, w, u, S0

    def run(args, force):
        if force is not None:
            mod.wkv_plan = lambda *x: force
        try:
            return wkv_bhtd(*args)
        finally:
            mod.wkv_plan = plan

    bad = []
    for B, T, H, with_s0, x_range, wdt in [
            (1, 64, 1, False, None, torch.float32),
            (2, 1, 4, True, None, torch.float32),
            (2, 63, 4, True, None, torch.float32),
            (2, 65, 4, False, None, torch.float32),
            (1, 200, 3, True, (-8.0, 3.0), torch.float32),
            (1, 300, 2, True, (-8.0, -8.0), torch.float32),
            (1, 300, 2, True, (3.0, 3.0), torch.float32),
            (2, 130, 3, True, None, torch.bfloat16),
            (1, 2048, 64, True, None, torch.float32),
            (8, 2048, 64, False, (-8.0, 3.0), torch.float32)]:
        args = inputs(B, T, H, with_s0, x_range, wdt)
        yr, Sr = wkv_ref(*args)
        for force in (("step", 64), ("chunk", 64), ("chunk", 32)):
            y, S = run(args, force)
            torch.cuda.synchronize()
            ey = float((y.float() - yr.float()).abs().max()) / max(
                1.0, float(yr.float().abs().max()))
            eS = float((S - Sr).abs().max()) / max(1.0, float(Sr.abs().max()))
            ok = ey <= 1e-2 and eS <= 1e-4 and bool(torch.isfinite(y).all())
            bad += [] if ok else [(B, T, H, with_s0, x_range, wdt, force)]
            print("wkv", (B, T, H, with_s0, x_range, str(wdt)), force,
                  f"y err {ey:.3g} S err {eS:.3g}", "ok" if ok else "BAD",
                  flush=True)
    for B, T in ((8, 2048), (1, 2048), (8, 1)):
        args = inputs(B, T, 64, T == 1)
        own = plan(args[0], args[1], args[2], args[3],
                   torch.empty_like(args[0]), 132)
        for force in (None, ("step", 64), ("chunk", 64), ("chunk", 32)):
            ms = median_ms(lambda: run(args, force))
            dev_ms = cs.kernel_device_ms(lambda: run(args, force))
            route = force or own
            bound = cs.wkv_bound(B, 64, T, 64, 2, T == 1, route[0])
            print("time wkv", (B, T), "plan" if force is None else "forced",
                  route, f"{ms:.4f} ms (events), {dev_ms} ms (device, 20 "
                  f"calls queued), bound {bound[0]:.4f} ms by {bound[1]}, "
                  f"recurrent form at 67 TFLOP/s {bound[4]:.4f} ms",
                  flush=True)
    assert not bad, f"out of tolerance: {bad}"


def wkv_profile():
    """Where a chunk's time goes: wkv.cu built with -DWKV_PROFILE, whose
    chunked kernel records clock64() at 8 phase boundaries of its chunk 8
    (lane 0 of each warp, every block); the median over blocks of each
    phase's cycles, by warp, at B 1 and B 8 x T 2,048."""
    import importlib

    from repro_torch.kernels.rwkv6 import wkv_bhtd

    mod = importlib.import_module("repro_torch.kernels.rwkv6.rwkv6")
    lib_path = os.path.join(build.BUILD_DIR, "wkv_profile.so")
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    p = subprocess.run([build.nvcc_path(), *build.SOURCE_FLAGS["wkv.cu"],
                        "-DWKV_PROFILE", "-o", lib_path,
                        os.path.join(build.CSRC, "wkv.cu")],
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stdout + p.stderr
    lib = ctypes.CDLL(lib_path)
    fn = lib.wkv_launch
    fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 8
                   + [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_longlong),
                                           ctypes.c_int, ctypes.c_int,
                                           ctypes.c_void_p])
    lib.wkv_error_string.restype = ctypes.c_char_p
    lib.wkv_profile_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    names = ["pass (walks, bonus, V^T)", "sync",
             "A blocks + diagonal", "S^T tiles + syncs", "A to registers",
             "y and S products + sync", "epilogue"]
    g = torch.Generator().manual_seed(7)
    orig_load, orig_plan = build.load_wkv, mod.wkv_plan
    build.load_wkv = lambda: lib
    try:
        for B, nj in ((1, 64), (1, 32), (8, 64), (8, 32)):
            T, H = 2048, 64
            r, k, v = [(torch.randn(B, T, H, 64, generator=g) * 0.5).to(
                DEV, torch.bfloat16).transpose(1, 2) for _ in range(3)]
            w = torch.exp(-torch.exp(-6 + 2 * torch.randn(
                B, T, H, 64, generator=g))).to(DEV).transpose(1, 2)
            u = (torch.randn(H, 64, generator=g) * 0.5).to(DEV)
            mod.wkv_plan = lambda *x: ("chunk", nj)
            wkv_bhtd(r, k, v, w, u)
            torch.cuda.synchronize()
            blocks = B * H * (64 // nj)
            buf = torch.zeros(blocks * 4 * 8, dtype=torch.int64)
            err = lib.wkv_profile_read(buf.data_ptr(), buf.numel())
            assert err == 0, err
            marks = buf.view(blocks, 4, 8).double()
            d = marks[:, :, 1:] - marks[:, :, :-1]
            med = d.median(dim=0).values          # [warp, phase]
            total = (marks[:, :, 7] - marks[:, :, 0]).median(dim=0).values
            print(f"wkv profile B={B} T={T} nj={nj}: a chunk "
                  f"{[round(x) for x in total.tolist()]} cycles by warp "
                  f"(median over {blocks} blocks)", flush=True)
            for i, name in enumerate(names):
                print(f"  {name:28s}",
                      " ".join(f"{x:8.0f}" for x in med[:, i].tolist()),
                      flush=True)
    finally:
        build.load_wkv, mod.wkv_plan = orig_load, orig_plan


def wkv_bwd_profile():
    """Where a chunk of the WKV backward's chunk pass spends its time:
    wkv_bwd_chunk.cu built with -DWKV_BWD_PROFILE, whose chunk pass records
    clock64() at 21 points of its blocks over chunk 8 (lane 0 of
    each warp); the median over (b, h) of each phase's cycles, by warp, at
    B 2 x T 4,096 x H 64 (the trainer's call) and at H 1 (64 blocks: one an
    SM, nothing beside it), and the SASS instructions of each kernel."""
    import importlib

    from repro_torch.kernels.rwkv6 import wkv_bwd_bhtd

    mod = importlib.import_module("repro_torch.kernels.rwkv6.rwkv6")
    lib_path = os.path.join(build.BUILD_DIR, "wkv_bwd_profile.so")
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    p = subprocess.run([build.nvcc_path(),
                        *build.SOURCE_FLAGS["wkv_bwd_chunk.cu"],
                        "-DWKV_BWD_PROFILE", "-o", lib_path,
                        os.path.join(build.CSRC, "wkv_bwd_chunk.cu")],
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stdout + p.stderr
    tool = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    if os.path.isfile(tool):
        sass = subprocess.run([tool, "--dump-sass", lib_path],
                              capture_output=True, text=True,
                              timeout=300).stdout
        counts, cur = {}, None
        for line in sass.splitlines():
            if "Function :" in line:
                cur = line.split("Function :")[1].strip()[:70]
                counts[cur] = 0
            elif cur and line.strip().startswith("/*") and "*/" in line[
                    line.index("/*") + 2:]:
                counts[cur] += 1
        for name, count in counts.items():
            print(f"wkv_bwd SASS {name}: ~{count} instructions", flush=True)
    lib = ctypes.CDLL(lib_path)
    fn = lib.wkv_bwd_chunk_launch
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 16
                   + [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_longlong),
                                           ctypes.c_int, ctypes.c_void_p])
    lib.wkv_bwd_chunk_error_string.restype = ctypes.c_char_p
    lib.wkv_bwd_profile_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    names = ["inputs issued (cp.async)", "u",
             "inputs landed + sync", "walks, bonus", "GP + sync",
             "A: first frags", "A: first diag", "A: first wait",
             "A: the rest", "sync, A's array", "sync", "dv", "K side",
             "S_c landed, rowsum, K stored", "X side",
             "X store, r/k again, syncs",
             "dr, dk, dw: loads, C_d", "dr, dk, dw: forward walk",
             "dr, dk, dw: backward walk", "dr, dk, dw: second sub-chunk"]
    g = torch.Generator().manual_seed(7)
    orig = build.load_wkv_bwd_chunk
    build.load_wkv_bwd_chunk = lambda: lib
    try:
        for B, T, H in ((2, 4096, 64), (1, 4096, 1)):
            r, k, v, dy = [(torch.randn(B, T, H, 64, generator=g) * 0.5).to(
                DEV, torch.bfloat16).transpose(1, 2) for _ in range(4)]
            w = torch.exp(-torch.exp(-6 + 2 * torch.randn(
                B, T, H, 64, generator=g))).to(DEV).transpose(1, 2)
            u = (torch.randn(H, 64, generator=g) * 0.5).to(DEV)
            before = wkv_bwd_bhtd.route_launches["chunk"]
            wkv_bwd_bhtd(r, k, v, w, u, None, dy)
            torch.cuda.synchronize()
            assert wkv_bwd_bhtd.route_launches["chunk"] == before + 1
            blocks = B * H
            buf = torch.zeros(blocks * 4 * 21, dtype=torch.int64)
            assert lib.wkv_bwd_profile_read(buf.data_ptr(), buf.numel()) == 0
            marks = buf.view(blocks, 4, 21).double()
            d = marks[:, :, 1:] - marks[:, :, :-1]
            med = d.median(dim=0).values          # [warp, phase]
            total = (marks[:, :, 20] - marks[:, :, 0]).median(dim=0).values
            print(f"wkv_bwd profile B={B} T={T} H={H}: a chunk "
                  f"{[round(x) for x in total.tolist()]} cycles by warp "
                  f"(median over {blocks} blocks of chunk 8; "
                  f"{B * H * T // 64} blocks in all)", flush=True)
            for i, name in enumerate(names):
                print(f"  {name:28s}",
                      " ".join(f"{x:8.0f}" for x in med[:, i].tolist()),
                      flush=True)
    finally:
        build.load_wkv_bwd_chunk = orig


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


# The float32 route's timed shapes (chip_smoke.py phases 7, 10 and 19a):
# (name, B, T, H, Hkv, hd, window), all causal.
F32_TIMED = [("qwen3", 1, 2048, 16, 8, 128, 0),
             ("qwen2", 1, 2048, 14, 2, 64, 0),
             ("recurrentgemma", 1, 2048, 10, 1, 256, 2048),
             ("recurrentgemma", 2, 4096, 10, 1, 256, 2048)]


def f32():
    """The float32 (FMA) kernels: their two sources built (ptxas's
    registers, spills and stack per entry), both held to the plain versions
    (float32: 2e-5 forward, 5e-5 + 5e-5 |ref| backward, chip_smoke.py's
    tolerances), the backward run twice for bit equality, then each timed
    at F32_TIMED beside its bound (cost.flash_fwd / flash_bwd at 67 TFLOP/s
    and 3.35 TB/s), its plain version and scaled_dot_product_attention in
    float32 (the window as a mask where it cuts).  With ``PROBE_SRC`` it
    measures another tree's kernels the same way."""
    from repro_torch.kernels import cost

    for src in ("flash_attention.cu", "flash_attention_bwd.cu"):
        log = build.build_log(src)
        print(src, "nvcc", build.nvcc_seconds(log), "s", flush=True)
        for name, line in build.ptxas_report(log).items():
            print(src, name[-70:], line, flush=True)
        print("\n".join(x for x in log.splitlines() if "arning" in x))
    g = torch.Generator().manual_seed(4)
    worst_f = worst_b = 0.0
    for B, Tq, Tk, H, Hkv, hd, causal, window, extra in [
            (1, 128, 128, 2, 1, 128, True, 0, 0),
            (2, 200, 200, 16, 8, 128, True, 0, 0),
            (1, 70, 130, 14, 2, 64, True, 0, 0),
            (2, 384, 384, 14, 2, 64, False, 0, 0),
            (2, 1000, 1000, 10, 1, 256, True, 0, 0),
            (1, 2048, 2048, 10, 1, 256, True, 2048, 0),
            (2, 200, 200, 16, 8, 128, True, 64, 0),
            (2, 150, 150, 16, 8, 128, True, 0, 100),
            (1, 2048, 2048, 14, 2, 64, True, 0, 0),
            (2, 4096, 4096, 10, 1, 256, True, 2048, 0)]:
        q, do = [torch.randn(B, Tq, H, hd, generator=g).to(DEV)
                 .transpose(1, 2) for _ in range(2)]
        kc, vc = [torch.randn(B, Tk + extra, Hkv, hd, generator=g).to(DEV)
                  for _ in range(2)]
        kc[:, Tk:] = float("nan")
        vc[:, Tk:] = float("nan")
        k, v = kc[:, :Tk].transpose(1, 2), vc[:, :Tk].transpose(1, 2)
        kw = dict(causal=causal, window=window)
        o, lse = flash_attention_bhtd(q, k, v, return_lse=True, **kw)
        ro, rl = attention_ref(q, k, v, return_lse=True, **kw)
        ef = max(float((o - ro).abs().max()), float((lse - rl).abs().max()))
        worst_f = max(worst_f, ef)
        line = f"f32 fwd {(B, Tq, Tk, H, Hkv, hd, causal, window, extra)} " \
               f"o/lse max |err| {ef:.3g}"
        if Tq == Tk and not extra:
            got = flash_attention_bwd_bhtd(q, k, v, o, lse, do, **kw)
            again = flash_attention_bwd_bhtd(q, k, v, o, lse, do, **kw)
            want = attention_bwd_ref(q, k, v, o, lse, do, **kw)
            excess = max(float((abs(a - b) - 5e-5 * b.abs()).max())
                         for a, b in zip(got, want))
            worst_b = max(worst_b, excess)
            line += (f"; bwd max(|err| - 5e-5 |ref|) {excess:.3g}, bit-equal "
                     f"twice {all(torch.equal(a, b) for a, b in zip(got, again))}")
        torch.cuda.synchronize()
        print(line, flush=True)
        del q, do, kc, vc, k, v, o, lse, ro, rl
    print(f"f32 worst: fwd {worst_f:.3g} (tol 2e-5), bwd excess {worst_b:.3g} "
          f"(tol 5e-5)", flush=True)
    assert worst_f <= 2e-5 and worst_b <= 5e-5

    for name, B, T, H, Hkv, hd, w in F32_TIMED:
        q, k, v, do = [torch.randn(B, T, h, hd, generator=g).to(DEV)
                       .transpose(1, 2) for h in (H, Hkv, Hkv, H)]
        mask = None
        if 0 < w < T:
            pos = torch.arange(T, device=DEV)
            mask = (pos[None] <= pos[:, None]) & (pos[None] > pos[:, None] - w)

        def sdpa(xs):
            if mask is None:
                return F.scaled_dot_product_attention(
                    xs[0], xs[1], xs[2], is_causal=True, enable_gqa=True)
            return F.scaled_dot_product_attention(
                xs[0], xs[1].expand(B, H, T, hd), xs[2].expand(B, H, T, hd),
                attn_mask=mask)
        o, lse = flash_attention_bhtd(q, k, v, return_lse=True, window=w)
        reps = 5 if T <= 2048 else 3
        if T <= 2048:
            ms = median_ms(lambda: flash_attention_bhtd(q, k, v, window=w),
                           reps)
            plain = median_ms(lambda: attention_ref(q, k, v, window=w), 2)
            lib = median_ms(lambda: sdpa((q, k, v)), reps)
            fl, nb = cost.flash_fwd(B, H, Hkv, hd, T, T, True, 4, w)
            bound = max(fl / 67e12, nb / 3.35e12) * 1e3
            print(f"f32 time fwd {name} {(B, T, H, Hkv, hd, w)}: kernel "
                  f"{ms:.4f} ms, bound {bound:.4f}, share {bound / ms:.3f}, "
                  f"plain {plain:.3f}, sdpa f32 {lib:.4f}", flush=True)
        ms = median_ms(lambda: flash_attention_bwd_bhtd(q, k, v, o, lse, do,
                                                        window=w), reps)
        plain = median_ms(lambda: attention_bwd_ref(q, k, v, o, lse, do,
                                                    window=w), 2)
        xs = [x.detach().requires_grad_() for x in (q, k, v)]
        lo = sdpa(xs)
        lib = median_ms(lambda: torch.autograd.grad(lo, xs, do,
                                                    retain_graph=True), reps)
        fl, nb = cost.flash_bwd(B, H, Hkv, hd, T, T, True, 4, w)
        bound = max(fl / 67e12, nb / 3.35e12) * 1e3
        print(f"f32 time bwd {name} {(B, T, H, Hkv, hd, w)}: kernel "
              f"{ms:.4f} ms, bound {bound:.4f}, share {bound / ms:.3f}, "
              f"plain {plain:.3f}, sdpa f32 backward {lib:.4f}", flush=True)
        # ten calls queued between two events: the host's share shows as
        # the difference from the single-call time
        if T <= 2048:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(10):
                flash_attention_bwd_bhtd(q, k, v, o, lse, do, window=w)
            end.record()
            torch.cuda.synchronize()
            print(f"f32 time bwd {name} {(B, T)}: ten calls queued "
                  f"{start.elapsed_time(end) / 10:.4f} ms a call", flush=True)
        # device time by kernel (one call each under the profiler)
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            if T <= 2048:
                flash_attention_bhtd(q, k, v, window=w)
            flash_attention_bwd_bhtd(q, k, v, o, lse, do, window=w)
            torch.cuda.synchronize()
        parts = [(e.key, e.device_time_total / 1e3)
                 for e in prof.key_averages() if "flash" in e.key]
        print(f"f32 device {name} {(B, T)}: " + "; ".join(
            f"{kname[:40]} {t:.4f} ms" for kname, t in parts), flush=True)
        del q, k, v, do, o, lse, xs, lo
        torch.cuda.empty_cache()
    # the forward at B 8 (more blocks than the card's slots)
    for name, B, T, H, Hkv, hd, w in F32_TIMED[:3]:
        B = 8
        q, k, v = [torch.randn(B, T, h, hd, generator=g).to(DEV)
                   .transpose(1, 2) for h in (H, Hkv, Hkv)]
        ms = median_ms(lambda: flash_attention_bhtd(q, k, v, window=w))
        fl, nb = cost.flash_fwd(B, H, Hkv, hd, T, T, True, 4, w)
        bound = max(fl / 67e12, nb / 3.35e12) * 1e3
        print(f"f32 time fwd {name} {(B, T, H, Hkv, hd, w)}: kernel "
              f"{ms:.4f} ms, bound {bound:.4f}, share {bound / ms:.3f}",
              flush=True)
        del q, k, v


def f32_shares():
    """The float32 kernels' device time (profiler, 5 calls each) at qwen3's
    and recurrentgemma's heads, B 1 x T 2,048, with every kernel's shares
    forced to 1 and to 2 in turn (1, 2, 1, 2, three times): the measurement
    behind ``flash_attention.shares``' one-wave threshold."""
    import importlib

    from torch.profiler import ProfilerActivity, profile

    fa = importlib.import_module(
        "repro_torch.kernels.flash_attention.flash_attention")
    fb = importlib.import_module(
        "repro_torch.kernels.flash_attention.flash_attention_bwd")
    plans = (fa.f32_split, fb.f32_dq_split, fb.f32_kv_split)
    g = torch.Generator().manual_seed(5)
    try:
        for name, H, Hkv, hd, w in [("qwen3", 16, 8, 128, 0),
                                    ("recurrentgemma", 10, 1, 256, 2048)]:
            q, k, v, do = [torch.randn(1, 2048, h, hd, generator=g).to(DEV)
                           .transpose(1, 2) for h in (H, Hkv, Hkv, H)]
            o, lse = flash_attention_bhtd(q, k, v, return_lse=True, window=w)
            res = {}
            for n in (1, 2, 1, 2, 1, 2):
                fa.f32_split = fb.f32_dq_split = fb.f32_kv_split = \
                    lambda *a, n=n: n
                for _ in range(2):
                    flash_attention_bhtd(q, k, v, window=w)
                    flash_attention_bwd_bhtd(q, k, v, o, lse, do, window=w)
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    for _ in range(5):
                        flash_attention_bhtd(q, k, v, window=w)
                        flash_attention_bwd_bhtd(q, k, v, o, lse, do,
                                                 window=w)
                    torch.cuda.synchronize()
                for e in prof.key_averages():
                    for kname in ("flash_fwd_kernel", "flash_fwd_combine",
                                  "flash_bwd_dq_kernel", "flash_bwd_dkdv",
                                  "flash_bwd_sum"):
                        if kname in e.key:
                            res.setdefault((n, kname), []).append(
                                e.device_time_total / 1e3 / 5)
            for (n, kname), ts in sorted(res.items()):
                print(f"f32 shares {name} {n}: {kname} "
                      + " ".join(f"{t:.4f}" for t in ts) + " ms a call",
                      flush=True)
            del q, k, v, do, o, lse
    finally:
        fa.f32_split, fb.f32_dq_split, fb.f32_kv_split = plans


def tick():
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from repro_torch import api
    from repro_torch.core import tickstate
    from repro_torch.kernels import tick_loop as tl

    for name, cells in (("fig2", cs.fig2_scenarios()),
                        ("fig_dvfs", cs.fig_dvfs_scenarios()),
                        ("greendataflow", cs.greendataflow_scenarios())):
        scs = [sc for _, sc in cells]
        tl.tick_loop.launches = 0
        _, runs = api.run_groups(scs, device=DEV)
        torch.cuda.synchronize()
        launches = tl.tick_loop.launches
        grs = cs.groups_on_card(scs, DEV)
        own = [cs.call(tl.tick_loop, k, r) for k, r in grs]
        same = 0
        for run, (k, _), (f32, i32, m) in zip(runs, grs, own):
            lay = tickstate.TickLayout(k.n_partitions)
            got = (*lay.pack_state(run.sim, run.ts), *run.metrics)
            want = (f32, i32, *m._replace(done=m.done != 0))
            same += all(torch.equal(x, y) for x, y in zip(got, want))
        rows = cs.grouped_rows_on_card(scs, DEV)
        kernel_ms = median_ms(lambda: tl.tick_loop_grouped(rows))
        if name == "fig2":
            for k, r in grs:
                own = median_ms(lambda: cs.call(tl.tick_loop, k, r), 3)
                print(f"tick fig2 group {r[1].shape[0]}x{r[1].shape[1]} "
                      f"P{k.n_partitions} {k.ctrl_code.name}: own launch "
                      f"{own:.3f} ms", flush=True)
        sweep_ms = median_ms(lambda: api.run_groups(scs, device=DEV))
        own_ms = median_ms(lambda: [cs.call(tl.tick_loop, k, r)
                                    for k, r in grs])
        assert launches == 1 and same == len(grs), (name, launches, same)
        print(f"tick {name}: {len(grs)} groups, {launches} launch(es); "
              f"{same}/{len(grs)} groups bit-equal to their own launch; "
              f"the sweep's launch {kernel_ms:.3f} ms, own launches "
              f"{own_ms:.3f} ms; run_groups {sweep_ms:.3f} ms (host prep "
              f"included)", flush=True)


def cells():
    """Kernel 1 on the one-group cells and the RUN_GOLDEN cells, each
    batch in a launch of its own (``tick_loop.tick_loop``), with the
    ``repro_torch`` that ``PROBE_SRC`` names: run it on two trees in one
    call to compare their kernels."""
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from repro_torch import api
    from repro_torch.kernels import tick_loop as tl

    print("cells: repro_torch from", os.path.dirname(
        os.path.dirname(tl.__file__)), flush=True)
    env_d = api.make_environment("dvfs", **cs.DVFS_TUNE)
    learned_p, _ = cs.golden_learned()
    for name, scs in (("tune", cs.tune_scenarios(executor="cuda")),
                      ("dvfs-tune", cs.tune_scenarios(executor="cuda",
                                                      environment=env_d)),
                      ("learned-tune", cs.tune_scenarios(
                          executor="cuda", learned=learned_p))):
        (k, r), = cs.groups_on_card(scs, DEV)
        ms = [median_ms(lambda: cs.call(tl.tick_loop, k, r))
              for _ in range(3)]
        print(f"cells {name}: {r[1].shape[0]} lanes P{k.n_partitions}: "
              f"{' '.join(f'{t:.3f}' for t in ms)} ms (three medians of 5)",
              flush=True)
    grs = cs.groups_on_card(list(cs.golden_scenarios("cuda").values()),
                            DEV)
    ms = [median_ms(lambda: [cs.call(tl.tick_loop, k, r) for k, r in grs])
          for _ in range(3)]
    print(f"cells RUN_GOLDEN: {sum(r[1].shape[0] for _, r in grs)} cells "
          f"in {len(grs)} groups, a launch each: "
          f"{' '.join(f'{t:.3f}' for t in ms)} ms for all (three medians "
          f"of 5)", flush=True)


def tp_fault_rank(rank, store, out, fault):
    """A rank of :func:`tp_fault`: chip_smoke's ``olmo_steps`` on the
    (1, TP_RANKS) mesh of a gloo world on the one card, ``fault`` ("1",
    "2": :func:`tp_fault`'s) planted first; rank 0's readings to
    ``out``."""
    import json

    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    sys.path.insert(0, ROOT)
    import chip_smoke as C
    from repro_torch.distributed import sharding

    if fault == "1":
        sharding._CopyToModel.backward = staticmethod(
            lambda ctx, g: (g, None))
    elif fault == "2":
        sharding._ReduceFromModel.backward = staticmethod(
            lambda ctx, g: (g * C.TP_RANKS, None))
    torch.cuda.set_device(DEV.index or 0)
    dist.init_process_group("gloo", store=dist.FileStore(store, C.TP_RANKS),
                            rank=rank, world_size=C.TP_RANKS)
    try:
        mesh = DeviceMesh("cuda", torch.arange(C.TP_RANKS).reshape(
            1, C.TP_RANKS), mesh_dim_names=("data", "model"))
        res = C.olmo_steps(DEV, mesh)
        if rank == 0:
            with open(out, "w") as f:
                json.dump(res, f)
    finally:
        dist.destroy_process_group()


def tp_fault():
    import json
    import tempfile

    sys.path.insert(0, ROOT)
    import chip_smoke as C

    tp1 = C.olmo_steps(DEV)
    runs = {}
    with tempfile.TemporaryDirectory() as d:
        for fault in ("0", "1", "2"):
            out = os.path.join(d, f"run{fault}.json")
            procs = [subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--tp-fault-rank",
                 str(r), os.path.join(d, f"store{fault}"), out, fault],
                env=dict(os.environ, OMP_NUM_THREADS="1"))
                for r in range(C.TP_RANKS)]
            codes = [p.wait(timeout=900) for p in procs]
            assert codes == [0] * C.TP_RANKS, codes
            with open(out) as f:
                runs[fault] = json.load(f)
    for fault, r in runs.items():
        def rel(k):
            return max(abs(a - b) / abs(b) for a, b in zip(r[k], tp1[k]))
        print(f"tp_fault {('clean', 'missing', 'doubled')[int(fault)]}: "
              f"{C.TP_OLMO} tp {C.TP_RANKS} losses {r['losses']} vs tp 1 "
              f"{tp1['losses']} (rel {rel('losses'):.3g}); grad norms "
              f"{r['grad_norms']} vs tp 1 {tp1['grad_norms']} (rel "
              f"{rel('grad_norms'):.3g})", flush=True)


STEPS = {"build": builds, "probe": probe, "fwd": fwd, "bwd": bwd,
         "f32": f32, "f32_shares": f32_shares, "rglru": rglru, "wkv": wkv,
         "wkv_profile": wkv_profile, "wkv_bwd_profile": wkv_bwd_profile,
         "timing": timing, "tick": tick, "cells": cells,
         "tp_fault": tp_fault}

if __name__ == "__main__":
    if sys.argv[1:2] == ["--tp-fault-rank"]:
        tp_fault_rank(int(sys.argv[2]), *sys.argv[3:6])
        sys.exit(0)
    print(sys.version, torch.__version__, torch.version.cuda, flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    for name in sys.argv[1:] or [s for s in STEPS
                                 if s not in ("cells", "wkv_profile",
                                              "wkv_bwd_profile",
                                              "f32_shares", "tp_fault")]:
        step(name, STEPS[name])
    sys.exit(1 if FAILED else 0)
