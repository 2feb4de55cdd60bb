"""Build the PyTorch/CUDA port on one NVIDIA GPU, drive its main path and
check it.

    python3 chip_smoke.py

Phases (each prints a line; any failure exits non-zero):

1. card     — ``nvidia-smi`` name and power limit, torch's device name/count.
2. build    — nvcc builds every ``src/repro_torch/kernels/csrc/*.cu`` at once
              (one nvcc each, in parallel), each source's nvcc wall time;
              ptxas registers / spills / shared memory per instantiation
              used (the grouped tick-loop kernel, kernel 5's two block
              widths among them); the count of ``HGMMA``
              (wgmma) instructions in the bf16 attention libraries
              (``cuobjdump --dump-sass``), which must not be 0.
3. goldens  — the 20 RUN_GOLDEN cells through ``repro_torch.api.run`` on the
              ``cuda`` executor, bit for bit; one launch per cell.
4. smoke    — the Figure 2 ``--smoke`` grid swept with the ``cuda`` and the
              ``reference`` executor on the card: final state rows and all
              seven traces bit-equal.
5. fig2     — the main path: all 72 Figure 2 cells through
              ``repro_torch.api.sweep``, all 6 groups in one launch of the
              grouped kernel, against ``tests/torch_goldens/fig2_full.json``;
              then the kernel (each group in its own launch, and all in one
              grouped launch, bit-equal) and its plain version on the first
              3 of the 6 groups (``FIG2_PLAIN_GROUPS``), compared bit for
              bit and timed.
6. tune     — 4,096 EEMT lanes (256 SLA points x 16 bandwidth schedules) in
              one launch: kernel vs plain on every lane, times, bound, memory.
17. environments — run right after phase 6, on the same kernel: (a) the
              four degenerate environments (dvfs with matched tables,
              lossy-wan without loss or jitter, big-little with every core
              big, logfit with a constant schedule at the nominal
              bandwidth) over the 20 RUN_GOLDEN cells through ``api.run``,
              bit-equal to the reference run and the goldens, one launch a
              cell; (b) kernel vs plain on the card for lossy-wan,
              big-little, dvfs hp race / lp capped and a fitted logfit
              schedule x ME, EEMT (with and without scaling), EETT,
              ismail-target and wget/curl on Chameleon x MIXED (900 s),
              bit for bit: ~170 s of plain loops, run by a child process
              (``python3 chip_smoke.py --env-plain``) on the same card
              beside phases 8, 11, 15 and 23c, which time nothing, and
              joined after them (inline with ``--tick-loop``); (c) the 18 ``benchmarks/fig_dvfs.py`` cells and its 24
              GreenDataFlow cells through ``api.sweep`` against
              ``tests/torch_goldens/fig_dvfs_full.json``, one launch a grid,
              the grouped launch bit-equal to the groups' own launches,
              timed; (d) phase 6's 4,096 lanes under dvfs hp race
              (n_big 4): kernel vs plain, times, bound, memory.
18. learn   — run right after phase 17: learned control at
              ``benchmarks/learn.py``'s configuration.  (a) the EEMT
              teacher's capture (Chameleon x small/mixed, 900 s) on the
              observed eager step, its metrics and final state bit-equal to
              the kernel's unobserved run, and ``bc_train`` (400 steps, seed
              0) on the card; (b) the learned kernel vs its plain version,
              bit for bit, for JAX's BC policy (``tests/torch_goldens/
              learn_full.json``) and the port's, under the reference
              environment and dvfs hp race, on (c)'s own learned group
              (Chameleon and CloudLab x small/mixed) for JAX's policy, then
              at phase 6's 4,096 lanes in one launch: times, bound (bytes, and the MLP's operations per
              controller tick at 67 TFLOP/s float32), memory; (c)
              ``evaluate(JAX's policy, smoke=False)``: 20 cells (5 groups)
              in one launch, bit-equal to the groups' own launches,
              against ``learn_full.json`` (a learned cell whose
              recorded top-two logit margin is at most 1e-5 of its largest
              |logit| is printed as a near tie, not held); (d) the port's BC
              policy within 1.10x of the teacher's energy (``vs_teacher``);
              (e) ``pg_train`` at tests/test_learn.py's acceptance
              configuration, twice: the cost falls, the params are finite
              and the two runs bit-equal; (f) the fig2 and fig_dvfs
              Experiments (the port's copies of ``benchmarks/fig2.py``'s and
              ``benchmarks/fig_dvfs.py``'s) against their goldens and the
              sweep of the same cells, one launch an Experiment; a cached
              re-run executes no cell.
7. flash    — the flash-attention kernels vs their plain version on the
              card at qwen3-0.6b's and qwen2-0.5b's head shapes (B 1/8, T
              128/384/2048, causal or not, window 0/256, bf16 (wgmma
              kernel) / f32 (FMA kernel), with/without LSE), and on
              blocks of queries at an offset (FLASH_OFFSET: qwen2's at
              T / 2 and 0, qwen3's at T / 4, both routes); times against
              bound, plain version and ``scaled_dot_product_attention``;
              T = 32,768 checked on its last 256 query rows; then
              recurrentgemma-2b's heads (MQA 10/1 of 256; B 1/8, T 200/
              2048, window 0/2048, bf16/f32), timed at B 1/8 x T 2048; the
              f32 kernel timed at B 1 x T 2048.
8. lm golden — full-width qwen3-0.6b in float32 (TF32 off) through
              ``repro_torch.serve`` against ``tests/torch_goldens/
              lm_qwen3_0_6b.json`` (JAX on the CPU): 16 greedy tokens exact,
              top-5 logits and norms to a stated tolerance.
9. serve    — full-width qwen3-0.6b in bf16: (a) ``generate`` of 8 x 2,048
              prompt tokens + 64 new ones, kernel vs plain prefill logits;
              (b) ``ContinuousBatcher`` with EEMT admission over 16 slots,
              64 requests of 128-2,048 prompt tokens: all finish, one kernel
              launch per layer per prefill.

10. flash bwd — the flash-attention backward kernels vs their plain
              version on the card (the heads of qwen3 (16/8 of 128), qwen2
              (14/2 of 64), whisper (12/12 of 64), olmo-1b (16/16 of 128)
              and qwen2-vl-2b (12/2 of 128); B 1/2; T 128/200/384/1000/
              2048; causal or not; window 0/256; and B 2 x T 4,096 causal;
              bf16 (wgmma) / f32 (FMA)), and phase 7's blocks of queries
              at an offset (the dk, dv of keys past the last query zero);
              times against bound, plain
              version and the
              backward of ``scaled_dot_product_attention``, bf16 at B 1/8
              and f32 at B 1 x T 2048.
11. train golden — full-width qwen3-0.6b in float32 (TF32 off): two
              ``make_train_step`` steps against ``tests/torch_goldens/
              train_qwen3_0_6b.json`` (JAX on the CPU): loss, ce, grad norm,
              lr, step-1 gradient norms and slices, step-2 weight slices.
12. train   — bf16 qwen3-0.6b at full width and depth through
              ``repro_torch.train.trainer.train`` with the SLA-tuned fetcher
              (B 8 x T 2048, remat, 6 steps): step time, tokens/s, peak
              memory, launches per step, the fetcher's trajectory; then one
              step at B 2 through the kernels and through the plain versions.
13. wkv     — the WKV kernels vs their plain version at rwkv6-7b's heads
              (H 64, hd 64; B 1/8; T 1/63/64/65/200/2048; r/k/v bf16 on
              both routes, the chunked and the step kernel, or f32 with w
              f32; S0 zero or not; decays of the model and at the extremes
              exp(-exp(-8)) and exp(-exp(3))): y and S_final; at B 8 and
              B 1 x T 2,048 and decode every route timed by CUDA events and
              by device time against its bound (bytes, and the route's own
              operations; the recurrent form's on the CUDA cores beside it)
              and plain.
14. rglru   — the RG-LRU kernel vs its plain version, bit for bit (C 2560;
              B 1/2/8; T 1/200/2048/4096; f32, bf16 at B 2 x T 200; a C not
              a multiple of the block width; a strided a), each timed by
              CUDA events (one call, and 20 queued behind a spin: device
              time) against its bound, beside the earlier kernel's times.
15. recurrent goldens — float32 (TF32 off) rwkv6-7b at full width and 4 of
              its 32 layers, and recurrentgemma-2b at full width and depth,
              against ``tests/torch_goldens/lm_rwkv6_7b.json`` and
              ``lm_recurrentgemma_2b.json`` (JAX on the CPU): 16 greedy
              tokens exact, top-5 logits and norms to a stated tolerance.
16. recurrent serve — both in bf16 at full width and depth: ``generate``
              of 8 x 2,048 prompt tokens + 64 new ones (recurrentgemma's
              ring of 2,048 wraps), launches per prefill and decode step,
              prefill and decode tokens/s, peak memory; the prefill's
              logits through the kernels and through the plain versions,
              each against the float32 prefill of the same weights; the
              WKV launches by route (the prefill's chunked, decode's step).
19. recurrent train — recurrentgemma-2b training: (a) the backward
              kernels at its heads (MQA 10/1 of 256; B 1/2; T 200/2,048/
              4,096; window 0/2,048; bf16 wgmma / f32 FMA) vs their plain
              version, and the forward's o and LSE they read vs theirs;
              times at B 2 x T 4,096 against bound, plain version, SDPA's
              backward with the window mask and (bf16) SDPA's flash
              backward, causal over all T, and the bf16 forward there
              beside SDPA's; (b) the RG-LRU backward kernel on both of
              its paths (the TMA ring, the direct path), and kernel 5's h
              it reads, vs their plain versions bit for bit (C 2,560; B 1/2;
              T 1/63/65/200/4,096), timed by CUDA events and device time
              on both paths; (c) two float32 train
              steps at full width cut to 3 layers, B 1 x T 2,176, against
              ``tests/torch_goldens/train_recurrentgemma_2b.json`` (JAX on
              the CPU), attention on the FMA route; (d) bf16 at full width
              and depth through ``trainer.train`` with the SLA-tuned
              fetcher (B 2 x T 4,096, remat, 4 steps): step time, tokens/s,
              peak memory, launches a step by kernel (16 kernel 2, 8 kernel
              3, 36 kernel 5, 18 RG-LRU backward), a profiled step and
              kernel 5's share of it; then one B 1 step through the kernels
              and the plain versions.
20. fleet    — run right after phase 18: the offline fleet through the
              tick kernel's wave mode (each wave's groups in one launch)
              and offline tuning.  (a) tests/test_fleet.py's _GOLDEN (16
              transfers) and tests/test_environments.py's FLEET_GOLDEN
              (under the reference environment and dvfs's matched tables)
              bit for bit, the reference / lossy-wan / big-little pool and
              the learned lane (JAX's BC policy) each equal to ``api.run``,
              and a 15-tick wave over controller strides of 2: the kernel
              against the plain wave loop on the card, bit for bit, one
              launch a wave; (b) ``benchmarks/fleet.py``'s fleet (10,000
              Poisson transfers, 8 hosts x 16 slots, wave_s 15, dt 0.5)
              against ``tests/torch_goldens/fleet_full.json`` (JAX on the
              CPU: order, hosts, starts, completion and time exact, energy
              to 1e-5): wall, transfers/s, launches, and a rerun split by
              wave (kernel by CUDA events against its bound, copies, host
              prep); its ``--smoke`` trace through the kernel against the
              same file's smoke columns; (c)
              ``examples/tune_controller.py``'s ``api.tune`` against
              ``tests/torch_goldens/tune_full.json``: best, feasible and
              evaluations equal, every row's metrics to 1e-5, launches by
              rung.
21. online   — run right after phase 20: the online fleet
              (``run_fleet_online``: every occupied slot pool of a wave in
              one launch of the tick kernel's wave mode) and the workloads.
              (a) tests/test_fleet_online.py's shared trace (24 transfers, 2
              hosts x 4 slots, wave_s 10, dt 0.5, pool_capacity 64) equal
              to ``run_fleet`` per transfer and in totals, as is a 15-tick
              wave over strides of 2; 8 transfers through one slot: the
              kernel against the plain wave loop on the card, bit for
              bit, one launch a wave; ``max_partitions`` 9 refused before
              a wave; (b) ``benchmarks/fleet.py --online --smoke``'s leg
              (10,000 diurnal transfers, 4 hosts, wave_s 20, dt 1.0,
              pool_capacity 256) against
              ``tests/torch_goldens/online_full.json`` (JAX on the CPU:
              order, hosts, starts, completion, time and counters exact,
              energy to 1e-5): wall, transfers/s, launches, a rerun split
              by wave, every 10th wave's kernel held to the plain wave on
              its occupied slots; peak device memory equal for 1,000 and
              10,000 transfers; (c) ``benchmarks/workloads.py --smoke``'s
              HTTP grid (8 cells) and fault leg (resume, scratch) through
              both drivers: offline == online per transfer and ledger,
              ``goodput_mb == offered_mb`` bit for bit, against
              ``tests/torch_goldens/workloads_full.json``.
22. rwkv6 train — run right after phase 19: rwkv6-7b training.  (a) The
              WKV backward kernel vs its plain version at rwkv6-7b's heads
              (H 64 sliced out of 128; r/k/v f32 or bf16, w f32 or bf16;
              T 1/63/64/65/200/4,096; S0 and dS_final zero and given;
              decays exp(-exp(x)), x in [-8, 3]), timed at the trainer's
              B 2 x T 4,096 against its bound and the plain version; (b)
              two float32 train steps at full width cut to 4 of 32 layers,
              B 1 x T 200, against ``tests/torch_goldens/
              train_rwkv6_7b.json`` (JAX on the CPU; the weights phase 15
              drew), both WKV kernels launched; (c) bf16 at full width and
              8 of 32 layers through ``trainer.train`` (B 2 x T 4,096,
              remat, 4 steps): finite losses, 16 WKV forward and 8
              backward launches a step, step time, peak memory, a profiled
              step's split.
24. mesh     — the multi-rank base on one card, a world of one rank over
              NCCL (``repro_torch.launch.mesh``, ``distributed/``).  (a)
              run after phase 11: ``make_host_mesh(model=1)``, a (1, 1)
              ``("data", "model")`` mesh; ``chunked_psum`` through
              ``shard_map`` equal to its input; ``compressed_grad_tree``
              over qwen3-0.6b's leaf shapes (float32, seeded) on the card
              bit-equal to the same call on the CPU; (c) phase 11's two
              float32 steps again with the state placed by
              ``shardings(mesh, param_specs(...))`` and ``grad_acc_specs =
              zero_specs(...)``: every metric and final weight bit-equal
              to phase 11's run; (b) inside phase 23, on 23a's
              qwen3-moe-30b-a3b weights: the prefill with
              ``moe_impl="a2a"`` at ample capacity (factor E / k, nothing
              dropped; B 1 x T 2,048) against the gmm prefill (the a2a
              routed as gmm's; its own differing expert sets each at a
              near tie; logits within ``SERVE_BF16_TOL``), then at the
              production factor 1.25 on 23a's 8 x 2,048 prompt: time
              beside 23a's gmm prefill, each layer's dropped share, kernel
              2 launched 48 times (all wgmma), finite logits, peak memory;
              one all-to-all against a copy of its bytes; the a2a prefill
              profiled (device time by kernel group, idle share; 23b
              profiles gmm's); (d, e) the partitioned step at tp 2, two
              ranks of a gloo world on the card, sequence-parallel
              residuals on: phase 11's float32 golden with context-
              parallel attention (every head on the rank's half of the
              positions, the float32 kernels at its query offset), then
              olmo-1b in bf16 at full width and depth beside tp 1
              (losses, grad norms, bytes, saved block inputs and peak a
              rank, kernels 2 and 3 at 8 heads); (g) in the same ranks,
              the MoE family's partitioned step (moe_impl gmm, each rank
              its experts): qwen3-moe-30b-a3b and moonshot-v1-16b-a3b in
              bf16 at full width, 2 of 48 layers, beside tp 1 routed
              alike (tp 1's
              router log replayed; each expert set a rank's own router
              picks otherwise at a near tie), held as (e), kernels 2 and
              3 at 16 and 8 heads, saved block inputs 1 / 2 of tp 1's;
              (f) qwen3-0.6b's, yi-9b's, qwen3-moe-30b-a3b's and
              qwen2-0.5b's train_4k dry runs beside the parent tree's
              values (qwen2's on its busiest model rank).
23. families — run last: the MoE, VLM and audio families at full width
              and depth in bf16, weights drawn on the card.  (a)
              ``serve.generate`` of qwen3-moe-30b-a3b (8 x 2,048 + 16,
              ``moe_impl="gmm"``), qwen2-vl-2b (8 x 2,048 + 16; the first
              1,024 slots a 32 x 32 image's ``vision_embeds`` with M-RoPE
              positions) and whisper-small (1,500 frames encoded once, 8 x
              64 + 384): kernel 2 launched once a layer in the prefill (48,
              28, 12), never in a decode step, all on the bf16 route;
              prefill and decode times, tokens/s, peak memory, eager calls
              and host syncs a decode step; (b) each prefill through the
              kernel against the plain version (the MoE's plain run routed
              as the kernel's, its own differing expert sets counted, each
              at a near tie), and the MoE's decode through moe_dense
              against moe_gmm (routed alike, the same count); the MoE's
              prefill profiled (device time by
              kernel group, idle share); (c) run beside 17b's child, after
              phase 15:
              the three float32 goldens (``tests/torch_goldens/lm_qwen3_
              moe_30b_a3b.json`` at 2 of 48 layers, ``lm_qwen2_vl_2b.json``,
              ``lm_whisper_small.json``; JAX on the CPU), teacher-forced,
              every MoE expert set held to JAX's; (d) kernel 2 at head
              width 64 (B 8 x T 64 and 2,048, 12 heads) against its bound,
              the plain version and SDPA.
25. dryrun  — the dry run (``repro_torch.launch.dryrun``): (a) its CLI in
              child processes (``python -m repro_torch.launch.dryrun``, meta
              tensors, no card) over a fake world of 256 ranks on the 16 x
              16 mesh, with probes, for qwen3-0.6b and qwen3-moe-30b-a3b
              ``train_4k``, started beside 17b's child and joined after it:
              each cell's bottleneck, three roofline terms, peak a device and
              useful FLOP share, every number finite, model_flops = 6
              N_active D; (b, after 12) qwen3-0.6b ``prefill_32k`` (B 32 x T
              32,768) at the probe's depth: the meta count, then the same
              step on the card over 24a's world of one (bf16, kernel 2 at hd
              128): FLOPs and bytes equal to the meta count exactly, the peak
              within 10% of its ``temp_bytes``, median of 3 by CUDA events
              beside the roofline time; (c, in 16) rwkv6-7b's prefill
              counted on the card and on meta, equal (kernel 4's formula);
              (d, after 12) phase 12's step under ``remat_save="dots"``
              beside ``"nothing"``, in turn: the loss bit-equal, the grad
              norm within the spread of two "nothing" runs, peak and step
              ms.
26. archs   — run last (b and d's goldens after 23c): every arch of
              ``configs.ARCHS`` on the card.  (a) ``serve.generate`` of
              the four archs the earlier phases do not serve, bf16, full
              width and depth, weights drawn on the card: qwen2-0.5b (14/2
              heads of 64, QKV bias), olmo-1b (16/16 of 128, non-parametric
              LayerNorm), yi-9b (32/4 of 128, untied head) and
              moonshot-v1-16b-a3b (64 experts top 6, 2 shared, ``moe_impl=
              "gmm"``), 8 x 2,048 + 16 each: kernel 2 once a layer in the
              prefill (24, 16, 48, 48), never in a decode step, all wgmma;
              the prefill through the kernel against the plain version
              within SERVE_BF16_TOL (moonshot's plain run routed as the
              kernel's, its own differing expert sets counted, each at a
              near tie), prefill and decode ms, tokens/s, peak memory,
              eager calls and host syncs a decode step, moonshot's prefill
              profiled; (b) their float32 goldens (``tests/torch_goldens/
              lm_{qwen2_0_5b,olmo_1b,yi_9b,moonshot_v1_16b_a3b}.json``; yi
              at 4 and moonshot at 2 of 48 layers), teacher-forced as 23c;
              (c) bf16 training at full width and depth, B 2 x T 4,096
              (``train_4k``'s sequence, one card's 2 rows of its 256),
              remat, 4 steps: qwen2-0.5b and olmo-1b through
              ``repro_torch.launch.train.main``, whisper-small (1,500
              frames) and qwen2-vl-2b (a 32 x 32 image in the first 1,024
              slots, M-RoPE) through ``trainer.train``: finite losses,
              kernel 2 twice and kernel 3 once a layer a step (48/24,
              32/16, 24/12, 56/28), all wgmma; step ms, tokens/s, peak
              memory, a profiled step's split; (d) the float32 train
              goldens of qwen2-0.5b, whisper-small and qwen2-vl-2b
              (``train_*.json``, full depth, on (b)'s and 23c's weights)
              to TRAIN_TOL, and kernel 3 at head width 64 (whisper's
              12/12 and qwen2-0.5b's 14/2 heads; held to its plain version
              in phase 10) timed at B 2 x T 4,096 against its bound, the
              plain version and SDPA's backward; (e) kernel
              2 at qwen2-0.5b's heads (hd 64, GQA 7), olmo-1b's (hd 128,
              16/16) and yi-9b's (hd 128, 32/4) as 23d.  Its time is
              printed against ARCH_BUDGET_S.

The order: 1-6, 17, 18, 20, 21, 7, then the float32 goldens 8, 11, 24
(a, c), 15, 23c and 26 (b, d's goldens) beside 17b's and 25a's children
(joined after them), then 9, 10, 12, 25 (d, b), 13, 14, 16 (25c in it),
19, 22, 23 (a, b, 24b, d) and 26 (a, c, d's kernel, e).

Phases 5, 6, 9, 12, 16, 17c, 18c, 18f, 19d, 20b, 20c, 21b, 21c, 22c, 23a,
24b, 26a and 26c drive the main paths: each kernel's launch count is set to 0 just before
and read just after; every attention launch there must take the bf16 (wgmma) route.  The
float32 (FMA) attention kernels' launches are counted over the float32 goldens' entry points
(phases 8, 11, 24c, 15, 19c, 23c, 26b and 26d).  The last two lines are the kernel summary and
``{"ok": true, "device": {...}}``.  The script imports nothing of JAX or of
the JAX package; it needs a CUDA card and the rest of the repository.

    python3 chip_smoke.py --tick-loop

runs phases 1-6 and 17 only (the tick loop's check after a change to it)
and prints neither of the last two lines;

    python3 chip_smoke.py --learn

runs phases 1-3 and 18 only, and prints neither either;

    python3 chip_smoke.py --fleet

runs phases 1-3, 20 and 21 only, and prints neither;

    python3 chip_smoke.py --recurrent-train

runs phases 1-2 and 19 only, and prints neither;

    python3 chip_smoke.py --rwkv6-train

runs phases 1-2 and 22 only, and prints neither;

    python3 chip_smoke.py --families

runs phases 1-2 and 23 only, and prints neither;

    python3 chip_smoke.py --mesh

runs phases 1-2, 11 and 24 (with 23a-b of the MoE, whose weights 24b
reads) only, and prints neither;

    python3 chip_smoke.py --dryrun

runs phases 1-2, 24a (the world of one) and 25 (with 16 of rwkv6-7b, in
which 25c runs) only, and prints neither;

    python3 chip_smoke.py --archs

runs phases 1-2, 10 (where kernel 3 is held at the trained archs' heads)
and 26 only, and prints neither.
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib
import json
import os
import re
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
T_START = time.perf_counter()
sys.path.insert(0, os.path.join(ROOT, "src"))

# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit), and the kernels'
# operations and bytes by their shapes: one source with the dry run's
# counts (repro_torch.launch.hlo_stats, repro_torch.kernels.cost).
from repro_torch.kernels import cost  # noqa: E402
from repro_torch.launch.hlo_stats import (  # noqa: E402
    BF16_TENSOR_OPS_PER_S, F32_OPS_PER_S, HBM_BYTES_PER_S)
# Float32 operations of one lane-tick of csrc/tick_loop.cu, counted from the
# source: ~22 per partition (channel split, channel rate, drain, window) and
# ~70 per lane (contention, capacity, power, accumulators, the controller
# tick amortised over its stride).
OPS_PER_PARTITION_TICK = 22
OPS_PER_LANE_TICK = 70
TRACE_BYTES_PER_TICK = 28    # 7 traces x 4 B
# ... and what an environment adds a lane-tick, by network and energy code:
# the jitter's sinf (~20) and RTT terms, the schedule lookup; the core mix;
# the core mix, V(f) interpolation over 16 slots, leakage and idle terms.
ENV_NET_OPS = (0, 26, 4)       # reference, lossy-wan, logfit
ENV_ENERGY_OPS = (0, 10, 40)   # reference, big-little, dvfs

# RUN_GOLDEN of tests/test_environments.py (api.run, total_s=240, dt=0.1):
# (completed, time_s, energy_j, avg_tput_MBps, avg_power_w).  The five cells
# marked "op-by-op" hold the JAX package's values under jax.disable_jit():
# its jitted goldens differ there in the last bits of one field (XLA fuses
# the float32 ops), and the port follows the op-by-op semantics (ROADMAP,
# queue 3; tests/test_torch_api.py checks this table against JAX).
RUN_GOLDEN = {
    ("chameleon", "eemt", "fast"): (True, 1.2000000000000002, 31.04885482788086, 833.3333333333333, 25.87404568990071),
    ("chameleon", "eemt", "one"): (True, 0.7000000000000001, 15.856439590454102, 714.2858014787946, 22.65205655779157),
    ("chameleon", "me", "fast"): (True, 4.0, 47.53553771972656, 249.99996948242188, 11.88388442993164),  # op-by-op
    ("chameleon", "me", "one"): (True, 2.7, 28.187297821044922, 185.18519648799187, 10.439739933720341),  # op-by-op
    ("chameleon", "wget/curl", "fast"): (True, 10.0, 187.87521362304688, 99.99998779296875, 18.787521362304688),
    ("chameleon", "wget/curl", "one"): (True, 8.3, 140.1924591064453, 60.24096385542168, 16.89065772366811),
    ("chameleon", "ismail-target", "fast"): (True, 5.6000000000000005, 127.40544128417969, 178.57147216796872, 22.750971657889227),
    ("chameleon", "ismail-target", "one"): (True, 4.1000000000000005, 82.59339141845703, 121.95125672875379, 20.14472961425781),
    ("chameleon", "eett", "fast"): (True, 2.0, 39.50807571411133, 500.0000305175781, 19.754037857055664),
    ("chameleon", "eett", "one"): (True, 1.4000000000000001, 25.693153381347656, 357.1429007393973, 18.352252415248323),
    ("cloudlab", "eemt", "fast"): (True, 8.4, 99.49142456054688, 119.04756091889881, 11.844217209588914),
    ("cloudlab", "eemt", "one"): (True, 4.3, 58.72537612915039, 116.27909105877544, 13.657064216081487),  # op-by-op
    ("cloudlab", "me", "fast"): (True, 11.600000000000001, 97.5721435546875, 86.20689129007273, 8.41139168574892),  # op-by-op
    ("cloudlab", "me", "one"): (True, 4.5, 40.65987014770508, 111.11109754774306, 9.035526699490017),
    ("cloudlab", "wget/curl", "fast"): (True, 22.1, 357.330322265625, 45.24885773119344, 16.168792862697963),  # op-by-op
    ("cloudlab", "wget/curl", "one"): (True, 20.1, 305.2291564941406, 24.87559759794776, 15.18553017383784),
    ("cloudlab", "ismail-target", "fast"): (True, 10.8, 200.1354217529297, 92.59255303276909, 18.53105756971571),
    ("cloudlab", "ismail-target", "one"): (True, 6.0, 108.07884979248047, 83.3333231608073, 18.013141632080078),
    ("cloudlab", "eett", "fast"): (True, 9.200000000000001, 104.67521667480469, 108.69562563688858, 11.377740942913551),
    ("cloudlab", "eett", "one"): (True, 4.2, 57.62987518310547, 119.04764084588913, 13.721398853120348),
}

# Figure 2 axes (the port's copy of benchmarks/fig2.py and
# benchmarks/common.py; tests/test_torch_api.py holds them equal).
FIG2_TOOLS = ("wget/curl", "http/2", "ismail-min-energy", "ismail-max-tput",
              "ME", "EEMT")
FIG2_SMOKE = (("chameleon",), ("small", "mixed"), ("wget/curl", "ME", "EEMT"))
# Phase 5b runs the plain version on the first FIG2_PLAIN_GROUPS of fig2's
# 6 groups (the cut that keeps the script under 950 s of its 1,200): each
# of those held to the kernel bit for bit; all 72 cells stay held to
# tests/torch_goldens/fig2_full.json, and the grouped launch to every
# group's own launch.
FIG2_PLAIN_GROUPS = 3
FIG2_TESTBEDS = ("chameleon", "cloudlab", "didclab")
FIG2_DATASETS = ("small", "medium", "large", "mixed")

# fig_dvfs axes (the port's copy of benchmarks/fig_dvfs.py and its
# GreenDataFlow grid; tests/test_torch_environments.py holds them equal).
# The sweep walls (s) when each group took a launch of its own: three runs
# of this script on the PR 18 tree (NVIDIA H100 80GB HBM3, 700 W), printed
# beside today's.
PER_GROUP_WALL_S = {"fig2": "0.379-0.663", "fig_dvfs": "0.095-0.703",
                    "greendataflow": "0.314-0.363"}
FIG_DVFS_TOOLS = ("wget/curl", "ME", "EEMT")
FIG_DVFS_FCAPS = {"uncapped": None, "2.4ghz": 2.4, "1.8ghz": 1.8}
FIG_DVFS_CORES = {"8c": 8, "4c": 4}
GDF_TESTBEDS = ("chameleon", "cloudlab")
GDF_TECHS = ("hp", "lp")
GDF_IDLES = ("race", "pace")

# Phase 17b: the environments and controllers held kernel == plain, on
# Chameleon x MIXED at fig_dvfs --smoke's 900 s.  Lossy-wan's jitter calls
# sinf in the kernel and torch.sin in the plain version: the same libdevice
# routine on the card, so it too is held bit for bit.
ENV_SMOKE_CONTROLLERS = ("ME", "EEMT", "EEMT-noscaling", "EETT",
                         "ismail-target", "wget/curl")
ENV_SMOKE_TARGET = 400.0      # MB/s, EETT and ismail-target
LOGFIT_LOG = (800.0, 1200.0, 400.0, 1000.0)   # MB/s, 60 s bins, rtt 40 ms
# Phase 17d's environment.
DVFS_TUNE = dict(tech="hp", idle="race", n_big=4)

# Phase 18: learned control, at benchmarks/learn.py's configuration: the
# EEMT teacher (max_ch 64) on Chameleon x small and mixed at 900 s, BC for
# 400 steps (batch 256, lr 3e-3, seed 0); the evaluation grid against
# tests/torch_goldens/learn_full.json, a learned cell held only where JAX's
# smallest top-two logit margin over its controller ticks exceeds
# LEARN_MARGIN of the largest |logit|; the port's own BC policy within
# LEARN_BC_RATIO of the teacher's energy (repro.learn's acceptance test);
# REINFORCE at tests/test_learn.py::test_pg_train_improves_energy_delay's
# configuration.
LEARN_MARGIN = 1e-5
LEARN_BC_RATIO = 1.10
LEARN_BC_STEPS = 400
LEARN_PG_LANES = 8
LEARN_PG = dict(steps=6, lr=2e-3, tput_floor_mbps=400.0)
# Float32 operations of one learned controller tick beyond the tuner's
# (counted from csrc/tick_loop.cu): the 9 features (~40, log1pf and log10f
# ~20 each), per layer a product and a sum per weight and a sum per bias,
# ~20 per tanhf, ~10 for the argmaxes and the action.
LEARN_FEATURE_OPS = 80
LEARN_TANH_OPS = 20
LEARN_ACTION_OPS = 10

# Phase 20: the offline fleet and offline tuning.  FLEET16_GOLDEN is
# tests/test_fleet.py's _GOLDEN (jitted JAX; name -> energy_j, time_s,
# start_s, host, completed) over its 16-transfer trace (2 hosts x 4 slots,
# wave_s 10, dt 0.5); FLEET_ONE_GOLDEN is tests/test_environments.py's
# FLEET_GOLDEN (completed, time_s, energy_j, moved_mb).  The full fleet is
# benchmarks/fleet.py's configuration (:47-77 and run(): wave_s 15, dt 0.5),
# copied here, held against tests/torch_goldens/fleet_full.json (JAX on
# the CPU): per transfer placement, start, completion and time exact and
# energy to FLEET_RTOL.  The tune search is examples/tune_controller.py's,
# copied, held against tests/torch_goldens/tune_full.json.
FLEET16_GOLDEN = {
    "xfer-00": (1814.7784423828125, 116.0, 10.0, "host-0", True),
    "xfer-01": (195.69314575195312, 10.5, 10.0, "host-1", True),
    "xfer-02": (36.4241943359375, 3.5, 10.0, "host-0", True),
    "xfer-03": (370.8283386230469, 37.0, 20.0, "host-0", True),
    "xfer-04": (47.423377990722656, 3.0, 20.0, "host-1", True),
    "xfer-05": (370.8283386230469, 37.0, 20.0, "host-0", True),
    "xfer-06": (37.65775680541992, 4.0, 20.0, "host-1", True),
    "xfer-07": (142.826171875, 8.5, 20.0, "host-0", True),
    "xfer-08": (142.826171875, 8.5, 30.0, "host-1", True),
    "xfer-09": (45.65776062011719, 5.0, 30.0, "host-1", True),
    "xfer-10": (142.826171875, 8.5, 30.0, "host-1", True),
    "xfer-11": (327.93096923828125, 34.0, 30.0, "host-0", True),
    "xfer-12": (45.65776062011719, 5.0, 30.0, "host-1", True),
    "xfer-13": (47.423377990722656, 3.0, 40.0, "host-1", True),
    "xfer-14": (47.423377990722656, 3.0, 40.0, "host-1", True),
    "xfer-15": (237.29710388183594, 16.5, 40.0, "host-1", True),
}
FLEET_ONE_GOLDEN = (True, 1.2000000000000002, 31.04885482788086, 1000.0)
FLEET_NO_CONTENTION = 1e9
FLEET_BENCH_CONTROLLERS = ("EEMT", "ME", "eett", "ismail-target",
                           "wget/curl", "http/2")
FLEET_WAVE_S, FLEET_DT = 15.0, 0.5
FLEET_RTOL = 1e-5
TUNE_EXAMPLE_RTOL = 1e-5

# Phase 21: the online fleet and the workloads.  The online leg is
# benchmarks/fleet.py's --online --smoke leg (build_online_stream and
# _run_online_leg: a diurnal stream, 4 hosts at 10x Chameleon's NIC with
# no slot limit, wave_s 20, dt 1.0, pool_capacity 256), copied here and
# held against tests/torch_goldens/online_full.json (JAX on the CPU); the
# workloads leg is benchmarks/workloads.py --smoke's HTTP grid and fault
# leg, copied, held against tests/torch_goldens/workloads_full.json.
# Placement, start, completion, time and every count exact, energy and MB
# to FLEET_RTOL.
ONLINE_CONTROLLERS = ("eemt", "me", "wget/curl")
ONLINE_WAVE_S, ONLINE_DT, ONLINE_CAPACITY, ONLINE_HOSTS = 20.0, 1.0, 256, 4
HTTP_CONTROLLERS = ("eemt", "wget/curl")
HTTP_REUSE = {"reuse": 30.0, "cold": 0.0}
HTTP_SLOS = {"tight": 6.0, "loose": 30.0}
HTTP_SERVICE = dict(request_mb=64.0, size_menu=(0.5, 1.0, 2.0),
                    conn_setup_mb=16.0, think_s=4.0, n_users=8, seed=1810)
HTTP_REQUESTS = 80


# Tune-sized sweep: 4 x 4 x 4 x 4 SLA points x 16 bandwidth schedules.
TUNE_ALPHA = (0.05, 0.1, 0.15, 0.2)
TUNE_BETA = (0.02, 0.05, 0.1, 0.15)
TUNE_DELTA_CH = (1, 2, 4, 8)
TUNE_MAX_CH = (16, 32, 64, 128)
TUNE_SEEDS = range(16)
TUNE_TOTAL_S = 1800.0
TUNE_SEGMENT_S = 60.0


def golden_scenarios(executor="auto"):
    """The 20 RUN_GOLDEN cells as port Scenarios, keyed like RUN_GOLDEN."""
    from repro_torch import api
    from repro_torch.core.types import CHAMELEON, CLOUDLAB, DatasetSpec

    profiles = {"chameleon": CHAMELEON, "cloudlab": CLOUDLAB}
    datasets = {"fast": (DatasetSpec("a", 200, 400.0, 2.0),
                         DatasetSpec("b", 10, 600.0, 60.0)),
                "one": (DatasetSpec("c", 50, 500.0, 10.0),)}
    out = {}
    for pn, cn, dn in RUN_GOLDEN:
        kw = {"target_tput_mbps": 400.0} if cn in ("eett",
                                                   "ismail-target") else {}
        out[(pn, cn, dn)] = api.Scenario(
            profile=profiles[pn], datasets=datasets[dn],
            controller=api.make_controller(cn, **kw), total_s=240.0, dt=0.1,
            executor=executor)
    return out


def budget_for(profile) -> float:
    """Per-testbed transfer budget (s): the 1 Gbps testbeds get longer."""
    return 28800.0 if profile.bandwidth_mbps < 500 else 7200.0


def _datasets():
    from repro_torch.core import types

    return {"small": (types.SMALL_FILES,), "medium": (types.MEDIUM_FILES,),
            "large": (types.LARGE_FILES,), "mixed": types.MIXED}


def tune_bw_schedules():
    """16 piecewise-constant schedules: 60 s segments at 0.3-1.0 of nominal,
    drawn with numpy from seeds 0-15."""
    import numpy as np

    n_seg = int(TUNE_TOTAL_S // TUNE_SEGMENT_S)
    per_seg = int(round(TUNE_SEGMENT_S / 0.1))
    return [np.repeat(np.random.default_rng(s).uniform(0.3, 1.0, n_seg)
                      .astype(np.float32), per_seg) for s in TUNE_SEEDS]


def tune_scenarios(executor="auto", environment=None, learned=None):
    """4,096 EEMT lanes on Chameleon x MIXED (one sweep group); with
    ``learned`` (policy params), the learned controller at the same SLA
    points (their delta_ch and max_ch scale its actions)."""
    from repro_torch import api
    from repro_torch.core import types

    schedules = tune_bw_schedules()
    out = []
    for a in TUNE_ALPHA:
        for b in TUNE_BETA:
            for d in TUNE_DELTA_CH:
                for m in TUNE_MAX_CH:
                    ctrl = (api.make_controller("EEMT", alpha=a, beta=b,
                                                delta_ch=d, max_ch=m)
                            if learned is None else
                            api.make_controller("learned", params=learned,
                                                alpha=a, beta=b, delta_ch=d,
                                                max_ch=m))
                    for s, bw in zip(TUNE_SEEDS, schedules):
                        out.append(api.Scenario(
                            profile=types.CHAMELEON, datasets=types.MIXED,
                            controller=ctrl, total_s=TUNE_TOTAL_S, dt=0.1,
                            bw_schedule=bw, executor=executor,
                            environment=environment,
                            name=f"tune/a{a}/b{b}/d{d}/m{m}/s{s}"))
    return out


def mixed_partition_scenarios():
    """A sweep of two partition counts: the tune cell's 4,096 EEMT lanes on
    LARGE alone (P 1) beside 16 ME lanes over 8 partitions (MIXED twice,
    then SMALL and MEDIUM; the tune cell's 16 bandwidth schedules).  The
    keys differ in controller as well, so neither is padded to the other's
    partition count."""
    from repro_torch import api
    from repro_torch.core import types

    wide = (*types.MIXED, *types.MIXED, types.SMALL_FILES,
            types.MEDIUM_FILES)
    return ([dataclasses.replace(sc, datasets=(types.LARGE_FILES,))
             for sc in tune_scenarios()]
            + [api.Scenario(profile=types.CHAMELEON, datasets=wide,
                            controller=api.make_controller("ME"),
                            total_s=TUNE_TOTAL_S, dt=0.1, bw_schedule=bw,
                            name=f"wide/s{s}")
               for s, bw in zip(TUNE_SEEDS, tune_bw_schedules())])


def padded_group_on_card(scenarios, key, dev, p):
    """(prow, bw, f0, i0) of the sweep group ``key`` on ``dev`` widened to
    ``p`` partitions with zero-byte ones (what padding it to a wider
    group's partition count would launch)."""
    from repro_torch.api import scenario as S
    from repro_torch.core import engine

    prepared, groups = S._prepare_groups(scenarios, dev)
    wide = [S._pad_partitions(prepared[i], p) for i in groups[key]]
    inp = S._stack_group(wide, range(len(wide)), dev)
    prow, f0, i0 = engine.pack_batch(key.env_code, inp)
    return prow, inp.bw, f0, i0


def _tool_controller(tool):
    from repro_torch import api

    return (api.make_controller(tool, max_ch=64)
            if tool in ("ME", "EEMT") else tool)


def fig2_experiment(smoke=False):
    """benchmarks/fig2.py's Experiment, built with the port's api."""
    from repro_torch import api
    from repro_torch.core import types

    testbeds, dss, tools = FIG2_SMOKE if smoke else (
        FIG2_TESTBEDS, FIG2_DATASETS, FIG2_TOOLS)
    datasets = _datasets()
    return api.Experiment(
        name="fig2",
        space=api.grid(
            api.axis("testbed", {tb: types.TESTBEDS[tb] for tb in testbeds},
                     field="profile"),
            api.axis("dataset", {ds: datasets[ds] for ds in dss},
                     field="datasets"),
            api.axis("tool", tools)),
        base={"cpu": types.CpuProfile(),
              "controller": lambda c: _tool_controller(c["tool"]),
              "total_s": 900.0 if smoke
              else (lambda c: budget_for(c["profile"]))})


def fig_dvfs_experiment():
    """benchmarks/fig_dvfs.py's ``experiment()``, built with the port's
    api."""
    import dataclasses

    from repro_torch import api
    from repro_torch.core import types

    return api.Experiment(
        name="fig_dvfs",
        space=api.grid(
            api.axis("tool", FIG_DVFS_TOOLS),
            api.axis("fcap", FIG_DVFS_FCAPS),
            api.axis("cores", FIG_DVFS_CORES)),
        base={"profile": types.CHAMELEON, "datasets": types.MIXED,
              "cpu": lambda c: dataclasses.replace(types.CpuProfile(),
                                                   num_cores=c["cores"]),
              "controller": lambda c: _tool_controller(c["tool"]),
              "environment": lambda c: api.make_environment(
                  "dvfs", n_big=4, max_freq_ghz=c["fcap"]),
              "total_s": budget_for(types.CHAMELEON)})


def greendataflow_experiment():
    """benchmarks/fig_dvfs.py's ``greendataflow()``, built with the port's
    api."""
    from repro_torch import api
    from repro_torch.core import types

    return api.Experiment(
        name="greendataflow",
        space=api.grid(
            api.axis("testbed", {tb: types.TESTBEDS[tb]
                                 for tb in GDF_TESTBEDS}, field="profile"),
            api.axis("tech", GDF_TECHS),
            api.axis("idle", GDF_IDLES),
            api.axis("tool", FIG_DVFS_TOOLS)),
        base={"cpu": types.CpuProfile(), "datasets": types.MIXED,
              "controller": lambda c: _tool_controller(c["tool"]),
              "environment": lambda c: api.make_environment(
                  "dvfs", tech=c["tech"], idle=c["idle"]),
              "total_s": lambda c: budget_for(c["profile"])})


def _labelled_scenarios(exp, executor):
    """[(labels, Scenario)] of an Experiment's cells, run by ``executor``:
    the sweep phases read the same grids as the Experiment phases."""
    import dataclasses

    return [(tuple(c.labels.values()),
             dataclasses.replace(c.scenario, executor=executor))
            for c in exp.cells()]


def fig2_scenarios(smoke=False, executor="auto"):
    """[(testbed, dataset, tool), Scenario] of the Figure 2 grid."""
    return _labelled_scenarios(fig2_experiment(smoke), executor)


def fig_dvfs_scenarios(executor="auto"):
    """[(tool, fcap, cores), Scenario] of benchmarks/fig_dvfs.py's grid:
    dvfs hp (n_big 4) under three frequency caps, 8 or 4 cores."""
    return _labelled_scenarios(fig_dvfs_experiment(), executor)


def greendataflow_scenarios(executor="auto"):
    """[(testbed, tech, idle, tool), Scenario] of fig_dvfs's GreenDataFlow
    grid: race-to-idle vs pace-to-deadline on both technologies."""
    return _labelled_scenarios(greendataflow_experiment(), executor)


def learn_teacher():
    from repro_torch import api

    return api.make_controller("EEMT", max_ch=64)


def learn_teacher_cells():
    """benchmarks/learn.py's teacher cells: EEMT on Chameleon x small and
    mixed at 900 s."""
    from repro_torch import api
    from repro_torch.core import types

    return [api.Scenario(profile=types.CHAMELEON, datasets=ds,
                         controller=learn_teacher(), total_s=900.0, dt=0.1)
            for ds in ((types.SMALL_FILES,), types.MIXED)]


def learn_pg_scenarios():
    """tests/test_learn.py::test_pg_train_improves_energy_delay's lanes."""
    from repro_torch import api
    from repro_torch.core import types

    return [api.Scenario(profile=types.CHAMELEON,
                         datasets=(types.DatasetSpec(
                             "d", 1000, 8000.0 + 1500.0 * i, 8.0),),
                         controller=api.make_controller("eemt"),
                         total_s=120.0, dt=0.1)
            for i in range(LEARN_PG_LANES)]


def golden_learned():
    """(JAX's BC params from learn_full.json, the golden)."""
    import numpy as np

    with open(os.path.join(ROOT, "tests", "torch_goldens",
                           "learn_full.json")) as f:
        gold = json.load(f)
    return {k: np.asarray(v, np.float32)
            for k, v in gold["params"].items()}, gold


def env_smoke_environments():
    """Phase 17b's environments, by name; logfit is fitted from a 4-bin
    synthetic log: one saturating 60 s transfer a bin at LOGFIT_LOG MB/s,
    each with a 40 ms RTT."""
    from repro_torch import api

    log = [dict(start_s=k * 60.0, end_s=(k + 1) * 60.0, mb=bw * 60.0,
                rtt_s=0.04) for k, bw in enumerate(LOGFIT_LOG)]
    return {
        "lossy-wan": api.make_environment("lossy-wan"),
        "big-little": api.make_environment("big-little", n_big=4),
        "dvfs hp race": api.make_environment("dvfs", **DVFS_TUNE),
        "dvfs lp 1.8ghz": api.make_environment("dvfs", tech="lp",
                                               max_freq_ghz=1.8),
        "logfit": api.make_environment("logfit", log=log),
    }


def env_smoke_scenarios(executor="auto"):
    """[(environment, controller), Scenario] of phase 17b."""
    from repro_torch import api
    from repro_torch.core import types

    ctrls = {"ME": api.make_controller("ME", max_ch=64),
             "EEMT": api.make_controller("EEMT", max_ch=64),
             "EEMT-noscaling": api.make_controller("EEMT", max_ch=64,
                                                   scaling=False),
             "EETT": api.make_controller("EETT",
                                         target_tput_mbps=ENV_SMOKE_TARGET),
             "ismail-target": api.make_controller(
                 "ismail-target", target_tput_mbps=ENV_SMOKE_TARGET),
             "wget/curl": "wget/curl"}
    return [((en, cn), api.Scenario(
        profile=types.CHAMELEON, datasets=types.MIXED, controller=ctrls[cn],
        environment=env, total_s=900.0, executor=executor,
        name=f"env/{en}/{cn}"))
        for en, env in env_smoke_environments().items()
        for cn in ENV_SMOKE_CONTROLLERS]


def degenerate_environments(profile, cpu):
    """The four environments that must reproduce the reference physics bit
    for bit on ``profile`` and ``cpu``."""
    from repro_torch import api
    from repro_torch.workloads import LogFitNetworkModel

    return {
        "dvfs matched": api.Environment(
            network=api.DvfsNetworkModel(),
            energy=api.DvfsEnergyModel.matched(cpu)),
        "lossy-wan clean": api.Environment(network=api.LossyWanNetworkModel(
            loss_rate=0.0, jitter_frac=0.0)),
        "big-little all big": api.Environment(
            energy=api.BigLittleEnergyModel(n_big=cpu.num_cores)),
        "logfit constant": api.Environment(network=LogFitNetworkModel(
            bw_mbps=(profile.bandwidth_mbps,) * 3)),
    }


# ---------------------------------------------------------------- helpers --

class Failed(Exception):
    pass


def lap(label):
    """Print the script's wall so far after ``label`` (where the 1,200 s
    go)."""
    print(f"[wall] {label} done at {time.perf_counter() - T_START:.1f} s",
          flush=True)


def check(cond, msg):
    if not cond:
        raise Failed(msg)


def groups_on_card(scenarios, dev):
    """[(key, (prow, bw, f0, i0))] for every sweep group, on ``dev``."""
    from repro_torch.api import scenario as S
    from repro_torch.core import engine

    prepared, groups = S._prepare_groups(scenarios, dev)
    out = []
    for key, idxs in groups.items():
        inp = S._stack_group(prepared, idxs, dev)
        prow, f0, i0 = engine.pack_batch(key.env_code, inp)
        out.append((key, (prow, inp.bw, f0, i0)))
    return out


def grouped_rows_on_card(scenarios, dev):
    """The arguments of ``tick_loop.tick_loop_grouped`` for a sweep's
    groups, on ``dev``, as ``api.run_groups`` hands them over."""
    return [(key.ctrl_code, key.env_code, key.cpu, *rows, key.dt,
             key.ctrl_every) for key, rows in groups_on_card(scenarios, dev)]


def grouped_vs_groups(scenarios, dev, per_group, tag):
    """Kernel 1's launch over a sweep's groups (one launch per partition
    count among them) held against ``per_group`` (each group's own (f32,
    i32, TickMetrics), in the sweep's group order) bit for bit: every final
    row and all seven traces.  Returns (the launch's arguments, max
    |err|)."""
    from repro_torch.kernels import tick_loop as tl

    rows = grouped_rows_on_card(scenarios, dev)
    n_p = len({(r[3].shape[1] - 13) // 5 for r in rows})
    before = tl.tick_loop.launches
    grouped = tl.tick_loop_grouped(rows)
    check(tl.tick_loop.launches - before == n_p,
          f"{tag}: the sweep's groups of {n_p} partition count(s) took "
          f"{tl.tick_loop.launches - before} launches")
    worst = 0.0
    for k, (out, want) in enumerate(zip(grouped, per_group)):
        equal, err = compare_outputs(out, want)
        check(equal, f"{tag}: group {k} of the grouped launch != its own "
                     f"(max |err| {err})")
        worst = max(worst, err)
    return rows, worst


def call(fn, key, rows):
    return fn(key.ctrl_code, key.env_code, key.cpu, *rows, dt=key.dt,
              ctrl_every=key.ctrl_every)


def compare_outputs(a, b):
    """Max |a - b| over final rows and traces, and whether all are equal."""
    import torch

    ta = [a[0], a[1], *a[2]]
    tb = [b[0], b[1], *b[2]]
    equal = all(torch.equal(x, y) for x, y in zip(ta, tb))
    err = max(float((x.double() - y.double()).abs().max()) if x.numel()
              else 0.0 for x, y in zip(ta, tb))
    return equal, err


def spilled(ptxas_line: str) -> int:
    """Bytes of spill stores and loads in one entry's ptxas line
    (``build.ptxas_report``)."""
    m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                  ptxas_line)
    return int(m.group(1)) + int(m.group(2)) if m else 0


def time_cuda(fn, reps):
    """Median wall time (ms) of ``fn()`` on the card over ``reps`` runs, by
    CUDA events, after one warm-up run."""
    import torch

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


def executed_lane_ticks(metrics, n_steps):
    """Ticks each lane actually ran: through its done tick, or the horizon."""
    import torch

    done = metrics.done.to(torch.int32)
    completed = done.any(dim=1)
    first = done.argmax(dim=1) + 1
    return int(torch.where(completed, first, n_steps).sum())


def executed_ctrl_ticks(metrics, n_steps, ctrl_every):
    """Controller ticks the lanes actually ran (one each ``ctrl_every``
    executed ticks)."""
    import torch

    done = metrics.done.to(torch.int32)
    ticks = torch.where(done.any(dim=1), done.argmax(dim=1) + 1, n_steps)
    return int((ticks // ctrl_every).sum())


def learned_ops(controller):
    """(float32 operations of one learned controller tick, floats of its
    weight table)."""
    from repro_torch.kernels import tick_loop as tl

    w = tl.policy_widths(controller)
    weights = sum(a * b + b for a, b in zip(w[:-1], w[1:]))
    mlp = sum(2 * a * b for a, b in zip(w[:-1], w[1:]))
    return (mlp + LEARN_TANH_OPS * sum(w[1:-1]) + LEARN_FEATURE_OPS
            + LEARN_ACTION_OPS, weights)


def bound_of(groups_rows, lane_ticks, ctrl_ticks=None):
    """(bound_ms, bound_by, bytes, ops) for a set of tick_loop calls: every
    trace written once, the parameter/state rows read and written once, the
    bandwidth share of every executed lane-tick read once and a learned
    policy's weight table read once; operations per executed lane-tick over
    the float32 peak, plus, for a learned controller, its MLP's operations
    per executed controller tick (``ctrl_ticks``, one count per group)."""
    from repro_torch.kernels import tick_loop as tl

    nbytes = 0
    ops = 0
    ctrl_ticks = ctrl_ticks or [0] * len(lane_ticks)
    for (key, (prow, bw, f0, i0)), ticks, cticks in zip(
            groups_rows, lane_ticks, ctrl_ticks):
        b, n = bw.shape
        kind, _, spec = tl.kernel_spec(key.ctrl_code, key.env_code)
        nbytes += TRACE_BYTES_PER_TICK * n * b
        nbytes += 4 * (prow.numel() + 2 * f0.numel() + 2 * i0.numel())
        nbytes += 4 * ticks + 4 * len(spec.schedule)
        ops += ticks * (OPS_PER_LANE_TICK
                        + OPS_PER_PARTITION_TICK * key.n_partitions
                        + ENV_NET_OPS[spec.network]
                        + ENV_ENERGY_OPS[spec.energy])
        if kind == tl.KIND_LEARNED:
            tick_ops, table = learned_ops(key.ctrl_code)
            nbytes += 4 * table
            ops += cticks * tick_ops
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations", nbytes, ops)


def partition_counts_of(scenarios, dev):
    """The partition counts (kernel instances) a sweep would launch."""
    from repro_torch.api import scenario as S

    _, groups = S._prepare_groups(scenarios, dev)
    return {key.n_partitions for key in groups}


def degeneration_scenarios(executor="auto"):
    """[((cell, environment), Scenario)]: every RUN_GOLDEN cell under each
    of the four degenerate environments."""
    import dataclasses

    out = []
    for cell, sc in golden_scenarios(executor).items():
        for en, env in degenerate_environments(sc.profile, sc.cpu).items():
            out.append(((cell, en), dataclasses.replace(sc, environment=env)))
    return out


def fig_dvfs_headline(cells, results) -> dict:
    """Per tool at 8 cores: the energy-optimal frequency cap, its savings
    over the uncapped ladder and its throughput cost
    (benchmarks/fig_dvfs.py::headline)."""
    out = {}
    for tool in FIG_DVFS_TOOLS:
        rows = {fcap: r for ((t, fcap, cores), _), r in zip(cells, results)
                if t == tool and cores == "8c"}
        best = min(rows, key=lambda k: rows[k].energy_j)
        out[tool] = {
            "best_fcap": best,
            "energy_savings_pct":
                100.0 * (1 - rows[best].energy_j / rows["uncapped"].energy_j),
            "tput_cost_pct":
                100.0 * (1 - rows[best].avg_tput_gbps
                         / rows["uncapped"].avg_tput_gbps),
        }
    return out


def phase_environments(dev, ref_runs) -> dict:
    """Phase 17: the environment families through the tick kernel (see the
    module docstring).  ``ref_runs`` are phase 3's reference-environment
    results of the RUN_GOLDEN cells."""
    import numpy as np
    import torch

    from repro_torch import api
    from repro_torch.kernels import tick_loop as tl

    t_phase = time.perf_counter()

    # (a) degenerations: bit-equal to the reference environment's runs
    before = tl.tick_loop.launches
    bad = []
    cases = degeneration_scenarios(executor="cuda")
    for (cell, en), sc in cases:
        r = api.run(sc, device=dev)
        got = (r.completed, r.time_s, r.energy_j, r.avg_tput_MBps,
               r.avg_power_w)
        same = all(np.array_equal(x, y)
                   for x, y in zip(r.metrics, ref_runs[cell].metrics))
        if got != RUN_GOLDEN[cell] or not same:
            bad.append((cell, en, got))
    launched = tl.tick_loop.launches - before
    check(not bad, f"17a degenerations differ from the reference: {bad}")
    check(launched == len(cases),
          f"17a: {launched} launches for {len(cases)} runs")
    n_env = len(cases) // len(RUN_GOLDEN)
    print(f"[17 envs] (a) {n_env} degenerate environments (dvfs matched, "
          f"lossy-wan clean, big-little all big, logfit constant) x "
          f"{len(RUN_GOLDEN)} RUN_GOLDEN cells on the cuda executor: "
          f"bit-equal to the goldens and to the reference runs' 7 traces; "
          f"{launched} launches", flush=True)

    # (b) runs in a child process (start_env_plain_child), beside phases
    # that time nothing

    # (c) the fig_dvfs and GreenDataFlow grids at full size (main paths)
    with open(os.path.join(ROOT, "tests", "torch_goldens",
                           "fig_dvfs_full.json")) as f:
        gold = json.load(f)
    grids = {"fig_dvfs": (fig_dvfs_scenarios(), ("tool", "fcap", "cores")),
             "greendataflow": (greendataflow_scenarios(),
                               ("testbed", "tech", "idle", "tool"))}
    launches = {}
    grs, grouped_rows, ticks_c = [], [], []
    for gname, (cells, axes) in grids.items():
        g = gold[gname]
        scs = [sc for _, sc in cells]
        n_groups = api.group_count(scs, device=dev)
        check(n_groups == g["group_count"],
              f"{gname}: group_count {n_groups} != JAX's {g['group_count']}")
        tl.tick_loop.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results = api.sweep(scs, device=dev)
        wall = time.perf_counter() - t0
        launches[gname] = tl.tick_loop.launches
        check(launches[gname] == 1,
              f"{gname}: {launches[gname]} launches for one sweep of "
              f"{n_groups} groups")
        want = {tuple(r[a] for a in axes): r for r in g["rows"]}
        n_exact = 0
        for (cell, _), r in zip(cells, results):
            w = want[cell]
            check(r.completed == w["completed"] and r.time_s == w["time_s"],
                  f"{gname} {cell}: completed/time_s {r.completed}/"
                  f"{r.time_s} vs {w['completed']}/{w['time_s']}")
            for fld in ("energy_j", "avg_tput_MBps"):
                check(abs(getattr(r, fld) - w[fld]) <= 1e-5 * abs(w[fld]),
                      f"{gname} {cell}: {fld} {getattr(r, fld)} vs {w[fld]}")
            n_exact += all(getattr(r, fld) == w[fld] for fld in
                           ("time_s", "energy_j", "avg_tput_MBps",
                            "avg_power_w"))
        print(f"[17 envs] (c) {gname}: {len(results)} cells in {n_groups} "
              f"groups ({launches[gname]} launch; PR 16-18: {n_groups}), "
              f"sweep wall {wall:.3f} s (PR 18: "
              f"{PER_GROUP_WALL_S[gname]}); "
              f"{sum(r.completed for r in results)} completed; vs "
              f"fig_dvfs_full.json: completed/time_s exact, energy/tput "
              f"rtol 1e-5, {n_exact}/{len(results)} cells bit-exact",
              flush=True)
        if gname == "fig_dvfs":
            print(f"[17 envs] (c) headline "
                  f"{json.dumps(fig_dvfs_headline(cells, results))}; JAX "
                  f"{json.dumps(g['headline'])}", flush=True)
        grs_g = groups_on_card(scs, dev)
        kern_g = [call(tl.tick_loop, k, r) for k, r in grs_g]
        rows_g, _ = grouped_vs_groups(scs, dev, kern_g, gname)
        grouped_rows.append(rows_g)
        grs += grs_g
        ticks_c += [executed_lane_ticks(m, k.n_steps)
                    for (k, _), (_, _, m) in zip(grs_g, kern_g)]
        del kern_g
    ms_c = time_cuda(lambda: [tl.tick_loop_grouped(r)
                              for r in grouped_rows], 5)
    group_ms_c = time_cuda(lambda: [call(tl.tick_loop, k, r)
                                    for k, r in grs], 5)
    bound_c, by_c, nbytes_c, ops_c = bound_of(grs, ticks_c)
    print(f"[17 envs] (c) kernel on both grids' {len(grs)} groups: "
          f"grouped {ms_c:.3f} ms (median of 5, 2 launches, one a grid, "
          f"each bit-equal to its groups' own launches; PR 16-17: 186.901 "
          f"in 42), the groups' own launches {group_ms_c:.3f} ms "
          f"({len(grs)} launches); {sum(ticks_c)} executed lane-ticks; "
          f"bound {bound_c:.4f} ms by {by_c} ({nbytes_c} B, {ops_c} ops)",
          flush=True)
    del grs, grouped_rows

    # (d) a tune-sized dvfs launch: 4,096 lanes in one group
    env_d = api.make_environment("dvfs", **DVFS_TUNE)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res_d = api.sweep(tune_scenarios(environment=env_d), device=dev)
    wall_d = time.perf_counter() - t0
    peak_d = torch.cuda.max_memory_allocated()
    grs_d = groups_on_card(tune_scenarios(executor="cuda",
                                          environment=env_d), dev)
    check(len(grs_d) == 1, f"dvfs tune split into {len(grs_d)} groups")
    (key_d, rows_d), = grs_d
    kern_d = call(tl.tick_loop, key_d, rows_d)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain_d = call(tl.tick_loop_reference, key_d, rows_d)
    torch.cuda.synchronize()
    plain_d_ms = (time.perf_counter() - t0) * 1e3
    eq_d, err_d = compare_outputs(kern_d, plain_d)
    check(eq_d, f"dvfs tune: kernel != plain version (max |err| {err_d})")
    del plain_d
    ticks_d = executed_lane_ticks(kern_d[2], key_d.n_steps)
    ms_d = time_cuda(lambda: call(tl.tick_loop, key_d, rows_d), 5)
    bound_d, by_d, nbytes_d, ops_d = bound_of(grs_d, [ticks_d])
    b, n = rows_d[1].shape
    print(f"[17 envs] (d) dvfs hp race n_big 4: {b} lanes x {n} ticks, 1 "
          f"group: kernel == plain on all lanes; kernel {ms_d:.3f} ms "
          f"(median of 5); {ticks_d} executed lane-ticks = "
          f"{ticks_d / (ms_d / 1e3):.4g} lane-ticks/s; {nbytes_d} B "
          f"written/read, memory bound "
          f"{nbytes_d / HBM_BYTES_PER_S * 1e3:.4f} ms (bound {bound_d:.4f} "
          f"ms by {by_d}, {ops_d} ops); plain {plain_d_ms:.1f} ms; peak "
          f"memory {peak_d} B; sweep end to end {wall_d:.3f} s; "
          f"{sum(r.completed for r in res_d)} completed", flush=True)
    print(f"[17 envs] phase time {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return {"launches": launches, "grids_ms": ms_c,
            "grids_group_ms": group_ms_c, "dvfs_tune_ms": ms_d}


def env_plain_check(dev) -> None:
    """Phase 17b: kernel == plain version on the card, per environment and
    controller (the child process's work: see :class:`EnvPlainChild`)."""
    import torch

    from repro_torch.kernels import tick_loop as tl

    t_plain = 0.0
    by_env: dict = {}
    for (en, cn), sc in env_smoke_scenarios(executor="cuda"):
        (key, rows), = groups_on_card([sc], dev)
        kern = call(tl.tick_loop, key, rows)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plain = call(tl.tick_loop_reference, key, rows)
        torch.cuda.synchronize()
        t_plain += time.perf_counter() - t0
        equal, err = compare_outputs(kern, plain)
        check(equal, f"17b {en} / {cn}: kernel != plain version "
                     f"(max |err| {err})")
        by_env.setdefault(en, []).append(
            (cn, executed_lane_ticks(kern[2], key.n_steps)))
    for en, runs in by_env.items():
        print(f"[17 envs] (b) {en}: kernel == plain on the card for "
              f"{len(runs)} controllers (final rows and 7 traces bit-equal);"
              f" executed ticks "
              + ", ".join(f"{cn} {t}" for cn, t in runs), flush=True)
    print(f"[17 envs] (b) plain versions {t_plain:.1f} s in all",
          flush=True)



class EnvPlainChild:
    """Phase 17b in a child process on the same card (``python3
    chip_smoke.py --env-plain``): the 30 plain tick loops take ~170 s of
    host time, so they run beside phases that time nothing (8, 11, 15 and
    23c) and are joined after them.  The same card and libdevice keep the
    comparison bit for bit; the child's failure or crash fails the run."""

    def __init__(self):
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--env-plain"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        CHILDREN.append(self.proc)

    def join(self) -> float:
        """Wait for the child, print its lines, fail on its failure;
        returns the seconds waited."""
        t0 = time.perf_counter()
        out, _ = self.proc.communicate(timeout=900)
        waited = time.perf_counter() - t0
        for line in out.splitlines():
            print(line, flush=True)
        check(self.proc.returncode == 0,
              f"17b's child process exited {self.proc.returncode}")
        print(f"[17 envs] (b) child process: "
              f"{time.perf_counter() - self.t0:.1f} s from start to join, "
              f"{waited:.1f} s waited at the join", flush=True)
        return waited


#: Child processes to stop if the script fails before joining them.
CHILDREN: list = []


def fleet_small_datasets():
    from repro_torch.core.types import DatasetSpec

    fast = (DatasetSpec("a", 200, 400.0, 2.0),
            DatasetSpec("b", 10, 600.0, 60.0))
    one = (DatasetSpec("c", 50, 500.0, 10.0),)
    return fast, one


def fleet16_trace():
    """tests/test_fleet.py::test_offline_golden_cells_bit_exact's trace."""
    from repro_torch import fleet
    from repro_torch.core.types import CHAMELEON, DatasetSpec

    fast, one = fleet_small_datasets()
    return fleet.poisson_trace(
        rate_per_s=0.5, n_transfers=16,
        datasets=[one, fast, (DatasetSpec("a", 2000, 4000.0, 2.0),)],
        controllers=("eemt", "me", "wget/curl"), profile=CHAMELEON,
        seed=1810, total_s=600.0)


def fleet_bench_build(smoke):
    """benchmarks/fleet.py::build (its DATASETS, make_controller_menu)."""
    from repro_torch import api, fleet
    from repro_torch.core.types import CHAMELEON, GB, DatasetSpec

    datasets = (
        (DatasetSpec("web", 20_000, 2.0 * GB, 0.1),),
        (DatasetSpec("data", 2_500, 8.0 * GB, 2.4),),
        (DatasetSpec("archive", 64, 16.0 * GB, 256.0),),
        (DatasetSpec("mix-s", 5_000, 1.0 * GB, 0.2),
         DatasetSpec("mix-m", 1_000, 3.0 * GB, 2.4),
         DatasetSpec("mix-l", 32, 8.0 * GB, 256.0)),
    )
    target = CHAMELEON.bandwidth_mbps * 0.5
    menu = tuple(api.make_controller(n, target_tput_mbps=target)
                 if n in ("eett", "ismail-target") else n
                 for n in FLEET_BENCH_CONTROLLERS)
    n_transfers, n_hosts, rate = ((400, 4, 0.4) if smoke
                                  else (10_000, 8, 0.8))
    trace = fleet.poisson_trace(
        rate_per_s=rate, n_transfers=n_transfers, seed=1810,
        datasets=datasets, controllers=menu, profile=CHAMELEON,
        total_s=1800.0)
    hosts = fleet.host_pool(n_hosts, nic_mbps=CHAMELEON.bandwidth_mbps,
                            slots=16)
    return trace, hosts


def tune_example_experiment():
    """examples/tune_controller.py's Experiment."""
    from repro_torch import api
    from repro_torch.core.types import CHAMELEON, GB, CpuProfile, DatasetSpec

    return api.Experiment(
        name="tune-eemt",
        space=api.grid(api.axis("max_ch", (8, 16, 32, 64)),
                       api.axis("max_load", (0.6, 0.85))),
        base={"profile": CHAMELEON,
              "datasets": (DatasetSpec("bulk", 800, 300.0 * GB, 384.0),),
              "cpu": CpuProfile(), "total_s": 120.0,
              "controller": lambda c: api.make_controller(
                  "eemt", max_ch=c["max_ch"], max_load=c["max_load"])})


def fleet_fields(t):
    return (t.name, t.controller, t.host, t.arrival_s, t.start_s, t.time_s,
            t.energy_j, t.moved_mb, t.completed, t.ideal_s)


def fleet_same(a, b, tag):
    """Two fleet reports bit for bit: every transfer, the host stats and
    the totals."""
    bad = [(x.name, fleet_fields(x), fleet_fields(y))
           for x, y in zip(a.transfers, b.transfers)
           if fleet_fields(x) != fleet_fields(y)]
    check(len(a.transfers) == len(b.transfers) and not bad,
          f"{tag}: {len(bad)} transfers differ, first {bad[:2]}")
    check([dataclasses.astuple(h) for h in a.host_stats]
          == [dataclasses.astuple(h) for h in b.host_stats]
          and (a.sim_s, a.waves, a.dropped) == (b.sim_s, b.waves, b.dropped),
          f"{tag}: host stats or (sim_s, waves, dropped) differ")


def fleet_pair(trace, hosts, dev, tag, **kw):
    """The fleet on the card through the kernel's wave mode and through the
    plain wave loop: bit for bit, one launch a wave.  Returns the kernel's
    report."""
    from repro_torch import fleet
    from repro_torch.kernels import tick_loop as tl

    before = tl.tick_loop.launches
    kern = fleet.run_fleet(trace, hosts, devices=[dev], **kw)
    launches = tl.tick_loop.launches - before
    plain = fleet.run_fleet(trace, hosts, devices=[dev],
                            executor="reference", **kw)
    check(tl.tick_loop.launches - before == launches,
          f"{tag}: the plain fleet launched the kernel")
    fleet_same(kern, plain, f"{tag}: kernel vs plain")
    check(launches == kern.waves,
          f"{tag}: {launches} launches for {kern.waves} waves")
    return kern


def fleet_golden_check(rep, gold, tag):
    """A fleet report against fleet_full.json's columns: order, placement,
    start, completion and time exact, energy to FLEET_RTOL; (sim_s, waves,
    dropped) exact.  Returns the largest relative energy difference."""
    ts = rep.transfers
    check(len(ts) == len(gold["index"]),
          f"{tag}: {len(ts)} transfers, JAX {len(gold['index'])}")
    worst, n_exact = 0.0, 0
    for k, t in enumerate(ts):
        want = (gold["index"][k], gold["controllers"][gold["controller"][k]],
                gold["hosts"][gold["host"][k]], gold["start_s"][k],
                bool(gold["completed"][k]), gold["time_s"][k])
        got = (int(t.name.rsplit("-", 1)[1]), t.controller, t.host,
               t.start_s, t.completed, t.time_s)
        check(got == want, f"{tag}: transfer {k}: {got} vs JAX {want}")
        e = gold["energy_j"][k]
        err = abs(t.energy_j - e) / max(abs(e), 1e-30)
        check(err <= FLEET_RTOL, f"{tag}: {t.name} energy {t.energy_j} vs "
                                 f"JAX {e}")
        worst = max(worst, err)
        n_exact += t.energy_j == e and t.moved_mb == gold["moved_mb"][k]
    check((rep.sim_s, rep.waves, rep.dropped)
          == (gold["sim_s"], gold["waves"], gold["dropped"]),
          f"{tag}: (sim_s, waves, dropped) {(rep.sim_s, rep.waves, rep.dropped)}"
          f" vs JAX {(gold['sim_s'], gold['waves'], gold['dropped'])}")
    return worst, n_exact


class WaveTimer:
    """Splits a fleet run's device step by wave, on the card: the copies to
    the card (``scheduler._to_device``, synchronised), the launch (CUDA
    events around ``engine.run_cuda_wave_groups``: the wrapper's host-side
    marshalling and the kernel) and the copies back (``scheduler._to_host``,
    which synchronises); and each launch's bound: its lanes' state bytes
    (each read or written once) against its executed lane-ticks'
    operations.  Every ``sample``-th wave's batches are kept with the
    kernel's outputs, to time the kernel alone afterwards
    (:meth:`device_ms`) and to hold it against the plain wave
    (:meth:`plain_ms`) on the rows whose parameter row is not all zero:
    an online pool's free slots are zero rows, which the kernel leaves as
    they are and the plain wave turns to NaN; an offline wave has none.
    Installed over the scheduler's functions for one run (``with``); both
    fleet loops run their waves through them
    (``scheduler.run_wave_rows``)."""

    def __init__(self, sample=100, tag="20b"):
        self.h2d_s = self.d2h_s = 0.0
        self.events = []
        self.bytes = self.ops = 0
        self.sample = sample
        self.kept = []
        self.tag = tag

    def __enter__(self):
        import torch

        from repro_torch.core import engine
        from repro_torch.fleet import scheduler

        self._saved = (scheduler._to_device, scheduler._to_host,
                       engine.run_cuda_wave_groups)
        to_device, to_host, launch = self._saved

        def timed_to_device(dev, items):
            t0 = time.perf_counter()
            out = to_device(dev, items)
            torch.cuda.synchronize()
            self.h2d_s += time.perf_counter() - t0
            return out

        def timed_to_host(res):
            t0 = time.perf_counter()
            out = to_host(res)
            self.d2h_s += time.perf_counter() - t0
            return out

        def timed_launch(waves):
            keep = len(self.events) % self.sample == 0
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            res = launch(waves)
            end.record()
            self.events.append((start, end))
            if keep:
                self.kept.append((waves, res))
            self._bound(waves, res)
            return res

        scheduler._to_device, scheduler._to_host = (timed_to_device,
                                                    timed_to_host)
        engine.run_cuda_wave_groups = timed_launch
        return self

    def __exit__(self, *exc):
        from repro_torch.core import engine
        from repro_torch.fleet import scheduler

        (scheduler._to_device, scheduler._to_host,
         engine.run_cuda_wave_groups) = self._saved

    def _bound(self, waves, res):
        import torch

        from repro_torch.kernels import tick_loop as tl

        for w, (_, _, done_at) in zip(waves, res):
            kind, _, spec = tl.kernel_spec(w.controller, w.env)
            b, p = w.bw.shape[0], (w.prow.shape[1] - 13) // 5
            ticks = int(torch.where(done_at >= 0, done_at - w.step0 + 1,
                                    w.wave_steps).sum())
            self.bytes += 4 * (w.prow.numel() + 2 * b + 2 * w.f32.numel()
                               + 2 * w.i32.numel() + b)
            self.ops += ticks * (OPS_PER_LANE_TICK
                                 + OPS_PER_PARTITION_TICK * p
                                 + ENV_NET_OPS[spec.network]
                                 + ENV_ENERGY_OPS[spec.energy])
            if kind == tl.KIND_LEARNED:
                tick_ops, table = learned_ops(w.controller)
                self.bytes += 4 * table
                self.ops += ticks // w.ctrl_every * tick_ops

    def kernel_ms(self):
        return [a.elapsed_time(b) for a, b in self.events]

    def device_ms(self):
        """Device time (ms) of each kept wave's launch: 5 launches queued
        behind a spin (:func:`kernel_device_ms`)."""
        from repro_torch.kernels import tick_loop as tl

        return [kernel_device_ms(lambda w=w: tl.tick_wave_grouped(w), reps=5)
                for w, _ in self.kept]

    def plain_ms(self):
        """Each kept wave's groups through the plain wave loop on the card
        (host clock, ending in a synchronise; one run each), each group's
        ``(f32, i32, done_at)`` held bit for bit against what the kernel
        returned for it in the fleet run."""
        import torch

        from repro_torch.kernels import tick_loop as tl

        out = []
        for n, (waves, kern) in enumerate(self.kept):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            plain = [tl.tick_wave_reference(
                w.controller, w.env, w.cpu, w.prow, w.bw, w.f32, w.i32,
                w.step0, wave_steps=w.wave_steps, dt=w.dt,
                ctrl_every=w.ctrl_every) for w in waves]
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3)
            for g, (w, a, b) in enumerate(zip(waves, kern, plain)):
                m = w.prow.ne(0).any(dim=1)
                check(all(torch.equal(x[m], y[m]) for x, y in zip(a, b)),
                      f"{self.tag}: wave {n * self.sample}, group {g}: the "
                      f"kernel's rows or done_at differ from the plain "
                      f"wave's")
        return out

    def bound_ms(self):
        t_bytes = self.bytes / HBM_BYTES_PER_S * 1e3
        t_ops = self.ops / F32_OPS_PER_S * 1e3
        return (max(t_bytes, t_ops),
                "bytes" if t_bytes >= t_ops else "operations")


def phase_fleet(dev) -> dict:
    """Phase 20: the offline fleet through the tick kernel's wave mode, and
    offline tuning.  (a) the fleet goldens, kernel against plain on the
    card bit for bit; (b) the full benchmark fleet against JAX's CPU
    golden, timed and split by wave, and the --smoke trace kernel against
    plain; (c) examples/tune_controller.py's search against JAX's
    golden."""
    import math

    import torch

    from repro_torch import api, fleet
    from repro_torch.core.types import CHAMELEON, CpuProfile
    from repro_torch.kernels import tick_loop as tl

    t_phase = time.perf_counter()
    fast, one = fleet_small_datasets()
    eemt = api.make_controller("eemt")

    # 20a. The goldens.  _GOLDEN: 16 transfers, 2 hosts x 4 slots.
    rep = fleet_pair(fleet16_trace(),
                     fleet.host_pool(2, nic_mbps=CHAMELEON.bandwidth_mbps,
                                     slots=4), dev, "20a _GOLDEN",
                     wave_s=10.0, dt=0.5)
    got = {t.name: (t.energy_j, t.time_s, t.start_s, t.host, t.completed)
           for t in rep.transfers}
    check(got == FLEET16_GOLDEN, "20a _GOLDEN: "
          + str([(k, got.get(k), v) for k, v in FLEET16_GOLDEN.items()
                 if got.get(k) != v][:3]))
    check(rep.total_energy_j == math.fsum(v[0] for v in
                                          FLEET16_GOLDEN.values())
          and (rep.sim_s, rep.waves) == (130.0, 12),
          f"20a _GOLDEN: total {rep.total_energy_j}, (sim_s, waves) "
          f"{(rep.sim_s, rep.waves)}")
    # FLEET_GOLDEN under the reference environment and dvfs's matched
    # tables.
    matched = api.Environment(network=api.DvfsNetworkModel(),
                              energy=api.DvfsEnergyModel.matched(
                                  CpuProfile()))
    req = fleet.TransferRequest(arrival_s=0.0, datasets=fast,
                                controller=eemt, profile=CHAMELEON,
                                name="g", total_s=240.0)
    for env in (None, matched):
        r = fleet_pair([req], [fleet.Host("h", nic_mbps=FLEET_NO_CONTENTION,
                                          environment=env)], dev,
                       f"20a FLEET_GOLDEN {env and 'dvfs'}", wave_s=5.0,
                       dt=0.1).transfers[0]
        check((r.completed, r.time_s, r.energy_j, r.moved_mb)
              == FLEET_ONE_GOLDEN, f"20a FLEET_GOLDEN: {r}")
    # The heterogeneous pool (tests/test_environments.py:386-413): each
    # pinned lane equals api.run under its host's environment.
    envs = (None, "lossy-wan", "big-little")
    hosts = [fleet.Host(f"h{i}", nic_mbps=FLEET_NO_CONTENTION, environment=e)
             for i, e in enumerate(envs)]
    reqs = [fleet.TransferRequest(arrival_s=0.0, datasets=fast,
                                  controller=eemt, profile=CHAMELEON,
                                  host=i, name=f"h{i}", total_s=600.0)
            for i in range(len(envs))]
    rep = fleet_pair(reqs, hosts, dev, "20a heterogeneous", wave_s=5.0,
                     dt=0.1)
    by = {t.name: t for t in rep.transfers}
    for i, env in enumerate(envs):
        solo = api.run(api.Scenario(profile=CHAMELEON, datasets=fast,
                                    controller=eemt, environment=env,
                                    total_s=600.0, dt=0.1), device=dev)
        t = by[f"h{i}"]
        check((t.time_s, t.energy_j) == (solo.time_s, solo.energy_j),
              f"20a heterogeneous {env}: {t.time_s}/{t.energy_j} vs api.run "
              f"{solo.time_s}/{solo.energy_j}")
    # The learned controller through the fleet (tests/test_learn.py:248),
    # with JAX's BC policy: its lane equals api.run bit for bit.
    learned = api.make_controller("learned", params=golden_learned()[0])
    reqs = [fleet.TransferRequest(arrival_s=0.0, datasets=fast,
                                  controller=learned, profile=CHAMELEON,
                                  name="lrn", total_s=240.0),
            fleet.TransferRequest(arrival_s=1.0, datasets=one,
                                  controller=eemt, profile=CHAMELEON,
                                  name="heur", total_s=240.0)]
    rep = fleet_pair(reqs, fleet.host_pool(2, nic_mbps=FLEET_NO_CONTENTION),
                     dev, "20a learned", wave_s=5.0, dt=0.1)
    lrn = {t.name: t for t in rep.transfers}["lrn"]
    solo = api.run(api.Scenario(profile=CHAMELEON, datasets=fast,
                                controller=learned, total_s=240.0, dt=0.1),
                   device=dev)
    check(lrn.moved_mb > 0 and (lrn.time_s, lrn.energy_j)
          == (solo.time_s, solo.energy_j),
          f"20a learned: {lrn.time_s}/{lrn.energy_j} vs api.run "
          f"{solo.time_s}/{solo.energy_j}")
    # A wave of 15 ticks over controller strides of 2: lanes admitted in
    # different waves tick their controllers out of phase.
    rep = fleet_pair(fleet16_trace(),
                     fleet.host_pool(2, nic_mbps=CHAMELEON.bandwidth_mbps,
                                     slots=4), dev, "20a unaligned",
                     wave_s=7.5, dt=0.5)
    print(f"[20a fleet goldens] _GOLDEN 16/16 bit-exact, (sim_s, waves) "
          f"(130.0, 12); FLEET_GOLDEN under the reference environment and "
          f"dvfs's matched tables; the reference / lossy-wan / big-little "
          f"pool and the learned lane (JAX's BC policy) each equal to "
          f"api.run; a 15-tick wave over strides of 2 ({rep.waves} waves): "
          f"kernel == plain on the card in every case, bit for bit, one "
          f"launch a wave", flush=True)

    # 20b. The full offline fleet at the benchmark's size, then its --smoke
    # trace kernel against plain.
    with open(os.path.join(ROOT, "tests", "torch_goldens",
                           "fleet_full.json")) as f:
        gold = json.load(f)
    trace, hosts = fleet_bench_build(smoke=False)
    tl.tick_loop.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rep = fleet.run_fleet(trace, hosts, wave_s=FLEET_WAVE_S, dt=FLEET_DT,
                          devices=[dev])
    wall = time.perf_counter() - t0
    fleet_launches = tl.tick_loop.launches
    check(fleet_launches == rep.waves,
          f"20b: {fleet_launches} launches for {rep.waves} waves")
    worst, n_exact = fleet_golden_check(rep, gold["full"], "20b fleet")
    with WaveTimer() as timer:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        again = fleet.run_fleet(trace, hosts, wave_s=FLEET_WAVE_S,
                                dt=FLEET_DT, devices=[dev])
        split_wall = time.perf_counter() - t0
    fleet_same(rep, again, "20b: the timed rerun")
    ks = timer.kernel_ms()
    kernel_s = sum(ks) / 1e3
    bound_ms, bound_by = timer.bound_ms()
    host_s = split_wall - timer.h2d_s - timer.d2h_s - kernel_s
    n_waves = len(ks)
    dev_ms = [t for t in timer.device_ms() if t is not None]
    check(dev_ms, "20b: no wave's device time could be read")
    wave_ms = statistics.median(dev_ms)
    wave_plain_ms = statistics.median(timer.plain_ms())
    print(f"[20b fleet] {len(trace)} transfers on {len(hosts)} hosts x 16 "
          f"slots (benchmarks/fleet.py), wave_s {FLEET_WAVE_S}, dt "
          f"{FLEET_DT}: wall {wall:.3f} s, {len(trace) / wall:.1f} "
          f"transfers/s; {rep.waves} waves, {fleet_launches} launches; "
          f"sim_s {rep.sim_s}, {rep.completed} completed, {rep.dropped} "
          f"dropped; vs fleet_full.json: order, hosts, starts, completion "
          f"and time exact, energy max rel diff {worst:.3g} (rtol "
          f"{FLEET_RTOL}), {n_exact}/{len(trace)} transfers bit-exact",
          flush=True)
    print(f"[20b fleet] split (a rerun, bit-equal, wall {split_wall:.3f} s): "
          f"launches (the wrapper's marshalling and the kernel, by events) "
          f"{sum(ks):.3f} ms in {n_waves} = {sum(ks) / n_waves:.4f} ms a "
          f"wave (median {statistics.median(ks):.4f}); the kernel alone "
          f"(device time of every {timer.sample}th wave, {len(dev_ms)} "
          f"waves, 5 launches queued behind a spin) median {wave_ms:.4f} ms "
          f"a wave (min {min(dev_ms):.4f}, max {max(dev_ms):.4f}; the plain "
          f"wave loop on the same waves {wave_plain_ms:.1f} ms, median, its "
          f"rows and done_at bit-equal to the kernel's on all "
          f"{len(timer.kept)}); "
          f"bound "
          f"{bound_ms / n_waves:.3g} ms a wave by {bound_by} ({timer.bytes} "
          f"B, {timer.ops} ops in all); host prep {host_s:.3f} s "
          f"({host_s / split_wall:.1%} of the wall; "
          f"{host_s / n_waves * 1e3:.3f} ms a wave), H2D {timer.h2d_s:.3f} "
          f"s, D2H and sync {timer.d2h_s:.3f} s", flush=True)
    jbc = gold["full"]["by_controller"]
    for name, row in rep.by_controller().items():
        p99 = row["slowdown"]["p99"]
        print(f"[20b fleet] fleet/{name}: {row['joules_per_gb']:.1f} J/GB; "
              f"p99={'na' if p99 is None else format(p99, '.2f')}; "
              f"n={row['transfers']} (JAX {jbc[name]['joules_per_gb']:.1f} "
              f"J/GB, p99 {jbc[name]['p99_slowdown']})", flush=True)
    # The --smoke trace on the kernel only: 20a's cases and the sampled
    # full-size waves above already hold the kernel to the plain wave.
    strace, shosts = fleet_bench_build(smoke=True)
    before = tl.tick_loop.launches
    t0 = time.perf_counter()
    srep = fleet.run_fleet(strace, shosts, wave_s=FLEET_WAVE_S, dt=FLEET_DT,
                           devices=[dev])
    s_wall = time.perf_counter() - t0
    s_launches = tl.tick_loop.launches - before
    check(s_launches == srep.waves,
          f"20b smoke: {s_launches} launches for {srep.waves} waves")
    s_worst, s_exact = fleet_golden_check(srep, gold["smoke"], "20b smoke")
    print(f"[20b smoke] {len(strace)} transfers on {len(shosts)} hosts "
          f"through the kernel ({srep.waves} waves, one launch each; wall "
          f"{s_wall:.1f} s): vs fleet_full.json order, hosts, starts, "
          f"completion and time exact, energy max rel diff {s_worst:.3g}, "
          f"{s_exact}/{len(strace)} bit-exact", flush=True)

    # 20c. examples/tune_controller.py's search.
    with open(os.path.join(ROOT, "tests", "torch_goldens",
                           "tune_full.json")) as f:
        tgold = json.load(f)
    args = ("energy_j", ("avg_tput_gbps", ">=", 2.0))
    kw = dict(seeds=[0, 1, 2], refine=2, device=dev)
    tl.tick_loop.launches = 0
    t0 = time.perf_counter()
    res = api.tune(tune_example_experiment(), *args, **kw)
    t_wall = time.perf_counter() - t0
    tune_launches = tl.tick_loop.launches
    check(res.best == tgold["best"] and res.feasible == tgold["feasible"]
          and res.n_evals == tgold["n_evals"],
          f"20c: best {res.best} feasible {res.feasible} n_evals "
          f"{res.n_evals} vs JAX {tgold['best']} {tgold['feasible']} "
          f"{tgold['n_evals']}")
    jrep = api.Report.from_dict(tgold["report"])
    check(len(res.report) == len(jrep)
          and all(list(res.report[a]) == list(jrep[a]) for a in jrep.axes),
          "20c: the search's rows differ from JAX's")
    t_worst = 0.0
    for m in jrep.metrics:
        a, b = res.report[m].astype(float), jrep[m].astype(float)
        err = float((abs(a - b) / abs(b).clip(1e-30)).max())
        check(err <= TUNE_EXAMPLE_RTOL, f"20c: {m} rel diff {err}")
        t_worst = max(t_worst, err)
    rungs = []

    def spy(scenarios):
        before = tl.tick_loop.launches
        out = api.sweep(scenarios, device=dev)
        rungs.append((len(scenarios), tl.tick_loop.launches - before))
        return out

    api.tune(tune_example_experiment(), *args, sweeper=spy, **kw)
    check(sum(n for _, n in rungs) == tune_launches
          and all(n == 1 for _, n in rungs),
          f"20c: launches by rung {rungs}, {tune_launches} in all")
    print(f"[20c tune] examples/tune_controller.py's search on the card: "
          f"best {res.best}, feasible {res.feasible}, {res.n_evals} "
          f"evaluations, as JAX's; every row's metrics within rel "
          f"{t_worst:.3g} (rtol {TUNE_EXAMPLE_RTOL}); wall {t_wall:.3f} s; "
          f"{tune_launches} launches, by rung (cells, launches): {rungs}",
          flush=True)
    print(f"[20 fleet] phase time {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return {"launches": {"fleet": fleet_launches, "tune": tune_launches},
            "wave_ms": wave_ms, "wave_launch_ms": sum(ks) / n_waves,
            "wave_plain_ms": wave_plain_ms,
            "wave_bound_ms": bound_ms / n_waves,
            "wave_bound_by": bound_by, "fleet_wall_s": wall}


def online_bench_stream(n):
    """benchmarks/fleet.py::build_online_stream (its ONLINE_DATASETS)."""
    from repro_torch import fleet
    from repro_torch.core.types import CHAMELEON, GB, DatasetSpec

    datasets = ((DatasetSpec("svc-s", 64, 0.25 * GB, 0.1),),
                (DatasetSpec("svc-m", 256, 1.0 * GB, 0.5),),
                (DatasetSpec("svc-l", 16, 4.0 * GB, 64.0),))
    return fleet.diurnal_stream(
        base_rate_per_s=4.0, peak_rate_per_s=40.0, period_s=3600.0,
        datasets=datasets, controllers=ONLINE_CONTROLLERS,
        profile=CHAMELEON, seed=1810, n_transfers=n, total_s=900.0)


def online_bench_hosts():
    """benchmarks/fleet.py::_run_online_leg's pool."""
    from repro_torch import fleet
    from repro_torch.core.types import CHAMELEON

    return fleet.host_pool(ONLINE_HOSTS,
                           nic_mbps=10.0 * CHAMELEON.bandwidth_mbps, slots=0)


def online_report_same(a, b, tag):
    """Two online reports bit for bit: every tracked transfer, the summary
    (totals, counters, percentiles, SLO and churn blocks) and the host
    stats."""
    bad = [(x.name, fleet_fields(x), fleet_fields(y))
           for x, y in zip(a.transfers, b.transfers)
           if fleet_fields(x) != fleet_fields(y)]
    check(len(a.transfers) == len(b.transfers) and not bad,
          f"{tag}: {len(bad)} transfers differ, first {bad[:2]}")
    check(a.summary() == b.summary()
          and [dataclasses.astuple(h) for h in a.host_stats]
          == [dataclasses.astuple(h) for h in b.host_stats],
          f"{tag}: summaries or host stats differ")


def online_pair(reqs, hosts, dev, tag, **kw):
    """The online fleet on the card through the kernel's wave mode and
    through the plain wave loop: bit for bit on every tracked transfer and
    the summary, one launch a wave.  Returns the kernel's report."""
    from repro_torch import fleet
    from repro_torch.kernels import tick_loop as tl

    before = tl.tick_loop.launches
    kern = fleet.run_fleet_online(reqs, hosts, devices=[dev],
                                  track_transfers=True, **kw)
    launches = tl.tick_loop.launches - before
    plain = fleet.run_fleet_online(reqs, hosts, devices=[dev],
                                   executor="reference",
                                   track_transfers=True, **kw)
    check(tl.tick_loop.launches - before == launches,
          f"{tag}: the plain fleet launched the kernel")
    online_report_same(kern, plain, f"{tag}: kernel vs plain")
    check(launches == kern.waves == kern.counters["waves_run"],
          f"{tag}: {launches} launches for {kern.waves} waves")
    return kern


def online_golden_check(rep, gold, tag):
    """An online report against online_full.json: per tracked transfer
    order, placement, arrival, start, completion and time exact, energy
    and MB to FLEET_RTOL; (sim_s, waves, dropped) and the counters exact.
    Returns (largest relative energy difference, transfers bit-exact)."""
    got = (rep.sim_s, rep.waves, rep.dropped, rep.fold.transfers,
           rep.completed)
    want = tuple(gold[k] for k in ("sim_s", "waves", "dropped", "transfers",
                                   "n_completed"))
    check(got == want, f"{tag}: (sim_s, waves, dropped, transfers, "
                       f"completed) {got} vs JAX {want}")
    check(rep.counters == gold["counters"],
          f"{tag}: counters {rep.counters} vs JAX {gold['counters']}")
    worst, n_exact = 0.0, 0
    for k, t in enumerate(rep.transfers or ()):
        want = (gold["index"][k], gold["controllers"][gold["controller"][k]],
                gold["hosts"][gold["host"][k]], gold["arrival_s"][k],
                gold["start_s"][k], bool(gold["completed"][k]),
                gold["time_s"][k])
        got = (int(t.name.rsplit("-", 1)[1]), t.controller, t.host,
               t.arrival_s, t.start_s, t.completed, t.time_s)
        check(got == want, f"{tag}: transfer {k}: {got} vs JAX {want}")
        for f in ("energy_j", "moved_mb"):
            e, v = gold[f][k], getattr(t, f)
            err = abs(v - e) / max(abs(e), 1e-30)
            check(err <= FLEET_RTOL, f"{tag}: {t.name} {f} {v} vs JAX {e}")
            worst = max(worst, err)
        n_exact += t.energy_j == gold["energy_j"][k] \
            and t.moved_mb == gold["moved_mb"][k]
    for f, v in (("total_energy_j", rep.total_energy_j),
                 ("total_gb", rep.total_gb)):
        err = abs(v - gold[f]) / max(abs(gold[f]), 1e-30)
        check(err <= FLEET_RTOL, f"{tag}: {f} {v} vs JAX {gold[f]}")
    return worst, n_exact


def close_to(got, want):
    return abs(got - want) <= FLEET_RTOL * max(abs(got), abs(want))


def phase_online(dev) -> dict:
    """Phase 21: the online fleet (every occupied slot pool of a wave in
    one launch of the tick kernel's wave mode) and the workloads (HTTP
    services, fault schedules) through both fleet drivers.  (a) parity on
    the card: online == offline per transfer, kernel == plain, recycling
    through one slot, an unaligned wave, P above the kernel's 8 refused;
    (b) the online leg of benchmarks/fleet.py --online --smoke against
    JAX's CPU golden, timed and split by wave, its device memory at a
    tenth of the stream; (c) benchmarks/workloads.py --smoke's HTTP grid
    and fault leg against JAX's CPU golden, with the port's own bit-exact
    invariants."""
    import math

    import torch

    from repro_torch import fleet, workloads
    from repro_torch.core.types import CHAMELEON, DatasetSpec
    from repro_torch.kernels import tick_loop as tl

    t_phase = time.perf_counter()
    fast, one = fleet_small_datasets()

    # 21a. tests/test_fleet_online.py's shared trace: 24 transfers, 2
    # hosts x 4 slots, wave_s 10, dt 0.5, pool_capacity 64.
    trace = fleet.poisson_trace(rate_per_s=0.5, n_transfers=24,
                                datasets=[one, fast],
                                controllers=("eemt", "me", "wget/curl"),
                                profile=CHAMELEON, seed=11, total_s=600.0)
    hosts = fleet.host_pool(2, nic_mbps=CHAMELEON.bandwidth_mbps, slots=4)
    on = online_pair(trace, hosts, dev, "21a shared trace", wave_s=10.0,
                     dt=0.5, pool_capacity=64)
    off = fleet.run_fleet(trace, hosts, wave_s=10.0, dt=0.5, devices=[dev])
    by = {t.name: t for t in on.transfers}
    check(len(by) == len(off.transfers) == len(trace)
          and all(by[t.name] == t for t in off.transfers)
          and (on.total_energy_j, on.total_gb, on.sim_s, on.waves)
          == (off.total_energy_j, off.total_gb, off.sim_s, off.waves),
          "21a shared trace: the online fleet differs from the offline "
          "run_fleet")
    # A 15-tick wave over controller strides of 2 (lanes admitted in
    # different waves tick their controllers out of phase), 8 slots a pool.
    un = online_pair(trace, hosts, dev, "21a unaligned", wave_s=7.5, dt=0.5,
                     pool_capacity=8)
    un_off = fleet.run_fleet(trace, hosts, wave_s=7.5, dt=0.5, devices=[dev])
    check([fleet_fields(t) for t in un.transfers]
          == [fleet_fields(t) for t in un_off.transfers],
          "21a unaligned: the online fleet differs from the offline one")
    # Recycling through a 1-slot pool (tests/test_fleet_online.py:87).
    reqs = [fleet.TransferRequest(arrival_s=0.0, datasets=one,
                                  controller="wget/curl", profile=CHAMELEON,
                                  name=f"r{i}", total_s=600.0)
            for i in range(8)]
    solo = fleet.host_pool(1, nic_mbps=FLEET_NO_CONTENTION)
    big = online_pair(reqs, solo, dev, "21a pool 64", wave_s=5.0, dt=0.1,
                      pool_capacity=64)
    small = online_pair(reqs, solo, dev, "21a pool 1", wave_s=5.0, dt=0.1,
                        pool_capacity=1)
    check(small.completed == big.completed == 8
          and small.counters["recycled_slots"] >= 7
          and (small.total_energy_j, small.total_gb)
          == (big.total_energy_j, big.total_gb)
          and small.sim_s > big.sim_s,
          f"21a pool 1: {small.counters} {small.total_energy_j} vs "
          f"{big.total_energy_j}")
    # Above the kernel's 8 partitions the cuda executor refuses the run
    # before its first wave.
    before = tl.tick_loop.launches
    try:
        fleet.run_fleet_online(trace, hosts, devices=[dev], max_partitions=9)
        refused = None
    except ValueError as e:
        refused = str(e)
    check(refused is not None and "max_partitions" in refused
          and tl.tick_loop.launches == before,
          f"21a: max_partitions 9 on the card: {refused!r}")
    print(f"[21a online parity] the shared trace (24 transfers, {on.waves} "
          f"waves) online == run_fleet per transfer and in totals, and a "
          f"15-tick wave over strides of 2 ({un.waves} waves); 8 transfers "
          f"through 1 slot ({small.counters['recycled_slots']} recycled) "
          f"== through 64 in energy and GB: kernel == plain on the card "
          f"in every case, bit for bit, one launch a wave; max_partitions "
          f"9 refused before a wave: {refused}", flush=True)

    # 21b. The online leg at benchmarks/fleet.py --online --smoke's size.
    with open(os.path.join(ROOT, "tests", "torch_goldens",
                           "online_full.json")) as f:
        gold = json.load(f)
    kw = dict(wave_s=ONLINE_WAVE_S, dt=ONLINE_DT,
              pool_capacity=ONLINE_CAPACITY, devices=[dev])
    hosts = online_bench_hosts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    small = fleet.run_fleet_online(online_bench_stream(1_000), hosts, **kw)
    small_wall = time.perf_counter() - t0
    small_peak = torch.cuda.max_memory_allocated() - mem0
    online_golden_check(small, gold["small"], "21b 1,000")
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    tl.tick_loop.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rep = fleet.run_fleet_online(online_bench_stream(10_000), hosts,
                                 track_transfers=True, **kw)
    wall = time.perf_counter() - t0
    online_launches = tl.tick_loop.launches
    peak = torch.cuda.max_memory_allocated() - mem0
    check(online_launches == rep.waves == rep.counters["waves_run"],
          f"21b: {online_launches} launches for {rep.waves} waves")
    worst, n_exact = online_golden_check(rep, gold["full"], "21b online")
    check(peak == small_peak, f"21b: peak device memory {peak} B for "
                              f"10,000 transfers, {small_peak} B for 1,000")
    # The split in a rerun: the timer keeps its sampled waves on the card,
    # which the memory reading above must not see.
    with WaveTimer(sample=10, tag="21b") as timer:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        again = fleet.run_fleet_online(online_bench_stream(10_000), hosts,
                                       track_transfers=True, **kw)
        split_wall = time.perf_counter() - t0
    online_report_same(rep, again, "21b: the timed rerun")
    ks = timer.kernel_ms()
    n_waves = len(ks)
    host_s = split_wall - timer.h2d_s - timer.d2h_s - sum(ks) / 1e3
    dev_ms = [t for t in timer.device_ms() if t is not None]
    check(dev_ms, "21b: no wave's device time could be read")
    wave_ms = statistics.median(dev_ms)
    wave_plain_ms = statistics.median(timer.plain_ms())
    bound_ms, bound_by = timer.bound_ms()
    c = rep.counters
    print(f"[21b online] {rep.fold.transfers} transfers "
          f"(benchmarks/fleet.py --online --smoke: a diurnal stream, "
          f"{len(hosts)} hosts, wave_s {ONLINE_WAVE_S}, dt {ONLINE_DT}, "
          f"pool_capacity {ONLINE_CAPACITY}): wall {wall:.3f} s, "
          f"{rep.fold.transfers / wall:.1f} transfers/s; {rep.waves} waves, "
          f"{online_launches} launches; sim_s {rep.sim_s}; {c['pools']} "
          f"pools, peak {c['peak_pool_in_flight']} a pool, "
          f"{c['recycled_slots']} recycled slots, backlog peak "
          f"{c['peak_queue_depth']}; vs online_full.json: order, hosts, "
          f"arrivals, starts, completion, time and counters exact, energy "
          f"and MB max rel diff {worst:.3g} (rtol {FLEET_RTOL}), "
          f"{n_exact}/{rep.fold.transfers} transfers bit-exact; peak "
          f"device memory {peak} B, equal to the 1,000-transfer leg's "
          f"({small_wall:.3f} s)", flush=True)
    print(f"[21b online] split (a rerun, bit-equal, wall {split_wall:.3f} "
          f"s): launches (marshalling and the kernel, by events) "
          f"{sum(ks):.3f} ms in {n_waves} = {sum(ks) / n_waves:.4f} ms a "
          f"wave; the kernel alone (device time of every "
          f"{timer.sample}th wave, {len(dev_ms)} waves) median "
          f"{wave_ms:.4f} ms (min {min(dev_ms):.4f}, max {max(dev_ms):.4f}"
          f"; the plain wave loop on the same waves {wave_plain_ms:.1f} ms, "
          f"median, bit-equal to the kernel on every occupied slot of all "
          f"{len(timer.kept)}); bound {bound_ms / n_waves:.3g} ms a wave by "
          f"{bound_by} ({timer.bytes} B, {timer.ops} ops in all); host "
          f"{host_s:.3f} s ({host_s / split_wall:.1%} of the wall; "
          f"{host_s / n_waves * 1e3:.3f} ms a wave), H2D "
          f"{timer.h2d_s:.3f} s, D2H and sync {timer.d2h_s:.3f} s",
          flush=True)

    # 21c. benchmarks/workloads.py --smoke: the HTTP grid and the fault
    # leg, both drivers on the card.
    with open(os.path.join(ROOT, "tests", "torch_goldens",
                           "workloads_full.json")) as f:
        wgold = json.load(f)
    tl.tick_loop.launches = 0
    waves = 0
    t0 = time.perf_counter()
    hosts = fleet.host_pool(2, nic_mbps=4.0 * CHAMELEON.bandwidth_mbps,
                            slots=0)
    cells = [(ctrl, reuse, keep, slo, slo_s)
             for ctrl in HTTP_CONTROLLERS
             for reuse, keep in HTTP_REUSE.items()
             for slo, slo_s in HTTP_SLOS.items()]
    viol = []
    for (ctrl, reuse, keep, slo, slo_s), g in zip(cells, wgold["http"]):
        tag = f"21c http {ctrl}/{reuse}/{slo}"
        check((g["controller"], g["reuse"], g["slo"]) == (ctrl, reuse, slo),
              f"{tag}: golden cell {g['controller']}/{g['reuse']}/"
              f"{g['slo']}")
        svc = workloads.HttpService(controllers=(ctrl,), keepalive_s=keep,
                                    **HTTP_SERVICE)
        trace = workloads.http_request_trace(svc, n_requests=HTTP_REQUESTS)
        off = fleet.run_fleet(trace, hosts, wave_s=5.0, dt=0.25,
                              slo_s=slo_s, devices=[dev])
        on = fleet.run_fleet_online(trace, hosts, wave_s=5.0, dt=0.25,
                                    slo_s=slo_s, pool_capacity=256,
                                    devices=[dev], track_transfers=True)
        waves += off.waves + on.waves
        check([fleet_fields(t) for t in on.transfers]
              == [fleet_fields(t) for t in off.transfers]
              and on.slo_violations() == off.slo_violations(),
              f"{tag}: offline and online differ")
        check((off.completed, on.completed, off.slo_violations(),
               on.slo_violations(), off.sim_s, off.waves, on.sim_s, on.waves)
              == (g["completed"], g["online_completed"], g["violations"],
                  g["online_violations"], g["sim_s"], g["waves"],
                  g["online_sim_s"], g["online_waves"])
              and all(close_to(a, b) for a, b in (
                  (off.total_energy_j, g["energy_j"]),
                  (off.total_gb, g["gb"]),
                  (on.total_energy_j, g["online_energy_j"]),
                  (on.total_gb, g["online_gb"]))),
              f"{tag}: {off.completed}/{on.completed} completed, "
              f"{off.slo_violations()} violations, {off.total_energy_j} J "
              f"vs JAX {g}")
        viol.append(f"{ctrl}/{reuse}/{slo} {off.slo_violations()}")
    http_s = time.perf_counter() - t0
    # The fault leg: 12 bulk transfers, a seed-7 schedule and named kills.
    from repro_torch.core.types import GB
    datasets = ((DatasetSpec("bulk-m", 2_500, 24.0 * GB, 2.4),),
                (DatasetSpec("bulk-l", 64, 48.0 * GB, 256.0),))
    trace = fleet.poisson_trace(rate_per_s=0.05, n_transfers=12, seed=1810,
                                datasets=datasets,
                                controllers=("eemt", "me"),
                                profile=CHAMELEON, total_s=3600.0)
    hosts = fleet.host_pool(2, nic_mbps=2.0 * CHAMELEON.bandwidth_mbps,
                            slots=4)
    horizon = max(r.arrival_s for r in trace) + 600.0
    base = workloads.FaultSchedule.generate(
        n_hosts=2, horizon_s=horizon, seed=7, host_loss_per_hour=18.0,
        outage_s=60.0, nic_degrade_per_hour=12.0, degrade_s=120.0)
    kills = tuple(workloads.KillTransfer(
        trace[i].name, math.ceil(trace[i].arrival_s / 10.0) * 10.0 + 5.0)
        for i in range(0, 12, 5))
    check(len(base.events) + len(kills) == wgold["faults"]["n_events"],
          "21c faults: the schedule differs from JAX's")
    churn = {}
    for mode in ("resume", "scratch"):
        tag, g = f"21c faults {mode}", wgold["faults"][mode]
        fs = workloads.FaultSchedule(events=base.events + kills,
                                     restart=mode)
        off = fleet.run_fleet(trace, hosts, wave_s=10.0, dt=0.5, faults=fs,
                              devices=[dev])
        on = fleet.run_fleet_online(
            sorted(trace, key=lambda r: r.arrival_s), hosts, wave_s=10.0,
            dt=0.5, faults=fs, pool_capacity=64, devices=[dev],
            track_transfers=True)
        waves += off.waves + on.waves
        c = off.churn
        check(on.churn == c and tuple(on.transfers) == tuple(sorted(
            off.transfers, key=lambda t: (t.start_s, t.name))),
              f"{tag}: offline and online ledgers or transfers differ")
        check(c["goodput_mb"] == c["offered_mb"]
              and (mode == "scratch" or c["wasted_mb"] == 0.0),
              f"{tag}: goodput {c['goodput_mb']!r} offered "
              f"{c['offered_mb']!r} wasted {c['wasted_mb']!r}")
        exact = ("restart", "kills", "host_loss_kills", "transfer_kills",
                 "restarts", "retired", "completed")
        check({k: c[k] for k in exact} == {k: g["churn"][k] for k in exact}
              and (off.completed, off.sim_s, off.waves, on.sim_s, on.waves)
              == (g["completed"], g["sim_s"], g["waves"], g["online_sim_s"],
                  g["online_waves"])
              and all(close_to(c[k], g["churn"][k]) for k in c
                      if k not in exact)
              and close_to(off.total_energy_j, g["energy_j"])
              and close_to(off.total_gb, g["gb"]),
              f"{tag}: {c} vs JAX {g}")
        churn[mode] = c
    workloads_launches = tl.tick_loop.launches
    check(workloads_launches == waves,
          f"21c: {workloads_launches} launches for {waves} waves")
    r, sc = churn["resume"], churn["scratch"]
    print(f"[21c workloads] HTTP grid (8 cells x {HTTP_REQUESTS} requests, "
          f"both drivers, {http_s:.1f} s): offline == online per request, "
          f"completed, violations, sim_s and waves as JAX's, energy and GB "
          f"to {FLEET_RTOL}; violations {', '.join(viol)}.  Faults: resume "
          f"{r['kills']} kills, goodput_frac {r['goodput_frac']}, "
          f"goodput_mb == offered_mb == {r['offered_mb']} bit for bit, "
          f"wasted 0.0; scratch {sc['kills']} kills, goodput_frac "
          f"{sc['goodput_frac']:.4f}, wasted {sc['wasted_mb']:.1f} MB; "
          f"offline == online ledgers and transfers, as JAX's.  "
          f"{workloads_launches} launches for {waves} waves", flush=True)
    print(f"[21 online] phase time {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return {"launches": {"online": online_launches,
                         "workloads": workloads_launches},
            "wave_ms": wave_ms, "wave_launch_ms": sum(ks) / n_waves,
            "wave_plain_ms": wave_plain_ms,
            "wave_bound_ms": bound_ms / n_waves, "wave_bound_by": bound_by,
            "wall_s": wall}


def phase_learn(dev) -> dict:
    """Phase 18: learned control on the card (see the module docstring)."""
    import tempfile

    import numpy as np
    import torch

    from repro_torch import api, learn
    from repro_torch.core import types
    from repro_torch.kernels import tick_loop as tl

    t_phase = time.perf_counter()
    jax_params, gold = golden_learned()
    teacher = learn_teacher()
    jax_learned = learn.LearnedController(params=jax_params, sla=teacher.sla,
                                          label="learned")
    check(jax_learned.digest == gold["digest"],
          "learn_full.json: params digest differs from the golden's")

    # (a) teacher capture on the observed eager step, and BC, on the card
    cells = learn_teacher_cells()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    feats, labels = learn.teacher_dataset(cells, device=dev)
    capture_s = time.perf_counter() - t0
    observed = learn.run_observed(cells, device=dev)
    before = tl.tick_loop.launches
    _, runs = api.run_groups(cells, device=dev)
    check(tl.tick_loop.launches - before == len(runs) == 1,
          f"teacher cells: {tl.tick_loop.launches - before} launches for "
          f"{len(runs)} groups")
    (run,), = [runs]
    for b, i in enumerate(run.indices):
        obs_run = observed[i]
        for name, kern, seen in zip(run.metrics._fields, run.metrics,
                                    obs_run.metrics):
            check(np.array_equal(kern[b].cpu().numpy(), seen),
                  f"18a cell {i}: observed {name} != the kernel's")
        for name, kern, seen in zip(run.sim._fields, run.sim, obs_run.sim):
            check(np.array_equal(kern[b].cpu().numpy(), seen),
                  f"18a cell {i}: observed final {name} != the kernel's")
    t0 = time.perf_counter()
    params, hist = learn.bc_train(feats, labels,
                                  key=learn.seed_everything(0),
                                  steps=LEARN_BC_STEPS, device=dev)
    fit_s = time.perf_counter() - t0
    check(hist["loss"][-1] < hist["loss"][0], "BC loss did not decrease")
    port_learned = learn.LearnedController(params=params, sla=teacher.sla,
                                           label="learned")
    print(f"[18 learn] (a) teacher capture (EEMT, Chameleon x small/mixed, "
          f"900 s) on the observed eager step: {feats.shape[0]} samples "
          f"(JAX: {gold['train']['samples']}) in {capture_s:.2f} s; "
          f"observed metrics and final state bit-equal to the kernel's run "
          f"(1 launch); BC {LEARN_BC_STEPS} steps on the card in "
          f"{fit_s:.2f} s, loss {hist['loss'][0]:.6f} -> "
          f"{hist['loss'][-1]:.6f} (JAX {gold['train']['loss_first']:.6f} "
          f"-> {gold['train']['loss_last']:.6f})", flush=True)

    # (b) kernel == plain version: both policies, two environments
    envs = {"reference": None,
            "dvfs hp race": api.make_environment("dvfs", **DVFS_TUNE)}
    t_plain = 0.0
    for pname, ctrl in (("JAX BC", jax_learned), ("port BC", port_learned)):
        for en, env in envs.items():
            scs = [dataclasses.replace(sc, controller=ctrl, environment=env,
                                       executor="cuda")
                   for sc in learn_teacher_cells()]
            (key, rows), = groups_on_card(scs, dev)
            kern = call(tl.tick_loop, key, rows)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            plain = call(tl.tick_loop_reference, key, rows)
            torch.cuda.synchronize()
            t_plain += time.perf_counter() - t0
            equal, err = compare_outputs(kern, plain)
            check(equal, f"18b {pname} / {en}: kernel != plain version "
                         f"(max |err| {err})")
            print(f"[18 learn] (b) {pname} policy, {en}: fig2 smoke cells "
                  f"(Chameleon x small/mixed, 900 s): kernel == plain "
                  f"(final rows and 7 traces bit-equal); fsm (controller "
                  f"ticks) {kern[1][:, 0].tolist()}; executed ticks "
                  f"{executed_lane_ticks(kern[2], key.n_steps)}", flush=True)
    # ... and on (c)'s own learned group: Chameleon and CloudLab x small
    # and mixed, whose bandwidth features differ
    exp = learn.evaluation_experiment(jax_learned, smoke=False)
    scs = [dataclasses.replace(c.scenario, executor="cuda")
           for c in exp.cells() if c.labels["tool"] == "learned"]
    (key, rows), = groups_on_card(scs, dev)
    kern = call(tl.tick_loop, key, rows)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain = call(tl.tick_loop_reference, key, rows)
    torch.cuda.synchronize()
    t_eval_plain = time.perf_counter() - t0
    equal, err = compare_outputs(kern, plain)
    check(equal, f"18b JAX BC / learn-eval learned group: kernel != plain "
                 f"version (max |err| {err})")
    print(f"[18 learn] (b) JAX BC policy, the learn-eval grid's learned "
          f"group ({len(scs)} lanes, Chameleon and CloudLab x small/mixed, "
          f"900 s): kernel == plain (final rows and 7 traces bit-equal); "
          f"fsm (controller ticks) {kern[1][:, 0].tolist()}; executed ticks "
          f"{executed_lane_ticks(kern[2], key.n_steps)}; plain version "
          f"{t_eval_plain:.1f} s", flush=True)
    del kern, plain
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res_t = api.sweep(tune_scenarios(learned=jax_params), device=dev)
    wall_t = time.perf_counter() - t0
    peak_t = torch.cuda.max_memory_allocated()
    grs_t = groups_on_card(tune_scenarios(executor="cuda",
                                          learned=jax_params), dev)
    check(len(grs_t) == 1, f"learned tune split into {len(grs_t)} groups")
    (key_t, rows_t), = grs_t
    kern_t = call(tl.tick_loop, key_t, rows_t)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain_t = call(tl.tick_loop_reference, key_t, rows_t)
    torch.cuda.synchronize()
    plain_t_ms = (time.perf_counter() - t0) * 1e3
    eq_t, err_t = compare_outputs(kern_t, plain_t)
    check(eq_t, f"learned tune: kernel != plain version (max |err| {err_t})")
    del plain_t
    ticks_t = executed_lane_ticks(kern_t[2], key_t.n_steps)
    cticks_t = executed_ctrl_ticks(kern_t[2], key_t.n_steps,
                                   key_t.ctrl_every)
    ms_t = time_cuda(lambda: call(tl.tick_loop, key_t, rows_t), 5)
    bound_t, by_t, nbytes_t, ops_t = bound_of(grs_t, [ticks_t], [cticks_t])
    b, n = rows_t[1].shape
    print(f"[18 learn] (b) learned tune (JAX BC policy at phase 6's SLA "
          f"points and schedules): {b} lanes x {n} ticks, 1 group: kernel "
          f"== plain "
          f"on all lanes; kernel {ms_t:.3f} ms (median of 5); {ticks_t} "
          f"executed lane-ticks ({cticks_t} controller ticks) = "
          f"{ticks_t / (ms_t / 1e3):.4g} lane-ticks/s; bound "
          f"{bound_t:.4f} ms by {by_t} ({nbytes_t} B, {ops_t} ops); plain "
          f"{plain_t_ms:.1f} ms; peak memory {peak_t} B; sweep end to end "
          f"{wall_t:.3f} s; {sum(r.completed for r in res_t)} completed; "
          f"plain versions of the smoke cells {t_plain:.1f} s", flush=True)
    del kern_t, rows_t, grs_t, res_t

    # (c) the evaluation grid through the kernel (main path) vs the golden
    n_groups = api.group_count([c.scenario for c in exp.cells()],
                               device=dev)
    check(n_groups == gold["group_count"],
          f"learn eval: group_count {n_groups} != JAX's "
          f"{gold['group_count']}")
    tl.tick_loop.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    report = learn.evaluate(jax_learned, smoke=False, timing="cold",
                            device=dev)
    eval_wall = time.perf_counter() - t0
    eval_launches = tl.tick_loop.launches
    check(eval_launches == 1,
          f"learn eval: {eval_launches} launches for one grid of "
          f"{n_groups} groups")
    eval_scs = [dataclasses.replace(c.scenario, executor="cuda")
                for c in exp.cells()]
    eval_grs = groups_on_card(eval_scs, dev)
    grouped_vs_groups(eval_scs, dev, [call(tl.tick_loop, k, r)
                                      for k, r in eval_grs], "learn eval")
    want = {(r["testbed"], r["dataset"], r["tool"]): r for r in gold["rows"]}
    near, n_exact = [], 0
    for r in report.rows():
        cell = (r["testbed"], r["dataset"], r["tool"])
        w = want[cell]
        if r["tool"] == "learned":
            m = gold["margins"][f"{cell[0]}/{cell[1]}"]["margin"]
            if m is not None and m <= LEARN_MARGIN:
                near.append((cell, m))
                continue
        check(bool(r["completed"]) == w["completed"]
              and r["time_s"] == w["time_s"],
              f"learn eval {cell}: completed/time_s {r['completed']}/"
              f"{r['time_s']} vs {w['completed']}/{w['time_s']}")
        for fld in ("energy_j", "avg_tput_MBps"):
            check(abs(r[fld] - w[fld]) <= 1e-5 * abs(w[fld]),
                  f"learn eval {cell}: {fld} {r[fld]} vs {w[fld]}")
        n_exact += all(r[f] == w[f] for f in ("time_s", "energy_j",
                                              "avg_tput_MBps",
                                              "avg_power_w"))
    for cell, m in near:
        print(f"[18 learn] (c) NEAR TIE, not held: {cell} margin {m:.3e} "
              f"<= {LEARN_MARGIN} of the largest |logit|", flush=True)
    print(f"[18 learn] (c) evaluate(JAX BC policy, smoke=False): "
          f"{len(report)} cells in {n_groups} groups ({eval_launches} "
          f"launch, bit-equal to the groups' own launches; PR 17-18: "
          f"{n_groups}), wall {eval_wall:.3f} s (PR 18: 0.088-0.093); vs "
          f"learn_full.json: "
          f"completed/time_s exact, energy/tput rtol 1e-5 on "
          f"{len(report) - len(near)} cells ({len(near)} near ties), "
          f"{n_exact} bit-exact; learned cells' smallest margins "
          + ", ".join(f"{k} {v['margin']:.3g}"
                      for k, v in gold["margins"].items()), flush=True)

    # (d) the port's BC policy against its teacher (the reference's
    # acceptance metric)
    rep_d = learn.evaluate(port_learned, rivals={"EEMT": teacher},
                           smoke=True, timing="cold", device=dev)
    ratios = learn.vs_teacher(rep_d, "EEMT")
    check(set(ratios) == {"chameleon/small", "chameleon/mixed"},
          f"vs_teacher cells {sorted(ratios)}")
    for cell, r in ratios.items():
        check(r["learned_completed"] and r["teacher_completed"]
              and r["energy_ratio"] <= LEARN_BC_RATIO,
              f"18d {cell}: the port's BC policy {r}")
    print(f"[18 learn] (d) the port's BC policy vs EEMT: "
          + "; ".join(f"{c} energy x{r['energy_ratio']:.4f} tput "
                      f"x{r['tput_ratio']:.4f}" for c, r in ratios.items())
          + f" (<= {LEARN_BC_RATIO}, both completed; JAX's policy: "
          + "; ".join(f"{c} x{r['energy_ratio']:.4f}" for c, r in
                      gold["vs_teacher"].items() if c.startswith("cham"))
          + ")", flush=True)

    # (e) REINFORCE on the card, twice
    pg = learn.PGConfig(**LEARN_PG)
    sla_me = types.SLA(policy=types.SLAPolicy.MIN_ENERGY)
    outs = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs.append(learn.pg_train(learn_pg_scenarios(),
                                   key=learn.seed_everything(0), sla=sla_me,
                                   pg=pg, device=dev)
                    + (time.perf_counter() - t0,))
    (p1, h1, s1), (p2, h2, s2) = outs
    check(h1["cost"].min() < h1["cost"][0],
          f"PG cost did not improve: {h1['cost'].tolist()}")
    check(all(np.isfinite(v).all() for v in p1.values()),
          "PG params not finite")
    check(all(np.array_equal(p1[k], p2[k]) for k in p1)
          and np.array_equal(h1["cost"], h2["cost"]),
          "PG is not bit-deterministic on the card")
    print(f"[18 learn] (e) pg_train ({LEARN_PG_LANES} lanes x 120 s, "
          f"{pg.steps} updates): cost {[round(float(c), 4) for c in h1['cost']]}"
          f" (min < first), params finite, two runs bit-equal; "
          f"{s1:.1f} / {s2:.1f} s = {s1 / (pg.steps + 1):.2f} s per rollout "
          f"(greedy reference + {pg.steps} updates)", flush=True)

    # (f) the figure Experiments (main paths) against the goldens and the
    # sweep of the same scenarios; a cached re-run executes no cell
    with open(os.path.join(ROOT, "tests", "torch_goldens",
                           "fig2_full.json")) as f:
        gold_fig2 = json.load(f)
    with open(os.path.join(ROOT, "tests", "torch_goldens",
                           "fig_dvfs_full.json")) as f:
        gold_dvfs = json.load(f)
    launches = {"learn_eval": eval_launches}
    for name, exp, golden, axes in (
            ("fig2_experiment", fig2_experiment(), gold_fig2,
             ("testbed", "dataset", "tool")),
            ("fig_dvfs_experiment", fig_dvfs_experiment(),
             gold_dvfs["fig_dvfs"], ("tool", "fcap", "cores")),
            ("greendataflow_experiment", greendataflow_experiment(),
             gold_dvfs["greendataflow"],
             ("testbed", "tech", "idle", "tool"))):
        cells_f = exp.cells()
        swept = api.sweep([c.scenario for c in cells_f], device=dev)
        with tempfile.TemporaryDirectory() as cache:
            tl.tick_loop.launches = 0
            t0 = time.perf_counter()
            rep = exp.run(cache=cache, cells=cells_f, device=dev)
            wall = time.perf_counter() - t0
            launches[name] = tl.tick_loop.launches
            check(launches[name] == 1,
                  f"{name}: {launches[name]} launches for one grid of "
                  f"{golden['group_count']} groups")
            again = exp.run(cache=cache, cells=cells_f, device=dev)
            check(again.meta["executed"] == 0
                  and again.meta["cache_hits"] == len(cells_f),
                  f"{name}: cached re-run executed {again.meta['executed']}")
            check(all(np.array_equal(rep[m], again[m])
                      for m in rep.metrics), f"{name}: cached rows differ")
        want_f = {tuple(r[a] for a in axes): r for r in golden["rows"]}
        n_exact = 0
        for row, res in zip(rep.rows(), swept):
            check(all(row[m] == float(getattr(res, m))
                      for m in api.report.RESULT_METRICS),
                  f"{name} {row}: Experiment row != the sweep's")
            w = want_f[tuple(row[a] for a in axes)]
            check(bool(row["completed"]) == w["completed"]
                  and row["time_s"] == w["time_s"],
                  f"{name} {row}: completed/time_s vs golden {w}")
            for fld in ("energy_j", "avg_tput_MBps"):
                check(abs(row[fld] - w[fld]) <= 1e-5 * abs(w[fld]),
                      f"{name} {row}: {fld} vs golden {w[fld]}")
            n_exact += all(row[f] == w[f] for f in ("time_s", "energy_j",
                                                    "avg_tput_MBps",
                                                    "avg_power_w"))
        print(f"[18 learn] (f) {name}: {len(rep)} cells, {launches[name]} "
              f"launch (PR 17-18: {golden['group_count']}), wall "
              f"{wall:.3f} s; rows == the sweep's; vs the "
              f"golden completed/time_s exact, energy/tput rtol 1e-5, "
              f"{n_exact} bit-exact; cached re-run executed 0 of "
              f"{len(cells_f)}", flush=True)
    print(f"[18 learn] phase time {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return {"launches": launches, "tune_ms": ms_t,
            "tune_plain_ms": plain_t_ms, "tune_bound_ms": bound_t,
            "tune_bound_by": by_t}


# ------------------------------------------------- attention and serving --

# Phase 7: (H, Hkv, hd) of qwen3-0.6b and qwen2-0.5b; tolerances of
# tests/test_kernels.py.
FLASH_HEADS = {"qwen3": (16, 8, 128), "qwen2": (14, 2, 64)}
FLASH_BATCH, FLASH_T = (1, 8), (128, 384, 2048)
FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# Kernels 2 (phase 7) and 3 (phase 10) on a block of queries at an offset
# against every key (context-parallel attention: query row i at position
# q_offset + i, keys from 0), both routes, B 1: (name, (H, Hkv, hd), Tq,
# Tk, q_offset).  qwen2-0.5b's 14/2 of 64 at T / 2 (the second of two
# blocks) and at 0 (the first: its last 1,024 keys no query reaches, so
# the backward writes their dk, dv as zeros); qwen3's 16/8 of 128 at
# T / 4 (the second of four blocks; keys past 1,024 unreached).
FLASH_OFFSET = (("qwen2", (14, 2, 64), 1024, 2048, 1024),
                ("qwen2", (14, 2, 64), 1024, 2048, 0),
                ("qwen3", (16, 8, 128), 512, 2048, 512))
# Kernels 2 (phase 7) and 3 (phase 10) at a rank's heads in phase 24 (h)'s
# partitioned step (tp 2), at the trainer's B 2 x T 4,096 (BWD_TRAIN_BT),
# causal, both routes: (name, (H, Hkv, hd), window) of recurrentgemma-2b's
# 5/1 of 256 with its window, qwen2-vl-2b's 6/1 of 128 and whisper-small's
# decoder 6/6 of 64.
TP_HEADS = (("recurrentgemma_tp2", (5, 1, 256), 2048),
            ("qwen2_vl_tp2", (6, 1, 128), 0),
            ("whisper_tp2", (6, 6, 64), 0))
# Timed at qwen3's heads, bf16, causal: (B, T).  Past FLASH_FULL_T only the
# last FLASH_TAIL query rows are held to the plain version.
FLASH_TIMED = ((1, 2048), (8, 2048), (1, 32768))
FLASH_FULL_T, FLASH_TAIL = 2048, 256
# recurrentgemma-2b's local attention: MQA 10/1 of 256, window 2,048; its
# cases (window 0 and 2,048) and timed shapes (B, T).
FLASH_256 = (10, 1, 256)
FLASH_256_WINDOW, FLASH_256_T = 2048, (200, 2048)
FLASH_256_TIMED = ((1, 2048), (8, 2048))
# The float32 (FMA) kernels' timed shape (B, T) and head groupings (H, Hkv,
# hd, window; causal): qwen3's, qwen2's and recurrentgemma's (phases 7 and
# 10).  F32_EARLIER: the first design's times there (one 4-warp block of
# 4 x 4 scalar tiles), forward and backward, as PERF.md's kernel table has
# them (H100 80GB HBM3, 700 W).
FLASH_F32_TIMED = (1, 2048)
F32_HEADS = {"qwen3": (16, 8, 128, 0), "qwen2": (14, 2, 64, 0),
             "recurrentgemma": (10, 1, 256, 2048)}
F32_EARLIER = {"qwen3": ("1.0302 ms", "3.7726 ms"),
               "qwen2": ("0.6069 ms", "2.8049 ms"),
               "recurrentgemma": ("2.1165 ms", "10.9111 ms")}
# Weights by position (tests/torch_goldens/make_lm_golden.py CHECK_LEAVES).
GOLDEN_WEIGHT_CHECK = {"embed": (0, slice(0, 4)),
                       "blocks/attn/wq": (27, -1, slice(-4, None)),
                       "blocks/mlp/wd": (13, 5, slice(0, 4))}
# Phase 8: the float32 golden's tolerance on top-5 logits and norms, relative
# to the row's largest top-5 |logit| / its norm (measured on the H100 80GB
# HBM3 at 700 W: see PERF.md).
GOLDEN_RTOL = 1e-3
# Phases 9 and 16: serving shapes.  New tokens cut from 128 to 64 (the
# cuts named for the next slice that adds time: phase 16's, then phase
# 9's) when the whole script read 1,141.7 s of its 1,200 with phase 24
# (d)-(f); recurrentgemma's ring of 2,048 still wraps at 2,048 + 64.
GEN_BATCH, GEN_PROMPT, GEN_NEW = 8, 2048, 64
CB_SLOTS, CB_MAX_LEN, CB_REQUESTS, CB_MAX_NEW = 16, 4096, 64, 64
CB_PROMPT = (128, 2048)     # prompt lengths, uniform, numpy seed 2
# Phase 9a: kernel vs plain prefill logits in bf16, as a share of the
# largest |logit| (see PERF.md).
SERVE_BF16_TOL = 0.05


def flash_bound(B, H, Hkv, hd, Tq, Tk, causal, elem_bytes,
                ops_per_s=BF16_TENSOR_OPS_PER_S, window=0):
    """(bound_ms, bound_by, flops, bytes) of one attention call
    (``cost.flash_fwd``: 4 hd operations per reachable (query, key) pair
    and head; q, k, v read and o written once) at ``ops_per_s`` (the
    tensor cores' bf16 rate; float32's 67 TFLOP/s for float32 inputs)."""
    flops, nbytes = cost.flash_fwd(B, H, Hkv, hd, Tq, Tk, causal,
                                   elem_bytes, window)
    t_ops = flops / ops_per_s * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes
            else "bytes", flops, nbytes)


def reset_attention_counts():
    """Sets the attention kernels' launch counts, in all and by route, to 0
    (just before a main path runs)."""
    from repro_torch.kernels.flash_attention import (flash_attention_bhtd,
                                                     flash_attention_bwd_bhtd)

    for fn in (flash_attention_bhtd, flash_attention_bwd_bhtd):
        fn.launches = 0
        fn.route_launches = {"wgmma": 0, "fma": 0}


def check_bf16_route(where):
    """Every attention launch since :func:`reset_attention_counts` took the
    bf16 (wgmma) route."""
    from repro_torch.kernels.flash_attention import (flash_attention_bhtd,
                                                     flash_attention_bwd_bhtd)

    for fn in (flash_attention_bhtd, flash_attention_bwd_bhtd):
        check(fn.route_launches == {"wgmma": fn.launches, "fma": 0},
              f"{where}: {fn.__name__} took routes {fn.route_launches} "
              f"in {fn.launches} launches")


def fma_launches():
    """(forward, backward) launches of the float32 (FMA) attention kernels
    so far."""
    from repro_torch.kernels.flash_attention import (flash_attention_bhtd,
                                                     flash_attention_bwd_bhtd)

    return (flash_attention_bhtd.route_launches["fma"],
            flash_attention_bwd_bhtd.route_launches["fma"])


def phase_flash(dev) -> dict:
    """[7 flash] kernel vs plain version, timed at the serving shapes."""
    import itertools

    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import (attention_ref,
                                                     flash_attention_bhtd)

    g = torch.Generator().manual_seed(7)
    worst = {"float32": 0.0, "bfloat16": 0.0}
    n = 0
    for (name, (H, Hkv, hd)), B, T, causal, window, dname, lse in \
            itertools.product(FLASH_HEADS.items(), FLASH_BATCH, FLASH_T,
                              (True, False), (0, 256),
                              ("bfloat16", "float32"), (False, True)):
        dt = getattr(torch, dname)
        q, k, v = [torch.randn(B, T, h, hd, generator=g).to(dev, dt)
                   .transpose(1, 2) for h in (H, Hkv, Hkv)]
        kw = dict(causal=causal, window=window, return_lse=lse)
        got = flash_attention_bhtd(q, k, v, **kw)
        want = attention_ref(q, k, v, **kw)
        if not lse:
            got, want = (got,), (want,)
        err = max(float((a.float() - b.float()).abs().max())
                  for a, b in zip(got, want))
        check(err <= FLASH_TOL[dname],
              f"flash attention {name} B={B} T={T} causal={causal} "
              f"window={window} {dname} lse={lse}: max |err| {err}")
        worst[dname] = max(worst[dname], err)
        n += 1
        del q, k, v, got, want
    torch.cuda.synchronize()
    print(f"[7 flash] kernel == plain version on {n} cases (heads "
          f"{FLASH_HEADS}; B {FLASH_BATCH}; T {FLASH_T}; causal or not; "
          f"window 0/256; bf16/f32; with/without LSE): max |err| bf16 "
          f"{worst['bfloat16']:.3g} (tol 2e-2), f32 {worst['float32']:.3g} "
          f"(tol 2e-5)", flush=True)
    worst = {"float32": 0.0, "bfloat16": 0.0}
    n = 0
    for (name, (H, Hkv, hd), Tq, Tk, off), dname, lse in itertools.product(
            FLASH_OFFSET, ("bfloat16", "float32"), (False, True)):
        dt = getattr(torch, dname)
        q = torch.randn(1, Tq, H, hd, generator=g).to(dev, dt).transpose(1, 2)
        k, v = [torch.randn(1, Tk, Hkv, hd, generator=g).to(dev, dt)
                .transpose(1, 2) for _ in range(2)]
        kw = dict(return_lse=lse, q_offset=off)
        got = flash_attention_bhtd(q, k, v, **kw)
        want = attention_ref(q, k, v, **kw)
        if not lse:
            got, want = (got,), (want,)
        err = max(float((a.float() - b.float()).abs().max())
                  for a, b in zip(got, want))
        check(err <= FLASH_TOL[dname],
              f"flash attention {name} Tq={Tq} Tk={Tk} q_offset={off} "
              f"{dname} lse={lse}: max |err| {err}")
        worst[dname] = max(worst[dname], err)
        n += 1
        del q, k, v, got, want
    torch.cuda.synchronize()
    print(f"[7 flash] with a query offset (a block of queries against every "
          f"key, causal): kernel == plain version on {n} cases "
          f"({FLASH_OFFSET}; bf16/f32; with/without LSE): max |err| bf16 "
          f"{worst['bfloat16']:.3g} (tol 2e-2), f32 {worst['float32']:.3g} "
          f"(tol 2e-5)", flush=True)
    worst = {"float32": 0.0, "bfloat16": 0.0}
    n = 0
    B, T = BWD_TRAIN_BT
    for (name, (H, Hkv, hd), window), dname in itertools.product(
            TP_HEADS, ("bfloat16", "float32")):
        dt = getattr(torch, dname)
        q, k, v = [torch.randn(B, T, h, hd, generator=g).to(dev, dt)
                   .transpose(1, 2) for h in (H, Hkv, Hkv)]
        kw = dict(window=window, return_lse=True)
        got = flash_attention_bhtd(q, k, v, **kw)
        want = attention_ref(q, k, v, **kw)
        err = max(float((a.float() - b.float()).abs().max())
                  for a, b in zip(got, want))
        check(err <= FLASH_TOL[dname],
              f"flash attention {name} ({H}/{Hkv} of {hd}) B={B} T={T} "
              f"window={window} {dname}: max |err| {err}")
        worst[dname] = max(worst[dname], err)
        n += 1
        del q, k, v, got, want
    torch.cuda.synchronize()
    print(f"[7 flash] at a rank's heads in phase 24 (h) (tp 2): kernel == "
          f"plain version on {n} cases ({TP_HEADS}; B {B} x T {T}, causal; "
          f"bf16/f32; o and LSE): max |err| bf16 {worst['bfloat16']:.3g} "
          f"(tol 2e-2), f32 {worst['float32']:.3g} (tol 2e-5)", flush=True)

    H, Hkv, hd = FLASH_HEADS["qwen3"]
    out = {}
    for B, T in FLASH_TIMED:
        q, k, v = [torch.randn(B, T, h, hd, generator=g).to(
            dev, torch.bfloat16).transpose(1, 2) for h in (H, Hkv, Hkv)]
        ms = time_cuda(lambda: flash_attention_bhtd(q, k, v), 5)
        lib_ms = time_cuda(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True), 5)
        bound_ms, bound_by, flops, nbytes = flash_bound(B, H, Hkv, hd, T, T,
                                                        True, 2)
        o = flash_attention_bhtd(q, k, v)
        if T <= FLASH_FULL_T:
            plain_ms = time_cuda(lambda: attention_ref(q, k, v), 5)
            err = float((o.float() - attention_ref(q, k, v).float())
                        .abs().max())
            rows = "all rows"
        else:
            # the full plain version would need a 68.7 GB score tensor
            plain_ms = None
            tail = FLASH_TAIL
            ref = attention_ref(q[:, :, -tail:], k, v, q_offset=T - tail)
            err = float((o[:, :, -tail:].float() - ref.float()).abs().max())
            rows = f"last {tail} rows"
        check(err <= FLASH_TOL["bfloat16"],
              f"flash attention B={B} T={T}: max |err| {err} ({rows})")
        plain = "not run" if plain_ms is None else f"{plain_ms:.3f} ms"
        print(f"[7 flash] qwen3 bf16 (wgmma kernel) causal B={B} T={T}: "
              f"kernel {ms:.4f} ms "
              f"(median of 5); bound {bound_ms:.4f} ms by {bound_by} "
              f"({flops} FLOP, {nbytes} B); x bound {ms / bound_ms:.1f}; "
              f"plain {plain}; scaled_dot_product_attention {lib_ms:.4f} "
              f"ms; max |err| {err:.3g} ({rows})", flush=True)
        out[(B, T)] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                           bound_ms=bound_ms, bound_by=bound_by,
                           max_abs_err=err)
        del q, k, v, o

    # recurrentgemma-2b's heads: hd 256, MQA, causal, window 0 / 2,048
    H, Hkv, hd = FLASH_256
    worst256 = {"float32": 0.0, "bfloat16": 0.0}
    n = 0
    for B, T, window, dname in itertools.product(
            FLASH_BATCH, FLASH_256_T, (0, FLASH_256_WINDOW),
            ("bfloat16", "float32")):
        dt = getattr(torch, dname)
        q, k, v = [torch.randn(B, T, h, hd, generator=g).to(dev, dt)
                   .transpose(1, 2) for h in (H, Hkv, Hkv)]
        err = float((flash_attention_bhtd(q, k, v, window=window).float()
                     - attention_ref(q, k, v, window=window).float())
                    .abs().max())
        check(err <= FLASH_TOL[dname],
              f"flash attention hd 256 B={B} T={T} window={window} "
              f"{dname}: max |err| {err}")
        worst256[dname] = max(worst256[dname], err)
        n += 1
        del q, k, v
    print(f"[7 flash] hd 256 (heads {FLASH_256}): kernel == plain version "
          f"on {n} cases (B {FLASH_BATCH}; T {FLASH_256_T}; causal, window "
          f"0/{FLASH_256_WINDOW}; bf16/f32): max |err| bf16 "
          f"{worst256['bfloat16']:.3g} (tol 2e-2), f32 "
          f"{worst256['float32']:.3g} (tol 2e-5)", flush=True)
    for B, T in FLASH_256_TIMED:
        q, k, v = [torch.randn(B, T, h, hd, generator=g).to(
            dev, torch.bfloat16).transpose(1, 2) for h in (H, Hkv, Hkv)]
        w = FLASH_256_WINDOW
        ms = time_cuda(lambda: flash_attention_bhtd(q, k, v, window=w), 5)
        plain_ms = time_cuda(lambda: attention_ref(q, k, v, window=w), 5)
        # at T <= window the window masks nothing: plain causal attention
        lib_ms = time_cuda(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True), 5)
        bound_ms, bound_by, flops, nbytes = flash_bound(B, H, Hkv, hd, T, T,
                                                        True, 2)
        print(f"[7 flash] recurrentgemma hd 256 bf16 (wgmma kernel) causal "
              f"window {w} "
              f"B={B} T={T}: kernel {ms:.4f} ms (median of 5); bound "
              f"{bound_ms:.4f} ms by {bound_by} ({flops} FLOP, {nbytes} "
              f"B); x bound {ms / bound_ms:.1f}; plain {plain_ms:.3f} ms; "
              f"scaled_dot_product_attention {lib_ms:.4f} ms", flush=True)
        del q, k, v

    # the float32 (FMA) kernel at each grouping of F32_HEADS
    B, T = FLASH_F32_TIMED
    shapes = {}
    for name, (H, Hkv, hd, w) in F32_HEADS.items():
        q, k, v = [torch.randn(B, T, h, hd, generator=g).to(dev)
                   .transpose(1, 2) for h in (H, Hkv, Hkv)]
        ms = time_cuda(lambda: flash_attention_bhtd(q, k, v, window=w), 5)
        plain_ms = time_cuda(lambda: attention_ref(q, k, v, window=w), 5)
        # at T <= window the window masks nothing: plain causal attention
        check(w == 0 or w >= T, "F32_HEADS' windows reach all of T")
        lib_ms = time_cuda(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True), 5)
        bound_ms, bound_by, flops, nbytes = flash_bound(
            B, H, Hkv, hd, T, T, True, 4, F32_OPS_PER_S, window=w)
        print(f"[7 flash] {name} f32 (FMA kernel) {H}/{Hkv} of {hd} causal "
              f"window {w} B={B} T={T}: kernel {ms:.4f} ms (median of 5); "
              f"bound {bound_ms:.4f} ms by {bound_by} at the 67 TFLOP/s "
              f"float32 rate ({flops} FLOP, {nbytes} B); share "
              f"{bound_ms / ms:.3f}; plain {plain_ms:.3f} ms; "
              f"scaled_dot_product_attention f32 {lib_ms:.4f} ms; the first "
              f"design {F32_EARLIER[name][0]}", flush=True)
        shapes[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                            bound_ms=bound_ms, bound_by=bound_by)
        del q, k, v
    f32 = dict(shapes["qwen3"],
               max_abs_err=max(worst["float32"], worst256["float32"]),
               shapes=shapes)
    torch.cuda.empty_cache()
    res = dict(out[(GEN_BATCH, GEN_PROMPT)])
    res["max_abs_err"] = max(res["max_abs_err"], worst["bfloat16"],
                             worst256["bfloat16"])
    return {"bf16": res, "f32": f32}


# Phase 10: the backward's cases (BWD_HEADS x BWD_BATCH x BWD_T, causal or
# not, window 0 or 256; non-causal only where T is a multiple of the 128-key
# block, JAX's contract; and each head grouping at the trainer's B 2 x T
# 4,096 (BWD_TRAIN_BT), causal) and tolerances.  BWD_HEADS: phase 7's, and
# those of the archs phase 26 trains that phase 7 does not hold: whisper's
# 12/12 of 64 (GQA 1), olmo-1b's 16/16 of 128 (GQA 1) and qwen2-vl-2b's 12/2
# of 128 (GQA 6); and a rank's heads at tp 2 in phase 24 (e, g): qwen3-moe's
# 16/2 of 128 (GQA 8), olmo-1b's and moonshot's 8/8 of 128.  float32:
# tests/test_kernels.py:181-182 (atol 5e-5 + rtol 5e-5 element-wise).  bf16:
# 1e-2 of each gradient's largest magnitude -- both sides round every output
# once to bf16 (2^-8 of a value), and float32 sums in another order can
# flip that rounding: two bf16 ulps of the largest value, with a margin.
BWD_HEADS = dict(FLASH_HEADS, whisper=(12, 12, 64), olmo=(16, 16, 128),
                 qwen2_vl=(12, 2, 128), qwen3_moe_tp2=(16, 2, 128),
                 tp2_8_8=(8, 8, 128))
BWD_BATCH, BWD_T = (1, 2), (128, 200, 384, 1000, 2048)
BWD_TRAIN_BT = (2, 4096)
BWD_F32_TOL = 5e-5
BWD_BF16_TOL = 1e-2
BWD_TIMED = ((1, 2048), (8, 2048))
BWD_F32_TIMED = (1, 2048)
# Phase 11: the float32 train golden's tolerances (full width and depth,
# cuBLAS float32 against XLA on the CPU: sums in another order through 28
# layers): loss and ce, relative; gnorm, each leaf's step-1 gradient norm
# and step 1's global norm, relative; gnorm_later, the later steps'
# global norm; lr, relative; grad, a step-1 gradient slice, x the slice's
# largest |g|; w, a step-2 weight where |g| at step 1 exceeds ``floor`` of
# its slice's largest |g| (Adam's first step is sign-like); elsewhere 2 lr
# per step.
TRAIN_TOL = dict(loss=1e-5, gnorm=1e-4, gnorm_later=1e-4, lr=1e-6,
                 grad=1e-3, w=5e-5, floor=1e-3)
# Phase 12: the trainer's cell (launch/train.py:158-161 ingest).
TRAIN_B, TRAIN_T, TRAIN_STEPS = 8, 2048, 6
TRAIN_CHECK_B = 2
# Phase 12, kernel step vs plain step in bf16 through 28 layers: loss and
# grad norm relative, and each leaf's gradient as a relative L2 distance
# (bf16 roundings flipped by another sum order compound over the layers).
TRAIN_BF16_LOSS_RTOL, TRAIN_BF16_GNORM_RTOL, TRAIN_BF16_GRAD_RTOL = \
    5e-3, 2e-2, 1e-1


def bwd_bound(B, H, Hkv, hd, T, causal, elem_bytes,
              ops_per_s=BF16_TENSOR_OPS_PER_S, window=0):
    """(bound_ms, bound_by, flops, bytes) of one attention backward
    (``cost.flash_bwd``: five products (s, dp, dq, dk, dv) = 10 hd
    operations per reachable (query, key) pair and query head; q, k, v, o,
    dO and lse read once and dq, dk, dv written once) at ``ops_per_s`` (as
    :func:`flash_bound`; a causal ``window`` > 0 reaches min(q + 1,
    window) keys from query q)."""
    flops, nbytes = cost.flash_bwd(B, H, Hkv, hd, T, T, causal, elem_bytes,
                                   window)
    t_ops = flops / ops_per_s * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes
            else "bytes", flops, nbytes)


def hold_bwd(where, dname, got, want, worst, max_abs):
    """Holds the backward kernels' (dq, dk, dv) to the plain version's at
    phase 10's tolerances (float32: BWD_F32_TOL + BWD_F32_TOL x |ref|
    element-wise; bf16: BWD_BF16_TOL of each gradient's largest magnitude)
    and keeps the worst error and |err| by dtype in ``worst``,
    ``max_abs``."""
    for gname, a, b in zip(("dq", "dk", "dv"), got, want):
        a, b = a.float(), b.float()
        diff = (a - b).abs()
        if dname == "float32":
            excess = float((diff - BWD_F32_TOL * b.abs()).max())
            ok = excess <= BWD_F32_TOL
            rel = float(diff.max())
        else:
            rel = float(diff.max()) / float(b.abs().max())
            ok = rel <= BWD_BF16_TOL
        check(ok, f"{where} {gname}: max |err| {float(diff.max())} (of max "
                  f"{float(b.abs().max())})")
        worst[dname] = max(worst[dname], rel)
        max_abs[dname] = max(max_abs[dname], float(diff.max()))


def phase_flash_bwd(dev) -> dict:
    """[10 flash bwd] kernel vs plain version, timed at the training
    shapes."""
    import itertools

    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import (attention_bwd_ref,
                                                     flash_attention_bhtd,
                                                     flash_attention_bwd_bhtd)

    g = torch.Generator().manual_seed(10)
    worst = {"float32": 0.0, "bfloat16": 0.0}
    max_abs = {"float32": 0.0, "bfloat16": 0.0}
    hd64 = {"float32": 0.0, "bfloat16": 0.0}
    dtypes = ("bfloat16", "float32")
    cases = [c for c in itertools.product(BWD_HEADS, BWD_BATCH, BWD_T,
                                          (True, False), (0, 256), dtypes)
             if c[3] or c[2] % 128 == 0]
    cases += [(name, *BWD_TRAIN_BT, True, 0, dname) for name in BWD_HEADS
              for dname in dtypes]
    for name, B, T, causal, window, dname in cases:
        H, Hkv, hd = BWD_HEADS[name]
        dt = getattr(torch, dname)
        q, k, v, do = [torch.randn(B, T, h, hd, generator=g).to(dev, dt)
                       .transpose(1, 2) for h in (H, Hkv, Hkv, H)]
        kw = dict(causal=causal, window=window)
        o, lse = flash_attention_bhtd(q, k, v, return_lse=True, **kw)
        got = flash_attention_bwd_bhtd(q, k, v, o, lse, do, **kw)
        want = attention_bwd_ref(q, k, v, o, lse, do, **kw)
        hold_bwd(f"flash backward {name} ({H}/{Hkv} of {hd}) B={B} T={T} "
                 f"causal={causal} window={window} {dname}", dname, got,
                 want, worst, hd64 if hd == 64 else max_abs)
        del q, k, v, do, o, lse, got, want
    # a block of queries at an offset, against every key (FLASH_OFFSET):
    # the key tiles past the last query get zero dk and dv
    for (name, (H, Hkv, hd), Tq, Tk, off), dname in itertools.product(
            FLASH_OFFSET, dtypes):
        dt = getattr(torch, dname)
        q, do = [torch.randn(1, Tq, H, hd, generator=g).to(dev, dt)
                 .transpose(1, 2) for _ in range(2)]
        k, v = [torch.randn(1, Tk, Hkv, hd, generator=g).to(dev, dt)
                .transpose(1, 2) for _ in range(2)]
        o, lse = flash_attention_bhtd(q, k, v, return_lse=True, q_offset=off)
        got = flash_attention_bwd_bhtd(q, k, v, o, lse, do, q_offset=off)
        want = attention_bwd_ref(q, k, v, o, lse, do, q_offset=off)
        where = (f"flash backward {name} ({H}/{Hkv} of {hd}) Tq={Tq} Tk={Tk} "
                 f"q_offset={off} {dname}")
        hold_bwd(where, dname, got, want, worst, hd64 if hd == 64 else
                 max_abs)
        if off + Tq < Tk:
            check(all(not bool(x[:, :, off + Tq:].any()) for x in got[1:]),
                  f"{where}: dk, dv of keys past the last query not zero")
        del q, k, v, do, o, lse, got, want
    cases += [(name, 1, Tq, True, 0, dname) for (name, _, Tq, _, _) in
              FLASH_OFFSET for dname in dtypes]
    # a rank's heads in phase 24 (h) (TP_HEADS), at the trainer's shape
    for (name, (H, Hkv, hd), window), dname in itertools.product(
            TP_HEADS, dtypes):
        B, T = BWD_TRAIN_BT
        q, k, v, do = [torch.randn(B, T, h, hd, generator=g).to(
            dev, getattr(torch, dname)).transpose(1, 2)
            for h in (H, Hkv, Hkv, H)]
        o, lse = flash_attention_bhtd(q, k, v, return_lse=True,
                                      window=window)
        got = flash_attention_bwd_bhtd(q, k, v, o, lse, do, window=window)
        want = attention_bwd_ref(q, k, v, o, lse, do, window=window)
        hold_bwd(f"flash backward {name} ({H}/{Hkv} of {hd}) B={B} T={T} "
                 f"window={window} {dname}", dname, got, want, worst,
                 hd64 if hd == 64 else max_abs)
        cases.append((name, B, T, True, window, dname))
        del q, k, v, do, o, lse, got, want
    torch.cuda.synchronize()
    for dname in dtypes:
        max_abs[dname] = max(max_abs[dname], hd64[dname])
    print(f"[10 flash bwd] kernel == plain version on {len(cases)} cases "
          f"(heads {BWD_HEADS}; B {BWD_BATCH} x T {BWD_T}, causal or not, "
          f"window 0/256; and B {BWD_TRAIN_BT[0]} x T {BWD_TRAIN_BT[1]} "
          f"causal; bf16/f32; and with a query offset, {FLASH_OFFSET}, "
          f"the dk, dv of keys past the last query zero; and a rank's heads "
          f"in phase 24 (h), {TP_HEADS}, at B {BWD_TRAIN_BT[0]} x T "
          f"{BWD_TRAIN_BT[1]}): max |err| f32 "
          f"{worst['float32']:.3g} (tol "
          f"{BWD_F32_TOL} + {BWD_F32_TOL} x |ref|), bf16 "
          f"{worst['bfloat16']:.3g} of each gradient's max (tol "
          f"{BWD_BF16_TOL}); at head width 64, max |err| (absolute) f32 "
          f"{hd64['float32']:.3g}, bf16 {hd64['bfloat16']:.3g}", flush=True)

    H, Hkv, hd = FLASH_HEADS["qwen3"]
    out = {}
    for B, T in BWD_TIMED:
        q, k, v, do = [torch.randn(B, T, h, hd, generator=g).to(
            dev, torch.bfloat16).transpose(1, 2) for h in (H, Hkv, Hkv, H)]
        o, lse = flash_attention_bhtd(q, k, v, return_lse=True)
        ms = time_cuda(lambda: flash_attention_bwd_bhtd(q, k, v, o, lse, do),
                       5)
        plain_ms = time_cuda(lambda: attention_bwd_ref(q, k, v, o, lse, do),
                             5)
        got = flash_attention_bwd_bhtd(q, k, v, o, lse, do)
        want = attention_bwd_ref(q, k, v, o, lse, do)
        err = max(float((a.float() - b.float()).abs().max())
                  / float(b.float().abs().max()) for a, b in zip(got, want))
        check(err <= BWD_BF16_TOL,
              f"flash backward B={B} T={T}: max |err| {err} of max")
        del got, want
        xs = [x.detach().requires_grad_() for x in (q, k, v)]
        lib_o = F.scaled_dot_product_attention(*xs, is_causal=True,
                                               enable_gqa=True)
        lib_ms = time_cuda(lambda: torch.autograd.grad(
            lib_o, xs, do, retain_graph=True), 5)
        bound_ms, bound_by, flops, nbytes = bwd_bound(B, H, Hkv, hd, T,
                                                      True, 2)
        print(f"[10 flash bwd] qwen3 bf16 (wgmma kernels) causal B={B} "
              f"T={T}: kernel "
              f"{ms:.4f} ms (dq + dk/dv + delta, median of 5); bound "
              f"{bound_ms:.4f} ms by {bound_by} ({flops} FLOP, {nbytes} B); "
              f"x bound {ms / bound_ms:.1f}; plain {plain_ms:.3f} ms; "
              f"scaled_dot_product_attention backward {lib_ms:.4f} ms; max "
              f"|err| {err:.3g} of each gradient's max", flush=True)
        out[(B, T)] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                           bound_ms=bound_ms, bound_by=bound_by)
        del q, k, v, do, o, lse, xs, lib_o

    # the float32 (FMA) kernels at each grouping of F32_HEADS
    B, T = BWD_F32_TIMED
    shapes = {}
    for name, (H, Hkv, hd, w) in F32_HEADS.items():
        q, k, v, do = [torch.randn(B, T, h, hd, generator=g).to(dev)
                       .transpose(1, 2) for h in (H, Hkv, Hkv, H)]
        o, lse = flash_attention_bhtd(q, k, v, return_lse=True, window=w)
        ms = time_cuda(lambda: flash_attention_bwd_bhtd(q, k, v, o, lse, do,
                                                        window=w), 5)
        plain_ms = time_cuda(lambda: attention_bwd_ref(q, k, v, o, lse, do,
                                                       window=w), 5)
        xs = [x.detach().requires_grad_() for x in (q, k, v)]
        lib_o = F.scaled_dot_product_attention(*xs, is_causal=True,
                                               enable_gqa=True)
        lib_ms = time_cuda(lambda: torch.autograd.grad(
            lib_o, xs, do, retain_graph=True), 5)
        bound_ms, bound_by, flops, nbytes = bwd_bound(
            B, H, Hkv, hd, T, True, 4, F32_OPS_PER_S, window=w)
        print(f"[10 flash bwd] {name} f32 (FMA kernels) {H}/{Hkv} of {hd} "
              f"causal window {w} B={B} T={T}: kernel {ms:.4f} ms (dq + "
              f"dk/dv + delta, median of 5); bound {bound_ms:.4f} ms by "
              f"{bound_by} at the 67 TFLOP/s float32 rate ({flops} FLOP, "
              f"{nbytes} B); share {bound_ms / ms:.3f}; plain "
              f"{plain_ms:.3f} ms; scaled_dot_product_attention f32 backward "
              f"{lib_ms:.4f} ms; the first design {F32_EARLIER[name][1]}",
              flush=True)
        shapes[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                            bound_ms=bound_ms, bound_by=bound_by)
        del q, k, v, do, o, lse, xs, lib_o
    f32 = dict(shapes["qwen3"], max_abs_err=max_abs["float32"],
               shapes=shapes)
    torch.cuda.empty_cache()
    return {"bf16": dict(out[(TRAIN_B, TRAIN_T)],
                         max_abs_err=max_abs["bfloat16"]), "f32": f32,
            "hd64_max_abs_err": hd64["bfloat16"]}


def _golden_index(idx, tokens):
    """A golden ``check_leaves`` index (JSON) as a Python index: None is
    the first batch token, [a, b] a slice."""
    return tuple(int(tokens[0, 0]) if i is None else
                 slice(*i) if isinstance(i, list) else i for i in idx)


def attention_layers(cfg) -> int:
    """How many of the model's layers attend (all of a dense model's;
    recurrentgemma's local ones; none of rwkv6's)."""
    if cfg.family == "ssm":
        return 0
    if cfg.family != "hybrid":
        return cfg.num_layers
    pat = cfg.block_pattern
    return sum(pat[i % len(pat)] == "local" for i in range(cfg.num_layers))


def phase_train_golden(dev, tree, golden="train_qwen3_0_6b.json",
                       tag="[11 train golden]", tol=TRAIN_TOL, mesh=None,
                       fields=None):
    """[11 train golden] (and 19c, 22b, 24c) two float32 train steps vs
    JAX's, from the golden's weights ``tree`` (its ``num_layers`` cut
    applied), held to ``tol`` (TRAIN_TOL's keys).  Every reading is
    printed before the first one out of its tolerance fails the phase.
    With ``mesh`` (24c) the state is placed on it by ``shardings(mesh,
    param_specs(...))`` and the step is given ``grad_acc_specs =
    zero_specs(...)``; ``fields``: config fields replaced (24d's
    ``cp_attention``).  Returns the steps' metrics and the final weights
    (on the card)."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch import convert
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import (flash_attention_bhtd,
                                                     flash_attention_bwd_bhtd)
    from repro_torch.models import build as build_model
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.train import (TrainState, loss_and_grads,
                                   make_loss_fn, make_train_step)

    with open(os.path.join(ROOT, "tests", "torch_goldens", golden)) as f:
        gold = json.load(f)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    arch = gold["arch"]
    cut = {"num_layers": gold["num_layers"]} if "num_layers" in gold else {}
    cfg = dataclasses.replace(get_config(arch), dtype="float32", **cut,
                              **(fields or {}))
    check(cfg.remat and cfg.remat_save == "nothing", f"{arch} remats")
    bundle = build_model(cfg)
    params = convert.lm_params_from_jax(tree, cfg, dev)
    arr = np.random.default_rng(gold["token_seed"]).integers(
        0, cfg.vocab_size, (gold["batch"], gold["seq"] + 1)).astype(np.int32)
    batch = {"tokens": torch.as_tensor(arr[:, :-1], device=dev),
             "labels": torch.as_tensor(arr[:, 1:], device=dev)}
    if "extra_seed" in gold:
        # whisper's frames, qwen2-vl's image grid and M-RoPE positions
        batch.update(family_inputs(cfg, gold["batch"], gold["seq"], dev,
                                   torch.float32, gold.get("image_grid"),
                                   gold["extra_seed"]))
    fa0, bw0 = flash_attention_bhtd.launches, flash_attention_bwd_bhtd.launches
    _, _, _, grads = loss_and_grads(make_loss_fn(bundle, executor="cuda"),
                                    params, batch)
    check(flash_attention_bwd_bhtd.launches - bw0 == attention_layers(cfg),
          "the gradient did not run the backward kernel once per attention "
          "layer")
    bad = []
    g_errs = {}
    for path, want in gold["grad_leaf_norms"].items():
        got = float(_leaf(grads, path).double().norm())
        g_errs[path] = abs(got - want) / want
    g_worst = max(g_errs, key=g_errs.get)
    g_err = g_errs[g_worst]
    if g_err > tol["gnorm"]:
        bad.append(f"step-1 gradient leaf norms vs the golden: rel err "
                   f"{g_err} at {g_worst}")
    gs_err, gs_worst = 0.0, None
    for (path, idx), want in zip(gold["check_leaves"], gold["grad_slices"]):
        got = _leaf(grads, path)[_golden_index(idx, arr)].double().cpu(
        ).numpy()
        want = np.asarray(want)
        err = float(np.abs(got - want).max() / np.abs(want).max())
        if err > tol["grad"]:
            bad.append(f"step-1 gradient slice {path} {idx}: max |err| "
                       f"{err} of the slice's max")
        if err >= gs_err:
            gs_err, gs_worst = err, path
    del grads

    state = TrainState(params=params, opt=adamw_init(params),
                       step=torch.zeros((), dtype=torch.int32, device=dev))
    acc_specs = None
    if mesh is not None:
        from repro_torch.distributed import sharding
        from repro_torch.train import place_state

        state = place_state(state, mesh)
        acc_specs = sharding.zero_specs(sharding.param_specs(
            params, model_divisor=sharding.mesh_shape(mesh)["model"]),
            params, mesh)
    step = make_train_step(bundle, AdamWConfig(**gold["opt"]),
                           executor="cuda", grad_acc_specs=acc_specs)
    m_err = {}
    readings = []
    for i, want in enumerate(gold["steps"]):
        if mesh is None:
            state, m = step(state, batch)
        else:
            with sharding.set_mesh(mesh):
                state, m = step(state, batch)
        readings.append({k: float(v) for k, v in m.items()})
        for k, t in (("loss", tol["loss"]), ("ce", tol["loss"]),
                     ("grad_norm", tol["gnorm"] if i == 0 else
                      tol["gnorm_later"]), ("lr", tol["lr"])):
            err = abs(float(m[k]) - want[k]) / abs(want[k])
            if err > t:
                bad.append(f"train step {i + 1} {k}: {float(m[k])} vs the "
                           f"golden's {want[k]} (rel err {err}, tol {t})")
            m_err[k] = max(m_err.get(k, 0.0), err)
    lr = gold["opt"]["lr"]
    w_err, w_worst = 0.0, None
    n_sure = n_all = 0
    if mesh is not None:
        state = state._replace(params=gather_blocks(state.params))
    for (path, idx), g1, want in zip(gold["check_leaves"],
                                     gold["grad_slices"],
                                     gold["param_slices_after_2"]):
        got = _leaf(state.params, path)[_golden_index(idx, arr)].double(
        ).cpu().numpy()
        d = np.abs(got - np.asarray(want))
        g1 = np.abs(np.asarray(g1))
        sure = g1 > tol["floor"] * g1.max()
        if not (bool((d[sure] <= tol["w"]).all())
                and bool((d <= 2 * lr * 2).all())):
            bad.append(f"weights after step 2, {path} {idx}: |err| "
                       f"{d.tolist()}")
        if sure.any() and float(d[sure].max()) >= w_err:
            w_err, w_worst = float(d[sure].max()), path
        n_sure += int(sure.sum())
        n_all += d.size
    losses = [float(x["loss"]) for x in gold["steps"]]
    print(f"{tag} {arch} float32 (TF32 off, remat, {cfg.num_layers} "
          f"layers), {gold['batch']} x {gold['seq']} tokens, 2 "
          f"make_train_step steps on the card vs {golden} (JAX losses "
          f"{losses}): rel err loss "
          f"{m_err['loss']:.3g}, ce {m_err['ce']:.3g} (tol "
          f"{tol['loss']}), grad norm {m_err['grad_norm']:.3g} (tol "
          f"{tol['gnorm']}, after step 1 {tol['gnorm_later']}), lr "
          f"{m_err['lr']:.3g} (tol {tol['lr']});"
          f" step-1 gradient leaf norms {g_err:.3g} at {g_worst} (tol "
          f"{tol['gnorm']}), slices {gs_err:.3g} of each slice's max at "
          f"{gs_worst} (tol {tol['grad']}); step-2 weights max |err| "
          f"{w_err:.3g} at {w_worst} on {n_sure}/{n_all} sure elements "
          f"(tol {tol['w']}); flash launches fwd "
          f"{flash_attention_bhtd.launches - fa0}, bwd "
          f"{flash_attention_bwd_bhtd.launches - bw0}", flush=True)
    final = state.params
    del state, params, batch
    torch.cuda.empty_cache()
    check(not bad, f"{tag} {len(bad)} reading(s) out of tolerance: "
          + "; ".join(bad))
    # each reading beside its limit
    shares = {"loss": (m_err["loss"], tol["loss"]),
              "ce": (m_err["ce"], tol["loss"]),
              "grad_norm": (m_err["grad_norm"], tol["gnorm"]),
              "lr": (m_err["lr"], tol["lr"]),
              "grad_leaf_norms": (g_err, tol["gnorm"]),
              "grad_slices": (gs_err, tol["grad"]),
              "weights": (w_err, tol["w"])}
    return {"metrics": readings, "final": final, "shares": shares}


def gather_blocks(tree):
    """Every DTensor leaf of ``tree`` as its whole value, gathered by
    ``torch.distributed``'s own all-gather (DTensor's ``full_tensor``
    takes the functional collectives, which a gloo group on the card does
    not carry); other leaves as they are."""
    from torch.distributed.tensor import Shard

    from repro_torch.distributed import sharding

    def whole(x):
        if not sharding.is_placed(x):
            return x
        axes = [[] for _ in range(x.dim())]
        for name, pl in zip(x.device_mesh.mesh_dim_names, x.placements):
            if isinstance(pl, Shard):
                axes[pl.dim].append(name)
        return sharding._gather_global(
            x.to_local(), tuple(x.shape), x.device_mesh,
            sharding.P(*(tuple(a) for a in axes)))
    return sharding._map_with_path(lambda _, x: whole(x), tree)


def phase_train(dev) -> dict:
    """[12 train] bf16 qwen3-0.6b through the trainer with tuned ingest."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import (flash_attention_bhtd,
                                                     flash_attention_bwd_bhtd)
    from repro_torch.optim import AdamWConfig, global_norm
    from repro_torch.train import loss_and_grads, make_loss_fn, \
        make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config("qwen3-0.6b")
    L = cfg.num_layers
    run = train_on_card(
        dev, "[12 train]", cfg, {"flash_attention": flash_attention_bhtd,
                                 "flash_attention_bwd":
                                 flash_attention_bwd_bhtd},
        {"flash_attention": 2 * L, "flash_attention_bwd": L}, TRAIN_B,
        TRAIN_T, TRAIN_STEPS, f"{L} layers", keep_state=True)
    state, bundle = run.pop("state"), run.pop("bundle")

    # one step at B 2 from a copy of the trained state: kernels vs plain
    gen = torch.Generator().manual_seed(12)
    toks = torch.randint(0, cfg.vocab_size, (TRAIN_CHECK_B, TRAIN_T + 1),
                         generator=gen, dtype=torch.int32).to(dev)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    opt = AdamWConfig(lr=3e-4, warmup_steps=20, total_steps=TRAIN_STEPS)
    res = {}
    for ex in ("cuda", "reference"):
        _, _, _, grads = loss_and_grads(make_loss_fn(bundle, executor=ex),
                                        state.params, batch)
        _, m = make_train_step(bundle, opt, executor=ex)(state, batch)
        res[ex] = (float(m["loss"]), float(m["grad_norm"]),
                   float(global_norm(grads)), grads)
    (lk, gk, nk, grk), (lr_, gr, nr, grr) = res["cuda"], res["reference"]
    l_err, g_err = abs(lk - lr_) / abs(lr_), abs(gk - gr) / gr
    from repro_torch.tree import leaves_with_paths
    leaf_err = {}
    for (p, a), (_, b) in zip(leaves_with_paths(grk), leaves_with_paths(grr)):
        leaf_err[p] = float((a.float() - b.float()).norm()
                            / b.float().norm().clamp_min(1e-30))
    worst = max(leaf_err, key=leaf_err.get)
    check(l_err <= TRAIN_BF16_LOSS_RTOL and g_err <= TRAIN_BF16_GNORM_RTOL
          and leaf_err[worst] <= TRAIN_BF16_GRAD_RTOL,
          f"bf16 step, kernels vs plain: loss {lk} vs {lr_}, grad norm {gk} "
          f"vs {gr}, worst leaf {worst} rel L2 {leaf_err[worst]}")
    print(f"[12 train] one bf16 step at {TRAIN_CHECK_B} x {TRAIN_T} from "
          f"the trained state, kernels vs plain versions: loss {lk:.6f} vs "
          f"{lr_:.6f} (rel {l_err:.3g}, tol {TRAIN_BF16_LOSS_RTOL}); grad "
          f"norm {gk:.5f} vs {gr:.5f} (rel {g_err:.3g}, tol "
          f"{TRAIN_BF16_GNORM_RTOL}); per-leaf gradient rel L2 distance max "
          f"{leaf_err[worst]:.3g} at {worst} (tol {TRAIN_BF16_GRAD_RTOL}), "
          f"median {statistics.median(leaf_err.values()):.3g}", flush=True)
    del state, res, grk, grr
    torch.cuda.empty_cache()
    return {"fa_launches": run["launches"]["flash_attention"],
            "bwd_launches": run["launches"]["flash_attention_bwd"],
            "breakdown": run["breakdown"]}


#: Device-kernel groups of a training step, by kernel name (first match).
STEP_GROUPS = (("flash forward (kernel 2)", ("flash_fwd",)),
               ("flash backward (kernel 3)", ("flash_bwd",)),
               ("rglru backward", ("rglru_bwd_kernel",)),
               ("rglru (kernel 5)", ("rglru_kernel",)),
               ("wkv backward", ("wkv_bwd_kernel", "wkv_bwd_state_kernel",
                                 "wkv_bwd_chunk_kernel")),
               ("wkv (kernel 4)", ("wkv_chunk_kernel", "wkv_kernel")),
               ("matrix products", ("gemm", "gemv", "cutlass", "xmma",
                                    "cublas", "nvjet", "sm90_", "sm80_")),
               ("copies", ("Memcpy", "Memset")))


def profile_split(fn, groups, other):
    """``fn()`` under ``torch.profiler`` (CPU and CUDA activity), ended by
    a sync: (host wall ms, device events, card busy ms (the union of its
    kernels' intervals), device ms by group of ``groups`` (name, kernel
    name keys) and ``other``, the largest ``other`` kernels), or None when
    the trace holds no device events."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        return wall_ms, None
    by = {name: 0.0 for name, _ in groups}
    by[other] = 0.0
    others = {}
    spans = []
    for e in kernels:
        dur = (e.time_range.end - e.time_range.start) / 1e3
        spans.append((e.time_range.start, e.time_range.end))
        group = next((g for g, keys in groups
                      if any(k in e.name for k in keys)), other)
        by[group] += dur
        if group == other:
            others[e.name[:60]] = others.get(e.name[:60], 0.0) + dur
    spans.sort()
    busy, end = 0.0, None
    for a, b in spans:
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    top = sorted(others.items(), key=lambda kv: -kv[1])[:6]
    return wall_ms, (len(kernels), busy / 1e3, by, top)


def profile_train_step(dev, bundle, state, B=TRAIN_B, T=TRAIN_T,
                       steps=TRAIN_STEPS, tag="[12 train]", extra=None):
    """One more B x T step from ``state`` (with the model's ``extra``
    inputs) under ``torch.profiler`` (CPU and CUDA activity): device time
    by kernel group, the card's busy time (the union of its kernels'
    intervals) and its idle share of the step's host wall.  Prints "not
    measured" when the trace holds no device events."""
    import torch

    from repro_torch.optim import AdamWConfig
    from repro_torch.train import make_train_step

    gen = torch.Generator().manual_seed(13)
    toks = torch.randint(0, bundle.cfg.vocab_size, (B, T + 1),
                         generator=gen, dtype=torch.int32).to(dev)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:], **(extra or {})}
    step = make_train_step(bundle, AdamWConfig(lr=3e-4, warmup_steps=20,
                                               total_steps=steps))
    other = "other (elementwise, reductions, optimizer)"
    wall_ms, split = profile_split(
        lambda: float(step(state, batch)[1]["loss"]), STEP_GROUPS, other)
    if split is None:
        print(f"{tag} profiled step: {wall_ms:.1f} ms host wall; the "
              f"trace holds no device events: breakdown and idle share "
              f"not measured", flush=True)
        return None
    n, busy_ms, by, top = split
    idle = max(0.0, 1.0 - busy_ms / wall_ms)
    parts = "; ".join(f"{g} {ms:.1f} ms" for g, ms in by.items())
    print(f"{tag} profiled step ({B} x {T}, torch.profiler "
          f"CPU+CUDA): host wall {wall_ms:.1f} ms, {n} device "
          f"events, card busy {busy_ms:.1f} ms, idle {idle:.3f} of the "
          f"wall; device time by group: {parts}; largest other kernels: "
          f"{[(n, round(ms, 1)) for n, ms in top]}", flush=True)
    return {"wall_ms": wall_ms, "busy_ms": busy_ms, "idle": idle, **by}


def train_on_card(dev, tag, cfg, kernels, want, B, T, steps, desc,
                  extra=None, launcher_argv=None, keep_state=False):
    """bf16 training of ``cfg`` on the card (phases 12, 19d, 22c, 26c):
    ``steps`` steps of B x T through ``trainer.train`` fed by SLA-tuned
    ingest (with the model's ``extra`` inputs), or, with
    ``launcher_argv``, through ``repro_torch.launch.train.main`` (its call
    of ``train`` replaced, for the run, by one that adds the hook; a
    launcher that does not call it fails the phase).  ``kernels`` {name:
    wrapper}: their counts set to 0 just before the run and read after
    each step, which must launch ``want`` {name: count}; every loss finite
    and every attention launch on the bf16 route.  Prints the run's line
    and one profiled step (:func:`profile_train_step`, inside the
    launcher's mesh while it stands); returns the readings (``routes``:
    each kernel's launches by route over the steps alone), and the final
    state and bundle with ``keep_state``."""
    import math
    import unittest.mock

    import torch

    from repro_torch.core.types import SLA, SLAPolicy
    from repro_torch.data import SyntheticSource, TunedFetcher, batches
    from repro_torch.launch import train as launcher
    from repro_torch.models import build as build_model
    from repro_torch.optim import AdamWConfig
    from repro_torch.train.trainer import TrainerConfig, train

    check(cfg.dtype == "bfloat16" and cfg.remat,
          f"{cfg.name} trains in bf16 with remat")
    marks, out = [], {}

    def hook(i, state, metrics):
        marks.append((time.perf_counter(),
                      {k: fn.launches for k, fn in kernels.items()},
                      float(metrics["loss"]), float(metrics["grad_norm"])))

    def traced(bundle, opt, data, tcfg, **kw):
        """The trainer with the hook; after its last step, the peak, the
        parameter count, the kernels' launches by route and one profiled
        step."""
        state, report = train(bundle, opt, data, tcfg, hooks=hook, **kw)
        torch.cuda.synchronize()
        out.update(end=time.perf_counter(), report=report,
                   peak=torch.cuda.max_memory_allocated(),
                   params=sum(x.numel() for x in _leaves(state.params)),
                   routes={k: dict(fn.route_launches)
                           for k, fn in kernels.items()
                           if hasattr(fn, "route_launches")})
        out["breakdown"] = profile_train_step(dev, bundle, state, B, T,
                                              steps, f"{tag} {cfg.name}",
                                              extra)
        if keep_state:
            out.update(state=state, bundle=bundle)
        return state, report

    fetcher = None
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for fn in kernels.values():
        fn.launches = 0
    reset_attention_counts()
    t0 = time.perf_counter()
    if launcher_argv is not None:
        how = "repro_torch.launch.train.main"
        with unittest.mock.patch.object(launcher, "train", traced):
            launcher.main(launcher_argv)
        check("report" in out, f"{how} did not run trainer.train")
    else:
        how = "trainer.train with SLA-tuned ingest" + "".join(
            f", {k} {list(v.shape)}" for k, v in (extra or {}).items())
        sla = SLA(policy=SLAPolicy.MAX_THROUGHPUT, timeout_s=0.5, max_ch=8)
        fetcher = TunedFetcher(SyntheticSource(cfg.vocab_size, 1 << 16), sla)
        data = batches(fetcher.source, batch=B, seq=T, tuned=True, sla=sla,
                       fetcher=fetcher)
        try:
            traced(build_model(cfg),
                   AdamWConfig(lr=3e-4, warmup_steps=20, total_steps=steps),
                   ({**b, **extra} for b in data) if extra else data,
                   TrainerConfig(total_steps=steps, log_every=0), device=dev)
        finally:
            data.close()                   # stops the fetcher's threads
    report = out["report"]
    check(report.steps_run == steps,
          f"{cfg.name}: ran {report.steps_run} steps")
    check(all(math.isfinite(x) for x in report.losses),
          f"{cfg.name}: non-finite loss: {report.losses}")
    zero = {k: 0 for k in kernels}
    per_step = [{k: b[1][k] - a[1][k] for k in kernels}
                for a, b in zip([(t0, zero)] + marks, marks)]
    check(all(p == want for p in per_step),
          f"{cfg.name}: kernel launches per step {per_step}, expected "
          f"{want} each")
    check_bf16_route(f"{cfg.name} train")
    launches = {k: sum(p[k] for p in per_step) for k in kernels}
    step_ms = [(b[0] - a[0]) * 1e3 for a, b in zip(marks, marks[1:])]
    mean_ms = statistics.mean(step_ms)
    fetched = ""
    if fetcher is not None:
        traj = []
        for t, w, c, fi in fetcher.trajectory:
            if not traj or traj[-1][1:] != (w, c, fi):
                traj.append((round(t, 2), w, c, fi))
        fetched = (f"; fetcher (s, workers, cores, freq_idx) {traj}, "
                   f"{fetcher.stats.bytes_fetched / 1e6:.1f} MB fetched, "
                   f"{fetcher.stats.energy_j:.1f} J accounted")
    print(f"{tag} {cfg.name} bf16 (remat, {desc}; {out['params']} "
          f"parameters), {steps} steps of {B} x {T} through {how}: wall "
          f"{out['end'] - t0:.3f} s (weights drawn on the card, init "
          f"included; first step {(marks[0][0] - t0) * 1e3:.1f} ms); steps "
          f"2-{steps} {mean_ms:.1f} ms a step (each "
          f"{[round(x, 1) for x in step_ms]}) = "
          f"{B * T / mean_ms * 1e3:.0f} tokens/s; peak memory {out['peak']} "
          f"B ({out['peak'] / 1e9:.2f} GB); launches per step {per_step[0]} "
          f"({launches} in all); losses "
          f"{[round(x, 4) for x in report.losses]}; grad norms "
          f"{[round(m[3], 4) for m in marks]}{fetched}", flush=True)
    torch.cuda.empty_cache()
    return dict(out, launches=launches, per_step=per_step[0],
                step_ms=mean_ms, losses=report.losses)


def random_qwen3_params():
    """Full-width qwen3-0.6b weights from ``random_lm_params(seed=0)``, as
    float32 numpy in JAX's tree (the golden's weights)."""
    from repro_torch import convert
    from repro_torch.configs import get_config

    t0 = time.perf_counter()
    tree = convert.random_lm_params(get_config("qwen3-0.6b"), seed=0)
    print(f"[8 lm golden] random_lm_params(qwen3-0.6b, seed=0): "
          f"{sum(x.size for x in _leaves(tree))} parameters drawn in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return tree


def _leaves(tree):
    if isinstance(tree, (dict, list)):
        for v in (tree.values() if isinstance(tree, dict) else tree):
            yield from _leaves(v)
    else:
        yield tree


def phase_lm_golden(dev, tree):
    """[8 lm golden] float32 qwen3-0.6b on the card vs the JAX golden."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch import convert
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention_bhtd
    from repro_torch.models import build as build_model
    from repro_torch.serve import make_decode_step, make_prefill

    with open(os.path.join(ROOT, "tests", "torch_goldens",
                           "lm_qwen3_0_6b.json")) as f:
        gold = json.load(f)
    for path, vals in gold["weight_check"].items():
        leaf = tree
        for key in path.split("/"):
            leaf = leaf[key]
        idx = GOLDEN_WEIGHT_CHECK[path]
        check([float(x) for x in leaf[idx]] == vals,
              f"random_lm_params differs from the golden's at {path}: "
              f"numpy drew other weights here")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(get_config("qwen3-0.6b"), dtype="float32")
    params = convert.lm_params_from_jax(tree, cfg, dev)
    bundle = build_model(cfg)
    prompt = torch.as_tensor(np.asarray(gold["prompt"]), device=dev)
    B, T, N = gold["batch"], gold["prompt_len"], gold["new_tokens"]
    state = bundle.init_decode_state(B, T + N, device=dev)
    prefill = make_prefill(bundle, executor="cuda")
    step = make_decode_step(bundle, executor="cuda")
    before = flash_attention_bhtd.launches
    logits, state = prefill(params, state, prompt)
    launches = flash_attention_bhtd.launches - before
    steps = [logits[:, -1].float()]
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    for i in range(N - 1):
        pos = torch.full((B, 1), T + i, dtype=torch.long, device=dev)
        tok, logits, state = step(params, state, tok, pos)
        steps.append(logits[:, -1].float())
    got_tokens = torch.stack([s.argmax(-1) for s in steps], 1).tolist()
    check(got_tokens == gold["tokens"],
          f"float32 greedy tokens {got_tokens} != JAX's {gold['tokens']}")
    top_err = norm_err = 0.0
    for s, g in zip(steps, gold["steps"]):
        ids = torch.as_tensor(g["top5_ids"], device=dev)
        vals = s.gather(1, ids).double().cpu().numpy()
        want = np.asarray(g["top5"])
        top_err = max(top_err, float(
            (np.abs(vals - want).max(1) / np.abs(want).max(1)).max()))
        norms = s.double().norm(dim=-1).cpu().numpy()
        norm_err = max(norm_err, float(
            (np.abs(norms - np.asarray(g["norm"])) / np.asarray(g["norm"]))
            .max()))
    margin = min(m for g in gold["steps"] for m in g["margin"])
    check(top_err <= GOLDEN_RTOL and norm_err <= GOLDEN_RTOL,
          f"float32 logits vs the golden: top-5 rel err {top_err}, norm rel "
          f"err {norm_err} (tol {GOLDEN_RTOL})")
    print(f"[8 lm golden] qwen3-0.6b float32 (TF32 off), {B} x {T} prompt "
          f"tokens + {N} greedy steps on the card ({launches} flash "
          f"launches in the prefill): tokens == lm_qwen3_0_6b.json; top-5 "
          f"logits max rel err {top_err:.3g}, norms {norm_err:.3g} (tol "
          f"{GOLDEN_RTOL}); smallest golden top-2 margin {margin:.4g}",
          flush=True)
    del params, state, steps
    torch.cuda.empty_cache()


def phase_serve(dev, tree) -> dict:
    """[9 serve] bf16 qwen3-0.6b: generate, then the continuous batcher."""
    import numpy as np
    import torch

    from repro_torch import convert
    from repro_torch.configs import get_config
    from repro_torch.core.types import SLA, SLAPolicy
    from repro_torch.kernels.flash_attention import (attention_ref,
                                                     flash_attention_bhtd)
    from repro_torch.models import build as build_model
    from repro_torch.serve import (ContinuousBatcher, Request, generate,
                                   make_decode_step, make_prefill)

    cfg = get_config("qwen3-0.6b")
    check(cfg.dtype == "bfloat16", "qwen3-0.6b serves in bf16")
    params = convert.lm_params_from_jax(tree, cfg, dev)
    bundle = build_model(cfg)
    B, T, N = GEN_BATCH, GEN_PROMPT, GEN_NEW
    prompt = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (B, T)), device=dev)

    # (a) generate: the main path, launches counted from 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    reset_attention_counts()
    t0 = time.perf_counter()
    toks = generate(bundle, params, prompt, N, T + N, device=dev,
                    executor="cuda")
    torch.cuda.synchronize()
    gen_wall = time.perf_counter() - t0
    gen_launches = flash_attention_bhtd.launches
    check_bf16_route("generate")
    gen_peak = torch.cuda.max_memory_allocated()
    check(tuple(toks.shape) == (B, N), f"generate returned {toks.shape}")
    check(gen_launches == cfg.num_layers,
          f"generate launched the kernel {gen_launches} times, not "
          f"{cfg.num_layers}")

    # the prefill alone, kernel vs plain version, timed
    logits, pre_ms, states = {}, {}, {}
    for ex in ("cuda", "reference"):
        state = bundle.init_decode_state(B, T + N, device=dev)
        prefill = make_prefill(bundle, executor=ex)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits[ex], states[ex] = prefill(params, state, prompt)
        torch.cuda.synchronize()
        pre_ms[ex] = (time.perf_counter() - t0) * 1e3
    del states["reference"]

    # decode steps after the kernel's prefill: host wall per step, and the
    # eager PyTorch calls one step makes (torch.profiler, host side only)
    from torch.profiler import ProfilerActivity, profile

    step = make_decode_step(bundle, executor="cuda")
    state, tok = states.pop("cuda"), toks[:, :1]
    n_dec = min(16, N - 2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n_dec):
        pos = torch.full((B, 1), T + i, dtype=torch.long, device=dev)
        tok, _, state = step(params, state, tok, pos)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / n_dec
    pos = torch.full((B, 1), T + n_dec, dtype=torch.long, device=dev)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(params, state, tok, pos)
        torch.cuda.synchronize()
    n_ops = sum(1 for e in prof.events() if e.name.startswith("aten::")
                and (e.cpu_parent is None
                     or not e.cpu_parent.name.startswith("aten::")))
    del state
    a, b = logits["cuda"][:, -1].float(), logits["reference"][:, -1].float()
    scale = float(b.abs().max())
    err = float((a - b).abs().max())
    check(err <= SERVE_BF16_TOL * scale,
          f"bf16 prefill logits, kernel vs plain: max |err| {err} > "
          f"{SERVE_BF16_TOL} x {scale}")
    top2 = b.topk(2, dim=-1).values
    sure = (top2[:, 0] - top2[:, 1]) > SERVE_BF16_TOL * scale
    agree = a.argmax(-1) == b.argmax(-1)
    check(bool(agree[sure].all()),
          "first greedy token differs on a row with a clear top-2 margin")
    check(torch.equal(a.argmax(-1).int(), toks[:, 0]),
          "generate's first token is not its prefill's argmax")
    print(f"[9 serve] (a) generate {B} x {T} prompt + {N} new tokens "
          f"(bf16): wall {gen_wall:.3f} s, {gen_launches} flash launches "
          f"(one per layer); prefill {pre_ms['cuda']:.1f} ms = "
          f"{B * T / pre_ms['cuda'] * 1e3:.0f} tok/s (plain attention "
          f"{pre_ms['reference']:.1f} ms); decode {step_ms:.2f} ms a step "
          f"(mean of {n_dec}) = {B / step_ms * 1e3:.0f} tok/s, {n_ops} "
          f"eager torch calls a step ({step_ms * 1e3 / n_ops:.1f} us "
          f"each); peak memory {gen_peak} B "
          f"({resident} B resident before: the weights); "
          f"prefill logits kernel vs plain max |err| {err:.4g} of max "
          f"|logit| {scale:.4g} (tol {SERVE_BF16_TOL} x); first token "
          f"agrees on {int(agree.sum())}/{B} rows ({int(sure.sum())} with "
          f"a top-2 margin above the tolerance)", flush=True)
    del logits, a, b
    torch.cuda.empty_cache()

    # (b) the SLA continuous batcher: the main path, launches from 0
    rng = np.random.default_rng(2)
    lens = rng.integers(CB_PROMPT[0], CB_PROMPT[1] + 1, CB_REQUESTS)
    reqs = [Request(i, rng.integers(0, cfg.vocab_size, int(n))
                    .astype(np.int32), max_new=CB_MAX_NEW)
            for i, n in enumerate(lens)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    cb = ContinuousBatcher(bundle, params, slots=CB_SLOTS,
                           max_len=CB_MAX_LEN,
                           sla=SLA(policy=SLAPolicy.MAX_THROUGHPUT,
                                   max_ch=CB_SLOTS, delta_ch=1,
                                   timeout_s=0.25),
                           device=dev, executor="cuda")
    for r in reqs:
        cb.submit(r)
    reset_attention_counts()
    trajectory = []
    t0 = time.perf_counter()
    steps = 0
    while cb.queue or any(r is not None for r in cb.active):
        cb.step()
        steps += 1
        if not trajectory or trajectory[-1][1] != cb.admitted:
            trajectory.append((steps, cb.admitted))
        check(steps < 10_000, "continuous batcher did not drain")
    torch.cuda.synchronize()
    cb_wall = time.perf_counter() - t0
    cb_launches = flash_attention_bhtd.launches
    check_bf16_route("batcher")
    cb_peak = torch.cuda.max_memory_allocated()
    produced = sum(len(r.out) for r in reqs)
    check(all(r.done for r in reqs), "not every request finished")
    check(cb_launches == cfg.num_layers * CB_REQUESTS,
          f"batcher launched the kernel {cb_launches} times, not "
          f"{cfg.num_layers} x {CB_REQUESTS}")

    # (b, held) every request's prefill again, into a slot of the drained
    # batcher (K/V a [:, :T] view of a 4,096-long cache row, stale entries
    # past T), once through the kernel and once through the plain version;
    # then the kernel alone on that layer-0 view with a random q
    H, Hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    g = torch.Generator().manual_seed(9)
    cb_err = logit_err = 0.0
    n_sure = n_agree = n_same = 0
    for r in reqs:
        T, slot = len(r.prompt), r.rid % CB_SLOTS
        prompt = torch.as_tensor(r.prompt[None], device=dev)
        out = {}
        for ex in ("cuda", "reference"):
            cb.executor = ex
            out[ex] = cb._prefill(slot, prompt)[0].float()
        a, b = out["cuda"], out["reference"]
        scale = float(b.abs().max())
        err = float((a - b).abs().max())
        check(err <= SERVE_BF16_TOL * scale,
              f"batcher prefill of request {r.rid} (T={T}), kernel vs "
              f"plain: max |err| {err} > {SERVE_BF16_TOL} x {scale}")
        logit_err = max(logit_err, err / scale)
        top2 = b.topk(2).values
        if float(top2[0] - top2[1]) > SERVE_BF16_TOL * scale:
            n_sure += 1
            check(int(a.argmax()) == int(b.argmax()),
                  f"batcher prefill of request {r.rid}: first token "
                  f"differs with a clear top-2 margin")
        n_agree += int(a.argmax()) == int(b.argmax())
        n_same += int(a.argmax()) == r.out[0]
        q = torch.randn(1, T, H, hd, generator=g).to(
            dev, torch.bfloat16).transpose(1, 2)
        k = cb.state["k"][0, slot:slot + 1, :T].transpose(1, 2)
        v = cb.state["v"][0, slot:slot + 1, :T].transpose(1, 2)
        err = float((flash_attention_bhtd(q, k, v).float()
                     - attention_ref(q, k, v).float()).abs().max())
        check(err <= FLASH_TOL["bfloat16"],
              f"flash attention on the batcher's slot view T={T}: max "
              f"|err| {err}")
        cb_err = max(cb_err, err)
    check(n_same == CB_REQUESTS,
          f"the kernel's prefill again gave the served first token on "
          f"{n_same}/{CB_REQUESTS} requests")
    cb.executor = "cuda"
    print(f"[9 serve] (b) ContinuousBatcher {CB_SLOTS} slots x "
          f"{CB_MAX_LEN}, EEMT admission: {CB_REQUESTS}/{CB_REQUESTS} "
          f"requests done ({int(lens.sum())} prompt tokens, {produced} "
          f"generated) in {steps} steps, {cb_wall:.3f} s = "
          f"{produced / cb_wall:.1f} generated tok/s, "
          f"{(produced + int(lens.sum())) / cb_wall:.0f} tok/s with "
          f"prompts; {cb_launches} flash launches "
          f"(= {cfg.num_layers} x {CB_REQUESTS}); peak memory {cb_peak} B "
          f"({resident} B resident before: the weights); "
          f"admitted slots (step, slots): {trajectory}", flush=True)
    print(f"[9 serve] (b) the {CB_REQUESTS} prefills again on the drained "
          f"batcher's slots (T {int(lens.min())}-{int(lens.max())}): "
          f"kernel vs plain last-position logits max |err| "
          f"{logit_err:.4g} of max |logit| (tol {SERVE_BF16_TOL} x); first "
          f"token agrees on {n_agree}/{CB_REQUESTS} ({n_sure} with a top-2 "
          f"margin above the tolerance), kernel == served on "
          f"{n_same}/{CB_REQUESTS}; kernel alone on the layer-0 slot views: "
          f"max |err| {cb_err:.3g} (tol 2e-2)", flush=True)
    del cb, params
    torch.cuda.empty_cache()
    return {"launches": cb_launches, "max_abs_err": cb_err}


# ------------------------------------------------------ recurrent serving --

# Phase 13: the WKV kernel's cases at rwkv6-7b's heads (H 64, hd 64) and
# tolerances, relative to the reference's largest |value| (at least 1):
# float32 sums in another order with FMA contraction (1e-4); y rounded once
# to bf16, where a last-bit float32 difference flips a rounding (1e-2).
WKV_HEADS, WKV_BATCH, WKV_T = 64, (1, 8), (1, 63, 64, 65, 200, 2048)
# Kernels 4 (phase 13) and 4b (phase 22a) at a rank's heads of rwkv6-7b's
# 64 in the partitioned step (tp 2 and tp 16) at the trainer's B x T.
WKV_TP_HEADS, WKV_TP_BT = (32, 4), (2, 4096)
WKV_TOL = {"y_float32": 1e-4, "y_bfloat16": 1e-2, "S": 1e-4}
# ... bf16 cases run on both routes (the wrapper's, and the other forced),
# and the extreme decays exp(-exp(x)) for x over each range (x = -8: the
# long memory, ~1 - 3e-4; x = 3: ~2e-9, products underflow within a
# sub-chunk), at (B, T) of WKV_EXTREME_BT.
WKV_EXTREME_X = ((-8.0, -8.0), (3.0, 3.0), (-8.0, 3.0))
WKV_EXTREME_BT = ((1, 2048), (8, 200))
# Kernel 4's earlier times (the step kernel, the only route before the
# chunked one; CUDA events, median of 5; PERF.md's kernel table, NVIDIA
# H100 80GB HBM3, 700 W), printed beside today's.
WKV_EARLIER_MS = {(8, 2048): "step kernel alone: 1.6068",
                  (1, 2048): "step kernel alone: 1.4558",
                  (8, 1): "step kernel alone: 0.0618"}
# Phase 14: the RG-LRU kernel's cases at recurrentgemma-2b's width.
RGLRU_C, RGLRU_BATCH, RGLRU_T = 2560, (1, 2, 8), (1, 200, 2048, 4096)
# Phase 15: the recurrent goldens' tolerance on top-5 logits and norms,
# relative to the row's largest top-5 |logit| / its norm (float32 on the
# card against XLA on the CPU: cuBLAS sums in another order, the WKV and
# RG-LRU recurrences in another order than JAX's scan and associative scan;
# the smoke-width CPU tests agree to ~1e-6 relative).  Set before the run.
RECURRENT_GOLDENS = {"rwkv6-7b": "lm_rwkv6_7b.json",
                     "recurrentgemma-2b": "lm_recurrentgemma_2b.json"}
RECURRENT_GOLDEN_RTOL = 1e-3
# Phase 16: the recurrent serving shapes (phase 9's).  The bf16 prefill's
# last logits through the kernels and through the plain versions are each
# held to the float32 prefill of the same weights: the kernels' max |err|
# (as a share of the largest |logit|) may be at most RECURRENT_SERVE_RATIO
# times the plain versions'.  bf16 alone moves rwkv6-7b's logits by ~5% of
# the largest through 32 layers, either way (a probe on the H100 80GB HBM3
# at 700 W: kernels 4.83%, plain 4.76% from float32, 5.45% from each
# other; recurrentgemma-2b 0.84% / 0.86% / 0.79%), so a fixed share of the
# logits cannot tell a kernel fault from bf16 rounding, and this ratio can.
RECURRENT_SERVE = ("rwkv6-7b", "recurrentgemma-2b")
RECURRENT_SERVE_RATIO = 1.25


def wkv_bound(B, H, T, hd, elem_bytes, with_s0, route):
    """(bound_ms, bound_by, flops, bytes, recurrent_ms) of one WKV call by
    ``route`` (``cost.wkv_fwd``, w in float32).  Bytes: r, k, v (and y) in
    their type and w in float32 read (written) once, u, S0 and S_final
    once.  Operations: the route's own at its unit's rate, the chunked
    route's tensor-core products (``cost.wkv_chunk_flops``) at 989
    TFLOP/s, the step route's 5 hd^2 float32 operations per (b, h, t) (r
    S, the decay, the outer product and their sums) at the CUDA cores' 67
    TFLOP/s.  recurrent_ms is that last figure for any route: the recurrent
    form on the CUDA cores, kernel 4's bound before the chunked route,
    printed beside the bound under its own name."""
    rec_flops = 5 * hd * hd * B * H * T
    flops, nbytes = cost.wkv_fwd(B, H, T, hd, elem_bytes, 4, with_s0, route)
    rate = BF16_TENSOR_OPS_PER_S if route == "chunk" else F32_OPS_PER_S
    t_ops = flops / rate * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes
            else "bytes", flops, nbytes, rec_flops / F32_OPS_PER_S * 1e3)


def rglru_bound(B, T, C, elem_bytes, backward=False):
    """(bound_ms, bound_by, flops, bytes): the forward reads a, b and
    writes h once, 2 operations per element (``cost.rglru_fwd``); the
    backward reads a, h, g and writes the float32 da, db, 3 operations per
    element (``cost.rglru_bwd``)."""
    flops, nbytes = (cost.rglru_bwd if backward else cost.rglru_fwd)(
        B, T, C, elem_bytes)
    t_ops = flops / F32_OPS_PER_S * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes
            else "bytes", flops, nbytes)


def phase_wkv(dev) -> dict:
    """[13 wkv] kernel 4 vs its plain version at rwkv6-7b's heads on both
    routes (the chunked kernel, the step kernel), at chunk-boundary Ts and
    extreme decays; timed at the serving prefill's shapes and decode."""
    import contextlib
    import importlib
    import itertools

    import torch

    from repro_torch.kernels.rwkv6 import wkv_bhtd, wkv_ref

    t_phase = time.perf_counter()
    mod = importlib.import_module("repro_torch.kernels.rwkv6.rwkv6")
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    g = torch.Generator().manual_seed(13)
    H, hd = WKV_HEADS, 64

    def inputs(B, T, dt, with_s0, x_range=None, H=H):
        r, k, v = [(torch.randn(B, T, H, hd, generator=g) * 0.5).to(
            dev, dt).transpose(1, 2) for _ in range(3)]
        if x_range is None:
            # decays as the model makes them: exp(-exp(w0 + lora)), w0 = -6
            x = -6.0 + 2.0 * torch.randn(B, T, H, hd, generator=g)
        else:
            lo, hi = x_range
            x = lo + (hi - lo) * torch.rand(B, T, H, hd, generator=g)
        w = torch.exp(-torch.exp(x)).to(dev).transpose(1, 2)
        u = (torch.randn(H, hd, generator=g) * 0.5).to(dev)
        S0 = ((torch.randn(B, H, hd, hd, generator=g) * 0.2).to(dev)
              if with_s0 else None)
        return r, k, v, w, u, S0

    def plan_of(args):
        r, k, v, w = args[:4]
        return mod.wkv_plan(r, k, v, w, torch.empty_like(r), n_sms)

    @contextlib.contextmanager
    def forced(plan):
        """The wrapper with its route forced to ``plan`` (None: its own)."""
        orig = mod.wkv_plan
        if plan is not None:
            mod.wkv_plan = lambda *a: plan
        try:
            yield
        finally:
            mod.wkv_plan = orig

    def errors(args, want):
        y, S = wkv_bhtd(*args)
        yr, Sr = want
        check(y.dtype == yr.dtype, "wkv output dtype")
        ey = float((y.float() - yr.float()).abs().max()) / max(
            1.0, float(yr.float().abs().max()))
        eS = float((S - Sr).abs().max()) / max(1.0, float(Sr.abs().max()))
        return ey, eS

    worst = {"y_float32": 0.0, "y_bfloat16": 0.0, "S": 0.0}
    by_route = {"chunk": 0, "step": 0}
    n = 0
    cases = [(B, T, dname, with_s0, None, H) for B, T, dname, with_s0 in
             itertools.product(WKV_BATCH, WKV_T, ("bfloat16", "float32"),
                               (False, True))]
    cases += [(B, T, "bfloat16", True, x, H) for (B, T), x in
              itertools.product(WKV_EXTREME_BT, WKV_EXTREME_X)]
    cases += [(*WKV_TP_BT, dname, False, None, h) for h, dname in
              itertools.product(WKV_TP_HEADS, ("bfloat16", "float32"))]
    for B, T, dname, with_s0, x_range, nh in cases:
        args = inputs(B, T, getattr(torch, dname), with_s0, x_range, nh)
        want = wkv_ref(*args)
        own = plan_of(args)
        plans = [None]
        if dname == "bfloat16":   # the other route too
            plans.append(("step", 64) if own[0] == "chunk" else
                         ("chunk", 32))
        for plan in plans:
            route = (plan or own)[0]
            with forced(plan):
                ey, eS = errors(args, want)
            check(ey <= WKV_TOL[f"y_{dname}"] and eS <= WKV_TOL["S"],
                  f"wkv B={B} T={T} H={nh} {dname} S0={with_s0} decays "
                  f"{x_range or 'model'} {route} route: y err {ey}, S err "
                  f"{eS}")
            worst[f"y_{dname}"] = max(worst[f"y_{dname}"], ey)
            worst["S"] = max(worst["S"], eS)
            by_route[route] += 1
            n += 1
        del args, want
    torch.cuda.synchronize()
    print(f"[13 wkv] kernel == plain version on {n} cases (H {H}, hd {hd}; "
          f"B {WKV_BATCH}; T {WKV_T}; r/k/v bf16 (both routes) or f32, w "
          f"f32; S0 zero or not; decays exp(-exp(x)) of the model and over "
          f"x in {WKV_EXTREME_X} at {WKV_EXTREME_BT}; and a rank's H "
          f"{WKV_TP_HEADS} at B {WKV_TP_BT[0]} x T {WKV_TP_BT[1]} (the "
          f"partitioned step's); {by_route['chunk']} "
          f"on the chunked route, {by_route['step']} on the step route): "
          f"max err / max(1, max |ref|) y bf16 {worst['y_bfloat16']:.3g} "
          f"(tol {WKV_TOL['y_bfloat16']}), y f32 {worst['y_float32']:.3g} "
          f"(tol {WKV_TOL['y_float32']}), S_final {worst['S']:.3g} (tol "
          f"{WKV_TOL['S']})", flush=True)

    out = {}
    for B, T in ((8, 2048), (1, 2048), (8, 1)):
        with_s0 = T == 1
        args = inputs(B, T, torch.bfloat16, with_s0)
        own = plan_of(args)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        wkv_ref(*args)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        variants = [None]
        if T > 1:
            variants += [("chunk", nj) for nj in (64, 32)
                         if ("chunk", nj) != own] + [("step", 64)]
        timed = {}
        for plan in variants:
            route, nj = plan or own
            with forced(plan):
                ms = time_cuda(lambda: wkv_bhtd(*args), 5)
                dev_ms = kernel_device_ms(lambda: wkv_bhtd(*args))
            bound_ms, bound_by, flops, nbytes, rec_ms = wkv_bound(
                B, H, T, hd, 2, with_s0, route)
            timed[f"{route}/{nj}"] = dict(ms=ms, device_ms=dev_ms,
                                          bound_ms=bound_ms,
                                          bound_by=bound_by)
            dev_txt = ("device time not measured" if dev_ms is None else
                       f"{dev_ms:.4f} ms of device time (20 calls queued; "
                       f"x bound {dev_ms / bound_ms:.2f})")
            which = "the wrapper's plan" if plan is None else "forced"
            print(f"[13 wkv] rwkv6-7b heads bf16 B={B} T={T}"
                  f"{' (decode, from a state)' if with_s0 else ''}: "
                  f"{route} route, {nj} columns a block ({which}): "
                  f"{ms:.4f} ms (CUDA events, median of 5), {dev_txt}; "
                  f"bound {bound_ms:.4f} ms by {bound_by} ({flops} FLOP at "
                  f"{'989' if route == 'chunk' else '67'} TFLOP/s, {nbytes} "
                  f"B at 3.35 TB/s); the recurrent form's operations at 67 "
                  f"TFLOP/s {rec_ms:.4f} ms; earlier "
                  f"{WKV_EARLIER_MS[(B, T)]}; plain {plain_ms:.1f} ms (one "
                  f"run); library call: none", flush=True)
        key = f"{own[0]}/{own[1]}"
        out[(B, T)] = dict(timed[key], plain_ms=plain_ms, route=own[0],
                           columns=own[1], recurrent_bound_ms=wkv_bound(
                               B, H, T, hd, 2, with_s0, own[0])[4],
                           variants=timed)
        del args
    res = {k: out[(8, 2048)][k] for k in ("ms", "device_ms", "plain_ms",
                                          "bound_ms", "bound_by")}
    res["max_abs_err"] = max(worst.values())
    res["shapes"] = {f"B{B} T{T}": v for (B, T), v in out.items()}
    print(f"[13 wkv] phase time {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return res


# Kernel 5's earlier times (CUDA events, median of 5; B 2 x T 4,096 by the
# profiler in phase 19d's step), by (B, T) at C 2,560 in float32: the
# first kernel, one thread a channel (my chip runs, PRs 15 and 18; NVIDIA
# H100 80GB HBM3, 700 W), printed beside today's.
RGLRU_EARLIER_MS = {(8, 2048): "PR 15: 1.0242", (1, 2048): "PR 15: 0.9121",
                    (8, 1): "PR 15: 0.0443",
                    (2, 4096): "PR 18: 1.81 (profiler, in the step)"}


def kernel_device_ms(fn, reps=20):
    """Device time (ms) of one call of ``fn``: CUDA events around ``reps``
    calls queued behind a spin kernel (``torch.cuda._sleep``), so the card
    runs them back to back and the host's launch overhead, which events
    around one short call include, stays hidden.  None when the host took
    longer to queue them than the spin lasts."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    queued_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    if queued_s > SPIN_MIN_S:
        return None
    return start.elapsed_time(end) / reps


def host_us_per_call(fn, reps=20):
    """Host time (us) of one call of ``fn``, which enqueues work on the
    card: ``reps`` calls queued behind a spin kernel, so none waits on the
    card."""
    import torch

    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(SPIN_CYCLES)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    return host_s / reps * 1e6


# The spin ahead of kernel_device_ms's calls: 2e7 cycles, at least 10 ms at
# the H100's 1.98 GHz boost clock; the host must queue the calls in less.
SPIN_CYCLES, SPIN_MIN_S = 20_000_000, 0.010


def phase_rglru(dev) -> dict:
    """[14 rglru] kernel 5 vs its plain version, bit for bit, and timed,
    at every (B, T) of RGLRU_BATCH x RGLRU_T, a ragged C and a strided a."""
    import ctypes
    import importlib
    import itertools

    import torch

    from repro_torch.kernels import build
    from repro_torch.kernels.rglru import rglru_ref, rglru_scan

    wrapper = importlib.import_module("repro_torch.kernels.rglru.rglru")
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    g = torch.Generator().manual_seed(14)
    C = RGLRU_C

    def inputs(B, T, dt, c=C):
        a = (torch.rand(B, T, c, generator=g) * 0.1 + 0.9).to(dev, dt)
        b = (torch.randn(B, T, c, generator=g) * 0.1).to(dev, dt)
        return a, b

    cases = [(B, T, C, "float32", False)
             for B, T in itertools.product(RGLRU_BATCH, RGLRU_T)]
    cases += [(2, 200, C, "bfloat16", False),
              (2, 300, 2536, "float32", False),    # C not a multiple of 32
              (2, 300, C, "float32", True)]        # a strided view
    out = {}
    for B, T, c, dname, strided in cases:
        a, b = inputs(B, T, getattr(torch, dname), c)
        if strided:   # every other time step of a longer a
            a = inputs(B, 2 * T, torch.float32, c)[0][:, ::2]
            check(not a.is_contiguous(), "the strided case's a is strided")
        width, tma = wrapper.kernel_plan(a, b, torch.empty_like(a), n_sms)
        h = rglru_scan(a, b)
        check(torch.equal(h, rglru_ref(a, b)),
              f"rglru B={B} T={T} C={c} {dname} strided={strided}: "
              f"kernel != plain version")
        ms = time_cuda(lambda: rglru_scan(a, b), 5)
        dev_ms = kernel_device_ms(lambda: rglru_scan(a, b))
        host_us = host_us_per_call(lambda: rglru_scan(a, b))
        plain_ms = time_cuda(lambda: rglru_ref(a, b), 2)
        bound_ms, bound_by, flops, nbytes = rglru_bound(
            B, T, c, a.element_size())
        main = c == C and dname == "float32" and not strided
        earlier = RGLRU_EARLIER_MS.get((B, T), "not measured") if main \
            else "not measured"
        dev_txt = ("device time not measured" if dev_ms is None else
                   f"{dev_ms:.4f} ms of device time (20 calls queued; x "
                   f"bound {dev_ms / bound_ms:.1f})")
        print(f"[14 rglru] B={B} T={T} C={c} {dname}"
              f"{' strided a' if strided else ''}: bit-equal; "
              f"{'TMA ring' if tma else 'direct path'}, {width} channels a "
              f"block; kernel {ms:.4f} ms (CUDA events, median of 5), "
              f"{dev_txt}; host {host_us:.1f} us a call; bound {bound_ms:.4f} ms by {bound_by} ({nbytes} "
              f"B at 3.35 TB/s); earlier {earlier}; plain {plain_ms:.3f} "
              f"ms (median of 2)", flush=True)
        if (B, T) == (2, 4096) and main:
            # the launch's own host cost on both paths: the TMA path
            # encodes three tensor maps a call
            lib = build.load_rglru()
            h = torch.empty_like(a)
            strides = (ctypes.c_longlong * 6)(*[
                st for x in (a, b, h) for st in wrapper._strides(x)])
            stream = torch.cuda.current_stream(dev).cuda_stream
            c_us = {}
            for path in (1, 0):
                def launch():
                    err = lib.rglru_launch(0, a.data_ptr(), b.data_ptr(),
                                           h.data_ptr(), B, T, c, strides,
                                           width, path, stream)
                    check(err == 0, f"rglru_launch (tma={path}): {err}")
                c_us[path] = host_us_per_call(launch)
            print(f"[14 rglru] B={B} T={T}: host cost of the C launch alone "
                  f"{c_us[1]:.1f} us on the TMA path (three tensor maps "
                  f"encoded), {c_us[0]:.1f} us on the direct path; the "
                  f"wrapper {host_us:.1f} us", flush=True)
        if main:
            out[(B, T)] = dict(ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                               bound_ms=bound_ms, bound_by=bound_by,
                               host_us=host_us)
        del a, b, h
    res = dict(out[(8, 2048)])
    res["max_abs_err"] = 0.0
    res["train_shape"] = out[(2, 4096)]
    return res


def _leaf(tree, path):
    for k in path.split("/"):
        tree = tree[int(k)] if isinstance(tree, list) else tree[k]
    return tree


# Weights by position (tests/torch_goldens/make_recurrent_goldens.py
# GOLDENS[arch]["check"]).
RECURRENT_WEIGHT_CHECK = {
    "rwkv6-7b": {"embed": (0, slice(0, 4)),
                 "blocks/tm/wr": (3, -1, slice(-4, None)),
                 "blocks/cm/wv": (1, 5, slice(0, 4)),
                 "head": (-1, slice(-4, None))},
    "recurrentgemma-2b": {"embed": (0, slice(0, 4)),
                          "layers/0/rec/wx": (-1, slice(-4, None)),
                          "layers/2/attn/wq": (5, slice(0, 4)),
                          "layers/25/mlp/wd": (13, slice(0, 4))}}


def phase_recurrent_golden(dev, arch, keep_tree=False):
    """[15 recurrent golden] a float32 recurrent model on the card vs the
    JAX golden.  With ``keep_tree``, returns the numpy weights it drew
    with their seed and depth ({"tree", "seed", "num_layers"}); else
    None."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch import convert
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import launch_counts
    from repro_torch.models import build as build_model
    from repro_torch.serve import make_decode_step, make_prefill

    with open(os.path.join(ROOT, "tests", "torch_goldens",
                           RECURRENT_GOLDENS[arch])) as f:
        gold = json.load(f)
    cfg = dataclasses.replace(get_config(arch), dtype="float32",
                              num_layers=gold["config"]["num_layers"])
    check(dataclasses.asdict(cfg) == {
        k: tuple(v) if isinstance(v, list) else v
        for k, v in gold["config"].items()},
          f"{arch}: the golden's config differs from the port's")
    t0 = time.perf_counter()
    tree = convert.random_lm_params(cfg, seed=gold["seed"])
    draw_s = time.perf_counter() - t0
    for path, vals in gold["weight_check"].items():
        got = _leaf(tree, path)[RECURRENT_WEIGHT_CHECK[arch][path]]
        check([float(x) for x in got] == vals,
              f"random_lm_params differs from the golden's at {path}: "
              f"numpy drew other weights here")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    params = convert.lm_params_from_jax(tree, cfg, dev)
    drawn = (dict(tree=tree, seed=gold["seed"], num_layers=cfg.num_layers)
             if keep_tree else None)
    del tree
    bundle = build_model(cfg)
    prompt = torch.as_tensor(np.asarray(gold["prompt"]), device=dev)
    B, T, N = gold["batch"], gold["prompt_len"], gold["new_tokens"]
    state = bundle.init_decode_state(B, T + N, device=dev)
    prefill = make_prefill(bundle, executor="cuda")
    step = make_decode_step(bundle, executor="cuda")
    before = launch_counts()
    logits, state = prefill(params, state, prompt)
    launches = launch_counts(before)
    steps = [logits[:, -1].float()]
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    for i in range(N - 1):
        pos = torch.full((B, 1), T + i, dtype=torch.long, device=dev)
        tok, logits, state = step(params, state, tok, pos)
        steps.append(logits[:, -1].float())
    got_tokens = torch.stack([s.argmax(-1) for s in steps], 1).tolist()
    check(got_tokens == gold["tokens"],
          f"{arch} float32 greedy tokens {got_tokens} != JAX's "
          f"{gold['tokens']}")
    top_err = norm_err = 0.0
    for s, gs in zip(steps, gold["steps"]):
        ids = torch.as_tensor(gs["top5_ids"], device=dev)
        vals = s.gather(1, ids).double().cpu().numpy()
        want = np.asarray(gs["top5"])
        top_err = max(top_err, float(
            (np.abs(vals - want).max(1) / np.abs(want).max(1)).max()))
        norms = s.double().norm(dim=-1).cpu().numpy()
        norm_err = max(norm_err, float(
            (np.abs(norms - np.asarray(gs["norm"]))
             / np.asarray(gs["norm"])).max()))
    margin = min(m for gs in gold["steps"] for m in gs["margin"])
    check(top_err <= RECURRENT_GOLDEN_RTOL
          and norm_err <= RECURRENT_GOLDEN_RTOL,
          f"{arch} float32 logits vs the golden: top-5 rel err {top_err}, "
          f"norm rel err {norm_err} (tol {RECURRENT_GOLDEN_RTOL})")
    print(f"[15 recurrent golden] {arch} float32 (TF32 off; "
          f"{cfg.num_layers} layers: {gold['depth_cut'] or 'full depth'}),"
          f" {B} x {T} prompt tokens + {N} greedy steps on the card "
          f"(weights drawn in {draw_s:.1f} s; prefill launches "
          f"{launches}): "
          f"tokens == {RECURRENT_GOLDENS[arch]}; top-5 logits max rel err "
          f"{top_err:.3g}, norms {norm_err:.3g} (tol "
          f"{RECURRENT_GOLDEN_RTOL}); smallest golden top-2 margin "
          f"{margin:.4g}", flush=True)
    del params, state, steps
    torch.cuda.empty_cache()
    return drawn


def phase_recurrent_serve(dev, arch) -> dict:
    """[16 recurrent serve] a bf16 recurrent model at full width and depth:
    generate, launches per prefill and decode step, kernels vs plain."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.serve import KERNELS, launch_counts
    from repro_torch.models import build as build_model
    from repro_torch.serve import generate, make_decode_step, make_prefill

    cfg = get_config(arch)
    check(cfg.dtype == "bfloat16", f"{arch} serves in bf16")
    bundle = build_model(cfg)
    n_attn = attention_layers(cfg)
    want_prefill = ({"wkv": cfg.num_layers, "rglru": 0, "flash_attention": 0}
                    if cfg.family == "ssm" else
                    {"wkv": 0, "rglru": cfg.num_layers - n_attn,
                     "flash_attention": n_attn})
    want_decode = dict(want_prefill, flash_attention=0)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(0)
    params = bundle.init_params(gen, device=dev)
    torch.cuda.synchronize()
    draw_s = time.perf_counter() - t0
    resident = torch.cuda.memory_allocated()
    B, T, N = GEN_BATCH, GEN_PROMPT, GEN_NEW
    prompt = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (B, T)), device=dev)

    # generate: the main path, launches counted from 0
    from repro_torch.kernels.rwkv6 import wkv_bhtd
    for fn in KERNELS.values():
        fn.launches = 0
    wkv_bhtd.route_launches = {"chunk": 0, "step": 0}
    reset_attention_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    toks = generate(bundle, params, prompt, N, T + N, device=dev,
                    executor="cuda")
    torch.cuda.synchronize()
    gen_wall = time.perf_counter() - t0
    gen_launches = launch_counts()
    wkv_routes = dict(wkv_bhtd.route_launches)
    # the prefill's WKV launches by the chunked kernel, decode's by steps
    want_routes = {"chunk": want_prefill["wkv"],
                   "step": (N - 1) * want_decode["wkv"]}
    check(wkv_routes == want_routes,
          f"{arch} generate's WKV launches by route {wkv_routes}, not "
          f"{want_routes}")
    check_bf16_route(f"{arch} generate")
    gen_peak = torch.cuda.max_memory_allocated()
    check(tuple(toks.shape) == (B, N), f"generate returned {toks.shape}")
    want_gen = {k: want_prefill[k] + (N - 1) * want_decode[k]
                for k in KERNELS}
    check(gen_launches == want_gen,
          f"{arch} generate launched {gen_launches}, not {want_gen}")

    # the prefill alone (kernels, then plain versions) and decode steps
    logits, pre_ms = {}, {}
    for ex in ("cuda", "reference"):
        state = bundle.init_decode_state(B, T + N, device=dev)
        prefill = make_prefill(bundle, executor=ex)
        c0 = launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits[ex], st = prefill(params, state, prompt)
        torch.cuda.synchronize()
        pre_ms[ex] = (time.perf_counter() - t0) * 1e3
        if ex == "cuda":
            pre_launches, state = launch_counts(c0), st
        del st
    if cfg.family == "ssm":
        count_prefill_card_and_meta(bundle, params, prompt, T + N, arch)
    check(pre_launches == want_prefill,
          f"{arch} prefill launched {pre_launches}, not {want_prefill}")
    step = make_decode_step(bundle, executor="cuda")
    tok = toks[:, :1]
    c0 = launch_counts()
    pos = torch.full((B, 1), T, dtype=torch.long, device=dev)
    tok, _, state = step(params, state, tok, pos)
    dec_launches = launch_counts(c0)
    check(dec_launches == want_decode,
          f"{arch} decode step launched {dec_launches}, not {want_decode}")
    n_dec = 16
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n_dec):
        pos = torch.full((B, 1), T + 1 + i, dtype=torch.long, device=dev)
        tok, _, state = step(params, state, tok, pos)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / n_dec
    del state
    a, b = logits["cuda"][:, -1].float(), logits["reference"][:, -1].float()
    check(bool(torch.isfinite(a).all()), f"{arch}: non-finite logits")
    check(torch.equal(a.argmax(-1).int(), toks[:, 0]),
          f"{arch}: generate's first token is not its prefill's argmax")

    # the float32 prefill of the same weights, through the kernels
    import dataclasses

    def upcast(tree):
        if isinstance(tree, dict):
            return {k: upcast(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [upcast(v) for v in tree]
        return tree.float()
    torch.backends.cuda.matmul.allow_tf32 = False
    params32 = upcast(params)
    del params
    torch.cuda.empty_cache()
    b32 = build_model(dataclasses.replace(cfg, dtype="float32"))
    f, _ = make_prefill(b32, executor="cuda")(
        params32, b32.init_decode_state(B, T + N, device=dev), prompt)
    f = f[:, -1].float()
    del params32
    scale = float(f.abs().max())
    err = {"kernels": float((a - f).abs().max()) / scale,
           "plain": float((b - f).abs().max()) / scale,
           "each other": float((a - b).abs().max()) / float(b.abs().max())}
    check(err["kernels"] <= RECURRENT_SERVE_RATIO * err["plain"],
          f"{arch} bf16 prefill logits: the kernels' max |err| from float32 "
          f"{err['kernels']:.4g} of max |logit| is above "
          f"{RECURRENT_SERVE_RATIO} x the plain versions' {err['plain']:.4g}")
    top2 = f.topk(2, dim=-1).values
    sure = (top2[:, 0] - top2[:, 1]) > 2 * max(err.values()) * scale
    agree = a.argmax(-1) == f.argmax(-1)
    check(bool(agree[sure].all()),
          f"{arch}: the first greedy token differs from float32's on a row "
          f"with a clear top-2 margin")
    print(f"[16 recurrent serve] {arch} bf16, {cfg.num_layers} layers, "
          f"weights drawn on the card in {draw_s:.1f} s ({resident} B): "
          f"generate {B} x {T} prompt + {N} new tokens, wall "
          f"{gen_wall:.3f} s, launches {gen_launches} (WKV by route "
          f"{wkv_routes}); prefill "
          f"{pre_ms['cuda']:.1f} ms = {B * T / pre_ms['cuda'] * 1e3:.0f} "
          f"tok/s (plain versions {pre_ms['reference']:.1f} ms), launches "
          f"{pre_launches}; decode {step_ms:.2f} ms a step (mean of "
          f"{n_dec}, past position {T}) = {B / step_ms * 1e3:.0f} tok/s, "
          f"launches a step {dec_launches}; peak memory {gen_peak} B; "
          f"bf16 prefill logits' max |err| as a share of max |logit|: "
          f"kernels vs float32 {err['kernels']:.4g}, plain vs float32 "
          f"{err['plain']:.4g} (kernels at most {RECURRENT_SERVE_RATIO} x "
          f"plain), kernels vs plain {err['each other']:.4g}; first token "
          f"agrees with float32's on {int(agree.sum())}/{B} rows "
          f"({int(sure.sum())} with a clear top-2 margin)", flush=True)
    del logits, a, b, f
    torch.cuda.empty_cache()
    return {"launches": gen_launches, "wkv_routes": wkv_routes,
            "max_abs_err": err["each other"], "prefill_ms": pre_ms["cuda"],
            "decode_ms": step_ms}


# ------------------------------------------------------------- dry run --

# Phase 25: the dry run (src/repro_torch/launch/dryrun.py).  (a) Its CLI
# over a fake world of 256 ranks on the 16 x 16 mesh, with probes, in child
# processes beside the float32 goldens (they time nothing), for these cells:
# each group in a child of its own (the second, the recurrent, VLM and
# audio families' cells, 29-42 s each on one CPU thread).
DRYRUN_GROUPS = (
    (("qwen3-0.6b", "train_4k"), ("qwen3-moe-30b-a3b", "train_4k"),
     ("yi-9b", "train_4k"), ("qwen2-0.5b", "train_4k")),
    (("rwkv6-7b", "train_4k"), ("recurrentgemma-2b", "train_4k"),
     ("qwen2-vl-2b", "train_4k"), ("whisper-small", "train_4k")))
DRYRUN_CELLS = tuple(c for g in DRYRUN_GROUPS for c in g)
# (b) This cell at the probe's depth (PROBE_DEPTHS[0] layers) counted on meta
# and run on the card over the world of one: the card's FLOPs and bytes
# equal to the meta count, its peak (max_memory_allocated above the level
# before the call) within DRYRUN_PEAK_RTOL of the meta count's temp_bytes.
DRYRUN_CARD = ("qwen3-0.6b", "prefill_32k")
DRYRUN_PEAK_RTOL = 0.10


class DryrunChildren:
    """[25 dryrun] (a) ``python -m repro_torch.launch.dryrun --arch A
    --shape S`` for each cell of a group of DRYRUN_GROUPS in turn, in a
    child process a group (one CPU thread each; meta tensors, no card; the
    module run by ``runpy`` as ``-m`` runs it), started beside the float32
    goldens and joined after them."""

    def __init__(self):
        import tempfile

        self.out = tempfile.mkdtemp(prefix="dryrun_")
        env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
                   OMP_NUM_THREADS="1")
        self.t0 = time.perf_counter()
        self.procs = []
        for group in DRYRUN_GROUPS:
            argv = [["dryrun", "--arch", arch, "--shape", shape, "--out",
                     self.out] for arch, shape in group]
            code = ("import runpy, sys\n"
                    f"for argv in {argv!r}:\n"
                    "    sys.argv = argv\n"
                    "    runpy.run_module('repro_torch.launch.dryrun', "
                    "run_name='__main__')\n")
            self.procs.append(subprocess.Popen(
                [sys.executable, "-c", code], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True, cwd=ROOT, env=env))
            CHILDREN.append(self.procs[-1])

    def join(self) -> dict:
        """Wait for the children; hold each cell's result (every number
        finite, model_flops = 6 N_active D) and print its roofline terms,
        peak and useful FLOP share.  Returns {arch: result}."""
        import math
        import shutil

        from repro_torch.configs import SHAPES, get_config

        t0 = time.perf_counter()
        waits = []
        for proc in self.procs:
            out = proc.communicate(timeout=900)[0]
            waits.append(time.perf_counter() - t0)
            check(proc.returncode == 0, f"[25 dryrun] (a) a child exited "
                  f"{proc.returncode}\n{out[-3000:]}")
        res = {}
        for arch, shape in DRYRUN_CELLS:
            with open(os.path.join(self.out,
                                   f"{arch}_{shape}_16x16.json")) as f:
                r = json.load(f)
            bad = [path for path, v in _numbers(r)
                   if not math.isfinite(v)]
            check(not bad, f"[25 dryrun] (a) {arch} {shape}: non-finite "
                           f"{bad}")
            sh = SHAPES[shape]
            want = (6 * get_config(arch).active_param_count()
                    * sh["seq_len"] * sh["global_batch"])
            check(r["model_flops"] == want,
                  f"[25 dryrun] (a) {arch}: model_flops {r['model_flops']} "
                  f"!= 6 N_active D = {want}")
            t = r["roofline"]
            print(f"[25 dryrun] (a) {arch} {shape} over a fake world of "
                  f"{r['chips']} ranks ({r['mesh']}), probes: bottleneck "
                  f"{t['bottleneck']}; compute {t['compute_s']:.4f} s, "
                  f"memory {t['memory_s']:.4f} s, collective "
                  f"{t['collective_s']:.4f} s a step "
                  f"({r['flops_per_device']:.4g} FLOP, "
                  f"{r['hbm_bytes_per_device']:.4g} B, "
                  f"{r['coll_bytes_per_device']:.4g} collective B a device);"
                  f" peak {r['memory']['peak_per_device'] / 1e9:.2f} GB a "
                  f"device; useful FLOP share {r['useful_flops_ratio']:.4f}; "
                  f"full program traced in {r['compile_s']} s", flush=True)
            res[arch] = r
        shutil.rmtree(self.out, ignore_errors=True)
        print(f"[25 dryrun] (a) {len(self.procs)} child processes: "
              f"{time.perf_counter() - self.t0:.1f} s from start to join, "
              + ", ".join(f"the group of {g[0][0]} done {w:.1f} s into the "
                          f"join" for g, w in zip(DRYRUN_GROUPS, waits)),
              flush=True)
        return res


def _numbers(tree, path=""):
    """[(path, number)] of a JSON tree's ints and floats."""
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in _numbers(
            v, f"{path}/{k}")]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree) for x in _numbers(
            v, f"{path}/{i}")]
    if isinstance(tree, (int, float)) and not isinstance(tree, bool):
        return [(path, tree)]
    return []


def phase_dryrun_card(dev, mesh) -> dict:
    """[25 dryrun] (b) the dry run's prediction on meta against the card: a
    depth probe of DRYRUN_CARD (bf16, kernel 2 at hd 128) counted on meta,
    then the same step on the card over the world of one (``mesh``), counted
    and timed."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import set_mesh
    from repro_torch.kernels.flash_attention import flash_attention_bhtd
    from repro_torch.launch import dryrun
    from repro_torch.launch.hlo_stats import StepCounter, roofline_terms

    t_phase = time.perf_counter()
    arch, shape = DRYRUN_CARD
    probe = dryrun._probe_cfgs(get_config(arch))[0][1][0]
    pred = dryrun.count_cell(probe, shape, mesh, None)
    terms = roofline_terms(pred["flops"], pred["bytes"], pred["coll"], 1)
    roof_ms = max(terms["compute_s"], terms["memory_s"],
                  terms["collective_s"]) * 1e3
    fn, args = dryrun.build_cell(probe, shape, mesh, device=dev, seed=0)

    def step():
        with set_mesh(mesh):
            return fn(*args)

    step()                                   # cuBLAS workspaces, libraries
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_attention_counts()
    with StepCounter() as c:
        out = step()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - before
    launches = flash_attention_bhtd.launches
    check_bf16_route("[25 dryrun] (b)")
    temp = pred["memory"]["temp_bytes"]
    B = out.shape[0]
    check(tuple(out.shape) == (B, 1) and bool(
        ((out >= 0) & (out < probe.vocab_size)).all()),
        f"[25 dryrun] (b) next tokens {tuple(out.shape)} out of range")
    check(launches == probe.num_layers,
          f"[25 dryrun] (b) kernel 2 launched {launches} times, not "
          f"{probe.num_layers}")
    check(c.flops == pred["flops"] and c.bytes == pred["bytes"]
          and c.collectives == pred["coll_detail"],
          f"[25 dryrun] (b) the card counted {c.flops} FLOP, {c.bytes} B, "
          f"{c.collectives}; meta {pred['flops']}, {pred['bytes']}, "
          f"{pred['coll_detail']}")
    check(abs(peak - temp) <= DRYRUN_PEAK_RTOL * temp,
          f"[25 dryrun] (b) peak {peak} B on the card vs {temp} B counted "
          f"on meta (more than {DRYRUN_PEAK_RTOL:.0%} apart)")
    del out
    ms = time_cuda(step, 3)
    print(f"[25 dryrun] (b) {arch} {shape} at {probe.num_layers} of "
          f"{get_config(arch).num_layers} layers (B {B} x T "
          f"{args[1]['tokens'].shape[1]}), bf16, world of one: meta "
          f"{pred['flops']:.6g} FLOP, {pred['bytes']:.6g} B == the card's "
          f"count exactly ({c.kernels['flash_attention_bhtd']['calls']} "
          f"kernel 2 calls, {launches} launches); peak {peak} B on the "
          f"card vs temp_bytes {temp} B on meta ({peak / temp - 1:+.2%}; "
          f"peak_per_device {pred['memory']['peak_per_device']} B); "
          f"{ms:.1f} ms (CUDA events, median of 3) vs the roofline "
          f"{roof_ms:.1f} ms by {terms['bottleneck']} (compute "
          f"{terms['compute_s'] * 1e3:.1f}, memory "
          f"{terms['memory_s'] * 1e3:.1f} ms): share {roof_ms / ms:.3f}; "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    del fn, args
    torch.cuda.empty_cache()
    return {"ms": ms, "roofline_ms": roof_ms, "peak": peak, "temp": temp,
            "flops": pred["flops"], "bytes": pred["bytes"]}


def count_prefill_card_and_meta(bundle, params, prompt, max_len, tag):
    """[25 dryrun] (c) one prefill through the kernels counted on the card
    (``params``, ``prompt``) and the same call on meta: FLOPs, bytes and
    each kernel's count must be equal."""
    import torch

    from repro_torch.launch.hlo_stats import StepCounter
    from repro_torch.serve import make_prefill

    prefill = make_prefill(bundle, executor="cuda")
    B = prompt.shape[0]
    got = {}
    for where in ("card", "meta"):
        if where == "card":
            p, pr = params, prompt
        else:
            p, pr = bundle.init_params(0, device="meta"), prompt.to("meta")
        st = bundle.init_decode_state(B, max_len, device=pr.device)
        with StepCounter() as c:
            prefill(p, st, pr)
        got[where] = (c.flops, c.bytes, c.kernels)
        del st
    torch.cuda.synchronize()
    check(got["card"] == got["meta"],
          f"[25 dryrun] (c) {tag}: the card counted {got['card']}, meta "
          f"{got['meta']}")
    flops, nbytes, kernels = got["card"]
    print(f"[25 dryrun] (c) {tag} prefill {tuple(prompt.shape)} through the "
          f"kernels counted on the card == on meta: {flops:.6g} FLOP, "
          f"{nbytes:.6g} B; kernels "
          + ", ".join(f"{k} {v['calls']} calls {v['flops']:.4g} FLOP "
                      f"{v['bytes']:.4g} B" for k, v in kernels.items()),
          flush=True)


def phase_dots(dev) -> dict:
    """[25 dryrun] (d) phase 12's train step (qwen3-0.6b, bf16, remat,
    TRAIN_B x TRAIN_T) with ``remat_save="dots"`` beside ``"nothing"``,
    from one fresh state on one batch, in turn (nothing, dots, nothing,
    dots): the first-step loss bit-equal, the gradient norm within the
    spread of the two "nothing" runs; each one's peak memory and step ms."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import build as build_model
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import init_train_state, make_train_step

    t_phase = time.perf_counter()
    cfg = get_config("qwen3-0.6b")
    state = init_train_state(build_model(cfg), seed=0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(25)
    toks = torch.randint(0, cfg.vocab_size, (TRAIN_B, TRAIN_T + 1),
                         generator=gen, device=dev, dtype=torch.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    opt = AdamWConfig(lr=3e-4, warmup_steps=20, total_steps=TRAIN_STEPS)
    steps = {save: make_train_step(build_model(dataclasses.replace(
        cfg, remat_save=save)), opt) for save in ("nothing", "dots")}
    steps["nothing"](state, batch)           # warm-up
    runs = []
    for save in ("nothing", "dots", "nothing", "dots"):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        new, m = steps[save](state, batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        runs.append((save, m["loss"].item(), m["grad_norm"].item(), ms,
                     torch.cuda.max_memory_allocated() - before))
        del new, m
    loss = {r[1] for r in runs}
    gn = {s: [r[2] for r in runs if r[0] == s] for s in steps}
    spread = max(gn["nothing"]) - min(gn["nothing"])
    off = max(abs(g - gn["nothing"][0]) for g in gn["dots"])
    check(len(loss) == 1, f"[25 dryrun] (d) first-step losses differ: "
                          f"{runs}")
    check(off <= spread, f"[25 dryrun] (d) dots' gradient norms {gn['dots']}"
                         f" vs nothing's {gn['nothing']}: {off} off, beyond "
                         f"their spread {spread}")
    med = {s: statistics.median(r[3] for r in runs if r[0] == s)
           for s in steps}
    peak = {s: max(r[4] for r in runs if r[0] == s) for s in steps}
    print(f"[25 dryrun] (d) qwen3-0.6b bf16 train step {TRAIN_B} x "
          f"{TRAIN_T}, remat_save dots vs nothing in turn: loss "
          f"{runs[0][1]!r} bit-equal in all 4; grad norm nothing "
          f"{gn['nothing']}, dots {gn['dots']} ({off} off, spread {spread});"
          f" step ms nothing {med['nothing']:.1f}, dots {med['dots']:.1f} "
          f"(each {[round(r[3], 1) for r in runs]}); peak above the state "
          f"nothing {peak['nothing']} B, dots {peak['dots']} B "
          f"({peak['dots'] / peak['nothing']:.3f}x); "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    del state, steps, batch, toks
    torch.cuda.empty_cache()
    return {"step_ms": med, "peak": peak}


# ----------------------------------------------------------------- phases --

# --------------------------------------------------- recurrent training --

# Phase 19: recurrentgemma-2b training.  (a) Kernel 3 at its heads
# (FLASH_256: MQA 10/1 of 256; window 0 and 2,048), both routes, held as
# phase 10 holds it (hold_bwd), timed at the trainer's shape; kernel 2's o
# and LSE, which the backward reads, held as phase 7 holds them
# (FLASH_TOL) at the same cases, the trainer's B 2 x T 4,096 with its
# window of 2,048 among them.
RG_BWD_BATCH, RG_BWD_T, RG_BWD_WINDOWS = (1, 2), (200, 2048, 4096), (0, 2048)
# The float32 backward's first design at the trainer's shape (PERF.md's
# kernel table, H100 80GB HBM3, 700 W), printed beside today's.
RG_F32_BWD_EARLIER = "27.2186 ms"
# (b) The RG-LRU backward kernel vs its plain version, bit for bit, at
# C 2,560, on both of its paths (the TMA ring, the direct path), with T at
# a float32 tile (64 steps at 32 channels a block) +- 1; and kernel 5's
# forward h, which it reads, likewise.  Its earlier time (the first design,
# one thread a channel; PERF.md's kernel table, NVIDIA H100 80GB HBM3,
# 700 W) is printed beside today's.
RG_LRU_BWD_T = (1, 63, 65, 200, 4096)
RG_LRU_BWD_BATCH = (1, 2)
# ... and kernels 5 and 5b at a rank's channels of the 2,560 in the
# partitioned step (tp 2 and tp 16), at the trainer's B 2 x T 4,096.
RG_LRU_TP_C = (1280, 160)
RG_LRU_BWD_EARLIER = "one thread a channel: 0.8134 ms by CUDA events"
# (c) The float32 golden (tests/torch_goldens/make_train_golden.py
# recurrentgemma-2b: full width, 3 of 26 layers, B 1 x T 2,176), held to
# phase 11's tolerances.
RG_TRAIN_GOLDEN = "train_recurrentgemma_2b.json"
# (d) The trainer's cell: train_4k's sequence length
# (src/repro/configs/__init__.py:45) at one card's 2 rows of its global
# batch of 256, remat, 4 steps; then one B 1 step (loss and gradients)
# through the kernels and through the plain versions, held to phase 12's
# bf16 tolerances.
RG_TRAIN_B, RG_TRAIN_T, RG_TRAIN_STEPS, RG_CHECK_B = 2, 4096, 4, 1


def phase_recurrent_train_kernels(dev) -> dict:
    """[19 recurrent train] (a) kernel 3 at recurrentgemma-2b's heads on
    both routes and (b) the RG-LRU backward kernel, each vs its plain
    version on the card, timed at the trainer's shape."""
    import itertools

    import torch
    import torch.nn.functional as F

    from torch.nn.attention import SDPBackend, sdpa_kernel

    from repro_torch.kernels.flash_attention import (attention_bwd_ref,
                                                     attention_ref,
                                                     flash_attention_bhtd,
                                                     flash_attention_bwd_bhtd)
    from repro_torch.kernels.rglru import (rglru_bwd_ref, rglru_ref,
                                           rglru_scan, rglru_scan_bwd)

    H, Hkv, hd = FLASH_256
    g = torch.Generator(device=dev).manual_seed(19)

    def qkvd(B, T, dt):
        return [torch.randn(B, T, h, hd, generator=g, device=dev).to(dt)
                .transpose(1, 2) for h in (H, Hkv, Hkv, H)]

    worst = {"float32": 0.0, "bfloat16": 0.0}
    max_abs = {"float32": 0.0, "bfloat16": 0.0}
    worst_fwd = {"float32": 0.0, "bfloat16": 0.0}
    n = 0
    for B, T, window, dname in itertools.product(
            RG_BWD_BATCH, RG_BWD_T, RG_BWD_WINDOWS, ("bfloat16", "float32")):
        q, k, v, do = qkvd(B, T, getattr(torch, dname))
        kw = dict(causal=True, window=window)
        o, lse = flash_attention_bhtd(q, k, v, return_lse=True, **kw)
        o_ref, lse_ref = attention_ref(q, k, v, return_lse=True, **kw)
        err = max(float((a.float() - b.float()).abs().max())
                  for a, b in ((o, o_ref), (lse, lse_ref)))
        check(err <= FLASH_TOL[dname],
              f"[19a] flash forward hd 256 B={B} T={T} window={window} "
              f"{dname} (o and lse): max |err| {err}")
        worst_fwd[dname] = max(worst_fwd[dname], err)
        del o_ref, lse_ref
        got = flash_attention_bwd_bhtd(q, k, v, o, lse, do, **kw)
        want = attention_bwd_ref(q, k, v, o, lse, do, **kw)
        hold_bwd(f"[19a] flash backward hd 256 B={B} T={T} window={window} "
                 f"{dname}", dname, got, want, worst, max_abs)
        n += 1
        del q, k, v, do, o, lse, got, want
    torch.cuda.synchronize()
    print(f"[19 recurrent train] (a) kernel 3 == plain version on {n} cases "
          f"at recurrentgemma-2b's heads ({H}/{Hkv} of {hd}; B "
          f"{RG_BWD_BATCH}; T {RG_BWD_T}; causal, window "
          f"{RG_BWD_WINDOWS}; bf16 wgmma / f32 FMA): max |err| f32 "
          f"{worst['float32']:.3g} (tol {BWD_F32_TOL} + {BWD_F32_TOL} x "
          f"|ref|), bf16 {worst['bfloat16']:.3g} of each gradient's max (tol "
          f"{BWD_BF16_TOL}); the forward's o and lse (kernel 2) on the same "
          f"cases: max |err| f32 {worst_fwd['float32']:.3g}, bf16 "
          f"{worst_fwd['bfloat16']:.3g} (tol {FLASH_TOL})", flush=True)

    B, T, w = RG_TRAIN_B, RG_TRAIN_T, FLASH_256_WINDOW
    qpos = torch.arange(T, device=dev)
    mask = (qpos[None] <= qpos[:, None]) & (qpos[None] > qpos[:, None] - w)
    out = {}
    # kernel 2 at the trainer's shape (bf16, the wgmma route), the forward
    # the backward reads: against its bound, the plain version, SDPA with
    # the window as a mask and SDPA's flash forward, causal over all T
    q, k, v, _ = qkvd(B, T, torch.bfloat16)
    fwd_ms = time_cuda(lambda: flash_attention_bhtd(q, k, v, window=w), 5)
    fwd_plain_ms = time_cuda(lambda: attention_ref(q, k, v, window=w), 2)
    fwd_lib_ms = time_cuda(lambda: F.scaled_dot_product_attention(
        q, k.expand(B, H, T, hd), v.expand(B, H, T, hd), attn_mask=mask), 5)
    with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
        fwd_flash_ms = time_cuda(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True), 5)
    fb_ms, fb_by, fb_flops, fb_bytes = flash_bound(
        B, H, Hkv, hd, T, T, True, 2, window=w)
    print(f"[19 recurrent train] (a) kernel 2, bf16 (wgmma) B={B} T={T} "
          f"window={w}: {fwd_ms:.4f} ms (median of 5); bound {fb_ms:.4f} ms "
          f"by {fb_by} ({fb_flops} FLOP, {fb_bytes} B); x bound "
          f"{fwd_ms / fb_ms:.1f}; plain {fwd_plain_ms:.3f} ms; "
          f"scaled_dot_product_attention (window mask) {fwd_lib_ms:.4f} ms, "
          f"its flash backend causal without the window (more work) "
          f"{fwd_flash_ms:.4f} ms", flush=True)
    out["forward"] = dict(ms=fwd_ms, plain_ms=fwd_plain_ms,
                          library_ms=fwd_lib_ms,
                          library_flash_causal_ms=fwd_flash_ms,
                          bound_ms=fb_ms, bound_by=fb_by)
    del q, k, v
    for dname, ops_per_s, elem in (("bfloat16", BF16_TENSOR_OPS_PER_S, 2),
                                   ("float32", F32_OPS_PER_S, 4)):
        q, k, v, do = qkvd(B, T, getattr(torch, dname))
        o, lse = flash_attention_bhtd(q, k, v, return_lse=True, window=w)
        reps = 5 if dname == "bfloat16" else 3
        ms = time_cuda(lambda: flash_attention_bwd_bhtd(q, k, v, o, lse, do,
                                                        window=w), reps)
        plain_ms = time_cuda(lambda: attention_bwd_ref(q, k, v, o, lse, do,
                                                       window=w), 2)
        # SDPA with the window as a boolean mask; k and v expanded to the
        # query heads (a view), so its backward sums dk and dv over them
        xs = [x.detach().requires_grad_() for x in (q, k, v)]
        lib_o = F.scaled_dot_product_attention(
            xs[0], xs[1].expand(B, H, T, hd), xs[2].expand(B, H, T, hd),
            attn_mask=mask)
        lib_ms = time_cuda(lambda: torch.autograd.grad(
            lib_o, xs, do, retain_graph=True), reps)
        del lib_o
        bound_ms, bound_by, flops, nbytes = bwd_bound(
            B, H, Hkv, hd, T, True, elem, ops_per_s, window=w)
        out[dname] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                          bound_ms=bound_ms, bound_by=bound_by,
                          max_abs_err=max_abs[dname])
        flash_note = ""
        if dname == "bfloat16":
            # A mask takes SDPA off its flash backend; its flash backward,
            # causal over all T (window 0), does more work than the
            # windowed function and so bounds the library's time above.
            with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
                lib_o = F.scaled_dot_product_attention(
                    *xs, is_causal=True, enable_gqa=True)
                flash_ms = time_cuda(lambda: torch.autograd.grad(
                    lib_o, xs, do, retain_graph=True), reps)
            del lib_o
            out[dname]["library_flash_causal_ms"] = flash_ms
            flash_note = (f"; its flash backend's backward, causal without "
                          f"the window (more work) {flash_ms:.4f} ms")
        if dname == "float32":
            flash_note = f"; the first design {RG_F32_BWD_EARLIER}"
        print(f"[19 recurrent train] (a) {dname} "
              f"({'wgmma' if elem == 2 else 'FMA'} kernels) B={B} T={T} "
              f"window={w}: kernel {ms:.4f} ms (dq + dk/dv + delta, median "
              f"of {reps}); bound {bound_ms:.4f} ms by {bound_by} ({flops} "
              f"FLOP, {nbytes} B); x bound {ms / bound_ms:.1f}; plain "
              f"{plain_ms:.3f} ms; scaled_dot_product_attention backward "
              f"(window mask) {lib_ms:.4f} ms{flash_note}", flush=True)
        del q, k, v, do, o, lse, xs

    # (b) the RG-LRU backward kernel, bit for bit, on both of its paths
    import contextlib
    import importlib

    rg = importlib.import_module("repro_torch.kernels.rglru.rglru")

    @contextlib.contextmanager
    def path(tma):
        """The backward with its path forced (None: the wrapper's own)."""
        orig = rg.bwd_plan
        if tma is not None:
            rg.bwd_plan = lambda *x: (orig(*x)[0], tma)
        try:
            yield
        finally:
            rg.bwd_plan = orig

    C = RGLRU_C
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    n = 0
    paths = {"ring": 0, "direct": 0}
    # a rank's channels first: the last case, at C and the trainer's shape,
    # is the one timed below
    cases = [(RG_TRAIN_B, RG_TRAIN_T, c) for c in RG_LRU_TP_C]
    cases += [(B, T, C) for B, T in itertools.product(RG_LRU_BWD_BATCH,
                                                      RG_LRU_BWD_T)]
    for B, T, Cn in cases:
        a = torch.rand(B, T, Cn, generator=g, device=dev) * 0.1 + 0.9
        b, gr = (torch.randn(B, T, Cn, generator=g, device=dev)
                 for _ in range(2))
        h = rglru_scan(a, b)
        check(torch.equal(h, rglru_ref(a, b)),
              f"[19b] rglru forward B={B} T={T} C={Cn}: kernel != plain "
              f"version")
        want = rglru_bwd_ref(a, h, gr)
        own = rg.bwd_plan(a, h, gr, *want, n_sms)[1]
        # the ring's cases also run on the direct path, forced
        for tma in ((None, False) if own else (None,)):
            with path(tma):
                got = rglru_scan_bwd(a, h, gr)
            on = "ring" if own and tma is None else "direct"
            check(all(torch.equal(x, y) for x, y in zip(got, want)),
                  f"[19b] rglru backward B={B} T={T} C={Cn} {on} path: "
                  f"kernel != plain version")
            paths[on] += 1
            n += 1
    B, T = RG_TRAIN_B, RG_TRAIN_T
    fwd_ms = time_cuda(lambda: rglru_scan(a, b), 5)
    fwd_dev_ms = kernel_device_ms(lambda: rglru_scan(a, b))
    fwd_bound = rglru_bound(B, T, C, 4)[0]
    print(f"[19 recurrent train] (b) kernel 5 (forward) B={B} T={T} C={C} "
          f"f32: {fwd_ms:.4f} ms (CUDA events, median of 5), "
          + ("device time not measured" if fwd_dev_ms is None else
             f"{fwd_dev_ms:.4f} ms of device time (20 calls queued)")
          + f"; bound {fwd_bound:.4f} ms by bytes; earlier "
          f"{RGLRU_EARLIER_MS[(B, T)]}", flush=True)
    plain_ms = time_cuda(lambda: rglru_bwd_ref(a, h, gr), 2)
    bound_ms, bound_by, flops, nbytes = rglru_bound(B, T, C, 4,
                                                    backward=True)
    width, own = rg.bwd_plan(a, h, gr, *want, n_sms)
    check(own, f"[19b] the trainer's shape B={B} T={T} takes the ring")
    timed = {}
    for on, tma in (("ring", None), ("direct", False)):
        with path(tma):
            ms = time_cuda(lambda: rglru_scan_bwd(a, h, gr), 5)
            dev_ms = kernel_device_ms(lambda: rglru_scan_bwd(a, h, gr))
        timed[on] = dict(ms=ms, device_ms=dev_ms)
        dev_txt = ("device time not measured" if dev_ms is None else
                   f"{dev_ms:.4f} ms of device time (20 calls queued; x "
                   f"bound {dev_ms / bound_ms:.2f})")
        print(f"[19 recurrent train] (b) RG-LRU backward, {on} path"
              f"{'' if tma is None else ' (forced)'}, {width} channels a "
              f"block, B={B} T={T}: {ms:.4f} ms (CUDA events, median of 5), "
              f"{dev_txt}; bound {bound_ms:.4f} ms by {bound_by} ({nbytes} B "
              f"at 3.35 TB/s, {flops} FLOP); earlier {RG_LRU_BWD_EARLIER}",
              flush=True)
    print(f"[19 recurrent train] (b) RG-LRU backward kernel, and kernel 5's "
          f"forward h that it reads, == plain versions bit for bit on {n} "
          f"cases ({paths['ring']} on the TMA ring, {paths['direct']} on "
          f"the direct path; C {C}; B {RG_LRU_BWD_BATCH}; T {RG_LRU_BWD_T}; "
          f"and a rank's C {RG_LRU_TP_C} at B {RG_TRAIN_B} x T {RG_TRAIN_T}, "
          f"the partitioned step's; f32); plain {plain_ms:.3f} ms (median "
          f"of 2) at B={B} T={T}; "
          f"library call: none", flush=True)
    out["rglru_bwd"] = dict(ms=timed["ring"]["ms"],
                            device_ms=timed["ring"]["device_ms"],
                            plain_ms=plain_ms, bound_ms=bound_ms,
                            bound_by=bound_by, max_abs_err=0.0,
                            library_ms=None, paths=timed)
    del a, b, gr, h, got, want
    torch.cuda.empty_cache()
    return out


def phase_recurrent_train(dev) -> dict:
    """[19 recurrent train] recurrentgemma-2b training: (a, b) the backward
    kernels vs their plain versions, (c) the float32 golden, (d) bf16 at
    full width and depth through ``trainer.train``."""
    import torch

    from repro_torch import convert
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import (flash_attention_bhtd,
                                                     flash_attention_bwd_bhtd)
    from repro_torch.kernels.rglru import rglru_scan, rglru_scan_bwd
    from repro_torch.optim import global_norm
    from repro_torch.train import loss_and_grads, make_loss_fn
    from repro_torch.tree import leaves_with_paths

    t_phase = time.perf_counter()
    res = {"kernels": phase_recurrent_train_kernels(dev)}

    # (c) the float32 golden, its attention on the FMA route
    with open(os.path.join(ROOT, "tests", "torch_goldens",
                           RG_TRAIN_GOLDEN)) as f:
        gold = json.load(f)
    cut = dataclasses.replace(get_config(gold["arch"]), dtype="float32",
                              num_layers=gold["num_layers"])
    t0 = time.perf_counter()
    tree = convert.random_lm_params(cut, seed=gold["seed"])
    print(f"[19 recurrent train] (c) {gold['arch']} weights, {cut.num_layers} "
          f"of 26 layers ({gold['depth_cut']}), drawn with numpy in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    fma0 = fma_launches()
    phase_train_golden(dev, tree, RG_TRAIN_GOLDEN, "[19 recurrent train] (c)")
    res["fma"] = [b - a for a, b in zip(fma0, fma_launches())]
    check(all(res["fma"]), f"the float32 golden launched the FMA attention "
                           f"kernels {res['fma']} times")
    del tree

    # (d) bf16, full width and depth, through the trainer
    cfg = get_config("recurrentgemma-2b")
    n_attn = attention_layers(cfg)
    n_rec = cfg.num_layers - n_attn
    # remat recomputes each layer's forward in the backward
    run = train_on_card(
        dev, "[19 recurrent train] (d)", cfg,
        {"flash_attention": flash_attention_bhtd,
         "flash_attention_bwd": flash_attention_bwd_bhtd,
         "rglru": rglru_scan, "rglru_bwd": rglru_scan_bwd},
        {"flash_attention": 2 * n_attn, "flash_attention_bwd": n_attn,
         "rglru": 2 * n_rec, "rglru_bwd": n_rec},
        RG_TRAIN_B, RG_TRAIN_T, RG_TRAIN_STEPS,
        f"{cfg.num_layers} layers: {n_rec} RG-LRU, {n_attn} local MQA",
        keep_state=True)
    state, bundle = run.pop("state"), run.pop("bundle")
    mean_ms, peak, breakdown = run["step_ms"], run["peak"], run["breakdown"]
    tokens = RG_TRAIN_B * RG_TRAIN_T
    k5 = "rglru (kernel 5)"
    print(f"[19 recurrent train] (d) step {mean_ms:.1f} ms = "
          f"{tokens / mean_ms * 1e3:.0f} tokens/s, peak memory "
          f"{peak / 1e9:.2f} GB; kernel 5 in the profiled step: "
          + ("not measured" if breakdown is None else
             f"{breakdown[k5]:.1f} ms of {breakdown['busy_ms']:.1f} ms of "
             f"device time ({breakdown[k5] / breakdown['busy_ms']:.3f})")
          + " (PR 18: 865.7 ms, 9,463 tokens/s, 65.28 GB; kernel 5 65.1 ms "
          "of the device time)", flush=True)

    # one step at B 1 from the trained state: kernels vs plain versions
    gen = torch.Generator().manual_seed(19)
    toks = torch.randint(0, cfg.vocab_size, (RG_CHECK_B, RG_TRAIN_T + 1),
                         generator=gen, dtype=torch.int32).to(dev)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    got = {}
    for ex in ("cuda", "reference"):
        t1 = time.perf_counter()
        loss, _, _, grads = loss_and_grads(make_loss_fn(bundle, executor=ex),
                                           state.params, batch)
        got[ex] = (float(loss), float(global_norm(grads)), grads,
                   time.perf_counter() - t1)
    (lk, gk, grk, sk), (lr_, gr, grr, sr) = got["cuda"], got["reference"]
    l_err, g_err = abs(lk - lr_) / abs(lr_), abs(gk - gr) / gr
    leaf_err = {p: float((a.float() - b.float()).norm()
                         / b.float().norm().clamp_min(1e-30))
                for (p, a), (_, b) in zip(leaves_with_paths(grk),
                                          leaves_with_paths(grr))}
    worst = max(leaf_err, key=leaf_err.get)
    check(l_err <= TRAIN_BF16_LOSS_RTOL and g_err <= TRAIN_BF16_GNORM_RTOL
          and leaf_err[worst] <= TRAIN_BF16_GRAD_RTOL,
          f"recurrentgemma bf16 step, kernels vs plain: loss {lk} vs {lr_}, "
          f"grad norm {gk} vs {gr}, worst leaf {worst} rel L2 "
          f"{leaf_err[worst]}")
    print(f"[19 recurrent train] (d) one bf16 step at {RG_CHECK_B} x "
          f"{RG_TRAIN_T} from the trained state, kernels vs plain versions "
          f"({sk:.1f} s / {sr:.1f} s): loss {lk:.6f} vs {lr_:.6f} (rel "
          f"{l_err:.3g}, tol {TRAIN_BF16_LOSS_RTOL}); grad norm {gk:.5f} vs "
          f"{gr:.5f} (rel {g_err:.3g}, tol {TRAIN_BF16_GNORM_RTOL}); "
          f"per-leaf gradient rel L2 distance max {leaf_err[worst]:.3g} at "
          f"{worst} (tol {TRAIN_BF16_GRAD_RTOL}), median "
          f"{statistics.median(leaf_err.values()):.3g}", flush=True)
    del state, got, grk, grr
    torch.cuda.empty_cache()
    print(f"[19 recurrent train] phase time "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    res.update(launches=run["launches"], per_step=run["per_step"],
               step_ms=mean_ms, peak=peak, breakdown=breakdown)
    return res


# --------------------------------------------------------- rwkv6 training --

# Phase 22: rwkv6-7b training.  (a) The WKV backward's two routes vs its
# plain version at rwkv6-7b's heads (H 64 of 64, the upper half of a tensor
# of 128 heads, so that every stride differs from a contiguous one): r, k,
# v float32 or bf16 with w float32 or bf16; T about the 64-step chunks and
# their sub-chunks (WKV_BWD_T at B 1 with S0 and dS_final zero, at B 2 with
# both given) and the trainer's T (WKV_BWD_LONG); decays exp(-exp(x)) for
# x uniform in [-8, 3], and phase 13's extreme ranges (WKV_EXTREME_X) at
# (B, T) of WKV_BWD_EXTREME_BT.  Every bf16 case runs on both routes (the
# plan's, and the other forced); float32 cases take the step route.
# Tolerances, relative to the reference's largest |value| (at least 1):
# 1e-2 for bf16 outputs (dr, dk, dv; dw of a bf16 decay), one rounding of
# float32 sums taken in another order; 1e-4 for float32 ones (dw of a
# float32 decay, du, dS0), which the chunked route's bf16 high + low
# operand split holds as kernel 4's chunked route holds S_final.  Both
# routes recompute the states from the same inputs as the plain version
# and never read the forward's accumulators, so the forward's route does
# not enter these tolerances.
WKV_BWD_T = (1, 63, 64, 65, 200)
WKV_BWD_LONG = ((2, 4096, "bfloat16", "float32", True, False),
                (1, 4096, "float32", "float32", False, True),
                (1, 4096, "bfloat16", "bfloat16", True, True))
WKV_BWD_PAIRS = (("float32", "float32"), ("bfloat16", "float32"),
                 ("bfloat16", "bfloat16"))
WKV_BWD_TOL = {"bfloat16": 1e-2, "float32": 1e-4}
WKV_BWD_EXTREME_BT = ((1, 2048), (2, 200))
# The step route's time at the trainer's shape when it was the only route
# (PERF.md's kernel table, row 4b, device time; NVIDIA H100 80GB HBM3,
# 700 W), printed beside today's.
WKV_BWD_EARLIER_MS = "the step route alone, before the chunked one: " \
    "6.7707-6.8119"
# (b) The float32 golden (tests/torch_goldens/make_train_golden.py
# rwkv6-7b: full width, 4 of 32 layers, B 1 x T 200: three 64-step
# checkpoints and a ragged tail), held to phase 11's tolerances but for
# the gradient norms, which this cell's float32 arithmetic cannot hold to
# 1e-4 (tests/torch_goldens/measure_rwkv6_conditioning.py, on the CPU):
#   * step 1, each leaf's and the global one: 2e-3.  The gradient is
#     ill-conditioned in the leaves the WKV's dr, dk and du feed (tm/wr,
#     wk, u, the token-shift mixes, the norms and the embedding below
#     them): against the same model's gradient in float64 (the port on
#     the CPU), jitted JAX's float32 gradient (the golden) is 1.67e-4 off
#     in those leaves' norms and the port's plain versions on the CPU
#     7.0e-4 (8.6e-4 from the golden); JAX op by op is 8.1e-5 from jitted
#     JAX.
#   * step 2's global norm: 3e-2.  Step 1 takes the loss from 11.84 to
#     0.52, and moving every weight by one float32 ulp (x (1 +- 2^-24))
#     moves jitted JAX's own step-2 gradient norm by 1.30% (its step-1
#     norm by 4.7e-4, its step-2 loss by 5.3e-6).
RWKV_TRAIN_GOLDEN = "train_rwkv6_7b.json"
RWKV_TRAIN_TOL = dict(TRAIN_TOL, gnorm=2e-3, gnorm_later=3e-2)
# (c) bf16 at full width and 8 of 32 layers through trainer.train: the
# update is not in place (adamw_update builds new params, mu and nu beside
# the old ones), ~22 B a parameter with the gradient, so full depth's
# 7.58 B parameters do not fit 80 GB and 8 layers' 2.30 B reckon to ~63
# GB; train_4k's sequence at one card's 2 rows of its batch, remat, 4
# steps (RG_TRAIN_*'s cut).
RWKV_TRAIN_LAYERS = 8
RWKV_TRAIN_BUDGET_S = 60.0      # the phase's time on a host like run I's


def wkv_bwd_bound(B, H, T, hd, elem_bytes, w_bytes, with_s0, with_ds,
                  route="step"):
    """(bound_ms, bound_by, flops, bytes, recurrent_ms) of one WKV backward
    call by ``route`` (``cost.wkv_bwd``).  Bytes: r, k, v, dy read and dr,
    dk, dv written once in their type, w read and dw written once in its
    type, u, S0 and dS_final read and dS0 and du's per-row partials written
    once.  Operations: the route's own at its unit's rate, the chunked
    route's tensor-core products (``cost.wkv_bwd_chunk_flops``) at 989
    TFLOP/s, the step route's 12 hd^2 float32 operations per (b, h, t) (the
    states' forward walk once, 2 hd^2, and the backward's five sums and
    state update, 10 hd^2) at the CUDA cores' 67 TFLOP/s.  recurrent_ms is
    that last figure for any route, printed beside the bound under its own
    name."""
    rec_flops = 12 * hd * hd * B * H * T
    flops, nbytes = cost.wkv_bwd(B, H, T, hd, elem_bytes, w_bytes, with_s0,
                                 with_ds, route)
    rate = BF16_TENSOR_OPS_PER_S if route == "chunk" else F32_OPS_PER_S
    t_ops = flops / rate * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes
            else "bytes", flops, nbytes, rec_flops / F32_OPS_PER_S * 1e3)


def phase_wkv_bwd(dev) -> dict:
    """[22 rwkv6 train] (a) the WKV backward's routes vs its plain version
    on the card (the chunked route and the step route, each bf16 case on
    both); both timed at the trainer's shape against their bounds, beside
    the plain version and the forward kernel there."""
    import contextlib
    import importlib
    import itertools

    import torch

    from repro_torch.kernels.rwkv6 import wkv_bhtd, wkv_bwd_bhtd, wkv_bwd_ref

    mod = importlib.import_module("repro_torch.kernels.rwkv6.rwkv6")
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    H, hd = WKV_HEADS, 64
    g = torch.Generator(device=dev).manual_seed(22)

    def inputs(B, T, dname, wname, with_s0, with_ds, x_range=(-8.0, 3.0),
               H=H):
        def heads(x, dt):     # the upper H of 2 H heads
            return x.to(dt).transpose(1, 2)[:, H:]

        r, k, v = (heads(torch.randn(B, T, 2 * H, hd, generator=g,
                                     device=dev) * 0.5, getattr(torch, dname))
                   for _ in range(3))
        dy = heads(torch.randn(B, T, 2 * H, hd, generator=g, device=dev),
                   getattr(torch, dname))
        lo, hi = x_range
        x = lo + (hi - lo) * torch.rand(B, T, 2 * H, hd, generator=g,
                                        device=dev)
        w = heads(torch.exp(-torch.exp(x)), getattr(torch, wname))
        u = torch.randn(H, hd, generator=g, device=dev) * 0.5
        S0, dS = (torch.randn(B, H, hd, hd, generator=g, device=dev) * 0.2
                  if on else None for on in (with_s0, with_ds))
        return r, k, v, w, u, S0, dy, dS

    @contextlib.contextmanager
    def forced(plan):
        """The wrapper with its route forced to ``plan`` (None: its own)."""
        orig = mod.wkv_bwd_plan
        if plan is not None:
            mod.wkv_bwd_plan = lambda *a: plan
        try:
            yield
        finally:
            mod.wkv_bwd_plan = orig

    names = ("dr", "dk", "dv", "dw", "du", "dS0")
    worst = {(route, kind): 0.0 for route in ("chunk", "step")
             for kind in ("bfloat16", "float32")}
    max_abs = {"chunk": 0.0, "step": 0.0}
    cases = [(B, T, dn, wn, on, on, None, H) for (dn, wn), T, (B, on) in
             itertools.product(WKV_BWD_PAIRS, WKV_BWD_T,
                               ((1, False), (2, True)))]
    cases += [c + (None, H) for c in WKV_BWD_LONG]
    cases += [(B, T, "bfloat16", "float32", True, True, x, H)
              for (B, T), x in itertools.product(WKV_BWD_EXTREME_BT,
                                                 WKV_EXTREME_X)]
    # a rank's heads in the partitioned step, as the trainer calls it
    cases += [(*WKV_TP_BT, "bfloat16", "float32", False, False, None, h)
              for h in WKV_TP_HEADS]
    n = 0
    for B, T, dname, wname, with_s0, with_ds, x_range, nh in cases:
        args = inputs(B, T, dname, wname, with_s0, with_ds,
                      x_range or (-8.0, 3.0), nh)
        want = wkv_bwd_ref(*args)
        own = mod.wkv_bwd_plan(*args[:4], args[6], n_sms)
        check(dname == "bfloat16" or own[0] == "step",
              f"[22a] a float32 case planned on the {own[0]} route")
        plans = [None]
        if dname == "bfloat16":   # the other route too
            plans.append(("step", 64) if own[0] == "chunk" else
                         ("chunk", 32))
        for plan in plans:
            route = (plan or own)[0]
            before = dict(wkv_bwd_bhtd.route_launches)
            with forced(plan):
                got = wkv_bwd_bhtd(*args)
            torch.cuda.synchronize()
            check(wkv_bwd_bhtd.route_launches[route] == before[route] + 1
                  and sum(wkv_bwd_bhtd.route_launches.values())
                  == sum(before.values()) + 1,
                  f"the WKV backward wrapper did not launch once on the "
                  f"{route} route")
            for name, a, b in zip(names, got, want):
                check(a.dtype == b.dtype and a.shape == b.shape,
                      f"wkv_bwd {name}: {a.dtype} {tuple(a.shape)} vs "
                      f"{b.dtype} {tuple(b.shape)}")
                kind = "float32" if a.dtype == torch.float32 else "bfloat16"
                diff = float((a.float() - b.float()).abs().max())
                err = diff / max(1.0, float(b.float().abs().max()))
                check(err <= WKV_BWD_TOL[kind],
                      f"[22a] wkv_bwd B={B} T={T} H={nh} {dname}/{wname} "
                      f"S0={with_s0} dS_final={with_ds} decays x in "
                      f"{x_range or (-8.0, 3.0)} {route} route"
                      f"{' (forced)' if plan else ''}: {name} err {err} "
                      f"(tol {WKV_BWD_TOL[kind]})")
                worst[route, kind] = max(worst[route, kind], err)
                max_abs[route] = max(max_abs[route], diff)
            n += 1
            del got
        del args, want
    torch.cuda.synchronize()
    print(f"[22 rwkv6 train] (a) WKV backward == plain version on {n} runs "
          f"(H {H} of 128 heads, hd {hd}; r/k/v and w {WKV_BWD_PAIRS}; T "
          f"{WKV_BWD_T} at B 1 (S0, dS_final zero) and B 2 (both given), "
          f"(B, T, r/k/v, w, S0, dS_final) {WKV_BWD_LONG}; decays "
          f"exp(-exp(x)), x in [-8, 3], and x in {WKV_EXTREME_X} at (B, T) "
          f"{WKV_BWD_EXTREME_BT}; a rank's H {WKV_TP_HEADS} at B "
          f"{WKV_TP_BT[0]} x T {WKV_TP_BT[1]}, bf16 r/k/v, float32 w (the "
          f"partitioned step's); every bf16 case on both routes, float32 "
          f"on the step route): max err / max(1, max |ref|), chunked route "
          f"bf16 outputs {worst['chunk', 'bfloat16']:.3g}, float32 outputs "
          f"{worst['chunk', 'float32']:.3g}; step route bf16 "
          f"{worst['step', 'bfloat16']:.3g}, float32 "
          f"{worst['step', 'float32']:.3g} (tol {WKV_BWD_TOL['bfloat16']} "
          f"/ {WKV_BWD_TOL['float32']}); max |err| chunk "
          f"{max_abs['chunk']:.3g}, step {max_abs['step']:.3g}", flush=True)

    # the trainer's call: bf16 r, k, v, dy, float32 w, no S0, S_final
    # unused (its gradient None), on each route
    B, T = RG_TRAIN_B, RG_TRAIN_T
    args = inputs(B, T, "bfloat16", "float32", False, False)
    own = mod.wkv_bwd_plan(*args[:4], args[6], n_sms)
    check(own[0] == "chunk", f"the trainer's backward planned {own}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    wkv_bwd_ref(*args)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    fwd_ms = time_cuda(lambda: wkv_bhtd(*args[:6]), 5)
    fb = wkv_bound(B, H, T, hd, 2, False, "chunk")
    timed = {}
    for plan in [None] + [p for p in (("chunk", 32), ("chunk", 64),
                                      ("step", 64)) if p != own]:
        route, nj = plan or own
        with forced(plan):
            ms = time_cuda(lambda: wkv_bwd_bhtd(*args), 5)
            dev_ms = kernel_device_ms(lambda: wkv_bwd_bhtd(*args))
            split = (kernel_split_ms(lambda: wkv_bwd_bhtd(*args), "wkv_bwd")
                     if route == "chunk" else None)
        bound_ms, bound_by, flops, nbytes, rec_ms = wkv_bwd_bound(
            B, H, T, hd, 2, 4, False, False, route)
        timed[f"{route}/{nj}"] = dict(ms=ms, device_ms=dev_ms,
                                      bound_ms=bound_ms, bound_by=bound_by,
                                      recurrent_bound_ms=rec_ms, split=split)
        dev_txt = ("device time not measured" if dev_ms is None else
                   f"{dev_ms:.4f} ms of device time (20 calls queued; x "
                   f"bound {dev_ms / bound_ms:.2f})")
        split_txt = ("" if not split else "; by kernel (profiler, median of "
                     "5 calls): " + ", ".join(f"{k} {v:.4f} ms"
                                              for k, v in split.items()))
        print(f"[22 rwkv6 train] (a) WKV backward, rwkv6-7b heads bf16 (w "
              f"f32) B={B} T={T}: {route} route"
              f"{f', state pass over {nj} columns a block' if route == 'chunk' else ''}"
              f" ({'the plan' if plan is None else 'forced'}): {ms:.4f} ms "
              f"(CUDA events, median of 5), {dev_txt}{split_txt}; bound "
              f"{bound_ms:.4f} ms by {bound_by} ({flops} FLOP at "
              f"{'989' if route == 'chunk' else '67'} TFLOP/s, {nbytes} B "
              f"at 3.35 TB/s); the recurrent form's operations at 67 "
              f"TFLOP/s {rec_ms:.4f} ms; earlier {WKV_BWD_EARLIER_MS}; "
              f"plain {plain_ms:.1f} ms (one run); library call: none (no "
              f"PyTorch call computes this recurrence's gradient); the "
              f"forward kernel at the same shape {fwd_ms:.4f} ms (bound "
              f"{fb[0]:.4f})", flush=True)
    del args
    torch.cuda.empty_cache()
    mine = timed[f"{own[0]}/{own[1]}"]
    step = timed["step/64"]
    return dict(ms=mine["ms"], device_ms=mine["device_ms"],
                plain_ms=plain_ms, bound_ms=mine["bound_ms"],
                bound_by=mine["bound_by"],
                recurrent_bound_ms=mine["recurrent_bound_ms"],
                max_abs_err=max_abs["chunk"],
                max_rel_err=max(worst["chunk", k]
                                for k in ("bfloat16", "float32")),
                library_ms=None, forward_ms=fwd_ms, split=mine["split"],
                variants=timed,
                step=dict(ms=step["ms"], device_ms=step["device_ms"],
                          plain_ms=plain_ms, bound_ms=step["bound_ms"],
                          bound_by=step["bound_by"],
                          max_abs_err=max_abs["step"],
                          max_rel_err=max(worst["step", k]
                                          for k in ("bfloat16", "float32")),
                          library_ms=None))


def kernel_split_ms(fn, key, calls=5):
    """Device time (ms) of each kernel whose name holds ``key`` in one call
    of ``fn``: the median over ``calls`` calls under ``torch.profiler``;
    None when the trace holds no device events."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    times = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA and key in e.name:
            name = re.search(r"(\w+_kernel)", e.name)
            name = name.group(1) if name else e.name[:40]
            times.setdefault(name, []).append(
                (e.time_range.end - e.time_range.start) / 1e3)
    return {k: statistics.median(v) for k, v in times.items()} or None


def phase_rwkv6_train(dev, drawn=None) -> dict:
    """[22 rwkv6 train] rwkv6-7b training: (a) the WKV backward kernel vs
    its plain version, (b) the float32 golden (from ``drawn``, phase 15's
    weights with their seed and depth, where they are the golden's), (c)
    bf16 at full width and 8 of 32 layers through ``trainer.train``."""
    from repro_torch import convert
    from repro_torch.configs import get_config
    from repro_torch.kernels.rwkv6 import wkv_bhtd, wkv_bwd_bhtd

    t_phase = time.perf_counter()
    res = {"kernel": phase_wkv_bwd(dev)}

    # (b) the float32 golden: the forward's step route (float32), the
    # backward kernel
    with open(os.path.join(ROOT, "tests", "torch_goldens",
                           RWKV_TRAIN_GOLDEN)) as f:
        gold = json.load(f)
    cut = dataclasses.replace(get_config(gold["arch"]), dtype="float32",
                              num_layers=gold["num_layers"])
    if drawn is not None and (drawn["seed"], drawn["num_layers"]) == (
            gold["seed"], cut.num_layers):
        tree, how = drawn["tree"], "phase 15's draw, reused"
    else:
        t0 = time.perf_counter()
        tree = convert.random_lm_params(cut, seed=gold["seed"])
        how = f"drawn with numpy in {time.perf_counter() - t0:.1f} s"
    del drawn
    print(f"[22 rwkv6 train] (b) {gold['arch']} weights, {cut.num_layers} of "
          f"32 layers ({gold['depth_cut']}), {how}", flush=True)
    before = (wkv_bhtd.launches, wkv_bwd_bhtd.launches)
    bwd_routes0 = dict(wkv_bwd_bhtd.route_launches)
    phase_train_golden(dev, tree, RWKV_TRAIN_GOLDEN, "[22 rwkv6 train] (b)",
                       RWKV_TRAIN_TOL)
    del tree
    fwd, bwd = (b - a for a, b in zip(before, (wkv_bhtd.launches,
                                               wkv_bwd_bhtd.launches)))
    bwd_routes = {k: v - bwd_routes0[k]
                  for k, v in wkv_bwd_bhtd.route_launches.items()}
    # the step-1 gradient and two steps, each block's forward twice (remat)
    check(fwd == 3 * 2 * cut.num_layers and bwd == 3 * cut.num_layers,
          f"the float32 golden launched the WKV kernels {fwd} (forward) and "
          f"{bwd} (backward) times, not {6 * cut.num_layers} and "
          f"{3 * cut.num_layers}")
    check(bwd_routes == {"chunk": 0, "step": bwd},
          f"the float32 golden's backward took the routes {bwd_routes}, not "
          f"the step route alone")
    res["golden_launches"] = {"wkv": fwd, "wkv_bwd": bwd}
    res["golden_bwd_routes"] = bwd_routes
    print(f"[22 rwkv6 train] (b) WKV launches: {fwd} forward (step route, "
          f"float32), {bwd} backward (routes {bwd_routes})", flush=True)

    # (c) bf16, full width, 8 of 32 layers, through the trainer
    cfg = dataclasses.replace(get_config("rwkv6-7b"),
                              num_layers=RWKV_TRAIN_LAYERS)
    L = cfg.num_layers
    wkv_bhtd.route_launches = {"chunk": 0, "step": 0}
    wkv_bwd_bhtd.route_launches = {"chunk": 0, "step": 0}
    # remat recomputes each block's forward in the backward
    run = train_on_card(
        dev, "[22 rwkv6 train] (c)", cfg,
        {"wkv": wkv_bhtd, "wkv_bwd": wkv_bwd_bhtd},
        {"wkv": 2 * L, "wkv_bwd": L}, RG_TRAIN_B, RG_TRAIN_T,
        RG_TRAIN_STEPS, f"full width, {L} of 32 layers")
    launches = run["launches"]
    routes, bwd_routes = run["routes"]["wkv"], run["routes"]["wkv_bwd"]
    check(routes["chunk"] == launches["wkv"],
          f"the bf16 training forward took the WKV routes {routes}")
    check(bwd_routes == {"chunk": launches["wkv_bwd"], "step": 0},
          f"the bf16 training backward took the WKV routes {bwd_routes}")
    mean_ms, peak, breakdown = run["step_ms"], run["peak"], run["breakdown"]
    tokens = RG_TRAIN_B * RG_TRAIN_T
    if breakdown is None:
        split = "not measured"
    else:
        mm = breakdown["matrix products"]
        wk = breakdown["wkv (kernel 4)"] + breakdown["wkv backward"]
        split = (f"busy {breakdown['busy_ms']:.1f} ms: cuBLAS {mm:.1f}, "
                 f"WKV kernels {wk:.1f} (forward "
                 f"{breakdown['wkv (kernel 4)']:.1f}, backward "
                 f"{breakdown['wkv backward']:.1f}), eager work and copies "
                 f"{breakdown['busy_ms'] - mm - wk:.1f}; idle "
                 f"{breakdown['idle']:.3f} of the wall")
    print(f"[22 rwkv6 train] (c) step {mean_ms:.1f} ms = "
          f"{tokens / mean_ms * 1e3:.0f} tokens/s, peak memory "
          f"{peak / 1e9:.2f} GB; profiled step: {split}", flush=True)
    took = time.perf_counter() - t_phase
    print(f"[22 rwkv6 train] phase time {took:.1f} s (budget "
          f"{RWKV_TRAIN_BUDGET_S:.0f} s"
          f"{'' if took <= RWKV_TRAIN_BUDGET_S else ', over it'})",
          flush=True)
    res.update(launches=launches, routes=routes, bwd_routes=bwd_routes,
               per_step=run["per_step"], step_ms=mean_ms, peak=peak,
               breakdown=breakdown, phase_s=took)
    return res


# ------------------------------------------- MoE, VLM and audio serving --

# Phase 23: the MoE, VLM and audio families at full width and depth, bf16,
# weights drawn on the card from torch.Generator seed 0, the prompt from
# numpy seed 1 and each family's inputs from numpy seed 2.  Per model:
# (batch, prompt, new tokens).  whisper's 64 + 384 = 448 positions are
# upstream whisper's decoder context.  The MoE's and the VLM's 16 new
# tokens (32 until phase 24g came): the script's wall.
FAMILY_SERVE = {"qwen3-moe-30b-a3b": (8, 2048, 16),
                "qwen2-vl-2b": (8, 2048, 16),
                "whisper-small": (8, 64, 384)}
# qwen2-vl's image: src/repro/launch/input_specs.py's VLM_IMG_TOKENS = 1,024
# patch slots, a 32 x 32 grid.
VLM_IMAGE_SIDE = 32
# Decode steps timed per model (after the generate).
FAMILY_DECODE_STEPS = 8
# 23c: the float32 goldens (tests/torch_goldens/make_lm_golden.py's
# FAMILIES), held to phase 8's tolerance (GOLDEN_RTOL); weights by position.
FAMILY_GOLDENS = {"qwen3-moe-30b-a3b": "lm_qwen3_moe_30b_a3b.json",
                  "qwen2-vl-2b": "lm_qwen2_vl_2b.json",
                  "whisper-small": "lm_whisper_small.json"}
FAMILY_WEIGHT_CHECK = {
    "qwen3-moe-30b-a3b": {"embed": (0, slice(0, 4)),
                          "blocks/moe/router": (1, -1, slice(-4, None)),
                          "blocks/moe/wg": (1, 127, 5, slice(0, 4)),
                          "blocks/moe/wd": (0, 64, -1, slice(-4, None))},
    "qwen2-vl-2b": {"embed": (0, slice(0, 4)),
                    "blocks/attn/wq": (27, -1, slice(-4, None)),
                    "blocks/mlp/wd": (13, 5, slice(0, 4))},
    "whisper-small": {"embed": (-1, slice(0, 4)),
                      "enc_layers/11/attn/wq": (-1, slice(-4, None)),
                      "dec_layers/11/cross_attn/wk": (5, slice(0, 4)),
                      "dec_layers/0/mlp/wd": (13, slice(0, 4))}}
# 23c: an MoE token's expert set may differ from JAX's only where JAX's
# top-k margin (the k-th minus the (k+1)-th router probability) is below
# this: float32 router logits on the card and in XLA differ by sums in
# another order over d_model, ~1e-7 of a probability.
FAMILY_FLIP_MARGIN = 1e-5
# 23d: kernel 2 at head width 64, whisper's heads (12 of 64, MHA): its
# prefill's shape (B, T) and a long one.
FLASH_64 = (12, 12, 64)
FLASH_64_TIMED = ((8, 64), (8, 2048))
# The phase's budget (s), on the host that ran the whole script in 886.8 s.
FAMILY_BUDGET_S = 90


def mrope_grid_positions(B, T, side):
    """Qwen2-VL's M-RoPE positions [3, B, T]: a side x side patch grid (t =
    0, h = row, w = col) in the first side^2 slots, then the text at t = h
    = w = side + i."""
    import numpy as np

    r, c = np.divmod(np.arange(side * side), side)
    text = side + np.arange(T - side * side)
    pos = np.stack([np.concatenate([np.zeros(side * side, int), text]),
                    np.concatenate([r, text]), np.concatenate([c, text])])
    return np.broadcast_to(pos[:, None], (3, B, T)).astype(np.int64)


def family_inputs(cfg, B, T, dev, dtype, side, seed=2):
    """The family's extra inputs on ``dev`` (numpy ``seed``): the VLM's
    patch embeddings and M-RoPE positions, whisper's frame embeddings."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    if cfg.family == "vlm":
        ve = rng.standard_normal((B, side * side, cfg.d_model), np.float32)
        return {"vision_embeds": torch.as_tensor(ve, device=dev).to(dtype),
                "mrope_pos": torch.as_tensor(
                    mrope_grid_positions(B, T, side), device=dev)}
    if cfg.family == "audio":
        fe = rng.standard_normal((B, cfg.encoder_positions, cfg.d_model),
                                 np.float32)
        return {"frame_embeds": torch.as_tensor(fe, device=dev).to(dtype)}
    return {}


class RouterLog:
    """While entered, records every MoE router call of the port: each
    token's expert set (sorted), its probabilities, its expert ids and the
    router's weights, on the card.  With ``replay`` (the log of another run
    of the same inputs), each call routes to that run's experts instead:
    a token whose own set is the replayed one keeps the port's own weights
    at them, and a token whose set differs (a near tie, which
    :func:`routing_flips` counts) takes the replayed call's weights.  Each
    call still records its own choice: two runs then differ only by what
    else differs."""

    def __init__(self, replay=None):
        self.replay = replay

    def __enter__(self):
        import torch

        from repro_torch.models import layers as TL

        self.calls, self._orig = [], TL.moe_router

        def rec(cfg, p, xf):
            w, ids, aux = self._orig(cfg, p, xf)
            with torch.no_grad():
                probs = torch.softmax(xf.float() @ p["router"], dim=-1)
            self.calls.append((ids.sort(dim=1).values, probs, ids,
                               w.detach()))
            if self.replay is not None:
                _, _, rids, rw = self.replay.calls[len(self.calls) - 1]
                eq = rids.unsqueeze(2) == ids.unsqueeze(1)    # [N, k, k]
                own = (eq * w.unsqueeze(1)).sum(dim=2)
                same = eq.any(dim=2).all(dim=1, keepdim=True)
                w, ids = torch.where(same, own, rw), rids
            return w, ids, aux
        TL.moe_router = rec
        return self

    def __exit__(self, *exc):
        from repro_torch.models import layers as TL

        TL.moe_router = self._orig


def routing_flips(a, b, k):
    """Compare two runs' router logs (the same inputs, call by call):
    ((token, layer) expert sets that differ, the largest ratio of a
    flipped token's top-k margin to twice the two runs' largest
    probability difference at it).  A set can only flip where the margin
    (the k-th minus the (k+1)-th probability) is below twice that
    difference: a ratio above 1 is a fault."""
    import torch

    n, worst = 0, 0.0
    for (ia, pa, *_), (ib, pb, *_) in zip(a.calls, b.calls):
        diff = (ia != ib).any(dim=1)
        n += int(diff.sum())
        if diff.any():
            idx = torch.nonzero(diff)[:, 0]
            top = pa[idx].topk(k + 1, dim=1).values
            margin = top[:, k - 1] - top[:, k]
            dp = (pa[idx] - pb[idx]).abs().max(dim=1).values
            worst = max(worst, float((margin / (2 * dp)).max()))
    return n, worst


def decode_profile(step, params, state, tok, pos, **extra):
    """One decode step's eager torch calls (top-level ``aten::`` ops, host
    side) and host syncs (torch's sync debug mode, one warning a sync)."""
    import warnings

    import torch
    from torch.profiler import ProfilerActivity, profile

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                out = step(params, state, tok, pos, **extra)
                torch.cuda.synchronize()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = sum("synchroniz" in str(w.message) for w in caught)
    n_ops = sum(1 for e in prof.events() if e.name.startswith("aten::")
                and (e.cpu_parent is None
                     or not e.cpu_parent.name.startswith("aten::")))
    return out, n_ops, syncs


def phase_family_serve(dev, arch, mesh=None, shapes=FAMILY_SERVE,
                       tag="[23 families]") -> dict:
    """[23 families] (a) a model at full width and depth in bf16 through
    ``serve.generate``, at its (batch, prompt, new tokens) in ``shapes``;
    (b) its prefill through the kernel against the plain version (and, for
    the MoE, moe_dense against moe_gmm at decode, and a profiled prefill);
    for the MoE with ``mesh``, phase 24b on the same weights.  Phase 26a
    runs it with its own ``shapes`` and ``tag``."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention_bhtd
    from repro_torch.models import build as build_model
    from repro_torch.models import whisper
    from repro_torch.serve import generate, make_decode_step, make_prefill

    cfg = get_config(arch)
    check(cfg.dtype == "bfloat16", f"{arch} serves in bf16")
    bundle = build_model(cfg)
    B, T, N = shapes[arch]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = bundle.init_params(torch.Generator(device=dev).manual_seed(0),
                                device=dev)
    torch.cuda.synchronize()
    draw_s = time.perf_counter() - t0
    draw_peak = torch.cuda.max_memory_allocated()
    resident = torch.cuda.memory_allocated()
    n_params = sum(x.numel() for x in _leaves(params))
    prompt = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (B, T)), device=dev)
    extra = family_inputs(cfg, B, T, dev, torch.bfloat16, VLM_IMAGE_SIDE)
    enc_ms = None
    if cfg.family == "audio":
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            extra = {"enc_out": whisper.encode(cfg, params,
                                               extra["frame_embeds"])}
        torch.cuda.synchronize()
        enc_ms = (time.perf_counter() - t0) * 1e3
    decode_extra = {k: v for k, v in extra.items() if k == "enc_out"}

    # (a) generate: the main path, launches counted from 0
    reset_attention_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    toks = generate(bundle, params, prompt, N, T + N, device=dev,
                    executor="cuda", moe_impl="gmm", **extra)
    torch.cuda.synchronize()
    gen_wall = time.perf_counter() - t0
    gen_launches = flash_attention_bhtd.launches
    check_bf16_route(f"{arch} generate")
    gen_peak = torch.cuda.max_memory_allocated()
    check(tuple(toks.shape) == (B, N), f"{arch} generate returned "
                                       f"{tuple(toks.shape)}")
    check(gen_launches == cfg.num_layers,
          f"{arch} generate launched kernel 2 {gen_launches} times, not "
          f"{cfg.num_layers} (one a layer in the prefill, none a decode "
          f"step)")

    # the prefill alone, kernel then plain version (the MoE's routing
    # logged in both), then decode steps after the kernel's prefill
    logits, pre_ms, logs = {}, {}, {}
    for ex in ("cuda", "reference"):
        state = bundle.init_decode_state(B, T + N, device=dev)
        prefill = make_prefill(bundle, executor=ex)
        with RouterLog(replay=logs.get("cuda")) as log:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            before = flash_attention_bhtd.launches
            logits[ex], st = prefill(params, state, prompt, **extra)
            torch.cuda.synchronize()
            pre_ms[ex] = (time.perf_counter() - t0) * 1e3
        logs[ex] = log
        if ex == "cuda":
            pre_launches, state = flash_attention_bhtd.launches - before, st
        del st
    check(pre_launches == cfg.num_layers,
          f"{arch} prefill launched kernel 2 {pre_launches} times")
    step = make_decode_step(bundle, executor="cuda")
    tok = toks[:, :1]
    pos = torch.full((B, 1), T, dtype=torch.long, device=dev)
    before = flash_attention_bhtd.launches
    (tok, _, state), n_ops, syncs = decode_profile(step, params, state, tok,
                                                   pos, **decode_extra)
    check(flash_attention_bhtd.launches == before,
          f"{arch}: a decode step launched kernel 2")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(FAMILY_DECODE_STEPS):
        pos = torch.full((B, 1), T + 1 + i, dtype=torch.long, device=dev)
        tok, _, state = step(params, state, tok, pos, **decode_extra)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / FAMILY_DECODE_STEPS
    dense = None
    if cfg.moe is not None:
        # moe_dense against moe_gmm on the same decode inputs: each call
        # writes this step's keys at the same slot before reading it; the
        # dense run routed as gmm's (its own differing expert sets counted,
        # each at a near tie, as (b) counts the prefill's)
        pos = torch.full((B, 1), T + 1 + FAMILY_DECODE_STEPS,
                         dtype=torch.long, device=dev)
        out, dlogs = {}, {}
        for impl in ("gmm", "dense"):
            with RouterLog(replay=dlogs.get("gmm")) as dlogs[impl]:
                _, lg, _ = make_decode_step(bundle, moe_impl=impl,
                                            executor="cuda")(params, state,
                                                             tok, pos)
            out[impl] = lg[:, -1].float()
        dflips, dratio = routing_flips(dlogs["gmm"], dlogs["dense"],
                                       cfg.moe.top_k)
        check(dratio <= 1.0,
              f"{arch} decode: an expert set differs between moe_gmm and "
              f"moe_dense at a top-k margin {dratio:.3g} x twice the runs' "
              f"probability difference (not a near tie)")
        scale = float(out["gmm"].abs().max())
        dense = float((out["dense"] - out["gmm"]).abs().max()) / scale
        check(dense <= SERVE_BF16_TOL,
              f"{arch} decode: moe_dense vs moe_gmm max |err| {dense:.4g} "
              f"of max |logit| > {SERVE_BF16_TOL}")
    del state

    # (b) kernel vs plain: the prefill's last logits (the plain run routed
    # as the kernel's, its own choices counted; whisper's -1e30 padding
    # left out)
    V = cfg.vocab_size
    a = logits["cuda"][:, -1, :V].float()
    b = logits["reference"][:, -1, :V].float()
    check(bool(torch.isfinite(a).all()), f"{arch}: non-finite logits")
    check(torch.equal(a.argmax(-1).int(), toks[:, 0]),
          f"{arch}: generate's first token is not its prefill's argmax")
    scale = float(b.abs().max())
    err = float((a - b).abs().max()) / scale
    check(err <= SERVE_BF16_TOL,
          f"{arch} bf16 prefill logits, kernel vs plain: max |err| {err:.4g} "
          f"of max |logit| > {SERVE_BF16_TOL}")
    flips, flip_ratio = 0, 0.0
    if cfg.moe is not None:
        flips, flip_ratio = routing_flips(logs["cuda"], logs["reference"],
                                          cfg.moe.top_k)
        check(flip_ratio <= 1.0,
              f"{arch}: an expert set differs between the kernel's and the "
              f"plain prefill at a top-k margin {flip_ratio:.3g} x twice "
              f"the runs' probability difference (not a near tie)")
    del logs, logits
    peak = torch.cuda.max_memory_allocated()
    check(max(gen_peak, draw_peak, peak) < 80e9,
          f"{arch}: peak device memory {max(gen_peak, peak)} B")
    tokens_s = B / step_ms * 1e3
    flipped = ""
    if cfg.moe is not None:
        flipped = (f"; the plain run routed as the kernel's: its own expert "
                   f"sets differ at {flips} of {B * T * cfg.num_layers} "
                   f"(token, layer), each at a near tie (margin at most "
                   f"{flip_ratio:.3g} x twice the runs' probability "
                   f"difference); decode moe_dense vs moe_gmm {dense:.4g} "
                   f"of max |logit| (tol {SERVE_BF16_TOL}; dense routed as "
                   f"gmm, its own expert sets differ at {dflips} of "
                   f"{B * cfg.num_layers}, margin at most {dratio:.3g} x)")
    enc = "" if enc_ms is None else (f"; encode {cfg.num_encoder_layers} "
                                     f"layers x {cfg.encoder_positions} "
                                     f"frames {enc_ms:.1f} ms")
    print(f"{tag} (a) {arch} bf16, {cfg.num_layers} layers, "
          f"{n_params} parameters drawn on the card in {draw_s:.1f} s "
          f"({resident} B; peak while drawing {draw_peak} B){enc}; "
          f"generate {B} x {T} prompt + {N} new tokens: wall "
          f"{gen_wall:.3f} s, {gen_launches} kernel 2 launches (one a "
          f"layer in the prefill, 0 a decode step, all wgmma); prefill "
          f"{pre_ms['cuda']:.1f} ms = {B * T / pre_ms['cuda'] * 1e3:.0f} "
          f"tok/s (plain attention {pre_ms['reference']:.1f} ms); decode "
          f"{step_ms:.2f} ms a step (mean of {FAMILY_DECODE_STEPS}) = "
          f"{tokens_s:.0f} tok/s, {n_ops} eager torch calls and {syncs} "
          f"host syncs a step; peak memory {gen_peak} B", flush=True)
    print(f"{tag} (b) {arch}: prefill logits kernel vs plain max "
          f"|err| {err:.4g} of max |logit| {scale:.4g} (tol "
          f"{SERVE_BF16_TOL}){flipped}", flush=True)
    a2a = None
    if cfg.moe is not None:
        profile_prefill(dev, bundle, params, prompt, "gmm", f"{tag} (b)")
    if mesh is not None and cfg.moe is not None:
        a2a = phase_mesh_moe(dev, bundle, params, prompt, mesh,
                             pre_ms["cuda"], gen_peak)
    del params
    torch.cuda.empty_cache()
    return {"launches": gen_launches, "prefill_ms": pre_ms["cuda"],
            "plain_prefill_ms": pre_ms["reference"], "decode_ms": step_ms,
            "peak": gen_peak, "max_abs_err": err, "eager_calls": n_ops,
            "syncs": syncs, "a2a": a2a}


def start_family_draws(archs=FAMILY_GOLDENS):
    """The float32 weights of the goldens of ``archs`` (23c's, and 26b's;
    ``random_lm_params``, numpy alone), drawn in threads of their own
    (numpy releases the GIL while it fills; at most 4 at once, in the
    order given), so they overlap the phases before them: {arch: future of
    (tree, seconds)}."""
    from concurrent.futures import ThreadPoolExecutor

    pool = ThreadPoolExecutor(max_workers=min(4, len(archs)))

    def draw(arch):
        from repro_torch import convert

        t0 = time.perf_counter()
        gold = family_golden(arch)
        tree = convert.random_lm_params(family_golden_config(arch, gold),
                                        seed=gold["seed"])
        return tree, time.perf_counter() - t0
    futures = {arch: pool.submit(draw, arch) for arch in archs}
    pool.shutdown(wait=False)
    return futures


def family_golden(arch):
    with open(os.path.join(ROOT, "tests", "torch_goldens",
                           {**FAMILY_GOLDENS, **ARCH_GOLDENS}[arch])) as f:
        return json.load(f)


def family_golden_config(arch, gold):
    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config(arch), dtype="float32",
                              num_layers=gold["config"]["num_layers"])
    check(dataclasses.asdict(cfg) == {
        k: tuple(v) if isinstance(v, list) else v
        for k, v in gold["config"].items()},
          f"{arch}: the golden's config differs from the port's")
    return cfg


def phase_family_golden(dev, arch, drawn, tag="[23 families] (c)") -> dict:
    """[23 families] (c) a float32 model on the card vs its JAX golden,
    teacher-forced: each decode step takes the golden's token, so a step
    where the golden's top two logits lie within the tolerance (a near
    tie, its argmax either way) does not derail the rest.  For the MoE,
    every token's expert set is held to JAX's: a set may differ only at a
    near tie (JAX's top-k margin below FAMILY_FLIP_MARGIN), and its row is
    then held only up to that step.  Phase 26b runs it on its own archs
    under its own ``tag`` (the lines' prefix)."""
    import numpy as np
    import torch

    from repro_torch import convert
    from repro_torch.models import build as build_model
    from repro_torch.models import whisper
    from repro_torch.serve import make_decode_step, make_prefill

    gold = family_golden(arch)
    gold_file = {**FAMILY_GOLDENS, **ARCH_GOLDENS}[arch]
    cfg = family_golden_config(arch, gold)
    t0 = time.perf_counter()
    tree, draw_s = drawn.result()
    wait_s = time.perf_counter() - t0
    for path, vals in gold["weight_check"].items():
        got = _leaf(tree, path)[FAMILY_WEIGHT_CHECK[arch][path]]
        check([float(x) for x in got] == vals,
              f"random_lm_params differs from the golden's at {path}: "
              f"numpy drew other weights here")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    params = convert.lm_params_from_jax(tree, cfg, dev)
    del tree
    bundle = build_model(cfg)
    prompt = torch.as_tensor(np.asarray(gold["prompt"]), device=dev)
    B, T, N = gold["batch"], gold["prompt_len"], gold["new_tokens"]
    extra = family_inputs(cfg, B, T, dev, torch.float32,
                          gold.get("image_grid"))
    if cfg.family == "audio":
        with torch.no_grad():
            extra = {"enc_out": whisper.encode(cfg, params,
                                               extra["frame_embeds"])}
    again = {k: v for k, v in extra.items() if k == "enc_out"}
    state = bundle.init_decode_state(B, T + N, device=dev)
    prefill = make_prefill(bundle, executor="cuda")
    step = make_decode_step(bundle, executor="cuda")
    gtok = torch.as_tensor(gold["tokens"], device=dev)          # [B, N]
    V = cfg.vocab_size      # whisper's padding logits (-1e30) left out
    with RouterLog() as log:
        logits, state = prefill(params, state, prompt, **extra)
        steps = [logits[:, -1, :V].float()]
        for i in range(N - 1):
            pos = torch.full((B, 1), T + i, dtype=torch.long, device=dev)
            _, logits, state = step(params, state,
                                    gtok[:, i:i + 1].to(torch.int32), pos,
                                    **again)
            steps.append(logits[:, -1, :V].float())

    # (step, row) held: all but those a flipped expert set reaches (MoE):
    # its own step, and the later ones unless it was in the last layer
    # (whose output reaches no cache)
    tainted = set()
    flips = []
    if cfg.moe is not None:
        L = cfg.num_layers
        for i, gs in enumerate(gold["steps"]):
            for layer in range(L):
                got = log.calls[i * L + layer][0].tolist()
                for n, (a, b) in enumerate(zip(got, gs["experts"][layer])):
                    if a != b:
                        m = gs["router_margins"][layer][n]
                        row = n // (T if i == 0 else 1)
                        flips.append((i, layer, row, m))
                        check(m <= FAMILY_FLIP_MARGIN,
                              f"{arch} step {i} layer {layer} row {row}: "
                              f"expert set {a} != JAX's {b} at a router "
                              f"margin {m:.3g} > {FAMILY_FLIP_MARGIN}")
                        last = N if layer < L - 1 else i + 1
                        tainted |= {(j, row) for j in range(i, last)}
    top_err = norm_err = 0.0
    ties, n_held = [], 0
    for i, (s, gs) in enumerate(zip(steps, gold["steps"])):
        rows = [r for r in range(B) if (i, r) not in tainted]
        n_held += len(rows)
        ids = torch.as_tensor(gs["top5_ids"], device=dev)
        vals = s.gather(1, ids).double().cpu().numpy()[rows]
        want = np.asarray(gs["top5"])[rows]
        if rows:
            top_err = max(top_err, float(
                (np.abs(vals - want).max(1) / np.abs(want).max(1)).max()))
            norms = s.double().norm(dim=-1).cpu().numpy()[rows]
            gn = np.asarray(gs["norm"])[rows]
            norm_err = max(norm_err, float((np.abs(norms - gn) / gn).max()))
        got = s.argmax(-1).tolist()
        for r in rows:
            if got[r] != gs["token"][r]:
                tol = 2 * GOLDEN_RTOL * float(np.abs(gs["top5"][r]).max())
                check(gs["margin"][r] <= tol,
                      f"{arch} step {i} row {r}: greedy token {got[r]} != "
                      f"JAX's {gs['token'][r]} with a top-2 margin "
                      f"{gs['margin'][r]:.3g} above {tol:.3g}")
                ties.append((i, r, gs["margin"][r]))
    check(top_err <= GOLDEN_RTOL and norm_err <= GOLDEN_RTOL,
          f"{arch} float32 logits vs the golden: top-5 rel err {top_err}, "
          f"norm rel err {norm_err} (tol {GOLDEN_RTOL})")
    margin = min(m for gs in gold["steps"] for m in gs["margin"])
    routed = ""
    if cfg.moe is not None:
        least = min(min(gs["router_margin"]) for gs in gold["steps"])
        routed = (f"; every token's expert set == JAX's but {len(flips)} "
                  f"(step, layer, row, JAX's margin) {flips}; smallest JAX "
                  f"router margin {least:.3g}")
    print(f"{tag} {arch} float32 (TF32 off; "
          f"{cfg.num_layers} layers: {gold['depth_cut'] or 'full depth'}), "
          f"{B} x {T} prompt tokens + {N} teacher-forced steps on the card "
          f"(weights drawn in {draw_s:.1f} s beside the earlier phases, "
          f"waited {wait_s:.1f} s): greedy tokens == "
          f"{gold_file}'s on {n_held - len(ties)}/{n_held} held "
          f"(step, row), near ties {ties}; top-5 logits max rel err "
          f"{top_err:.3g}, norms {norm_err:.3g} (tol {GOLDEN_RTOL}); "
          f"smallest golden top-2 margin {margin:.4g}{routed}", flush=True)
    del params, state, steps
    torch.cuda.empty_cache()
    return {"flips": len(flips), "ties": len(ties)}


def phase_flash64(dev, heads=FLASH_64, tag="[23 families] (d)",
                  shapes=FLASH_64_TIMED) -> dict:
    """[23 families] (d) kernel 2 at head width 64 (whisper's ``heads``)
    at each (B, T) of ``shapes``: kernel vs plain version, timed against
    its bound, the plain version and SDPA (phase 26e: at the new archs'
    heads)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import (attention_ref,
                                                     flash_attention_bhtd)

    g = torch.Generator().manual_seed(23)
    H, Hkv, hd = heads
    out = {}
    for B, T in shapes:
        q, k, v = [torch.randn(B, T, h, hd, generator=g).to(
            dev, torch.bfloat16).transpose(1, 2) for h in (H, Hkv, Hkv)]
        err = float((flash_attention_bhtd(q, k, v).float()
                     - attention_ref(q, k, v).float()).abs().max())
        check(err <= FLASH_TOL["bfloat16"],
              f"flash attention hd {hd} ({H}/{Hkv}) B={B} T={T}: max |err| "
              f"{err}")
        ms = time_cuda(lambda: flash_attention_bhtd(q, k, v), 5)
        plain_ms = time_cuda(lambda: attention_ref(q, k, v), 5)
        lib_ms = time_cuda(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=Hkv != H), 5)
        bound_ms, bound_by, flops, nbytes = flash_bound(B, H, Hkv, hd, T, T,
                                                        True, 2)
        print(f"{tag} kernel 2 bf16 (wgmma) causal hd {hd} (heads "
              f"{H}/{Hkv}) B={B} T={T}: kernel {ms:.4f} ms (median of 5); "
              f"bound {bound_ms:.4f} ms by {bound_by} ({flops} FLOP, "
              f"{nbytes} B); x bound {ms / bound_ms:.1f}; plain "
              f"{plain_ms:.3f} ms; scaled_dot_product_attention "
              f"{lib_ms:.4f} ms; max |err| {err:.3g} (tol 2e-2)", flush=True)
        out[f"B{B}_T{T}"] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                                 bound_ms=bound_ms, bound_by=bound_by,
                                 max_abs_err=err)
        del q, k, v
    return out


def phase_families(dev, mesh=None) -> dict:
    """Phase 23 (a, b, d): the three families served at full width (and
    with ``mesh``, phase 24b on the MoE's weights, timed apart)."""
    t_phase = time.perf_counter()
    res = {arch: phase_family_serve(dev, arch, mesh) for arch in
           FAMILY_SERVE}
    res["hd64"] = phase_flash64(dev)
    a2a = res["qwen3-moe-30b-a3b"]["a2a"]
    res["phase_s"] = time.perf_counter() - t_phase - (
        a2a["phase_s"] if a2a else 0.0)
    return res


def mesh_budget(*parts):
    took = sum(parts)
    print(f"[24 mesh] phase time {took:.1f} s ("
          + ", ".join(f"{n} {t:.1f} s" for n, t in zip("acb", parts))
          + f"; budget {MESH_BUDGET_S:.0f} s"
          + ("" if took <= MESH_BUDGET_S else ", over it") + ")", flush=True)
    return took


def family_budget(serve_s, golden_s):
    took = serve_s + golden_s
    print(f"[23 families] phase time {took:.1f} s (a, b, d {serve_s:.1f} s; "
          f"c {golden_s:.1f} s; budget {FAMILY_BUDGET_S:.0f} s"
          f"{'' if took <= FAMILY_BUDGET_S else ', over it'})", flush=True)
    return took


# ---------------------------------------------------- every arch (26) --
# Phase 26: every arch of configs.ARCHS on the card.  (a) The four archs
# the earlier phases do not serve, bf16, full width and depth, weights
# drawn on the card (torch.Generator seed 0), phase 23a's batch, prompt
# and new tokens (each cut from 32 to 16 when phase 24 gained (d)-(f)).
ARCH_SERVE = {"qwen2-0.5b": (8, 2048, 16), "olmo-1b": (8, 2048, 16),
              "yi-9b": (8, 2048, 16), "moonshot-v1-16b-a3b": (8, 2048, 16)}
# (b) Their float32 goldens (tests/torch_goldens/make_lm_golden.py's
# FAMILIES: qwen2-0.5b and olmo-1b at full depth, yi-9b at 4 of 48 layers,
# moonshot at 2 of 48), teacher-forced as 23c; weights by position.
ARCH_GOLDENS = {"qwen2-0.5b": "lm_qwen2_0_5b.json",
                "olmo-1b": "lm_olmo_1b.json", "yi-9b": "lm_yi_9b.json",
                "moonshot-v1-16b-a3b": "lm_moonshot_v1_16b_a3b.json"}
FAMILY_WEIGHT_CHECK.update({
    "qwen2-0.5b": {"embed": (0, slice(0, 4)),
                   "blocks/attn/wq": (23, -1, slice(-4, None)),
                   "blocks/attn/bk": (11, slice(0, 4)),
                   "blocks/mlp/wd": (13, 5, slice(0, 4))},
    "olmo-1b": {"embed": (0, slice(0, 4)),
                "blocks/attn/wq": (15, -1, slice(-4, None)),
                "blocks/mlp/wd": (13, 5, slice(0, 4))},
    "yi-9b": {"embed": (0, slice(0, 4)),
              "blocks/attn/wq": (3, -1, slice(-4, None)),
              "blocks/mlp/wd": (2, 5, slice(0, 4)),
              "head": (5, slice(-4, None))},
    "moonshot-v1-16b-a3b": {"embed": (0, slice(0, 4)),
                            "blocks/moe/router": (1, -1, slice(-4, None)),
                            "blocks/moe/wg": (1, 63, 5, slice(0, 4)),
                            "blocks/moe/shared/wd": (0, -1,
                                                     slice(-4, None))}})
# (c) Training on the card of every arch whose bf16 AdamW state fits one
# card (~22 B a parameter): train_4k's sequence at one card's 2 rows of its
# global batch of 256, remat, ARCH_TRAIN_STEPS steps (4 cut to 3 with
# phase 24 (d)-(f)).  qwen2-0.5b and olmo-1b through the launcher (tokens
# alone, as JAX's launcher feeds); whisper-small and qwen2-vl-2b through
# trainer.train with train_4k's extra inputs
# (src/repro/launch/input_specs.py:98-110: 1,500 frames; a 32 x 32 image in
# the first 1,024 slots with its M-RoPE positions).  yi-9b (8.83 B
# parameters, ~194 GB of state) needs a state split over several cards (the
# partitioned step, phase 24 (e)-(f)); moonshot (28.55 B, ~628 GB) also the
# MoE's partitioned step (ROADMAP queue 1).
ARCH_TRAIN_LAUNCHER = ("qwen2-0.5b", "olmo-1b")
ARCH_TRAIN_TRAINER = ("whisper-small", "qwen2-vl-2b")
ARCH_TRAIN_B, ARCH_TRAIN_T, ARCH_TRAIN_STEPS = 2, 4096, 3
# (d) The float32 train goldens (tests/torch_goldens/make_train_golden.py:
# full depth, B 2 x T 128; whisper's frames and qwen2-vl's 8 x 8 image
# grid from numpy seed 2), held to phase 11's TRAIN_TOL, on the weights of
# the serving golden of the same arch, seed and depth (drawn once).
ARCH_TRAIN_GOLDENS = {"qwen2-0.5b": "train_qwen2_0_5b.json",
                      "whisper-small": "train_whisper_small.json",
                      "qwen2-vl-2b": "train_qwen2_vl_2b.json"}
# (d) kernel 3 at head width 64: whisper's heads (12/12, GQA group 1) and
# qwen2-0.5b's (14/2, group 7), held to its plain version in phase 10
# (BWD_HEADS, with the other trained archs' groupings), timed at the
# trainer's B 2 x T 4,096; (e) kernel 2 at the served archs' new head
# groupings as 23d: (H, Hkv, hd) and the (B, T) timed.
ARCH_FLASH = {"hd64_gqa7": ((14, 2, 64), FLASH_64_TIMED),
              "hd128_gqa1": ((16, 16, 128), ((8, 2048),)),
              "hd128_gqa8": ((32, 4, 128), ((8, 2048),))}
# The phase's budget (s) on a host that runs the earlier phases in ~816 s,
# counted as FAMILY_BUDGET_S: (a, c, d's kernel, e) and (b, d's goldens).
ARCH_BUDGET_S = 120


def arch_train(dev, arch) -> dict:
    """[26 archs] (c) one arch trained in bf16 at full width and depth
    (:func:`train_on_card`), ARCH_TRAIN_STEPS steps of ARCH_TRAIN_B x
    ARCH_TRAIN_T: through ``repro_torch.launch.train.main``
    (ARCH_TRAIN_LAUNCHER, tokens alone) or ``trainer.train`` with the extra
    inputs (ARCH_TRAIN_TRAINER).  Kernel 2 twice a layer a step (remat),
    kernel 3 once."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import (flash_attention_bhtd,
                                                     flash_attention_bwd_bhtd)

    cfg = get_config(arch)
    B, T, S = ARCH_TRAIN_B, ARCH_TRAIN_T, ARCH_TRAIN_STEPS
    L = attention_layers(cfg)
    kernels = {"flash_attention": flash_attention_bhtd,
               "flash_attention_bwd": flash_attention_bwd_bhtd}
    want = {"flash_attention": 2 * L, "flash_attention_bwd": L}
    desc = f"{cfg.num_layers} layers"
    if arch in ARCH_TRAIN_LAUNCHER:
        return train_on_card(dev, "[26 archs] (c)", cfg, kernels, want, B, T,
                             S, desc, launcher_argv=[
                                 "--arch", arch, "--batch", str(B), "--seq",
                                 str(T), "--steps", str(S)])
    # train_4k's extra inputs (numpy seed 2): whisper's frames, qwen2-vl's
    # VLM_IMAGE_SIDE x VLM_IMAGE_SIDE image and its M-RoPE positions
    extra = family_inputs(cfg, B, T, dev, torch.bfloat16, VLM_IMAGE_SIDE)
    return train_on_card(dev, "[26 archs] (c)", cfg, kernels, want, B, T, S,
                         desc, extra=extra)


def phase_flash_bwd64(dev) -> dict:
    """[26 archs] (d) kernel 3 at head width 64 (held to its plain version
    in phase 10, BWD_HEADS), timed at the trainer's B 2 x T 4,096, causal,
    bf16, at whisper's heads (12/12, GQA 1) and qwen2-0.5b's (14/2, GQA
    7) against its bound (10 hd operations a reachable pair and head at
    989 TFLOP/s), the plain version and SDPA's backward."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import (attention_bwd_ref,
                                                     flash_attention_bhtd,
                                                     flash_attention_bwd_bhtd)

    g = torch.Generator(device=dev).manual_seed(26)
    B, T = ARCH_TRAIN_B, ARCH_TRAIN_T
    out = {}
    for name in ("whisper", "qwen2"):
        H, Hkv, hd = BWD_HEADS[name]
        q, k, v, do = [torch.randn(B, T, h, hd, generator=g, device=dev)
                       .to(torch.bfloat16).transpose(1, 2)
                       for h in (H, Hkv, Hkv, H)]
        o, lse = flash_attention_bhtd(q, k, v, return_lse=True)
        ms = time_cuda(lambda: flash_attention_bwd_bhtd(q, k, v, o, lse, do),
                       5)
        plain_ms = time_cuda(lambda: attention_bwd_ref(q, k, v, o, lse, do),
                             2)
        xs = [x.detach().requires_grad_() for x in (q, k, v)]
        lib_o = F.scaled_dot_product_attention(*xs, is_causal=True,
                                               enable_gqa=Hkv != H)
        lib_ms = time_cuda(lambda: torch.autograd.grad(
            lib_o, xs, do, retain_graph=True), 5)
        bound_ms, bound_by, flops, nbytes = bwd_bound(B, H, Hkv, hd, T,
                                                      True, 2)
        print(f"[26 archs] (d) kernel 3 bf16 (wgmma kernels) causal hd 64 "
              f"{name} heads {H}/{Hkv} B={B} T={T}: kernel {ms:.4f} ms (dq "
              f"+ dk/dv + delta, median of 5); bound {bound_ms:.4f} ms by "
              f"{bound_by} ({flops} FLOP, {nbytes} B); x bound "
              f"{ms / bound_ms:.1f}; plain {plain_ms:.3f} ms (median of 2); "
              f"scaled_dot_product_attention backward {lib_ms:.4f} ms",
              flush=True)
        out[f"{name}_B{B}_T{T}"] = dict(ms=ms, plain_ms=plain_ms,
                                        library_ms=lib_ms, bound_ms=bound_ms,
                                        bound_by=bound_by)
        del q, k, v, do, o, lse, xs, lib_o
    torch.cuda.empty_cache()
    return out


def phase_arch_goldens(dev, draws) -> float:
    """[26 archs] (b) the four serving goldens, teacher-forced (as 23c),
    and (d) the three float32 train goldens (as phase 11), each on the
    weights of the serving golden of its arch (``draws``: {arch: future
    of (tree, seconds)}, 23c's for whisper and qwen2-vl).  Returns the
    seconds taken."""
    t0 = time.perf_counter()
    for arch in ARCH_GOLDENS:
        # each tree is let go after its last use
        phase_family_golden(dev, arch, draws[arch] if arch in
                            ARCH_TRAIN_GOLDENS else draws.pop(arch),
                            "[26 archs] (b)")
    for arch, file in ARCH_TRAIN_GOLDENS.items():
        with open(os.path.join(ROOT, "tests", "torch_goldens", file)) as f:
            gold = json.load(f)
        lm = family_golden(arch)
        check((gold["arch"], gold["seed"], gold["num_layers"])
              == (arch, lm["seed"], lm["config"]["num_layers"]),
              f"{file}: not the weights of {arch}'s serving golden")
        phase_train_golden(dev, draws.pop(arch).result()[0], file,
                           "[26 archs] (d)")
    return time.perf_counter() - t0


def phase_archs(dev) -> dict:
    """Phase 26 (a, c, d's kernel 3, e): the four archs served, the four
    trained, kernel 3 at head width 64 and kernel 2 at the new head
    groupings; returns each path's launches, the kernels' readings and the
    seconds taken."""
    t_phase = time.perf_counter()
    res = {"serve": {arch: phase_family_serve(dev, arch, shapes=ARCH_SERVE,
                                              tag="[26 archs]")
                     for arch in ARCH_SERVE}}
    res["train"] = {arch: arch_train(dev, arch)
                    for arch in ARCH_TRAIN_LAUNCHER + ARCH_TRAIN_TRAINER}
    res["bwd64"] = phase_flash_bwd64(dev)
    res["fwd"] = {name: phase_flash64(dev, heads, "[26 archs] (e)", shapes)
                  for name, (heads, shapes) in ARCH_FLASH.items()}
    res["phase_s"] = time.perf_counter() - t_phase
    return res


def arch_budget(run_s, golden_s):
    took = run_s + golden_s
    print(f"[26 archs] phase time {took:.1f} s (a, c, d's kernel, e "
          f"{run_s:.1f} s; b, d's goldens {golden_s:.1f} s; budget "
          f"{ARCH_BUDGET_S:.0f} s"
          f"{'' if took <= ARCH_BUDGET_S else ', over it'})", flush=True)
    return took


# 24: the multi-rank base on one card, a world of one rank over NCCL.
# (a) chunked_psum through shard_map on a [4,096, 1,024] float32 input; the
# int8 compression over qwen3-0.6b's leaf shapes (float32, drawn on the card
# with seed 0, scaled to a gradient's size), card against CPU.
MESH_PSUM_SHAPE = (4096, 1024)
MESH_INT8_ARCH = "qwen3-0.6b"
MESH_INT8_SCALE = 1e-3
# (b) qwen3-moe-30b-a3b's a2a prefill on phase 23a's weights: at ample
# capacity (factor E / k, so C = N and nothing drops) at B 1 x T 2,048
# against the gmm prefill; at the production factor on 23a's 8 x 2,048
# prompt.
A2A_AMPLE_B = 1
A2A_FACTOR = 1.25
# a2a and gmm prefills timed in turn at the production factor, this many
# of each (medians and spread reported).
A2A_TIMED = 3
# (c) the launcher's step with the state plain and placed, this many
# timed steps of each after one untimed.
MESH_STEP_TIMED = 3
# The phase's budget (s), on the host of PR 25's run B.
MESH_BUDGET_S = 40
# 24b's profiled prefills: device time by kernel group.
MOE_GROUPS = (("flash forward (kernel 2)", ("flash_fwd",)),
              ("matrix products", ("gemm", "gemv", "cutlass", "xmma",
                                   "cublas", "nvjet", "sm90_", "sm80_")),
              ("all-to-all (NCCL)", ("nccl",)),
              ("index, scatter, gather", ("index", "scatter", "gather")),
              ("scans, sorts", ("scan", "Scan", "sort", "Sort", "cumsum")),
              ("copies", ("Memcpy", "Memset", "copy")))


def bit_equal(a, b) -> bool:
    """Same dtype, shape and bits (float32 compared as int32)."""
    import torch

    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype == torch.float32:
        a, b = a.contiguous().view(torch.int32), b.contiguous().view(
            torch.int32)
    return torch.equal(a.cpu(), b.cpu())


def phase_mesh_world(dev) -> dict:
    """[24 mesh] (a) the host mesh of a world of one rank over NCCL on the
    card, chunked_psum through shard_map, and compressed_grad_tree on the
    card against the same call on the CPU, bit for bit."""
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.distributed import collectives, sharding
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build as build_model
    from repro_torch.tree import leaves, leaves_with_paths, tree_map

    t_phase = time.perf_counter()
    mesh = make_host_mesh(model=1, device=dev)
    backend = str(dist.get_backend())
    init_s = time.perf_counter() - t_phase
    check(backend == "nccl", f"the card's world runs {backend!r}, not nccl")
    shape = sharding.mesh_shape(mesh)
    check(shape == {"data": 1, "model": 1}, f"host mesh {shape}")
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(MESH_PSUM_SHAPE, generator=gen, device=dev)
    y = sharding.shard_map(
        lambda v: collectives.chunked_psum(v, ("data", "model"), 4),
        mesh=mesh, in_specs=sharding.P(), out_specs=sharding.P())(x)
    check(bit_equal(x, y), "chunked_psum on a world of one changed its input")
    shapes = build_model(get_config(MESH_INT8_ARCH)).init_params(
        0, device="meta")
    grads = tree_map(lambda m: torch.randn(
        m.shape, generator=gen, device=dev) * MESH_INT8_SCALE, shapes)
    n = sum(g.numel() for g in leaves(grads))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card = collectives.compressed_grad_tree(grads)
    torch.cuda.synchronize()
    card_ms = (time.perf_counter() - t0) * 1e3
    host = tree_map(lambda g: g.cpu(), grads)
    del grads
    t0 = time.perf_counter()
    cpu = collectives.compressed_grad_tree(host)
    cpu_s = time.perf_counter() - t0
    bad = [f"{name} {path}"
           for name, a, b in zip(("q", "scale", "error"), card, cpu)
           for (path, u), (_, v) in zip(leaves_with_paths(a),
                                        leaves_with_paths(b))
           if not bit_equal(u, v)]
    check(not bad, f"[24 mesh] int8 card != CPU at {len(bad)} leaves: "
                   f"{bad[:6]}")
    q_bytes = sum(q.numel() for q in leaves(card[0]))
    del card, cpu, host
    torch.cuda.empty_cache()
    took = time.perf_counter() - t_phase
    print(f"[24 mesh] (a) make_host_mesh(model=1) on the card: "
          f"{dict(shape)}, backend {backend}, started in {init_s:.1f} s; "
          f"chunked_psum of {list(MESH_PSUM_SHAPE)} float32 over (data, "
          f"model) in 4 chunks == its input bit for bit; "
          f"compressed_grad_tree over {MESH_INT8_ARCH}'s "
          f"{len(leaves(shapes))} leaf shapes ({n} float32 values, scale "
          f"{MESH_INT8_SCALE}): q ({q_bytes} B int8, 4x fewer than "
          f"float32), scales and errors on the card == on the CPU bit for "
          f"bit (card {card_ms:.1f} ms, CPU {cpu_s:.1f} s beside 17b's "
          f"child); {took:.1f} s", flush=True)
    return {"mesh": mesh, "phase_s": took}


def phase_mesh_train(dev, tree, mesh, p11, count_fma) -> float:
    """[24 mesh] (c) phase 11's two float32 steps again with the state
    placed on the 1 x 1 mesh and grad_acc_specs = zero_specs: every metric
    and every final weight bit-equal to phase 11's run without a mesh."""
    from repro_torch.tree import leaves_with_paths

    t0 = time.perf_counter()
    got = count_fma(phase_train_golden, dev, tree, "train_qwen3_0_6b.json",
                    "[24 mesh] (c)", TRAIN_TOL, mesh)
    bad = [f"step {i + 1} {k}" for i, (a, b) in
           enumerate(zip(got["metrics"], p11["metrics"])) for k in a
           if a[k] != b[k]]
    pairs = list(zip(leaves_with_paths(got["final"]),
                     leaves_with_paths(p11["final"])))
    bad += [path for (path, a), (_, b) in pairs if not bit_equal(a, b)]
    took = time.perf_counter() - t0
    check(not bad, f"[24 mesh] (c) the mesh's steps differ from phase 11's "
                   f"at {bad[:6]}")
    print(f"[24 mesh] (c) two float32 steps with the state placed on the "
          f"1 x 1 mesh (params and moments by shardings(param_specs), "
          f"grad_acc_specs = zero_specs): loss, ce, grad norm, lr of both "
          f"steps and all {len(pairs)} final weight leaves bit-equal to "
          f"phase 11's run without a mesh; {took:.1f} s", flush=True)
    return took + phase_mesh_launcher_step(dev, mesh)


def phase_mesh_launcher_step(dev, mesh) -> float:
    """[24 mesh] (c) what placing the state costs the one-card launcher:
    qwen3-0.6b train steps (bf16, full width, the launcher's README shape
    TRAIN_B x TRAIN_T) from one state, plain (no mesh: the trainer's) and
    placed on the 1 x 1 mesh by ``place_state`` (the launcher's), timed in
    turn after one untimed step each, whose metrics must be bit-equal."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding
    from repro_torch.models import build as build_model
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import (init_train_state, make_train_step,
                                   place_state)

    t0 = time.perf_counter()
    cfg = get_config("qwen3-0.6b")
    bundle = build_model(cfg)
    plain = init_train_state(bundle, 0, device=dev)
    with sharding.set_mesh(mesh):
        placed = place_state(plain, mesh)
    step = make_train_step(bundle, AdamWConfig(lr=3e-4, warmup_steps=20,
                                               total_steps=20),
                           executor="cuda")
    g = torch.Generator(device=dev).manual_seed(24)
    toks = torch.randint(0, cfg.vocab_size, (TRAIN_B, TRAIN_T + 1),
                         generator=g, device=dev, dtype=torch.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    states = {"plain": plain, "placed": placed}
    times = {name: [] for name in states}
    first = {}
    for i in range(MESH_STEP_TIMED + 1):
        for name, st in states.items():
            torch.cuda.synchronize()
            t = time.perf_counter()
            with (sharding.set_mesh(mesh) if name == "placed"
                  else contextlib.nullcontext()):
                _, m = step(st, batch)
            m = {k: float(v) for k, v in m.items()}       # reads back
            ms = (time.perf_counter() - t) * 1e3
            if i == 0:
                first[name] = m
            else:
                times[name].append(ms)
    del states, plain, placed, batch, toks
    torch.cuda.empty_cache()
    check(first["plain"] == first["placed"],
          f"[24 mesh] (c) the placed state's first step differs: "
          f"{first['placed']} vs {first['plain']}")
    med = {name: statistics.median(t) for name, t in times.items()}
    took = time.perf_counter() - t0
    print(f"[24 mesh] (c) the launcher's step, qwen3-0.6b bf16 at {TRAIN_B} "
          f"x {TRAIN_T} from one state, in turn (host wall to the metrics "
          f"read back): plain median {med['plain']:.1f} ms (each "
          f"{[round(x, 1) for x in times['plain']]}), placed on the 1 x 1 "
          f"mesh median {med['placed']:.1f} ms (each "
          f"{[round(x, 1) for x in times['placed']]}): placed / plain "
          f"{med['placed'] / med['plain']:.4f}; first steps' loss, ce, aux, "
          f"grad norm and lr bit-equal; {took:.1f} s", flush=True)
    return took


# (d, e) The partitioned train step (train/step.py) over a world of TP_RANKS
# ranks on the one card: each rank a child process of this script
# (``--tp-rank``), in a gloo group of its own over a FileStore (NCCL takes
# one rank a device; the launcher's world-of-one rule stays), a
# ("data", "model") mesh of (1, TP_RANKS).  gloo carries the card's tensors
# through the host: no time here is an NVLink figure.  (d) phase 11's
# float32 golden at tp 2, held to TRAIN_TOL; (e) olmo-1b in bf16 at full
# width and depth with remat, ARCH_TRAIN_B x ARCH_TRAIN_T, TP_OLMO_STEPS
# steps from the placed init (init_train_state(mesh=...)) on in-order
# SyntheticSource batches, against tp 1's steps on the same batches on the
# card (this process, before the ranks start), the losses to
# TRAIN_BF16_LOSS_RTOL (phase 12's bf16 bound: the same roundings in
# another sum order).  Each rank's parameter and moment bytes at most
# TP_BYTES_SHARE of tp 1's; kernels 2 and 3 at TP_OLMO_HEADS heads.  The
# grad norms against tp 1's to TP_GNORM_RTOL: the losses barely see a
# gradient scaled wrongly by a missing or doubled all-reduce (Adam is
# nearly scale-invariant per leaf and lr is at most 4.5e-5 here), the
# norm does.  Read on an H100 80GB HBM3 at 700 W (tests/sm90/probe.py
# tp_fault): 2.57e-4 clean; 0.735 with copy_to_model's gradient
# all-reduce taken away (the losses then 0.092 off).
TP_RANKS = 2
# (d) runs context-parallel attention (cp_attention; qwen3's 16 heads
# divide 2): each rank every head on its half of the golden's 128
# positions, the second half at query offset 64 in the float32 kernels.
TP_GOLDEN_FIELDS = {"cp_attention": True}
TP_OLMO = "olmo-1b"
# 3 steps cut to 2 with (h) (a tp-2 olmo-1b step through gloo takes 7.2-8.4
# s; PERF.md section 5)
TP_OLMO_STEPS = 2
TP_OLMO_HEADS = 8
TP_BYTES_SHARE = 0.55
TP_GNORM_RTOL = 2e-2
# (g) The MoE family's partitioned step in the same two ranks, after (e):
# each arch at full width, bf16, remat, TP_MOE_LAYERS of 48 layers (full
# depth is ~670 GB (qwen3-moe) and ~628 GB (moonshot) of state, which two
# ranks of one card would still hold on the one card), ARCH_TRAIN_B x
# ARCH_TRAIN_T, TP_MOE_STEPS steps from the placed init on in-order
# SyntheticSource batches under moe_impl gmm (the trainer's), against tp
# 1's steps on the same batches in this process before the ranks start,
# routed alike: tp 1's RouterLog goes to the ranks through the world's
# directory, the ranks replay it, and each expert set a rank's own router
# picks otherwise must be a near tie (routing_flips' ratio at most 1).
# The same holds as (e)'s; kernels 2 and 3 at the rank's heads.
TP_MOE = ("qwen3-moe-30b-a3b", "moonshot-v1-16b-a3b")
TP_MOE_LAYERS = 2
TP_MOE_STEPS = 2
TP_MOE_BUDGET_S = 40
# (h) The recurrent, VLM and audio families' partitioned step in the same
# two ranks, after (g): each arch at full width, bf16, remat, cut in depth
# (TP_FAM_DEPTH: rwkv6-7b 2 of 32 layers, recurrentgemma-2b 3 of 26 (rglru,
# rglru, local), qwen2-vl-2b 2 of 28, whisper-small 2 + 2 of 12 + 12),
# ARCH_TRAIN_B x ARCH_TRAIN_T, TP_FAM_STEPS steps from the placed init on
# in-order SyntheticSource batches (whisper's 1,500 frames and qwen2-vl's
# VLM_IMAGE_SIDE^2 image by family_inputs), against tp 1's steps on the
# same batches in this process before the ranks start.  Held as (e):
# losses to TRAIN_BF16_LOSS_RTOL, grad norms to TP_GNORM_RTOL, a rank's
# bytes at most TP_BYTES_SHARE of tp 1's, its saved block inputs 1 /
# TP_RANKS; kernels 2 and 3 at the rank's query heads (recurrentgemma 5/1
# of 256, qwen2-vl 6/1 of 128, whisper's decoder 6/6 of 64), kernels 4
# and 4b at the rank's H / 2 heads, 5 and 5b at its lru / 2 channels, each
# as many launches a step as tp 1's.
TP_FAM_DEPTH = {"rwkv6-7b": {"num_layers": 2},
                "recurrentgemma-2b": {"num_layers": 3},
                "qwen2-vl-2b": {"num_layers": 2},
                "whisper-small": {"num_layers": 2, "num_encoder_layers": 2}}
TP_FAM_STEPS = 2
TP_FAM_BUDGET_S = 30
# (f) The dry run's partitioned cells (25a's children, DRYRUN_CELLS): what
# the parent tree (before the partitioned step) printed for them on meta at
# 16 x 16 (python -m repro_torch.launch.dryrun --arch A --shape train_4k at
# commit beeb03c): flops_per_device, peak_per_device, useful_flops_ratio.
TP_DRYRUN_BEFORE = {
    "qwen3-0.6b": (419102371872768.0, 18737611816, 0.03494829236048929),
    "yi-9b": (4648576248446976.0, 293615340584, 0.04667703318116177),
    # before the MoE's partitioned step (commit 5b41e77's 25a, as printed:
    # 1.628e+16 FLOP, 1063.63 GB, useful share 0.0046)
    "qwen3-moe-30b-a3b": (1.628e16, 1063.63e9, 0.0046)}
# (f) what the partitioned step must reach: qwen3-0.6b's useful FLOP share
# at least this many times the parent's, yi-9b's and qwen3-moe's peaks
# under one card, qwen3-moe's FLOPs a device at most this share of the
# parent's.
TP_DRYRUN_USEFUL_GAIN, TP_DRYRUN_PEAK_B = 4.0, 80e9
TP_DRYRUN_MOE_FLOPS_SHARE = 1 / 8
# (f) the same cells on the tree before sequence-parallel residuals and
# context-parallel attention (commit 8b48f06, run on the CPU):
# flops_per_device, peak_per_device, useful_flops_ratio, and kernel 2's
# and kernel 3's FLOPs a device (the full program's count).
TP_DRYRUN_PARENT = {
    "qwen2-0.5b": (78354900320256.0, 1214877044, 0.1549308440799295,
                   23095381327872, 28869226659840),
    "qwen3-0.6b": (28118043590656.0, 1410081844, 0.520907942046557,
                   3849230221312, 4811537776640),
    "yi-9b": (310327224827904.0, 10321636404, 0.6992030683555078,
              13197360758784, 16496700948480),
    "qwen3-moe-30b-a3b": (1033827350740992.0, 30071111712,
                          0.07230584318518363, 13197360758784,
                          16496700948480)}
# (f) the remat saves of the block inputs a rank that sequence
# parallelism takes away (L x [2, 4,096, D] bf16 x 15 / 16: PERF.md's
# prediction); each peak must fall by at least TP_SP_PEAK_SHARE of them.
# qwen2-0.5b's kernels 2 and 3 on its busiest model rank (context-parallel
# attention: 14 heads at model 16) at most TP_CP_KERNEL_SHARE of the
# parent's FLOPs (its last query block reaches 0.121 of the pairs).
TP_SP_SAVES = {"yi-9b": 3.020e9, "qwen3-0.6b": 0.440e9}
TP_SP_PEAK_SHARE = 0.5
TP_CP_KERNEL_SHARE = 0.15
# (f) the recurrent, VLM and audio families' cells (25a's second child) on
# the tree before their partitioned step (commit 922b154, run on the CPU):
# flops_per_device, peak_per_device, useful_flops_ratio, and kernels 4 and
# 4b's FLOPs a device (rwkv6-7b) or 5 and 5b's bytes (recurrentgemma-2b).
# Each must reach TP_DRYRUN_USEFUL_GAIN x its useful share and a peak
# below the parent's and TP_DRYRUN_PEAK_B; the kernels' counts exactly 1
# / 16 of the parent's (linear in the heads and channels a rank runs).
TP_DRYRUN_FAM_PARENT = {
    "rwkv6-7b": (3839735122362368.0, 246789022760, 0.05358341312381992,
                 {"wkv_bhtd": ("flops", 20340965113856),
                  "wkv_bwd_bhtd": ("flops", 23880018165760)}),
    "recurrentgemma-2b": (1293327731261440.0, 76208497960,
                          0.04827928581676554,
                          {"rglru_scan": ("bytes", 72477573120),
                           "rglru_scan_bwd": ("bytes", 60397977600)}),
    "qwen2-vl-2b": (832106561273856.0, 53596238632, 0.04558882664371063, {}),
    "whisper-small": (123646777491456.0, 7956301608, 0.04730743597736055,
                      {})}


def tp_batches(vocab, n):
    """``n`` in-order SyntheticSource batches of ARCH_TRAIN_B x
    ARCH_TRAIN_T (the same in every process)."""
    from repro_torch.data import SyntheticSource, batches

    it = batches(SyntheticSource(vocab, 1 << 16), batch=ARCH_TRAIN_B,
                 seq=ARCH_TRAIN_T, tuned=False)
    out = [next(it) for _ in range(n)]
    it.close()
    return out


def state_bytes(state):
    """(parameter bytes, moment bytes) this rank holds of ``state``."""
    from repro_torch.distributed import sharding

    def nbytes(tree):
        return sum((x.to_local() if sharding.is_placed(x) else x).numel()
                   * x.element_size() for x in _leaves(tree))
    return nbytes(state.params), nbytes(state.opt.mu) + nbytes(state.opt.nu)


def olmo_steps(dev, mesh=None):
    """(e): TP_OLMO_STEPS bf16 steps of olmo-1b (:func:`tp_train_steps`)."""
    from repro_torch.configs import get_config

    return tp_train_steps(dev, get_config(TP_OLMO), TP_OLMO_STEPS, mesh)


def tp_fam_config(arch):
    """(h): ``arch`` at full width, cut to TP_FAM_DEPTH."""
    import dataclasses

    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(arch), **TP_FAM_DEPTH[arch])


def tp_fam_rank(dev, mesh):
    """(h) in a rank: each of TP_FAM_DEPTH's archs' TP_FAM_STEPS steps on
    ``mesh``."""
    t0 = time.perf_counter()
    out = {arch: tp_train_steps(dev, tp_fam_config(arch), TP_FAM_STEPS, mesh)
           for arch in TP_FAM_DEPTH}
    out["s"] = time.perf_counter() - t0
    return out


def tp_moe_config(arch):
    """(g): ``arch`` at full width, TP_MOE_LAYERS of its layers."""
    import dataclasses

    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(arch), num_layers=TP_MOE_LAYERS)


class AttnCalls:
    """While entered, the shapes of every call of kernels 2 (``fwd``) and
    3 (``bwd``) through the model's wrapper (``ops``): (query heads, query
    rows, query offset); and of kernels 4 (``wkv``), 4b (``wkv_bwd``), 5
    (``rglru``) and 5b (``rglru_bwd``) through their autograd Functions'
    modules: (heads,) and (channels,); each a sorted list of distinct
    tuples."""

    SITES = (("repro_torch.kernels.flash_attention.ops",
              (("fwd", "flash_attention_bhtd"),
               ("bwd", "flash_attention_bwd_bhtd"))),
             ("repro_torch.kernels.rwkv6.ops",
              (("wkv", "wkv_bhtd"), ("wkv_bwd", "wkv_bwd_bhtd"))),
             ("repro_torch.kernels.rglru.ops",
              (("rglru", "rglru_scan"), ("rglru_bwd", "rglru_scan_bwd"))))

    @staticmethod
    def shape(key, q, kw):
        if key in ("fwd", "bwd"):
            return (q.shape[1], q.shape[2], kw.get("q_offset", 0))
        return (q.shape[1],) if key.startswith("wkv") else (q.shape[-1],)

    def __enter__(self):
        self.calls = {key: set() for _, keys in self.SITES
                      for key, _ in keys}
        self._real = []

        def wrap(key, fn):
            def call(q, *a, **kw):
                self.calls[key].add(self.shape(key, q, kw))
                return fn(q, *a, **kw)
            return call
        for mod_name, keys in self.SITES:
            mod = importlib.import_module(mod_name)
            for key, name in keys:
                self._real.append((mod, name, getattr(mod, name)))
                setattr(mod, name, wrap(key, getattr(mod, name)))
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self._real:
            setattr(mod, name, fn)
        self.calls = {k: sorted(v) for k, v in self.calls.items()}


class SavedBlockInputs:
    """While entered, the bytes autograd saves of the remat blocks' inputs
    (the tensors the models hand ``torch.utils.checkpoint``, each block's
    first tensor argument: ``lm``'s, ``rwkv6``'s, ``rglru``'s layers and
    ``whisper``'s encoder and decoder layers): every saved tensor seen by
    ``saved_tensors_hooks`` whose storage is one of those inputs', each
    counted once (``bytes``; ``inputs``: the blocks run).  It keeps
    addresses only, so it holds no tensor alive."""

    def __enter__(self):
        import torch

        from repro_torch.models import lm, rglru, rwkv6, whisper

        self._mods = [(m, m.checkpoint) for m in (lm, rwkv6, rglru, whisper)]
        self._inputs, self._saved = set(), set()

        def patched(real):
            def checkpoint(fn, *args, **kw):
                x = next(a for a in args if isinstance(a, torch.Tensor))
                self._inputs.add(x.data_ptr())
                self.inputs += 1
                return real(fn, *args, **kw)
            return checkpoint

        def pack(t):
            self._saved.add((t.data_ptr(), t.untyped_storage().nbytes()))
            return t
        self.inputs = 0
        for m, real in self._mods:
            m.checkpoint = patched(real)
        self._hooks = torch.autograd.graph.saved_tensors_hooks(
            pack, lambda t: t)
        self._hooks.__enter__()
        return self

    def __exit__(self, *exc):
        self._hooks.__exit__(*exc)
        for m, real in self._mods:
            m.checkpoint = real
        self.bytes = sum(n for p, n in self._saved if p in self._inputs)


def tp_train_steps(dev, cfg, n_steps, mesh=None):
    """``n_steps`` bf16 steps of ``cfg`` (make_train_step, the cuda
    executor, moe_impl gmm) from init_train_state(seed 0), placed on
    ``mesh`` when given, on tp_batches (with the family's inputs,
    ``family_inputs``): per-step losses, grad norms and host walls (each
    ending in a read of the loss), the state's bytes, the peak, the block
    inputs' bytes saved in step 1 (:class:`SavedBlockInputs`), kernels 2
    and 3's launches a step (``launches``) and every kernel's of the
    train step (``kernels``: 2, 3, 4, 4b, 5, 5b), and the head counts
    (channels for 5 and 5b) they ran at."""
    import torch

    from repro_torch.distributed import sharding
    from repro_torch.kernels.flash_attention import (flash_attention_bhtd,
                                                     flash_attention_bwd_bhtd)
    from repro_torch.kernels.rglru import rglru_scan, rglru_scan_bwd
    from repro_torch.kernels.rwkv6 import wkv_bhtd, wkv_bwd_bhtd
    from repro_torch.models import build as build_model
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import init_train_state, make_train_step

    check(cfg.dtype == "bfloat16" and cfg.remat, f"{cfg.name} trains in "
          f"bf16 with remat")
    bundle = build_model(cfg)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = init_train_state(bundle, 0, device=dev, mesh=mesh)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated()
    pbytes, mbytes = state_bytes(state)
    step = make_train_step(bundle, AdamWConfig(lr=3e-4, warmup_steps=20,
                                               total_steps=n_steps),
                           executor="cuda")
    extra = family_inputs(cfg, ARCH_TRAIN_B, ARCH_TRAIN_T, dev,
                          torch.bfloat16, VLM_IMAGE_SIDE)
    batches = [dict({k: v.to(dev) for k, v in b.items()}, **extra)
               for b in tp_batches(cfg.vocab_size, n_steps)]
    del extra
    counted = {"2": flash_attention_bhtd, "3": flash_attention_bwd_bhtd,
               "4": wkv_bhtd, "4b": wkv_bwd_bhtd, "5": rglru_scan,
               "5b": rglru_scan_bwd}
    losses, gnorms, walls, per_step, kernels = [], [], [], [], []
    saved = SavedBlockInputs()          # step 1's
    with AttnCalls() as calls:
        torch.cuda.reset_peak_memory_stats()
        for i, b in enumerate(batches):
            n0 = (flash_attention_bhtd.launches,
                  flash_attention_bwd_bhtd.launches)
            k0 = {k: fn.launches for k, fn in counted.items()}
            torch.cuda.synchronize()
            t = time.perf_counter()
            with (sharding.set_mesh(mesh) if mesh is not None
                  else contextlib.nullcontext()), \
                    (saved if i == 0 else contextlib.nullcontext()):
                state, m = step(state, b)
            losses.append(float(m["loss"]))
            walls.append((time.perf_counter() - t) * 1e3)
            gnorms.append(float(m["grad_norm"]))
            per_step.append((flash_attention_bhtd.launches - n0[0],
                             flash_attention_bwd_bhtd.launches - n0[1]))
            kernels.append({k: fn.launches - k0[k]
                            for k, fn in counted.items()})
    peak = torch.cuda.max_memory_allocated()
    del state, batches
    torch.cuda.empty_cache()
    return {"losses": losses, "grad_norms": gnorms, "step_ms": walls,
            "param_bytes": pbytes, "moment_bytes": mbytes,
            "init_s": init_s, "init_peak": init_peak, "peak": peak,
            "launches": per_step, "kernels": kernels,
            "heads": {k: sorted({c[0] for c in v})
                      for k, v in calls.calls.items() if v},
            "saved": (saved.bytes, saved.inputs), "layers": cfg.num_layers,
            "num_heads": cfg.num_heads}


class RouterCalls:
    """A RouterLog's calls saved under a directory, one ``.npy`` file an
    array (``save``), and read back onto a device as a log to replay and
    compare against (``load``)."""

    NAMES = ("sets", "probs", "ids", "w")

    @staticmethod
    def save(log, d):
        import numpy as np

        os.makedirs(d)
        for i, call in enumerate(log.calls):
            for name, x in zip(RouterCalls.NAMES, call):
                np.save(os.path.join(d, f"{i}.{name}.npy"),
                        x.detach().cpu().numpy())

    @staticmethod
    def load(d, dev):
        import types

        import numpy as np
        import torch

        n = len(os.listdir(d)) // len(RouterCalls.NAMES)
        log = types.SimpleNamespace(calls=[tuple(
            torch.from_numpy(np.load(os.path.join(d, f"{i}.{name}.npy")))
            .to(dev) for name in RouterCalls.NAMES) for i in range(n)])
        return log


def tp_moe_rank(dev, mesh, d):
    """(g) in a rank: each of TP_MOE's steps on ``mesh``, replaying tp 1's
    router log (under ``d``), and the expert sets its own router picked
    otherwise (routing_flips against tp 1's log)."""
    t0 = time.perf_counter()
    out = {}
    for arch in TP_MOE:
        cfg = tp_moe_config(arch)
        tp1 = RouterCalls.load(os.path.join(d, f"router_{arch}"), dev)
        with RouterLog(replay=tp1) as log:
            r = tp_train_steps(dev, cfg, TP_MOE_STEPS, mesh)
        r["flips"] = routing_flips(log, tp1, cfg.moe.top_k)
        r["calls"] = len(log.calls)
        out[arch] = r
        del tp1, log
    out["s"] = time.perf_counter() - t0
    return out


def save_tree(tree, d):
    """A tree of dicts of numpy arrays as one .npy file a leaf under
    ``d`` (path keys joined by ``.``), for :func:`load_tree`."""
    import numpy as np

    os.makedirs(d)

    def walk(node, path):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
            else:
                np.save(os.path.join(d, ".".join(path + (k,)) + ".npy"), v)
    walk(tree, ())


def load_tree(d):
    """The tree :func:`save_tree` wrote under ``d``."""
    import numpy as np

    tree = {}
    for name in sorted(os.listdir(d)):
        *path, leaf = name[:-len(".npy")].split(".")
        node = tree
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = np.load(os.path.join(d, name))
    return tree


def tp_rank_main(rank, store, out):
    """A rank of phase 24 (d, e, g, h) (``chip_smoke.py --tp-rank R STORE
    OUT``): the gloo world of TP_RANKS ranks, the (1, TP_RANKS) mesh, (d),
    (e), (g) then (h); its readings to ``out`` as JSON."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.kernels.flash_attention import (flash_attention_bhtd,
                                                     flash_attention_bwd_bhtd)

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group("gloo", store=dist.FileStore(store, TP_RANKS),
                            rank=rank, world_size=TP_RANKS)
    try:
        mesh = DeviceMesh("cuda", torch.arange(TP_RANKS).reshape(1, TP_RANKS),
                          mesh_dim_names=("data", "model"))
        res = {"backend": str(dist.get_backend())}
        t0 = time.perf_counter()
        tree = load_tree(os.path.join(os.path.dirname(store), "tree"))
        n0 = (flash_attention_bhtd.launches, flash_attention_bwd_bhtd.launches)
        with AttnCalls() as calls:
            gold = phase_train_golden(dev, tree,
                                      tag=f"[24 mesh] (d) rank {rank}",
                                      mesh=mesh, fields=TP_GOLDEN_FIELDS)
        res["d"] = {"metrics": gold["metrics"], "shares": gold["shares"],
                    "launches": [flash_attention_bhtd.launches - n0[0],
                                 flash_attention_bwd_bhtd.launches - n0[1]],
                    "calls": calls.calls, "s": time.perf_counter() - t0}
        del tree, gold
        t0 = time.perf_counter()
        res["e"] = olmo_steps(dev, mesh)
        res["e"]["s"] = time.perf_counter() - t0
        res["g"] = tp_moe_rank(dev, mesh, os.path.dirname(store))
        res["h"] = tp_fam_rank(dev, mesh)
        with open(out + ".tmp", "w") as f:
            json.dump(res, f)
        os.replace(out + ".tmp", out)
    finally:
        dist.destroy_process_group()


class MeshTP:
    """[24 mesh] (d, e, g, h): tp 1's olmo-1b, MoE and (h) families' steps
    in this process (the MoE's router logs written for the ranks to
    replay), then the TP_RANKS ranks started (child processes: (d), (e),
    (g), then (h)); the full run joins them after the float32 goldens,
    which time nothing (the ranks' step times beside them are host-staged
    figures anyway)."""

    def __init__(self, dev, tree):
        import tempfile

        self.t0 = time.perf_counter()
        self.tp1 = olmo_steps(dev)
        self.tp1_s = time.perf_counter() - self.t0
        self.dir = tempfile.mkdtemp(prefix="tp_world_")
        self.moe_tp1 = {}
        for arch in TP_MOE:
            with RouterLog() as log:
                self.moe_tp1[arch] = tp_train_steps(
                    dev, tp_moe_config(arch), TP_MOE_STEPS)
            self.moe_tp1[arch]["calls"] = len(log.calls)
            RouterCalls.save(log, os.path.join(self.dir, f"router_{arch}"))
            del log
        self.moe_tp1_s = time.perf_counter() - self.t0 - self.tp1_s
        t_fam = time.perf_counter()
        self.fam_tp1 = {arch: tp_train_steps(dev, tp_fam_config(arch),
                                             TP_FAM_STEPS)
                        for arch in TP_FAM_DEPTH}
        self.fam_tp1_s = time.perf_counter() - t_fam
        # the golden's weights for (d), written once for both ranks
        save_tree(tree, os.path.join(self.dir, "tree"))
        env = dict(os.environ, OMP_NUM_THREADS="1")
        self.procs, self.outs, self.logs = [], [], []
        for rank in range(TP_RANKS):
            self.outs.append(os.path.join(self.dir, f"rank{rank}.json"))
            self.logs.append(open(os.path.join(self.dir, f"rank{rank}.log"),
                                  "w"))
            self.procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--tp-rank",
                 str(rank), os.path.join(self.dir, "store"), self.outs[-1]],
                stdout=self.logs[-1], stderr=subprocess.STDOUT, cwd=ROOT,
                env=env))
            CHILDREN.append(self.procs[-1])

    def join(self, p11_metrics) -> dict:
        """Wait for the ranks; hold and print (d) and (e) beside phase
        11's steps (``p11_metrics``) and tp 1's.  Returns the seconds from
        the start to the join and rank 0's kernel 2 and 3 launches a step
        in (e)."""
        import shutil

        t_wait = time.perf_counter()
        codes = [p.wait(timeout=900) for p in self.procs]
        waited = time.perf_counter() - t_wait
        for f in self.logs:
            f.close()
        try:
            out = phase_mesh_tp(self.dir, self.outs, codes, self.tp1,
                                p11_metrics, time.perf_counter() - self.t0,
                                waited)
            out["moe"] = phase_mesh_moe_tp(self.outs, self.moe_tp1,
                                           self.moe_tp1_s)
            out["fam"] = phase_mesh_fam_tp(self.outs, self.fam_tp1,
                                           self.fam_tp1_s)
            return out
        finally:
            # the golden's weights (2.4 GB of .npy), the store, the logs
            shutil.rmtree(self.dir, ignore_errors=True)


def check_saved(where, saved, tp1_saved):
    """A rank's block inputs saved in step 1 (:class:`SavedBlockInputs`:
    bytes, blocks) are exactly 1 / TP_RANKS of tp 1's (the residual stream
    cut by sequence), over as many blocks."""
    check(saved[1] == tp1_saved[1] and saved[0] * TP_RANKS == tp1_saved[0]
          and saved[0] > 0,
          f"{where}: a rank saved {saved[0]} B of {saved[1]} block inputs, "
          f"tp 1 {tp1_saved[0]} B of {tp1_saved[1]}: not 1 / {TP_RANKS}")


def saved_line(r, tp1) -> str:
    """The block inputs a rank saved against tp 1's, for the prints."""
    return (f"block inputs saved for the backward {r['saved'][0]} B "
            f"({r['saved'][0] / tp1['saved'][0]:.4f} of tp 1's "
            f"{tp1['saved'][0]} B over {tp1['saved'][1]} blocks; 1 / "
            f"{TP_RANKS} = {1 / TP_RANKS:.4f})")


def phase_mesh_tp(d, outs, codes, tp1, p11_metrics, took, waited) -> dict:
    """[24 mesh] (d, e) the ranks' readings (``outs``, their logs in
    ``d``) held and printed beside phase 11's and tp 1's."""
    import math

    for rank in range(TP_RANKS):
        with open(os.path.join(d, f"rank{rank}.log")) as f:
            text = f.read()
        print("".join(f"  [rank {rank}] {line}\n"
                      for line in text.splitlines()[-12:]), end="",
              flush=True)
    check(codes == [0] * TP_RANKS, f"[24 mesh] (d, e) the ranks exited "
                                   f"{codes}")
    ranks = []
    for out in outs:
        with open(out) as f:
            ranks.append(json.load(f))
    card = nvidia_card()
    # (d) phase 11's golden at tp 2: both ranks the same, each reading's
    # share of its limit, and the distance from phase 11's tp 1 steps
    r0 = ranks[0]
    check(all(r["d"]["metrics"] == r0["d"]["metrics"] for r in ranks),
          "[24 mesh] (d) the ranks' metrics differ")
    check(r0["backend"] == "gloo", f"[24 mesh] (d) backend {r0['backend']}")
    vs11 = max(abs(a[k] - b[k]) / abs(b[k]) for a, b in
               zip(r0["d"]["metrics"], p11_metrics)
               for k in ("loss", "ce", "grad_norm"))
    # context-parallel: every head on the rank's block of the positions at
    # its query offset (and the whole sequence in the gradient check that
    # the golden takes first, without the mesh)
    with open(os.path.join(ROOT, "tests", "torch_goldens",
                           "train_qwen3_0_6b.json")) as f:
        T = json.load(f)["seq"]
    n = T // TP_RANKS
    for rank, r in enumerate(ranks):
        for key in ("fwd", "bwd"):
            want = sorted([(16, n, rank * n), (16, T, 0)])
            check([tuple(c) for c in r["d"]["calls"][key]] == want,
                  f"[24 mesh] (d) rank {rank}: kernel {key} calls (heads, "
                  f"rows, offset) {r['d']['calls'][key]}, expected {want}")
    print(f"[24 mesh] (d) qwen3-0.6b float32 (TF32 off, remat, 28 layers) "
          f"two partitioned steps at tp {TP_RANKS} (a (1, {TP_RANKS}) mesh "
          f"of {TP_RANKS} processes on the one card, gloo) vs "
          f"train_qwen3_0_6b.json: each reading / its limit "
          + ", ".join(f"{k} {v[0]:.3g} / {v[1]} = {v[0] / v[1]:.3f}"
                      for k, v in r0["d"]["shares"].items())
          + f"; loss, ce and grad norm {vs11:.3g} (relative) from phase "
          f"11's tp 1 steps; context-parallel attention "
          f"({TP_GOLDEN_FIELDS}): kernels 2 and 3 launched "
          f"{r0['d']['launches']} times a rank (FMA route), (heads, query "
          f"rows, query offset) "
          + ", ".join(f"rank {i} {r['d']['calls']['fwd']}"
                      for i, r in enumerate(ranks))
          + f"; {r0['d']['s']:.1f} s a rank; {card}", flush=True)
    # (e) olmo-1b at tp 2 against tp 1
    e0 = ranks[0]["e"]
    check(all(r["e"]["losses"] == e0["losses"] for r in ranks),
          "[24 mesh] (e) the ranks' losses differ")
    for r in ranks:
        check(all(math.isfinite(x) for x in r["e"]["losses"]),
              f"[24 mesh] (e) non-finite loss {r['e']['losses']}")
    errs = [abs(a - b) / abs(b) for a, b in zip(e0["losses"], tp1["losses"])]
    check(max(errs) <= TRAIN_BF16_LOSS_RTOL,
          f"[24 mesh] (e) tp {TP_RANKS} losses {e0['losses']} vs tp 1's "
          f"{tp1['losses']}: rel err {errs} > {TRAIN_BF16_LOSS_RTOL}")
    check(all(r["e"]["grad_norms"] == e0["grad_norms"] for r in ranks),
          "[24 mesh] (e) the ranks' grad norms differ")
    g_errs = [abs(a - b) / abs(b) for a, b in zip(e0["grad_norms"],
                                                  tp1["grad_norms"])]
    check(max(g_errs) <= TP_GNORM_RTOL,
          f"[24 mesh] (e) tp {TP_RANKS} grad norms {e0['grad_norms']} vs "
          f"tp 1's {tp1['grad_norms']}: rel err {g_errs} > {TP_GNORM_RTOL}")
    L = e0["layers"]
    for r in ranks:
        e = r["e"]
        share = (e["param_bytes"] + e["moment_bytes"]) / (
            tp1["param_bytes"] + tp1["moment_bytes"])
        check(e["param_bytes"] <= TP_BYTES_SHARE * tp1["param_bytes"]
              and e["moment_bytes"] <= TP_BYTES_SHARE * tp1["moment_bytes"],
              f"[24 mesh] (e) a rank holds {e['param_bytes']} B of "
              f"parameters and {e['moment_bytes']} B of moments, tp 1 "
              f"{tp1['param_bytes']} and {tp1['moment_bytes']}")
        check(all(tuple(p) == (2 * L, L) for p in e["launches"]),
              f"[24 mesh] (e) kernel 2, 3 launches a step {e['launches']}, "
              f"expected ({2 * L}, {L})")
        check(e["heads"] == {"fwd": [TP_OLMO_HEADS], "bwd": [TP_OLMO_HEADS]},
              f"[24 mesh] (e) kernels 2 and 3 ran at heads {e['heads']}")
        check_saved(f"[24 mesh] (e) {TP_OLMO}", e["saved"], tp1["saved"])
    check(tp1["heads"] == {"fwd": [tp1["num_heads"]],
                           "bwd": [tp1["num_heads"]]},
          f"[24 mesh] (e) tp 1's kernels ran at heads {tp1['heads']}")
    print(f"[24 mesh] (e) {TP_OLMO} bf16 (remat, {L} layers) "
          f"{TP_OLMO_STEPS} steps of {ARCH_TRAIN_B} x {ARCH_TRAIN_T} from "
          f"the placed init, tp {TP_RANKS} (gloo, its collectives through "
          f"the host: no NVLink figure) vs tp 1 on the card: losses "
          f"{[round(x, 5) for x in e0['losses']]} vs "
          f"{[round(x, 5) for x in tp1['losses']]} (rel err "
          f"{max(errs):.3g}, tol {TRAIN_BF16_LOSS_RTOL}, share "
          f"{max(errs) / TRAIN_BF16_LOSS_RTOL:.3f}); grad norms "
          f"{[round(x, 4) for x in e0['grad_norms']]} vs "
          f"{[round(x, 4) for x in tp1['grad_norms']]} (rel err "
          f"{max(g_errs):.3g}, tol {TP_GNORM_RTOL}, share "
          f"{max(g_errs) / TP_GNORM_RTOL:.3f}); "
          + "; ".join(
              f"rank {i}: parameters {r['e']['param_bytes']} B, moments "
              f"{r['e']['moment_bytes']} B "
              f"({(r['e']['param_bytes'] + r['e']['moment_bytes']) / (tp1['param_bytes'] + tp1['moment_bytes']):.4f} "
              f"of tp 1's {tp1['param_bytes']} + {tp1['moment_bytes']} B), "
              f"peak {r['e']['peak'] / 1e9:.2f} GB (init peak "
              f"{r['e']['init_peak'] / 1e9:.2f} GB, drawn in "
              f"{r['e']['init_s']:.1f} s), kernel 2, 3 launches a step "
              f"{r['e']['launches'][0]} at {r['e']['heads']['fwd']} of "
              f"{r['e']['num_heads']} heads, {saved_line(r['e'], tp1)}, "
              f"step ms {[round(x, 1) for x in r['e']['step_ms']]} "
              f"(host-staged collectives)" for i, r in enumerate(ranks))
          + f"; tp 1: peak {tp1['peak'] / 1e9:.2f} GB, step ms "
          f"{[round(x, 1) for x in tp1['step_ms']]}, kernel 2, 3 launches "
          f"a step {tp1['launches'][0]} at {tp1['heads']['fwd']} heads; "
          f"{card}", flush=True)
    print(f"[24 mesh] (d, e) {took:.1f} s from tp 1's steps to the join "
          f"({waited:.1f} s waited at it)", flush=True)
    return {"s": took, "launches_a_step": e0["launches"][0],
            "heads": TP_OLMO_HEADS}


def phase_mesh_moe_tp(outs, tp1, tp1_s) -> dict:
    """[24 mesh] (g) the ranks' MoE steps (``outs``) held and printed beside
    tp 1's (``tp1``, taken in ``tp1_s`` s before the ranks started).
    Returns {arch: rank 0's kernel 2 and 3 launches a step and heads}."""
    import math

    from repro_torch.distributed.sharding import ModelAxis
    from repro_torch.models.layers import local_heads

    ranks = []
    for out in outs:
        with open(out) as f:
            ranks.append(json.load(f)["g"])
    card = nvidia_card()
    res = {}
    for arch in TP_MOE:
        cfg = tp_moe_config(arch)
        t1, g0 = tp1[arch], ranks[0][arch]
        for r in ranks:
            g = r[arch]
            check(all(math.isfinite(x) for x in g["losses"]),
                  f"[24 mesh] (g) {arch} non-finite loss {g['losses']}")
            check(g["losses"] == g0["losses"]
                  and g["grad_norms"] == g0["grad_norms"],
                  f"[24 mesh] (g) {arch}: the ranks' losses or grad norms "
                  f"differ")
            check(g["calls"] == t1["calls"],
                  f"[24 mesh] (g) {arch}: {g['calls']} router calls, tp 1 "
                  f"{t1['calls']}")
            n, worst = g["flips"]
            check(worst <= 1.0, f"[24 mesh] (g) {arch}: a rank's expert set "
                  f"differs from tp 1's beyond a near tie (margin / twice "
                  f"the probabilities' difference {worst:.4g} > 1)")
            check(g["param_bytes"] <= TP_BYTES_SHARE * t1["param_bytes"]
                  and g["moment_bytes"]
                  <= TP_BYTES_SHARE * t1["moment_bytes"],
                  f"[24 mesh] (g) {arch}: a rank holds {g['param_bytes']} B "
                  f"of parameters and {g['moment_bytes']} B of moments, "
                  f"tp 1 {t1['param_bytes']} and {t1['moment_bytes']}")
            L = g["layers"]
            check(all(tuple(p) == (2 * L, L) for p in g["launches"]),
                  f"[24 mesh] (g) {arch}: kernel 2, 3 launches a step "
                  f"{g['launches']}, expected ({2 * L}, {L})")
            nq = local_heads(cfg, ModelAxis(None, TP_RANKS, 0))[1]
            check(g["heads"] == {"fwd": [nq], "bwd": [nq]},
                  f"[24 mesh] (g) {arch}: kernels 2 and 3 ran at heads "
                  f"{g['heads']}, the rank's {nq}")
            check_saved(f"[24 mesh] (g) {arch}", g["saved"], t1["saved"])
        check(t1["heads"] == {"fwd": [cfg.num_heads],
                              "bwd": [cfg.num_heads]},
              f"[24 mesh] (g) {arch}: tp 1's kernels ran at heads "
              f"{t1['heads']}")
        errs = [abs(a - b) / abs(b) for a, b in zip(g0["losses"],
                                                     t1["losses"])]
        g_errs = [abs(a - b) / abs(b) for a, b in zip(g0["grad_norms"],
                                                       t1["grad_norms"])]
        check(max(errs) <= TRAIN_BF16_LOSS_RTOL,
              f"[24 mesh] (g) {arch} tp {TP_RANKS} losses {g0['losses']} vs "
              f"tp 1's {t1['losses']}: rel err {errs} > "
              f"{TRAIN_BF16_LOSS_RTOL}")
        check(max(g_errs) <= TP_GNORM_RTOL,
              f"[24 mesh] (g) {arch} tp {TP_RANKS} grad norms "
              f"{g0['grad_norms']} vs tp 1's {t1['grad_norms']}: rel err "
              f"{g_errs} > {TP_GNORM_RTOL}")
        print(f"[24 mesh] (g) {arch} bf16 (remat, {cfg.num_layers} of 48 "
              f"layers, moe_impl gmm) {TP_MOE_STEPS} steps of "
              f"{ARCH_TRAIN_B} x {ARCH_TRAIN_T} from the placed init, tp "
              f"{TP_RANKS} (gloo: no NVLink figure; routed as tp 1, "
              f"{g0['calls']} router calls replayed) vs tp 1 on the card: "
              f"losses {[round(x, 5) for x in g0['losses']]} vs "
              f"{[round(x, 5) for x in t1['losses']]} (rel err "
              f"{max(errs):.3g}, tol {TRAIN_BF16_LOSS_RTOL}, share "
              f"{max(errs) / TRAIN_BF16_LOSS_RTOL:.3f}); grad norms "
              f"{[round(x, 4) for x in g0['grad_norms']]} vs "
              f"{[round(x, 4) for x in t1['grad_norms']]} (rel err "
              f"{max(g_errs):.3g}, tol {TP_GNORM_RTOL}, share "
              f"{max(g_errs) / TP_GNORM_RTOL:.3f}); "
              + "; ".join(
                  f"rank {i}: parameters {r[arch]['param_bytes']} B, "
                  f"moments {r[arch]['moment_bytes']} B "
                  f"({(r[arch]['param_bytes'] + r[arch]['moment_bytes']) / (t1['param_bytes'] + t1['moment_bytes']):.4f} "
                  f"of tp 1's {t1['param_bytes']} + {t1['moment_bytes']} "
                  f"B), peak {r[arch]['peak'] / 1e9:.2f} GB (init peak "
                  f"{r[arch]['init_peak'] / 1e9:.2f} GB), expert sets of "
                  f"its own router off tp 1's {r[arch]['flips'][0]}, each "
                  f"a near tie (largest ratio {r[arch]['flips'][1]:.4g}, "
                  f"limit 1), kernel 2, 3 launches a step "
                  f"{r[arch]['launches'][0]} at {r[arch]['heads']['fwd']} "
                  f"of {cfg.num_heads} heads, {saved_line(r[arch], t1)}, "
                  f"step ms "
                  f"{[round(x, 1) for x in r[arch]['step_ms']]}"
                  for i, r in enumerate(ranks))
              + f"; tp 1: peak {t1['peak'] / 1e9:.2f} GB, step ms "
              f"{[round(x, 1) for x in t1['step_ms']]}, kernel 2, 3 "
              f"launches a step {t1['launches'][0]} at "
              f"{t1['heads']['fwd']} heads; {card}", flush=True)
        res[arch] = {"launches_a_step": g0["launches"][0],
                     "heads": g0["heads"]["fwd"][0]}
    took = max(r["s"] for r in ranks)
    print(f"[24 mesh] (g) tp 1's MoE steps {tp1_s:.1f} s in this process; "
          f"the ranks' (g) {took:.1f} s (budget {TP_MOE_BUDGET_S} s"
          f"{'' if took <= TP_MOE_BUDGET_S else ', over it'})", flush=True)
    return res


def tp_fam_expected(cfg, mp) -> dict:
    """(h): each kernel's launches a step of ``cfg``'s train step with
    remat (every forward kernel twice: the forward and the backward's
    recompute) and the heads or channels a rank of ``mp`` runs it at."""
    from repro_torch.distributed.sharding import ModelAxis
    from repro_torch.models.layers import local_heads

    la = attention_layers(cfg)
    if cfg.family == "audio":           # the decoder's causal attention
        la = cfg.num_layers
    rec = cfg.num_layers - la if cfg.family == "hybrid" else 0
    wkv = cfg.num_layers if cfg.family == "ssm" else 0
    launches = {"2": 2 * la, "3": la, "4": 2 * wkv, "4b": wkv,
                "5": 2 * rec, "5b": rec}
    nq = local_heads(cfg, None if mp == 1 else ModelAxis(None, mp, 0))[1]
    lru = cfg.lru_width or cfg.d_model
    heads = {"fwd": [nq] if la else None, "bwd": [nq] if la else None,
             "wkv": [cfg.num_heads // mp] if wkv else None,
             "wkv_bwd": [cfg.num_heads // mp] if wkv else None,
             "rglru": [lru // mp] if rec else None,
             "rglru_bwd": [lru // mp] if rec else None}
    return launches, {k: v for k, v in heads.items() if v}


def phase_mesh_fam_tp(outs, tp1, tp1_s) -> dict:
    """[24 mesh] (h) the ranks' steps of the recurrent, VLM and audio
    families (``outs``) held and printed beside tp 1's (``tp1``, taken in
    ``tp1_s`` s before the ranks started).  Returns {arch: rank 0's
    launches a step of each kernel and the heads or channels}."""
    import math

    ranks = []
    for out in outs:
        with open(out) as f:
            ranks.append(json.load(f)["h"])
    card = nvidia_card()
    res = {}
    for arch in TP_FAM_DEPTH:
        cfg = tp_fam_config(arch)
        t1, h0 = tp1[arch], ranks[0][arch]
        launches, heads = tp_fam_expected(cfg, TP_RANKS)
        launches1, heads1 = tp_fam_expected(cfg, 1)
        check(all(k == launches1 for k in t1["kernels"])
              and t1["heads"] == heads1,
              f"[24 mesh] (h) {arch}: tp 1's launches {t1['kernels']} at "
              f"{t1['heads']}, expected {launches1} at {heads1}")
        for r in ranks:
            h = r[arch]
            check(all(math.isfinite(x) for x in h["losses"]),
                  f"[24 mesh] (h) {arch} non-finite loss {h['losses']}")
            check(h["losses"] == h0["losses"]
                  and h["grad_norms"] == h0["grad_norms"],
                  f"[24 mesh] (h) {arch}: the ranks' losses or grad norms "
                  f"differ")
            check(h["param_bytes"] <= TP_BYTES_SHARE * t1["param_bytes"]
                  and h["moment_bytes"]
                  <= TP_BYTES_SHARE * t1["moment_bytes"],
                  f"[24 mesh] (h) {arch}: a rank holds {h['param_bytes']} B "
                  f"of parameters and {h['moment_bytes']} B of moments, "
                  f"tp 1 {t1['param_bytes']} and {t1['moment_bytes']}")
            check(all(k == launches for k in h["kernels"]),
                  f"[24 mesh] (h) {arch}: launches a step {h['kernels']}, "
                  f"expected {launches}")
            check(h["heads"] == heads,
                  f"[24 mesh] (h) {arch}: kernels ran at {h['heads']}, the "
                  f"rank's {heads}")
            check_saved(f"[24 mesh] (h) {arch}", h["saved"], t1["saved"])
        errs = [abs(a - b) / abs(b) for a, b in zip(h0["losses"],
                                                     t1["losses"])]
        g_errs = [abs(a - b) / abs(b) for a, b in zip(h0["grad_norms"],
                                                       t1["grad_norms"])]
        check(max(errs) <= TRAIN_BF16_LOSS_RTOL,
              f"[24 mesh] (h) {arch} tp {TP_RANKS} losses {h0['losses']} vs "
              f"tp 1's {t1['losses']}: rel err {errs} > "
              f"{TRAIN_BF16_LOSS_RTOL}")
        check(max(g_errs) <= TP_GNORM_RTOL,
              f"[24 mesh] (h) {arch} tp {TP_RANKS} grad norms "
              f"{h0['grad_norms']} vs tp 1's {t1['grad_norms']}: rel err "
              f"{g_errs} > {TP_GNORM_RTOL}")
        depth = ", ".join(f"{k} {v}" for k, v in TP_FAM_DEPTH[arch].items())
        print(f"[24 mesh] (h) {arch} bf16 (remat, {depth}) {TP_FAM_STEPS} "
              f"steps of {ARCH_TRAIN_B} x {ARCH_TRAIN_T} from the placed "
              f"init, tp {TP_RANKS} (gloo: no NVLink figure) vs tp 1 on the "
              f"card: losses {[round(x, 5) for x in h0['losses']]} vs "
              f"{[round(x, 5) for x in t1['losses']]} (rel err "
              f"{max(errs):.3g}, tol {TRAIN_BF16_LOSS_RTOL}, share "
              f"{max(errs) / TRAIN_BF16_LOSS_RTOL:.3f}); grad norms "
              f"{[round(x, 4) for x in h0['grad_norms']]} vs "
              f"{[round(x, 4) for x in t1['grad_norms']]} (rel err "
              f"{max(g_errs):.3g}, tol {TP_GNORM_RTOL}, share "
              f"{max(g_errs) / TP_GNORM_RTOL:.3f}); "
              + "; ".join(
                  f"rank {i}: parameters {r[arch]['param_bytes']} B, "
                  f"moments {r[arch]['moment_bytes']} B "
                  f"({(r[arch]['param_bytes'] + r[arch]['moment_bytes']) / (t1['param_bytes'] + t1['moment_bytes']):.4f} "
                  f"of tp 1's {t1['param_bytes']} + {t1['moment_bytes']} "
                  f"B), peak {r[arch]['peak'] / 1e9:.2f} GB (init peak "
                  f"{r[arch]['init_peak'] / 1e9:.2f} GB), launches a step "
                  f"{r[arch]['kernels'][0]} at {r[arch]['heads']}, "
                  f"{saved_line(r[arch], t1)}, step ms "
                  f"{[round(x, 1) for x in r[arch]['step_ms']]}"
                  for i, r in enumerate(ranks))
              + f"; tp 1: peak {t1['peak'] / 1e9:.2f} GB, step ms "
              f"{[round(x, 1) for x in t1['step_ms']]}, launches a step "
              f"{t1['kernels'][0]} at {t1['heads']}; {card}", flush=True)
        res[arch] = {"kernels": h0["kernels"][0], "heads": h0["heads"]}
    took = max(r["s"] for r in ranks)
    print(f"[24 mesh] (h) tp 1's steps {tp1_s:.1f} s in this process; the "
          f"ranks' (h) {took:.1f} s (budget {TP_FAM_BUDGET_S} s"
          f"{'' if took <= TP_FAM_BUDGET_S else ', over it'})", flush=True)
    return res


def nvidia_card() -> str:
    """The card's name and power limit (nvidia-smi)."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
        else "nvidia-smi failed"


def phase_mesh_dryrun(res) -> None:
    """[24 mesh] (f) 25a's dry runs of the partitioned cells beside what
    the trees before the partitioned step (TP_DRYRUN_BEFORE) and before
    sequence and context parallelism (TP_DRYRUN_PARENT) printed, held to
    TP_DRYRUN_USEFUL_GAIN, TP_DRYRUN_PEAK_B, TP_SP_PEAK_SHARE and
    TP_CP_KERNEL_SHARE."""
    for arch, parent in TP_DRYRUN_PARENT.items():
        r = res[arch]
        flops, peak, useful = TP_DRYRUN_BEFORE.get(arch, parent[:3])
        k = r["kernels"]
        kf = (k["flash_attention_bhtd"]["flops"],
              k["flash_attention_bwd_bhtd"]["flops"])
        print(f"[24 mesh] (f) {arch} train_4k on meta at 16 x 16 (fake "
              f"world of 256, model rank {r['model_index']}), the "
              f"partitioned step: flops_per_device "
              f"{r['flops_per_device']:.6g} (parent {parent[0]:.6g}; "
              f"before the partitioned step {flops:.6g}), peak_per_device "
              f"{r['memory']['peak_per_device']} B (parent {parent[1]}; "
              f"before {peak}), useful FLOP share "
              f"{r['useful_flops_ratio']:.4f} (parent {parent[2]:.4f}; "
              f"before {useful:.4f}), kernel 2 and 3 FLOPs {kf[0]:.6g} and "
              f"{kf[1]:.6g} (parent {parent[3]:.6g} and {parent[4]:.6g}: "
              f"{kf[0] / parent[3]:.4f}, {kf[1] / parent[4]:.4f})",
              flush=True)
    for arch, saves in TP_SP_SAVES.items():
        fell = TP_DRYRUN_PARENT[arch][1] - res[arch]["memory"][
            "peak_per_device"]
        check(fell >= TP_SP_PEAK_SHARE * saves,
              f"[24 mesh] (f) {arch} peak fell {fell} B, under "
              f"{TP_SP_PEAK_SHARE} of the {saves:.4g} B of saves cut")
    r = res["qwen2-0.5b"]
    check(r["model_index"] == 15, f"[24 mesh] (f) qwen2-0.5b counted on "
                                  f"model rank {r['model_index']}, not 15")
    for i, name in enumerate(("flash_attention_bhtd",
                              "flash_attention_bwd_bhtd")):
        got = r["kernels"][name]["flops"]
        check(got <= TP_CP_KERNEL_SHARE * TP_DRYRUN_PARENT["qwen2-0.5b"][3
                                                                       + i],
              f"[24 mesh] (f) qwen2-0.5b {name} {got} FLOP a device")
    q = res["qwen3-0.6b"]["useful_flops_ratio"]
    check(q >= TP_DRYRUN_USEFUL_GAIN * TP_DRYRUN_BEFORE["qwen3-0.6b"][2],
          f"[24 mesh] (f) qwen3-0.6b useful FLOP share {q}")
    for arch in ("yi-9b", "qwen3-moe-30b-a3b"):
        y = res[arch]["memory"]["peak_per_device"]
        check(y < TP_DRYRUN_PEAK_B, f"[24 mesh] (f) {arch} peak {y} B")
    f = res["qwen3-moe-30b-a3b"]["flops_per_device"]
    check(f <= TP_DRYRUN_MOE_FLOPS_SHARE
          * TP_DRYRUN_BEFORE["qwen3-moe-30b-a3b"][0],
          f"[24 mesh] (f) qwen3-moe-30b-a3b {f} FLOP a device")
    mp = 16                     # the 16 x 16 mesh's model axis
    for arch, (flops, peak, useful, kern) in TP_DRYRUN_FAM_PARENT.items():
        r = res[arch]
        got = (r["flops_per_device"], r["memory"]["peak_per_device"],
               r["useful_flops_ratio"])
        kinds = {name: (what, r["kernels"][name][what], want)
                 for name, (what, want) in kern.items()}
        print(f"[24 mesh] (f) {arch} train_4k on meta at 16 x 16 (fake "
              f"world of 256, model rank {r['model_index']}), the "
              f"partitioned step: flops_per_device {got[0]:.6g} (parent "
              f"{flops:.6g}: {got[0] / flops:.4f}), peak_per_device "
              f"{got[1]} B (parent {peak}: {got[1] / peak:.4f}), useful FLOP "
              f"share {got[2]:.4f} (parent {useful:.4f}: x "
              f"{got[2] / useful:.2f})"
              + "".join(f"; {name} {what} {v} (parent {w}: 1 / {w / v:g})"
                        for name, (what, v, w) in kinds.items()), flush=True)
        check(got[2] >= TP_DRYRUN_USEFUL_GAIN * useful,
              f"[24 mesh] (f) {arch} useful FLOP share {got[2]}, under "
              f"{TP_DRYRUN_USEFUL_GAIN} x the parent's {useful}")
        check(got[1] < min(peak, TP_DRYRUN_PEAK_B),
              f"[24 mesh] (f) {arch} peak {got[1]} B, parent {peak}")
        for name, (what, v, w) in kinds.items():
            check(v * mp == w, f"[24 mesh] (f) {arch} {name} {what} {v} "
                               f"a device, not 1 / {mp} of the parent's {w}")


class A2ACapacity:
    """While entered, ``moe_impl="a2a"`` runs at capacity ``factor`` (the
    model calls ``moe_a2a`` with its default 1.25, as JAX's does)."""

    def __init__(self, factor):
        self.factor = factor

    def __enter__(self):
        import functools

        from repro_torch.distributed import moe_a2a as A

        self._orig = A.moe_a2a
        A.moe_a2a = functools.partial(self._orig,
                                      capacity_factor=self.factor)
        return self

    def __exit__(self, *exc):
        from repro_torch.distributed import moe_a2a as A

        A.moe_a2a = self._orig


class IdLog:
    """While entered, keeps every MoE router call's expert ids [N, k]."""

    def __enter__(self):
        from repro_torch.models import layers as TL

        self.calls, self._orig = [], TL.moe_router

        def rec(cfg, p, xf):
            w, ids, aux = self._orig(cfg, p, xf)
            self.calls.append(ids)
            return w, ids, aux
        TL.moe_router = rec
        return self

    def __exit__(self, *exc):
        from repro_torch.models import layers as TL

        TL.moe_router = self._orig


def profile_prefill(dev, bundle, params, prompt, moe_impl, tag):
    """One more bf16 prefill of ``prompt`` under ``torch.profiler``: host
    wall, the card's busy time and idle share, device time by
    ``MOE_GROUPS``."""
    from repro_torch.serve import make_prefill

    B, T = prompt.shape
    state = bundle.init_decode_state(B, T, device=dev)
    run = make_prefill(bundle, moe_impl=moe_impl, executor="cuda")
    wall, split = profile_split(lambda: run(params, state, prompt),
                                MOE_GROUPS, "other")
    del state
    if split is None:
        print(f"{tag} profiled {moe_impl} prefill: {wall:.1f} ms host wall; "
              f"no device events: split not measured", flush=True)
        return
    n, busy, by, top = split
    print(f"{tag} profiled {moe_impl} prefill (torch.profiler CPU+CUDA, B "
          f"{B} x T {T}): host wall {wall:.1f} ms, {n} device events, card "
          f"busy {busy:.1f} ms, idle {max(0.0, 1 - busy / wall):.3f} of the "
          f"wall; device time by group: "
          + "; ".join(f"{g} {ms:.1f} ms" for g, ms in by.items())
          + f"; largest other kernels: "
          f"{[(k_, round(ms, 1)) for k_, ms in top]}", flush=True)


def phase_mesh_moe(dev, bundle, params, prompt, mesh, gmm_ms,
                   gmm_peak) -> dict:
    """[24 mesh] (b) qwen3-moe-30b-a3b's prefill through ``moe_a2a`` on
    the 1 x 1 mesh, on phase 23a's weights: at ample capacity against the
    gmm prefill (the a2a routed as gmm's, its own differing expert sets
    each at a near tie); at the production factor on the 8 x 2,048 prompt:
    the a2a and gmm prefills timed in turn, each layer's dropped share,
    launches, peak."""
    import torch

    from repro_torch.distributed import moe_a2a as A
    from repro_torch.distributed import sharding
    from repro_torch.kernels.flash_attention import flash_attention_bhtd
    from repro_torch.serve import make_prefill

    t_phase = time.perf_counter()
    cfg = bundle.cfg
    E, k, D = cfg.moe.num_experts, cfg.moe.top_k, cfg.d_model
    B, T = prompt.shape
    ample = E / k
    logits, logs = {}, {}
    with sharding.set_mesh(mesh), A2ACapacity(ample):
        for impl in ("gmm", "a2a"):
            state = bundle.init_decode_state(A2A_AMPLE_B, T, device=dev)
            prefill = make_prefill(bundle, moe_impl=impl, executor="cuda")
            with RouterLog(replay=logs.get("gmm")) as log:
                logits[impl], _ = prefill(params, state,
                                          prompt[:A2A_AMPLE_B])
            logs[impl] = log
            del state
    n_ample = A2A_AMPLE_B * T
    c_ample = A.capacity(n_ample, k, E, ample)
    dropped_ample = sum(int((~A.dispatch_slots(ids, E, c_ample)[1]).sum())
                        for _, _, ids, _ in logs["a2a"].calls)
    a = logits["a2a"][:, -1].float()
    b = logits["gmm"][:, -1].float()
    check(bool(torch.isfinite(a).all()), "a2a prefill: non-finite logits")
    scale = float(b.abs().max())
    err = float((a - b).abs().max()) / scale
    flips, ratio = routing_flips(logs["a2a"], logs["gmm"], k)
    del logs, logits
    check(dropped_ample == 0 and c_ample == n_ample,
          f"ample capacity {c_ample} for {n_ample} tokens dropped "
          f"{dropped_ample} pairs")
    check(ratio <= 1.0, f"a2a vs gmm: an expert set differs at a top-k "
                        f"margin {ratio:.3g} x twice the runs' probability "
                        f"difference (not a near tie)")
    check(err <= SERVE_BF16_TOL, f"a2a vs gmm prefill logits max |err| "
                                 f"{err:.4g} of max |logit| > "
                                 f"{SERVE_BF16_TOL}")

    state = bundle.init_decode_state(B, T, device=dev)
    prefill = make_prefill(bundle, moe_impl="a2a", executor="cuda")
    reset_attention_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    retries = torch.cuda.memory_stats().get("num_alloc_retries", 0)
    t0 = time.perf_counter()
    with sharding.set_mesh(mesh), IdLog() as ids:
        lg, _ = prefill(params, state, prompt)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    retries = torch.cuda.memory_stats().get("num_alloc_retries", 0) - retries
    launches = flash_attention_bhtd.launches
    check_bf16_route("a2a prefill")
    peak = torch.cuda.max_memory_allocated()
    # a2a and gmm prefills timed in turn, A2A_TIMED of each
    runs = {"a2a": prefill,
            "gmm": make_prefill(bundle, moe_impl="gmm", executor="cuda")}
    times = {impl: [] for impl in runs}
    for _ in range(A2A_TIMED):
        for impl, run in runs.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with sharding.set_mesh(mesh):
                run(params, state, prompt)
            torch.cuda.synchronize()
            times[impl].append((time.perf_counter() - t0) * 1e3)
    a2a_ms, gmm_med = (statistics.median(times[i]) for i in ("a2a", "gmm"))
    lo = min(times["a2a"]) / max(times["gmm"])
    hi = max(times["a2a"]) / min(times["gmm"])
    del state
    check(bool(torch.isfinite(lg.float()).all()),
          "a2a prefill at the production factor: non-finite logits")
    check(launches == cfg.num_layers,
          f"the a2a prefill launched kernel 2 {launches} times, not "
          f"{cfg.num_layers}")
    check(len(ids.calls) == cfg.num_layers, "a router call a layer")
    C = A.capacity(B * T, k, E, A2A_FACTOR)
    drops = [float((~A.dispatch_slots(i, E, C)[1]).float().mean())
             for i in ids.calls]
    del ids, lg
    send = E * (C + 1) * D * 2
    # where the time goes: one dispatch all-to-all of a layer's [E, C, D]
    # buffer over the model axis (NCCL, a world of one) against a copy of
    # the same bytes
    buf = torch.zeros((E, C, D), dtype=torch.bfloat16, device=dev)
    a2a_one = sharding.shard_map(
        lambda v: sharding.all_to_all(v, "model", 0, 1), mesh=mesh,
        in_specs=sharding.P(), out_specs=sharding.P())
    a2a_one_ms = time_cuda(lambda: a2a_one(buf), 3)
    copy_ms = time_cuda(lambda: buf.clone(), 3)
    del buf
    # and the prefill profiled (23b profiles gmm's)
    with sharding.set_mesh(mesh):
        profile_prefill(dev, bundle, params, prompt, "a2a", "[24 mesh] (b)")
    took = time.perf_counter() - t_phase
    print(f"[24 mesh] (b) {cfg.name} on the 1 x 1 mesh, moe_impl a2a: "
          f"ample capacity (factor {ample:g}: C {c_ample} = N, 0 pairs "
          f"dropped) at B {A2A_AMPLE_B} x T {T} vs the gmm prefill: last "
          f"logits max |err| {err:.4g} of max |logit| {scale:.4g} (tol "
          f"{SERVE_BF16_TOL}); routed as gmm's, its own expert sets differ "
          f"at {flips} of {n_ample * cfg.num_layers} (token, layer), each "
          f"at a near tie (margin at most {ratio:.3g} x twice the runs' "
          f"probability difference)", flush=True)
    print(f"[24 mesh] (b) production factor {A2A_FACTOR} at B {B} x T {T} "
          f"(C {C} slots an expert; send buffer [{E}, {C + 1}, {D}] bf16 = {send} "
          f"B): prefills in turn, {A2A_TIMED} each (host wall, synchronized): "
          f"a2a median {a2a_ms:.1f} ms (each "
          f"{[round(x, 1) for x in times['a2a']]}), gmm median {gmm_med:.1f} "
          f"ms (each {[round(x, 1) for x in times['gmm']]}); a2a / gmm "
          f"{a2a_ms / gmm_med:.3f} of the medians, {lo:.3f}-{hi:.3f} over "
          f"the runs, at a mean dropped share of "
          f"{statistics.mean(drops):.4f} (a different answer from gmm's); "
          f"the first, counted a2a prefill {first_ms:.1f} ms, 23a's timed "
          f"gmm prefill {gmm_ms:.1f} ms; {launches} kernel 2 "
          f"launches (all wgmma), logits finite, peak {peak} B (gmm "
          f"generate {gmm_peak} B; PR 25 run B 67.1 GB); dropped (token, "
          f"expert) share by layer: "
          + " ".join(f"{d:.4f}" for d in drops)
          + f" (mean {statistics.mean(drops):.4f}, max {max(drops):.4f}); "
          f"one all-to-all of a layer's [{E}, {C}, {D}] bf16 buffer "
          f"{a2a_one_ms:.3f} ms (CUDA events, median of 3; a copy of its "
          f"bytes {copy_ms:.3f} ms), two a layer: "
          f"{2 * cfg.num_layers * a2a_one_ms:.1f} ms of the prefill; "
          f"{retries} allocator retries in the timed prefill; "
          f"{took:.1f} s", flush=True)
    return {"launches": launches, "prefill_ms": a2a_ms, "gmm_ms": gmm_med,
            "times": times,
            "max_abs_err": err, "peak": peak, "drops": drops,
            "a2a_ms": a2a_one_ms, "copy_ms": copy_ms, "phase_s": took}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if "--env-plain" in sys.argv:
        env_plain_check(torch.device("cuda"))
        return 0
    if "--tp-rank" in sys.argv:
        i = sys.argv.index("--tp-rank")
        tp_rank_main(int(sys.argv[i + 1]), sys.argv[i + 2], sys.argv[i + 3])
        return 0
    try:
        return smoke(torch.device("cuda"),
                     tick_only="--tick-loop" in sys.argv,
                     learn_only="--learn" in sys.argv,
                     recurrent_only="--recurrent-train" in sys.argv,
                     fleet_only="--fleet" in sys.argv,
                     rwkv6_only="--rwkv6-train" in sys.argv,
                     families_only="--families" in sys.argv,
                     mesh_only="--mesh" in sys.argv,
                     dryrun_only="--dryrun" in sys.argv,
                     archs_only="--archs" in sys.argv)
    finally:
        for proc in CHILDREN:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        if "repro_torch.launch.mesh" in sys.modules:
            sys.modules["repro_torch.launch.mesh"].close_world()


def smoke(dev, tick_only=False, learn_only=False, recurrent_only=False,
          fleet_only=False, rwkv6_only=False, families_only=False,
          mesh_only=False, dryrun_only=False, archs_only=False) -> int:
    """Every phase (with ``tick_only``, phases 1-6 and 17; with
    ``learn_only``, phases 1-3 and 18; with ``recurrent_only``, phases 1-2
    and 19; with ``fleet_only``, phases 1-3, 20 and 21; with
    ``rwkv6_only``, phases 1-2 and 22; with ``families_only``, phases 1-2
    and 23; with ``mesh_only``, phases 1-2, 11 and 24, with 23a-b for the
    MoE; with ``dryrun_only``, phases 1-2, 24a's world and 25, with 16 for
    rwkv6-7b; with ``archs_only``, phases 1-2 and 26), on the CUDA device
    ``dev``."""
    import torch

    from repro_torch import api
    from repro_torch.core import tickstate
    from repro_torch.kernels import build
    from repro_torch.kernels import tick_loop as tl
    fa = importlib.import_module(
        "repro_torch.kernels.flash_attention.flash_attention")
    fa_bwd = importlib.import_module(
        "repro_torch.kernels.flash_attention.flash_attention_bwd")

    # 1. card
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    print(f"[1 card] torch {torch.__version__} cuda {torch.version.cuda}; "
          f"device {kind!r} x{count}", flush=True)

    # 2. build
    t0 = time.perf_counter()
    logs = build.build_all()
    build.load_tick_loop()
    build.load_flash_attention()
    build.load_flash_attention_bwd()
    build.load_flash_attention_sm90()
    build.load_flash_attention_bwd_sm90()
    build.load_wkv()
    build.load_wkv_bwd()
    build.load_wkv_bwd_chunk()
    build.load_rglru()
    print(f"[2 build] {', '.join(logs)} built (in parallel) and loaded in "
          f"{time.perf_counter() - t0:.1f} s; nvcc wall time each: "
          + ", ".join(f"{src} {build.nvcc_seconds(log)} s"
                      for src, log in logs.items()), flush=True)
    # The float32 (FMA) kernels: registers and spills (none allowed), shared
    # memory and the warps an SM holds (fa.resident_warps).
    for name, line in build.ptxas_report(
            logs["flash_attention.cu"]).items():
        inst = build.flash_attention_instance(name)
        combine = build.flash_attention_combine_instance(name)
        check(inst is not None or combine is not None,
              f"unexpected entry {name}")
        check(spilled(line) == 0, f"flash_attention.cu {name} spills: "
                                  f"{line}")
        if combine is not None:
            print(f"[2 build] flash_attention.cu combine {combine[0]} "
                  f"hd={combine[1]}: {line}", flush=True)
            continue
        smem = fa.smem_bytes(inst[1])
        print(f"[2 build] flash_attention.cu {inst[0]} hd={inst[1]}: "
              f"{line}; {smem} B dynamic shared memory; "
              f"{fa.resident_warps(smem, fa.F32_THREADS[inst[1]])} warps "
              f"an SM")
    for name, line in build.ptxas_report(
            logs["flash_attention_bwd.cu"]).items():
        inst = build.flash_attention_bwd_instance(name)
        check(inst is not None, f"unexpected entry {name}")
        check(spilled(line) == 0, f"flash_attention_bwd.cu {inst[0]} "
                                  f"hd={inst[2]} spills: {line}")
        if inst[0] == "sum":
            print(f"[2 build] flash_attention_bwd.cu sum {inst[1]} "
                  f"hd={inst[2]}: {line}", flush=True)
            continue
        smem = fa_bwd.smem_bytes(inst[2])[inst[0] == "dkdv"]
        threads = (fa_bwd.F32_KV_THREADS if inst[0] == "dkdv"
                   else fa_bwd.F32_DQ_THREADS)[inst[2]]
        print(f"[2 build] flash_attention_bwd.cu {inst[0]} {inst[1]} "
              f"hd={inst[2]}: {line}; {smem} B dynamic shared memory; "
              f"{fa.resident_warps(smem, threads)} warps an SM")
    for src in ("flash_attention_sm90.cu", "flash_attention_bwd_sm90.cu"):
        for name, line in build.ptxas_report(logs[src]).items():
            inst = build.flash_attention_sm90_instance(name)
            check(inst is not None, f"unexpected entry {name}")
            smem = (fa.sm90_smem_bytes(inst[1]) if inst[0] == "fwd" else
                    fa_bwd.sm90_smem_bytes(inst[1])[inst[0] == "dkdv"])
            print(f"[2 build] {src} {inst[0]} bf16 hd={inst[1]}: {line}; "
                  f"{smem} B dynamic shared memory")
        hgmma = build.hgmma_count(src)
        check(hgmma != 0, f"{src}: no HGMMA instruction in its library")
        print(f"[2 build] {src}: "
              + ("cuobjdump not in the toolkit, HGMMA not counted"
                 if hgmma is None else
                 f"{hgmma} HGMMA (wgmma) instructions in its SASS"),
              flush=True)
    from repro_torch.kernels.rwkv6 import rwkv6 as wkv_mod
    for name, line in build.ptxas_report(logs["wkv.cu"]).items():
        inst = build.wkv_instance(name)
        check(inst is not None, f"unexpected entry {name}")
        w_bytes = 4 if inst[2] == "float32" else 2
        smem = ("" if inst[0] == "step" else
                f"; {wkv_mod.chunk_smem_bytes(inst[3], w_bytes)} B dynamic "
                f"shared memory")
        print(f"[2 build] wkv {inst[0]} route, r/k/v {inst[1]}, w {inst[2]}, "
              f"{inst[3]} columns a block: {line}{smem}")
    hgmma = build.hgmma_count("wkv.cu")
    check(hgmma != 0, "wkv.cu: no HGMMA instruction in its library")
    print(f"[2 build] wkv.cu: "
          + ("cuobjdump not in the toolkit, HGMMA not counted"
             if hgmma is None else
             f"{hgmma} HGMMA (wgmma) instructions in its SASS"), flush=True)
    for name, line in build.ptxas_report(logs["wkv_bwd.cu"]).items():
        inst = build.wkv_bwd_instance(name)
        check(inst is not None and len(inst) == 2, f"unexpected entry {name}")
        print(f"[2 build] wkv_bwd step route, r/k/v {inst[0]}, w {inst[1]} "
              f"(256 threads a (b, h); {wkv_mod.WKV_BWD_SMEM} B dynamic "
              f"shared memory): {line}")
    for name, line in build.ptxas_report(logs["wkv_bwd_chunk.cu"]).items():
        inst = build.wkv_bwd_instance(name)
        check(inst is not None and len(inst) == 3, f"unexpected entry {name}")
        w_bytes = 4 if inst[1] == "float32" else 2
        smem = (wkv_mod.bwd_chunk_smem_bytes(w_bytes) if inst[2] == "chunk"
                else wkv_mod.bwd_state_smem_bytes(int(inst[2][6:]), w_bytes))
        what = ("chunk pass (128 threads a (b, h, chunk))"
                if inst[2] == "chunk" else
                f"state pass (128 threads a (b, h) and {inst[2][6:]} "
                f"columns)")
        print(f"[2 build] wkv_bwd chunked route, {what}, r/k/v {inst[0]}, w "
              f"{inst[1]}: {line}; {smem} B dynamic shared memory")
    hgmma = build.hgmma_count("wkv_bwd_chunk.cu")
    check(hgmma != 0, "wkv_bwd_chunk.cu: no HGMMA instruction in its library")
    print(f"[2 build] wkv_bwd_chunk.cu: "
          + ("cuobjdump not in the toolkit, HGMMA not counted"
             if hgmma is None else
             f"{hgmma} HGMMA (wgmma) instructions in its SASS"), flush=True)
    for name, line in build.ptxas_report(logs["rglru.cu"]).items():
        inst = build.rglru_instance(name)
        if inst is not None:
            print(f"[2 build] rglru {inst[0]}, {inst[1]} channels a block "
                  f"(one warp; TMA ring of "
                  f"{2 * 4 * 8192 + 128} B dynamic shared memory): {line}")
            continue
        inst = build.rglru_bwd_instance(name)
        check(inst is not None, f"unexpected entry {name}")
        print(f"[2 build] rglru_bwd {inst[0]}, {inst[1]} channels a block "
              f"(one warp; TMA ring): {line}")
    if recurrent_only:
        phase_recurrent_train(dev)
        print("chip_smoke: recurrent train phases (1-2, 19) passed")
        return 0
    if rwkv6_only:
        phase_rwkv6_train(dev)
        lap("phase 22")
        print("chip_smoke: rwkv6 train phases (1-2, 22) passed")
        return 0
    if mesh_only:
        dry = DryrunChildren()
        tree = random_qwen3_params()
        p11 = phase_train_golden(dev, tree)
        lap("phase 11")
        world = phase_mesh_world(dev)
        c_s = phase_mesh_train(dev, tree, world["mesh"], p11,
                               lambda phase, *a: phase(*a))
        MeshTP(dev, tree).join(p11["metrics"])
        del tree, p11
        lap("phase 24d, e, g")
        phase_mesh_dryrun(dry.join())
        lap("phase 24f (25a joined)")
        moe = phase_family_serve(dev, "qwen3-moe-30b-a3b", world["mesh"])
        mesh_budget(world["phase_s"], c_s, moe["a2a"]["phase_s"])
        lap("phase 24")
        print("chip_smoke: mesh phases (1-2, 11, 24 with 23a-b of the MoE "
              "and 25a's dry runs) passed")
        return 0
    if dryrun_only:
        dry = DryrunChildren()
        world = phase_mesh_world(dev)
        phase_dots(dev)
        phase_dryrun_card(dev, world["mesh"])
        phase_recurrent_serve(dev, "rwkv6-7b")
        dry.join()
        lap("phase 25")
        print("chip_smoke: dry-run phases (1-2, 24a, 25 with 16 of rwkv6-7b)"
              " passed")
        return 0
    if archs_only:
        # 26d's train goldens of whisper and qwen2-vl take 23c's weights
        draws = start_family_draws(tuple(ARCH_GOLDENS)
                                   + ("whisper-small", "qwen2-vl-2b"))
        phase_flash_bwd(dev)
        lap("phase 10")
        archs = phase_archs(dev)
        arch_budget(archs["phase_s"], phase_arch_goldens(dev, draws))
        lap("phase 26")
        print("chip_smoke: arch phases (1-2, 10, 26) passed")
        return 0
    if families_only:
        draws = start_family_draws()
        t0 = time.perf_counter()
        for arch in FAMILY_GOLDENS:
            phase_family_golden(dev, arch, draws[arch])
        golden_s = time.perf_counter() - t0
        fams = phase_families(dev)
        family_budget(fams["phase_s"], golden_s)
        lap("phase 23")
        print("chip_smoke: family phases (1-2, 23) passed")
        return 0
    report = build.ptxas_report(logs["tick_loop.cu"])
    used = set()
    env_d = api.make_environment("dvfs", **DVFS_TUNE)
    learned_p, _ = golden_learned()
    learned_c = api.make_controller("learned", params=learned_p)
    for scs in ([dataclasses.replace(sc, controller=learned_c,
                                     environment=env)
                 for sc in learn_teacher_cells() for env in (None, env_d)],
                tune_scenarios(learned=learned_p)[:1],
                list(golden_scenarios().values()),
                [s for _, s in fig2_scenarios(smoke=False)],
                tune_scenarios()[:1],
                [s for _, s in degeneration_scenarios()],
                [s for _, s in env_smoke_scenarios()],
                [s for _, s in fig_dvfs_scenarios()],
                [s for _, s in greendataflow_scenarios()],
                tune_scenarios(environment=env_d)[:1]):
        used |= partition_counts_of(scs, dev)
    grouped = {build.tick_loop_grouped_instance(k): v
               for k, v in report.items()}
    check(sorted(grouped) == list(range(1, 9)),
          f"tick-loop kernels {sorted(grouped)}, expected P 1-8 only")
    for p in sorted(used):
        print(f"[2 build] tick_loop_grouped_kernel P={p} (every KIND, "
              f"scaling and environment flag in one kernel): {grouped[p]}")

    # 3. goldens
    before = tl.tick_loop.launches
    bad = []
    ref_runs = {}
    for cell, sc in golden_scenarios(executor="cuda").items():
        r = ref_runs[cell] = api.run(sc, device=dev)
        got = (r.completed, r.time_s, r.energy_j, r.avg_tput_MBps,
               r.avg_power_w)
        if got != RUN_GOLDEN[cell]:
            bad.append((cell, got, RUN_GOLDEN[cell]))
    launched = tl.tick_loop.launches - before
    check(not bad, f"RUN_GOLDEN mismatches on the card: {bad}")
    check(launched == len(RUN_GOLDEN),
          f"{launched} launches for {len(RUN_GOLDEN)} golden cells")
    print(f"[3 goldens] {len(RUN_GOLDEN)}/{len(RUN_GOLDEN)} RUN_GOLDEN cells "
          f"bit-exact on the cuda executor, {launched} launches", flush=True)
    if learn_only:
        phase_learn(dev)
        print("chip_smoke: learn phases (1-3, 18) passed")
        return 0
    if fleet_only:
        phase_fleet(dev)
        phase_online(dev)
        print("chip_smoke: fleet phases (1-3, 20, 21) passed")
        return 0

    lap("phases 1-3")
    # 4. smoke grid: cuda executor vs reference executor, both on the card
    outs = {}
    for ex in ("cuda", "reference"):
        scs = [s for _, s in fig2_scenarios(smoke=True, executor=ex)]
        _, runs = api.run_groups(scs, device=dev)
        rows = []
        for r in sorted(runs, key=lambda r: r.indices):
            lay = tickstate.TickLayout(r.key.n_partitions)
            rows.append((*lay.pack_state(r.sim, r.ts), *r.metrics))
        outs[ex] = rows
    torch.cuda.synchronize()
    n_eq = sum(all(torch.equal(x, y) for x, y in zip(a, b))
               for a, b in zip(outs["cuda"], outs["reference"]))
    check(n_eq == len(outs["cuda"]),
          f"smoke grid: {len(outs['cuda']) - n_eq} groups differ between "
          f"the kernel and the plain version")
    print(f"[4 smoke] fig2 --smoke grid ({len(FIG2_SMOKE[0]) * len(FIG2_SMOKE[1]) * len(FIG2_SMOKE[2])} cells, "
          f"{n_eq} groups): cuda == reference on the card, final rows and "
          f"7 traces bit-equal", flush=True)

    lap("phase 4")
    # 5. the main path: full Figure 2 through api.sweep
    with open(os.path.join(ROOT, "tests", "torch_goldens",
                           "fig2_full.json")) as f:
        gold = json.load(f)
    cells = fig2_scenarios(smoke=False)
    scs = [s for _, s in cells]
    n_groups = api.group_count(scs, device=dev)
    check(n_groups == gold["group_count"],
          f"group_count {n_groups} != JAX's {gold['group_count']}")
    tl.tick_loop.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = api.sweep(scs, device=dev)
    wall = time.perf_counter() - t0
    main_launches = tl.tick_loop.launches
    check(main_launches == 1,
          f"main path launched the kernel {main_launches} times for one "
          f"sweep of {n_groups} groups")
    rows = {(r["testbed"], r["dataset"], r["tool"]): r for r in gold["rows"]}
    n_exact = 0
    for (cell, _), r in zip(cells, results):
        g = rows[cell]
        check(r.completed == g["completed"] and r.time_s == g["time_s"],
              f"fig2 {cell}: completed/time_s {r.completed}/{r.time_s} vs "
              f"{g['completed']}/{g['time_s']}")
        for f in ("energy_j", "avg_tput_MBps"):
            check(abs(getattr(r, f) - g[f]) <= 1e-5 * abs(g[f]),
                  f"fig2 {cell}: {f} {getattr(r, f)} vs {g[f]}")
        n_exact += all(getattr(r, f) == g[f] for f in
                       ("time_s", "energy_j", "avg_tput_MBps",
                        "avg_power_w"))
    headline = fig2_headline(cells, results)
    print(f"[5 fig2] {len(results)} cells in {n_groups} groups "
          f"({main_launches} launch; PR 11-18: 6), sweep wall {wall:.3f} s "
          f"(PR 18: {PER_GROUP_WALL_S['fig2']}); "
          f"{sum(r.completed for r in results)} completed; vs "
          f"fig2_full.json: completed/time_s exact, energy/tput rtol 1e-5, "
          f"{n_exact}/{len(results)} cells bit-exact", flush=True)
    print(f"[5 fig2] headline {json.dumps(headline)}; JAX "
          f"{json.dumps(gold['headline'])}", flush=True)

    # 5b. kernel vs plain version at the main path's shapes, timed
    grs = groups_on_card(scs, dev)
    kern = [call(tl.tick_loop, k, rows_) for k, rows_ in grs]
    t0 = time.perf_counter()
    plain = [call(tl.tick_loop_reference, k, rows_)
             for k, rows_ in grs[:FIG2_PLAIN_GROUPS]]
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    errs = [compare_outputs(a, b) for a, b in zip(kern, plain)]
    max_err = max(e for _, e in errs)
    check(all(eq for eq, _ in errs),
          f"fig2 groups: kernel != plain version (max |err| {max_err})")
    ticks = [executed_lane_ticks(m, k.n_steps)
             for (k, _), (_, _, m) in zip(grs, kern)]
    group_ms = time_cuda(lambda: [call(tl.tick_loop, k, r)
                                  for k, r in grs], 5)
    # the main path's launch: every group at once, held to the groups' own
    # launches (and so to the plain version where it ran) bit for bit
    rows_g, err_g = grouped_vs_groups(scs, dev, kern, "fig2")
    max_err = max(max_err, err_g)
    ms = time_cuda(lambda: tl.tick_loop_grouped(rows_g), 5)
    # a sweep costs its slowest group: each group in a launch of its own
    per = []
    for (k, r), t in zip(grs, ticks):
        own = time_cuda(lambda: call(tl.tick_loop, k, r), 3)
        per.append(f"{r[1].shape[0]}x{r[1].shape[1]} P{k.n_partitions} "
                   f"{k.ctrl_code.name}: "
                   f"{own:.3f} ms ({t / own * 1e3:.4g} lane-ticks/s)")
    print(f"[5 fig2] each group in its own launch (median of 3): "
          + "; ".join(per), flush=True)
    bound_ms, bound_by, nbytes, ops = bound_of(grs, ticks)
    shapes = ", ".join(f"{r[1].shape[0]}x{r[1].shape[1]}" for _, r in grs)
    print(f"[5 fig2] kernel vs plain on the card: the first "
          f"{len(plain)} of {len(grs)} groups bit-equal to the plain "
          f"version, all {len(grs)} (lanes x ticks: {shapes}) each in its "
          f"own launch and all in one launch bit-equal (P "
          f"{(rows_g[0][3].shape[1] - 13) // 5}); the sweep's launch {ms:.3f} "
          f"ms (median of 5, 1 launch; PR 17: 56.982 in 6), the groups' "
          f"own launches {group_ms:.3f} ms ({len(grs)} launches); plain "
          f"{plain_ms:.1f} ms over {len(plain)} groups (one run); "
          f"{sum(ticks)} executed lane-ticks; "
          f"bound {bound_ms:.4f} ms by {bound_by} ({nbytes} B, {ops} ops)",
          flush=True)
    del rows_g

    lap("phase 5")
    # 6. tune-sized sweep: 4,096 lanes in one group
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tune_results = api.sweep(tune_scenarios(), device=dev)
    tune_wall = time.perf_counter() - t0
    check(len(tune_results) == len(TUNE_ALPHA) * len(TUNE_BETA)
          * len(TUNE_DELTA_CH) * len(TUNE_MAX_CH) * len(TUNE_SEEDS),
          "tune sweep size")
    peak = torch.cuda.max_memory_allocated()
    tscs = tune_scenarios(executor="cuda")
    grs_t = groups_on_card(tscs, dev)
    check(len(grs_t) == 1, f"tune sweep split into {len(grs_t)} groups")
    (key_t, rows_t), = grs_t
    kern_t = call(tl.tick_loop, key_t, rows_t)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain_t = call(tl.tick_loop_reference, key_t, rows_t)
    torch.cuda.synchronize()
    plain_t_ms = (time.perf_counter() - t0) * 1e3
    eq_t, err_t = compare_outputs(kern_t, plain_t)
    check(eq_t, f"tune sweep: kernel != plain version (max |err| {err_t})")
    _, runs_ref = api.run_groups(tune_scenarios(executor="reference"),
                                 device=dev)
    lay = tickstate.TickLayout(key_t.n_partitions)
    ref_rows = (*lay.pack_state(runs_ref[0].sim, runs_ref[0].ts),
                *runs_ref[0].metrics)
    ker_rows = (kern_t[0], kern_t[1], *[m if f != "done" else m != 0
                                        for f, m in zip(
                                            kern_t[2]._fields, kern_t[2])])
    check(all(torch.equal(x, y) for x, y in zip(ker_rows, ref_rows)),
          "tune sweep: cuda executor != reference executor")
    del plain_t, runs_ref
    ticks_t = executed_lane_ticks(kern_t[2], key_t.n_steps)
    ms_t = time_cuda(lambda: call(tl.tick_loop, key_t, rows_t), 5)
    bound_t, by_t, nbytes_t, ops_t = bound_of(grs_t, [ticks_t])
    b, n = rows_t[1].shape
    print(f"[6 tune] {b} lanes x {n} ticks, 1 group: kernel == plain on "
          f"all lanes; kernel {ms_t:.3f} ms (median of 5); "
          f"{ticks_t} executed lane-ticks = {ticks_t / (ms_t / 1e3):.4g} "
          f"lane-ticks/s; {nbytes_t} B written/read, memory bound "
          f"{nbytes_t / HBM_BYTES_PER_S * 1e3:.4f} ms (bound {bound_t:.4f} "
          f"ms by {by_t}); plain {plain_t_ms:.1f} ms; peak memory "
          f"{peak} B; sweep end to end {tune_wall:.3f} s; "
          f"{sum(r.completed for r in tune_results)} completed", flush=True)

    # 6b. a sweep of two partition counts: one launch per count, no group
    # padded to another's; and what padding the P 1 group to P 8 would cost
    mix = mixed_partition_scenarios()
    tl.tick_loop.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mix_results = api.sweep(mix, device=dev)
    mix_wall = time.perf_counter() - t0
    mix_launches = tl.tick_loop.launches
    grs_m = groups_on_card(mix, dev)
    check(sorted(k.n_partitions for k, _ in grs_m) == [1, 8]
          and mix_launches == 2,
          f"mixed sweep: partition counts "
          f"{[k.n_partitions for k, _ in grs_m]} in {mix_launches} launches")
    kern_m = [call(tl.tick_loop, k, r) for k, r in grs_m]
    for (k, r), kern in zip(grs_m, kern_m):
        eq, err = compare_outputs(kern, call(tl.tick_loop_reference, k, r))
        check(eq, f"mixed sweep P{k.n_partitions}: kernel != plain version "
                  f"(max |err| {err})")
    rows_m, _ = grouped_vs_groups(mix, dev, kern_m, "mixed sweep")
    ms_m = time_cuda(lambda: tl.tick_loop_grouped(rows_m), 5)
    own_m = [time_cuda(lambda: call(tl.tick_loop, k, r), 5)
             for k, r in grs_m]
    (k1, r1, m1), = [(k, r, m) for (k, r), m in zip(grs_m, kern_m)
                     if k.n_partitions == 1]
    wide_rows = padded_group_on_card(mix, k1, dev, 8)
    wide = call(tl.tick_loop, k1, wide_rows)
    f32w = torch.cat([wide[0][:, :1], wide[0][:, 8:9], wide[0][:, 16:]],
                     dim=1)
    check(compare_outputs((f32w, wide[1], wide[2]), m1)[0],
          "mixed sweep: the P 1 group padded to P 8 != at P 1")
    ms_1 = own_m[[k.n_partitions for k, _ in grs_m].index(1)]
    ms_w = time_cuda(lambda: call(tl.tick_loop, k1, wide_rows), 5)
    ticks_1 = executed_lane_ticks(m1[2], k1.n_steps)
    print(f"[6b mixed P] {len(mix)} cells in {len(grs_m)} groups (P 1: "
          f"{r1[1].shape[0]} EEMT lanes on LARGE; P 8: 16 ME lanes): "
          f"{mix_launches} launches, one a partition count, each group "
          f"bit-equal to its own launch and the plain version; the sweep's "
          f"launches "
          f"{ms_m:.3f} ms (median of 5), each group's own "
          + ", ".join(f"P{k.n_partitions} {t:.3f} ms"
                      for (k, _), t in zip(grs_m, own_m))
          + f"; sweep wall {mix_wall:.3f} s, "
          f"{sum(r.completed for r in mix_results)} completed.  The P 1 "
          f"group padded to P 8 (bit-equal): {ms_w:.3f} ms vs {ms_1:.3f} "
          f"ms at P 1 over {ticks_1} executed lane-ticks: "
          f"{ms_w / ms_1:.3f}x a lane-tick", flush=True)
    del kern_m, rows_m, wide, wide_rows, mix_results

    lap("phase 6")
    # 17: the environment families, on the same kernel
    del kern, plain, grs, outs, results, tune_results, grs_t, rows_t, \
        kern_t, ker_rows, ref_rows
    torch.cuda.empty_cache()
    envs = phase_environments(dev, ref_runs)
    lap("phase 17")
    if tick_only:
        env_plain_check(dev)
        lap("phase 17b")
        print("chip_smoke: tick-loop phases (1-6, 17) passed")
        return 0
    learned = phase_learn(dev)
    lap("phase 18")
    fleets = phase_fleet(dev)
    lap("phase 20")
    online = phase_online(dev)
    lap("phase 21")
    print(f"[wall] phases 1-21 took {time.perf_counter() - T_START:.1f} s",
          flush=True)

    # 7-9: flash attention, the float32 golden, serving (the tick loop's
    # tensors are freed first, so the serving phases' peaks are their own)
    torch.cuda.empty_cache()
    print(f"[7 flash] {torch.cuda.memory_allocated()} B allocated on the "
          f"card after phases 1-6 and 17", flush=True)
    flash = phase_flash(dev)
    lap("phase 7")
    # The float32 goldens (8, 11, 15, 23c) time nothing: 17b's child
    # process runs beside them, and 23c's weights are drawn in threads
    # meanwhile.
    child = EnvPlainChild()
    dry = DryrunChildren()
    draws = start_family_draws(tuple(FAMILY_GOLDENS) + tuple(ARCH_GOLDENS))
    tree = random_qwen3_params()
    # the float32 (FMA) attention kernels' launches over the float32
    # goldens' entry points (generate, the train step): phases 8, 11, 15
    # and 23c
    fma = [0, 0]

    def count_fma(phase, *args):
        before = fma_launches()
        out = phase(*args)
        for i, (a, b) in enumerate(zip(before, fma_launches())):
            fma[i] += b - a
        return out

    count_fma(phase_lm_golden, dev, tree)
    lap("phase 8")
    p11 = count_fma(phase_train_golden, dev, tree)
    lap("phase 11")
    # 24 (a, c): a world of one rank over NCCL; phase 11 again on its mesh
    world = phase_mesh_world(dev)
    mesh_c_s = phase_mesh_train(dev, tree, world["mesh"], p11, count_fma)
    p11_metrics = p11["metrics"]
    del p11
    lap("phase 24a, c")
    # 24 (d, e): the partitioned step on two ranks of the card, beside the
    # float32 goldens
    tp = MeshTP(dev, tree)
    lap("phase 24e, g's tp 1 steps")
    # phase 22's float32 golden takes phase 15's rwkv6-7b weights where
    # their seed and cut agree (4 of 32 layers, seed 0): drawn once
    rwkv6_drawn = None
    for arch in RECURRENT_GOLDENS:
        drawn = count_fma(phase_recurrent_golden, dev, arch,
                          arch == "rwkv6-7b")
        rwkv6_drawn = drawn or rwkv6_drawn
    check(all(fma), f"the float32 goldens launched the FMA attention kernels "
                    f"{fma[0]} (forward) and {fma[1]} (backward) times")
    lap("phase 15")
    t0 = time.perf_counter()
    for arch in FAMILY_GOLDENS:
        # whisper's and qwen2-vl's weights serve 26d's train goldens too
        count_fma(phase_family_golden, dev, arch,
                  draws[arch] if arch in ARCH_TRAIN_GOLDENS
                  else draws.pop(arch))
    golden_s = time.perf_counter() - t0
    lap("phase 23c")
    arch_golden_s = count_fma(phase_arch_goldens, dev, draws)
    del draws
    lap("phase 26b, d (goldens)")
    child.join()
    lap("phase 17b (joined)")
    mesh_tp = tp.join(p11_metrics)
    lap("phase 24d, e, g (joined)")
    phase_mesh_dryrun(dry.join())
    lap("phase 25a (joined), 24f")
    serve = phase_serve(dev, tree)
    lap("phase 9")
    del tree
    bwd = phase_flash_bwd(dev)
    lap("phase 10")
    trained = phase_train(dev)
    lap("phase 12")
    phase_dots(dev)
    phase_dryrun_card(dev, world["mesh"])
    lap("phase 25b, d")
    wkv = phase_wkv(dev)
    lap("phase 13")
    rglru = phase_rglru(dev)
    lap("phase 14")
    rserve = {arch: phase_recurrent_serve(dev, arch)
              for arch in RECURRENT_SERVE}
    lap("phase 16")
    rtrain = phase_recurrent_train(dev)
    rk = rtrain["kernels"]
    lap("phase 19")
    wtrain = phase_rwkv6_train(dev, rwkv6_drawn)
    del rwkv6_drawn
    lap("phase 22")
    fams = phase_families(dev, world["mesh"])
    family_budget(fams["phase_s"], golden_s)
    a2a = fams["qwen3-moe-30b-a3b"]["a2a"]
    mesh_budget(world["phase_s"], mesh_c_s, a2a["phase_s"])
    fam_launches = sum(fams[a]["launches"] for a in FAMILY_SERVE)
    lap("phase 23 (24b in it)")
    archs = phase_archs(dev)
    arch_budget(archs["phase_s"], arch_golden_s)
    arch_serve = {a: archs["serve"][a]["launches"] for a in ARCH_SERVE}
    arch_fwd = {a: t["launches"]["flash_attention"]
                for a, t in archs["train"].items()}
    arch_bwd = {a: t["launches"]["flash_attention_bwd"]
                for a, t in archs["train"].items()}
    hd64_train = ("qwen2-0.5b", "whisper-small")
    lap(f"phase 26: all phases, on {card}")

    def fam_tp2(kernel, key):
        """24h's launches a step a rank of ``kernel`` and what it ran at
        (``key`` of the heads or channels), by arch, where it ran."""
        return {k: v for a, m in mesh_tp["fam"].items() if m["kernels"][
            kernel] for k, v in ((f"train_{a}", m["kernels"][kernel]),
                                 (f"heads_{a}", m["heads"][key]))}

    print(json.dumps({"kernels": [{
        "name": "tick_loop", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/tick_loop.cu",
        "replaces": "src/repro/core/engine.py:612",
        "launches": main_launches + sum(envs["launches"].values())
        + sum(learned["launches"].values())
        + sum(fleets["launches"].values())
        + sum(online["launches"].values()),
        "launches_by_path": {"fig2": main_launches, **envs["launches"],
                             **learned["launches"], **fleets["launches"],
                             **online["launches"]},
        "environments": ["reference", "lossy-wan", "logfit", "big-little",
                         "dvfs"],
        "controllers": ["ME", "EEMT", "EETT", "ismail-target", "static",
                        "learned"],
        "max_abs_err": max_err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None,
        "note": "ms: fig2's groups in one grouped launch (the main path); "
                "per_group_ms: each group in its own launch; plain_ms: "
                f"the plain version over the first {FIG2_PLAIN_GROUPS} of "
                "the 6 groups",
        "per_group_ms": group_ms, "grids_ms": envs["grids_ms"],
        "grids_per_group_ms": envs["grids_group_ms"],
        "wave_mode": {"ms_per_wave": fleets["wave_ms"],
                      "launch_ms_per_wave": fleets["wave_launch_ms"],
                      "plain_ms_per_wave": fleets["wave_plain_ms"],
                      "bound_ms_per_wave": fleets["wave_bound_ms"],
                      "bound_by": fleets["wave_bound_by"],
                      "note": "the fleet's waves (phase 20b): each wave's "
                              "groups in one launch; ms: device time "
                              "(launches queued behind a spin), median of "
                              "sampled waves; launch_ms: CUDA events around "
                              "each launch call, marshalling included"},
        "wave_mode_online": {
            "ms_per_wave": online["wave_ms"],
            "launch_ms_per_wave": online["wave_launch_ms"],
            "plain_ms_per_wave": online["wave_plain_ms"],
            "bound_ms_per_wave": online["wave_bound_ms"],
            "bound_by": online["wave_bound_by"],
            "note": "the online fleet's waves (phase 21b): every occupied "
                    "slot pool of a wave in one launch, free slots "
                    "included; timed as wave_mode"}}, {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention_sm90.cu",
        "replaces": "src/repro/kernels/flash_attention/flash_attention.py:130",
        "launches": serve["launches"] + trained["fa_launches"]
        + rserve["recurrentgemma-2b"]["launches"]["flash_attention"]
        + rtrain["launches"]["flash_attention"] + fam_launches
        + a2a["launches"] + sum(arch_serve.values())
        + sum(arch_fwd.values()),
        "launches_by_path": {
            "serve_qwen3": serve["launches"], "train_qwen3":
            trained["fa_launches"], "serve_recurrentgemma":
            rserve["recurrentgemma-2b"]["launches"]["flash_attention"],
            "train_recurrentgemma": rtrain["launches"]["flash_attention"],
            "a2a_prefill": a2a["launches"],
            **{f"serve_{a}": n for a, n in arch_serve.items()},
            **{f"train_{a}": n for a, n in arch_fwd.items()}},
        "launches_by_family_generate": {a: fams[a]["launches"]
                                        for a in FAMILY_SERVE},
        "launches_a_step_a_rank_tp2": {
            f"train_{TP_OLMO}": mesh_tp["launches_a_step"][0],
            "heads": mesh_tp["heads"],
            **{k: v for a, m in mesh_tp["moe"].items() for k, v in (
                (f"train_{a}", m["launches_a_step"][0]),
                (f"heads_{a}", m["heads"]))},
            **fam_tp2("2", "fwd")},
        "launches_a2a_prefill": a2a["launches"],
        "max_abs_err": max(flash["bf16"]["max_abs_err"],
                           serve["max_abs_err"],
                           *(v["max_abs_err"] for v in fams["hd64"].values()),
                           *(archs["serve"][a]["max_abs_err"]
                             for a in ARCH_SERVE),
                           *(v["max_abs_err"] for f in archs["fwd"].values()
                             for v in f.values())),
        "ms": flash["bf16"]["ms"], "plain_ms": flash["bf16"]["plain_ms"],
        "bound_ms": flash["bf16"]["bound_ms"],
        "bound_by": flash["bf16"]["bound_by"],
        "library_ms": flash["bf16"]["library_ms"],
        "hd256_train_forward": rk["forward"], "hd64": fams["hd64"],
        **archs["fwd"]}, {
        "name": "flash_attention_f32", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/flash_attention.py:130",
        "launches": fma[0], **flash["f32"]}, {
        "name": "flash_attention_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention_bwd_sm90.cu",
        "replaces":
            "src/repro/kernels/flash_attention/flash_attention_bwd.py:151",
        "launches": trained["bwd_launches"]
        + sum(n for a, n in arch_bwd.items() if a not in hd64_train),
        "launches_by_path": {"train_qwen3": trained["bwd_launches"],
                             **{f"train_{a}": n for a, n in arch_bwd.items()
                                if a not in hd64_train}},
        "launches_a_step_a_rank_tp2": {
            f"train_{TP_OLMO}": mesh_tp["launches_a_step"][1],
            "heads": mesh_tp["heads"],
            **{k: v for a, m in mesh_tp["moe"].items() for k, v in (
                (f"train_{a}", m["launches_a_step"][1]),
                (f"heads_{a}", m["heads"]))},
            **fam_tp2("3", "bwd")},
        **bwd["bf16"]}, {
        "name": "flash_attention_bwd_hd64", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention_bwd_sm90.cu",
        "replaces":
            "src/repro/kernels/flash_attention/flash_attention_bwd.py:151",
        "note": "kernel 3 at head width 64 (held in phase 10, timed in "
                "26d); ms at qwen2-0.5b's "
                "heads (14/2, GQA 7), B 2 x T 4,096 causal, bf16; shapes: "
                "whisper-small's heads (12/12) too",
        "launches": sum(arch_bwd[a] for a in hd64_train),
        "launches_by_path": {f"train_{a}": arch_bwd[a] for a in hd64_train},
        **archs["bwd64"][f"qwen2_B{ARCH_TRAIN_B}_T{ARCH_TRAIN_T}"],
        "max_abs_err": bwd["hd64_max_abs_err"], "shapes": archs["bwd64"]}, {
        "name": "flash_attention_bwd_f32", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        "replaces":
            "src/repro/kernels/flash_attention/flash_attention_bwd.py:151",
        "launches": fma[1], **bwd["f32"]}, {
        "name": "flash_attention_bwd_hd256", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention_bwd_sm90.cu",
        "replaces":
            "src/repro/kernels/flash_attention/flash_attention_bwd.py:151",
        "launches": rtrain["launches"]["flash_attention_bwd"],
        **rk["bfloat16"]}, {
        "name": "flash_attention_bwd_hd256_f32", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        "replaces":
            "src/repro/kernels/flash_attention/flash_attention_bwd.py:151",
        "launches": rtrain["fma"][1], **rk["float32"]}, {
        "name": "wkv", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/wkv.cu",
        "replaces": "src/repro/kernels/rwkv6/rwkv6.py:68",
        "launches": rserve["rwkv6-7b"]["launches"]["wkv"]
        + wtrain["launches"]["wkv"],
        "launches_by_path": {"serve": rserve["rwkv6-7b"]["launches"]["wkv"],
                             "train": wtrain["launches"]["wkv"]},
        "launches_a_step_a_rank_tp2": fam_tp2("4", "wkv"),
        "launches_by_route": rserve["rwkv6-7b"]["wkv_routes"],
        "train_launches_by_route": wtrain["routes"],
        "max_abs_err": wkv["max_abs_err"], "ms": wkv["ms"],
        "device_ms": wkv["device_ms"],
        "plain_ms": wkv["plain_ms"], "bound_ms": wkv["bound_ms"],
        "bound_by": wkv["bound_by"], "library_ms": None,
        "note": "ms at B 8 x T 2,048 by the chunked route (wkv_chunk_kernel, "
                "the prefill's); decode by the step route (wkv_kernel); "
                "shapes: each shape's route and every route timed",
        "shapes": wkv["shapes"]}, {
        "name": "rglru", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/rglru.cu",
        "replaces": "src/repro/kernels/rglru/rglru.py:61",
        "launches": rserve["recurrentgemma-2b"]["launches"]["rglru"]
        + rtrain["launches"]["rglru"],
        "launches_by_path": {
            "serve": rserve["recurrentgemma-2b"]["launches"]["rglru"],
            "train": rtrain["launches"]["rglru"]},
        "launches_a_step_a_rank_tp2": fam_tp2("5", "rglru"),
        "max_abs_err": rglru["max_abs_err"], "ms": rglru["ms"],
        "plain_ms": rglru["plain_ms"], "bound_ms": rglru["bound_ms"],
        "bound_by": rglru["bound_by"], "library_ms": None,
        "device_ms": rglru["device_ms"],
        "note": "ms at B 8 x T 2,048 (the serving prefill); train_shape at "
                "B 2 x T 4,096; device_ms: 20 calls queued behind a spin",
        "train_shape": rglru["train_shape"]}, {
        "name": "rglru_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/rglru.cu",
        "replaces": "src/repro/models/rglru.py:102",
        "note": "the port's own backward of kernel 5: JAX has no Pallas "
                "backward and differentiates this associative scan in XLA; "
                "ms at B 2 x T 4,096 on the TMA ring; paths: the ring and "
                "the direct path",
        "launches": rtrain["launches"]["rglru_bwd"],
        "launches_a_step_a_rank_tp2": fam_tp2("5b", "rglru_bwd"),
        **rk["rglru_bwd"]}, {
        "name": "wkv_bwd_chunk", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/wkv_bwd_chunk.cu",
        "replaces": "src/repro/models/rwkv6.py:186",
        "note": "the port's own backward of kernel 4 (JAX has no Pallas "
                "backward and differentiates this lax.scan in XLA), its "
                "chunked route: a state pass and a chunk pass, one wrapper "
                "launch; ms at B 2 x T 4,096 x H 64, bf16 r/k/v, float32 w "
                "(the trainer's call); max_abs_err over phase 22a's runs "
                "on this route",
        "launches": wtrain["bwd_routes"]["chunk"],
        "launches_by_path": {"train": wtrain["bwd_routes"]["chunk"]},
        "launches_a_step_a_rank_tp2": fam_tp2("4b", "wkv_bwd"),
        **{k: v for k, v in wtrain["kernel"].items()
           if k not in ("step", "variants")}}, {
        "name": "wkv_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/wkv_bwd.cu",
        "replaces": "src/repro/models/rwkv6.py:186",
        "note": "the backward's step route (float32, short or misaligned "
                "inputs); ms at B 2 x T 4,096 x H 64, bf16 r/k/v, float32 "
                "w, forced; max_abs_err over phase 22a's runs on this route",
        "launches": wtrain["golden_bwd_routes"]["step"],
        "launches_by_path": {"train_golden":
                             wtrain["golden_bwd_routes"]["step"]},
        **wtrain["kernel"]["step"]}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def fig2_headline(cells, results) -> dict:
    """The paper's headline comparisons on the mixed dataset
    (benchmarks/fig2.py::headline)."""
    by = {cell: r for (cell, _), r in zip(cells, results)}
    out = {}
    for tb in dict.fromkeys(c[0] for c, _ in cells):
        me, imin = by[(tb, "mixed", "ME")], by[(tb, "mixed",
                                                "ismail-min-energy")]
        eemt, imax = by[(tb, "mixed", "EEMT")], by[(tb, "mixed",
                                                    "ismail-max-tput")]
        out[tb] = {
            "me_energy_reduction_pct":
                100.0 * (1 - me.energy_j / imin.energy_j),
            "eemt_tput_gain_pct":
                100.0 * (eemt.avg_tput_gbps / imax.avg_tput_gbps - 1),
            "eemt_energy_reduction_pct":
                100.0 * (1 - eemt.energy_j / imax.energy_j),
        }
    return out


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Failed as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        sys.exit(1)
