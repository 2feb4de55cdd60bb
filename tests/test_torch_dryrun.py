"""The port's dry run (``repro_torch.launch.{hlo_stats,input_specs,
dryrun}``) on the CPU: JAX's three dry-run tests ported (the collective
counter, the roofline terms, the six smoke cells built on a 2 x 2 mesh),
the depth probes against the full-depth count, the ``meta`` count against
a real CPU run of the same step, a fake world's collectives against a gloo
world's, and ``input_specs`` against JAX's golden
(tests/torch_goldens/dryrun_specs.json, remade by
``make_dryrun_golden.py``).  Worlds of 4 and 256 ranks are fake process
groups in this process (``dryrun.fake_world``), each ended after its test;
the gloo world is four subprocesses (tests/torch_dist.py).

The smoke configs run at head width 64 (``torch_dist.dryrun_config``):
the dry run counts what the card launches, and the attention kernels take
hd 64, 128 and 256.  Counts are integers: every comparison is exact.
"""
import json
import math
import os
import subprocess
import sys

import pytest
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

import torch_dist as D
from repro_torch import configs
from repro_torch.distributed.sharding import P
from repro_torch.launch import dryrun, hlo_stats
from repro_torch.launch.input_specs import NamedSharding, input_specs
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "torch_goldens", "dryrun_specs.json")

#: JAX's test_cell_lowers_on_small_mesh cells.
SMOKE_CELLS = [("qwen2-0.5b", "train_4k"), ("qwen3-moe-30b-a3b", "train_4k"),
               ("rwkv6-7b", "decode_32k"), ("recurrentgemma-2b", "long_500k"),
               ("whisper-small", "decode_32k"),
               ("qwen2-vl-2b", "prefill_32k")]

#: One cell of each family for the probes, and for the meta-vs-CPU and
#: fake-vs-gloo counts (small shapes, tests/torch_dist.py).
PROBE_CELLS = [("qwen3-0.6b", "train_4k"), ("qwen3-moe-30b-a3b", "train_4k"),
               ("rwkv6-7b", "train_4k"), ("recurrentgemma-2b", "train_4k"),
               ("whisper-small", "train_4k"),
               ("qwen2-vl-2b", "prefill_32k")]
CPU_CELLS = [("qwen3-0.6b", "train_tiny"), ("qwen3-0.6b", "prefill_tiny"),
             ("qwen3-moe-30b-a3b", "train_tiny"),
             ("rwkv6-7b", "train_tiny"), ("rwkv6-7b", "decode_tiny"),
             ("recurrentgemma-2b", "train_tiny"),
             ("whisper-small", "train_tiny"),
             ("whisper-small", "decode_tiny"),
             ("qwen2-vl-2b", "prefill_vlm")]


@pytest.fixture(autouse=True)
def no_world_left():
    """Every test leaves no process group running."""
    assert not dist.is_initialized()
    yield
    assert not dist.is_initialized()


@pytest.fixture(scope="module", autouse=True)
def gloo_counts(tmp_path_factory):
    """The gloo world of four counting CPU_CELLS on CPU tensors, started
    before the module's first test so that it runs while the others do;
    joined by the test that reads it (tests/torch_dist.py kills it and
    fails after 120 s)."""
    return D.start_world("dryrun", 4, tmp_path_factory.mktemp("dryrun"),
                         cells=CPU_CELLS)


def test_collective_parser():
    """JAX's test_collective_parser, as c10d ops on a fake world of four:
    an all-reduce of f32[128, 256] counts twice, an all-gather its bf16[64]
    result, an all-to-all its 64 int8 bytes."""
    def step():
        dist.all_reduce(torch.empty(128, 256, device="meta"))
        dist.all_gather_into_tensor(
            torch.empty(64, dtype=torch.bfloat16, device="meta"),
            torch.empty(16, dtype=torch.bfloat16, device="meta"))
        x = torch.empty(64, dtype=torch.int8, device="meta")
        dist.all_to_all_single(torch.empty_like(x), x)
        torch.empty(4, device="meta") + 1          # not a collective

    with dryrun.fake_world(4):
        out = hlo_stats.collective_bytes(step)
    assert out["bytes"]["all-reduce"] == 128 * 256 * 4 * 2
    assert out["bytes"]["all-gather"] == 64 * 2
    assert out["bytes"]["all-to-all"] == 64
    assert out["bytes"]["total"] == 128 * 256 * 8 + 128 + 64
    assert out["counts"] == {"all-reduce": 1, "all-gather": 1,
                             "all-to-all": 1}


def test_roofline_terms_bottleneck():
    t = hlo_stats.roofline_terms(hlo_stats.BF16_TENSOR_OPS_PER_S, 0.0, 0.0,
                                 chips=1)        # 1 s of pure compute
    assert t["bottleneck"] == "compute"
    assert abs(t["compute_s"] - 1.0) < 1e-9
    t = hlo_stats.roofline_terms(0.0, hlo_stats.HBM_BYTES_PER_S, 0.0, 1)
    assert t["bottleneck"] == "memory" and abs(t["memory_s"] - 1) < 1e-9
    t = hlo_stats.roofline_terms(0.0, 0.0, hlo_stats.NVLINK_BYTES_PER_S, 1)
    assert t["bottleneck"] == "collective"
    assert abs(t["collective_s"] - 1.0) < 1e-9


def test_step_counter_counts_products_bytes_and_memory():
    """A product by FlopCounterMode's formula, an add's bytes (inputs read,
    output written), views free, the live peak; a kernel wrapper's formula
    stands for the plain version's ops on the CPU."""
    from repro_torch.kernels import cost
    from repro_torch.kernels.flash_attention import flash_attention_bhtd

    a = torch.empty(64, 32, dtype=torch.bfloat16, device="meta")
    b = torch.empty(32, 48, dtype=torch.bfloat16, device="meta")
    with hlo_stats.StepCounter() as c:
        y = a @ b                                  # 2 * 64 * 32 * 48
        z = y.view(-1) + y.view(-1)
        del y
        _ = z[:10]
    assert c.flops == 2 * 64 * 32 * 48
    assert c.bytes == (64 * 32 + 32 * 48 + 64 * 48) * 2 + 3 * 64 * 48 * 2
    assert c.peak_bytes == 2 * 64 * 48 * 2 and c.live_bytes == 64 * 48 * 2

    q = torch.randn(1, 2, 128, 64)
    kv = torch.randn(1, 1, 128, 64)
    want = cost.flash_fwd(1, 2, 1, 64, 128, 128, True, 4)
    with hlo_stats.StepCounter() as c:
        flash_attention_bhtd(q, kv, kv, causal=True)
    assert (c.flops, c.bytes) == want
    assert c.kernels == {"flash_attention_bhtd": {
        "calls": 1, "flops": want[0], "bytes": want[1]}}
    qm, kvm = q.to("meta"), kv.to("meta")
    with hlo_stats.StepCounter() as m:
        flash_attention_bhtd(qm, kvm, kvm)
    assert (m.flops, m.bytes) == want and m.kernels == c.kernels


@pytest.mark.parametrize("arch,shape", SMOKE_CELLS)
def test_cell_builds_on_small_mesh(arch, shape):
    """JAX's test_cell_lowers_on_small_mesh: each smoke cell builds with
    microbatches=2 on a 2 x 2 mesh, and its step runs on meta with every
    count finite and positive."""
    with dryrun.fake_world(4):
        mesh = make_host_mesh(model=2, device="cpu")
        cfg = D.dryrun_config(arch)
        fn, args = dryrun.build_cell(cfg, shape, mesh, microbatches=2)
        assert callable(fn) and dryrun.local_bytes(args) > 0
        r = dryrun.count_cell(cfg, shape, mesh, None, microbatches=2)
    mem = r["memory"]
    assert mem["peak_per_device"] == mem["argument_bytes"] + mem["temp_bytes"]
    for v in (r["flops"], r["bytes"], r["coll"], *mem.values()):
        assert math.isfinite(v) and v > 0


@pytest.mark.parametrize("arch,shape", PROBE_CELLS)
def test_probes_extrapolate_to_the_full_depth(arch, shape):
    """The depth probes (2 and 3 layers of each type) extrapolate to the
    full-depth count exactly: FLOPs, bytes and collective bytes (one
    microbatch, the probes' own; a 1 x 2 mesh, so no moment's placement
    depends on the depth)."""
    import dataclasses

    cfg = D.dryrun_config(arch)
    if cfg.family == "hybrid":
        cfg = dataclasses.replace(cfg, num_layers=8)   # 6 RG-LRU, 2 local
    elif cfg.family == "audio":
        cfg = dataclasses.replace(cfg, num_layers=4, num_encoder_layers=5)
    else:
        cfg = dataclasses.replace(cfg, num_layers=5)
    with dryrun.fake_world(2):
        mesh = make_host_mesh(model=2, device="cpu")
        total, detail = dryrun.probe_extrapolate(cfg, shape, mesh, None)
        full = dryrun.count_cell(cfg, shape, mesh, None, microbatches=1)
    for k in ("flops", "bytes", "coll"):
        assert total[k] == full[k], (k, total[k], full[k])
    assert full["coll"] > 0
    names = [n for n, *_ in dryrun._probe_cfgs(cfg)]
    assert set(detail) == set(names) | {"out"}


def test_dp_only_cuts_the_batch_over_every_axis():
    """``dp_only`` (JAX's pure data parallelism): the batch splits over
    ('data', 'model'), the parameters are replicated, so each rank of a
    2 x 2 mesh runs half the rows of the default step, whose model axis
    partitions every product of its data rank's rows instead: the same
    FLOPs, the default step's reductions (reduce-scatters over T under
    sequence parallelism, and all-reduces) carrying the row products'
    partial sums."""
    cfg = D.dryrun_config("qwen3-0.6b")
    with dryrun.fake_world(4):
        mesh = make_host_mesh(model=2, device="cpu")
        _, shards, _ = input_specs(cfg, "train_4k", mesh, dp_only=True)
        assert shards["tokens"].spec == P(("data", "model"), None)
        base, dp = (dryrun.count_cell(cfg, "train_4k", mesh, None,
                                      microbatches=2, dp_only=flag)
                    for flag in (False, True))
    assert dp["flops"] == base["flops"]
    red = [sum(c["coll_detail"]["bytes"].get(k, 0)
               for k in ("all-reduce", "reduce-scatter")) for c in (base, dp)]
    assert red[0] > 100 * red[1]


def test_meta_count_equals_a_cpu_run(gloo_counts):
    """The dry run's step counted on meta equals the same step run on CPU
    tensors (the kernels' plain versions inside their wrappers), FLOPs,
    bytes and collectives exactly; and a fake world of four counts the
    collectives a gloo world of four runs.  The dense and MoE train cells
    take the partitioned step: at model 2 the dense one counts half the
    FLOPs of a rank of a mesh of the same two data ranks at model 1 (no
    product repeated over the model axis), the MoE's (moe_dense) half
    but the routing's, which every rank runs alike, with the model axis's
    all-reduces beside the data axes' mean."""
    tp_cells = [("qwen3-0.6b", "train_tiny"), ("qwen3-moe-30b-a3b",
                                               "train_tiny")]
    with dryrun.fake_world(4):
        mesh = make_host_mesh(model=2, device="cpu")
        meta = D.count_dryrun_cells(CPU_CELLS, mesh, "meta")
        cpu = D.count_dryrun_cells(CPU_CELLS, mesh, "cpu")
        model1 = D.count_dryrun_cells(tp_cells, DeviceMesh(
            "cpu", torch.arange(2).reshape(2, 1),
            mesh_dim_names=("data", "model")), "meta")
    for cell in tp_cells:
        tp = meta[cell]
        n = [c["coll_detail"]["counts"]["all-reduce"]
             for c in (tp, model1[cell])]
        assert n[0] > n[1], cell
    dense, moe = (meta[c]["flops"] * 2 - model1[c]["flops"]
                  for c in tp_cells)
    assert dense == 0
    cfg = D.dryrun_config("qwen3-moe-30b-a3b")
    rows = D.DRYRUN_SHAPES["train_tiny"]
    tokens = rows["global_batch"] // 2 * rows["seq_len"]   # a data rank's
    # what every rank computes alike, a layer: the router's product [N, D]
    # x [D, E] (forward, its two backward products, the remat's forward
    # again) and the combine weights' [N, k] x [N, k, E] (forward, the
    # weights' backward product, the remat's forward)
    E = cfg.moe.num_experts
    router = 2 * tokens * cfg.d_model * E
    comb = 2 * tokens * cfg.moe.top_k * E
    assert moe == (4 * router + 3 * comb) * cfg.num_layers
    ranks = D.join(gloo_counts)
    for cell in CPU_CELLS:
        m, c = meta[cell], cpu[cell]
        for k in ("flops", "bytes", "coll_detail"):
            assert m[k] == c[k], (cell, k, m[k], c[k])
        # gloo's reduce-scatter on CPU tensors copies its result into the
        # output when the caller waits, in the caller's thread, where the
        # counter sees a copy (read and written): 2 x the result's bytes
        # more than the program moves (a fake world, or NCCL, write the
        # output in the collective itself)
        rs = m["coll_detail"]["bytes"].get("reduce-scatter", 0)
        for r in ranks:
            g = r[f"{cell[0]}/{cell[1]}"]
            assert g["coll_detail"] == m["coll_detail"], cell
            assert (g["flops"], g["bytes"]) == (m["flops"],
                                                m["bytes"] + 2 * rs)


def _flat(tree, shards, path=""):
    """[(path, leaf, sharding)] of an inputs tree, dict keys sorted (the
    golden's order), leaves without a sharding (``per_row``) left out."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(
            tree[k], shards[k], f"{path}/{k}" if path else k)]
    if isinstance(tree, (tuple, list)):
        return [x for i, v in enumerate(tree) for x in _flat(
            v, shards[i], f"{path}/{i}")]
    return [] if shards is None else [(path, tree, shards)]


def _spec_json(spec):
    return [list(a) if isinstance(a, tuple) else a for a in tuple(spec)]


def test_input_specs_equal_jax_golden():
    """Every arch, cell and mesh of the golden: each input's shape, dtype
    and spec are JAX's, leaf for leaf (a cache's ``idx``, a host int in the
    port, its spec), and the placements are the spec's."""
    with open(GOLDEN) as f:
        gold = json.load(f)["cells"]
    assert len(gold) == 2 * sum(len(configs.cells(a))
                                for a in configs.ARCHS)
    for mname, n in (("2x2", 4), ("16x16", 256)):
        with dryrun.fake_world(n):
            mesh = (make_host_mesh(model=2, device="cpu") if n == 4 else
                    make_production_mesh(device="cpu"))
            for g in (g for g in gold if g["mesh"] == mname):
                inputs, shards, kind = input_specs(g["arch"], g["shape"],
                                                   mesh)
                assert kind == g["kind"]
                got = {p: (x, s) for p, x, s in _flat(inputs, shards)}
                assert sorted(got) == sorted(g["leaves"]), (g["arch"],
                                                            g["shape"])
                for p, want in g["leaves"].items():
                    x, s = got[p]
                    assert isinstance(s, NamedSharding)
                    assert _spec_json(s.spec) == want["spec"], (p, s.spec)
                    if isinstance(x, torch.Tensor):
                        assert x.device.type == "meta"
                        assert list(x.shape) == want["shape"], p
                        assert str(x.dtype).split(".")[1] == want["dtype"]
                    else:       # the port's host write offset
                        assert isinstance(x, int) and want["dtype"] == \
                            "int32", p


def test_placements_of_a_multi_axis_dim():
    """("pod", "data") on one dim is Shard of it on both mesh dims, the
    pod the major (JAX's order); out of the mesh's order it raises."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.distributed.sharding import shardings

    with dryrun.fake_world(512):
        mesh = make_production_mesh(multi_pod=True, device="cpu")
        assert shardings(mesh, P(("pod", "data"), None)) == (
            Shard(0), Shard(0), Replicate())
        with pytest.raises(NotImplementedError, match="order"):
            shardings(mesh, P(("data", "pod"), None))


def test_fake_world_refuses_a_world_of_another_size():
    with dryrun.fake_world(4):
        with pytest.raises(RuntimeError, match="a world of 4 is running"):
            with dryrun.fake_world(256):
                pass
        with dryrun.fake_world(4) as started:     # the running one, as is
            assert started is False
    assert not dist.is_initialized()


def test_cli_counts_a_production_cell(tmp_path):
    """``python -m repro_torch.launch.dryrun`` on one production cell (no
    probes) in a fresh process that imports neither JAX nor the JAX
    package: its JSON has JAX's fields, finite numbers and 2 N D model
    FLOPs."""
    code = ("import sys, runpy; sys.argv = ['dryrun', '--arch', "
            "'qwen2-0.5b', '--shape', 'decode_32k', '--skip-probes', "
            f"'--out', {str(tmp_path)!r}]; "
            "runpy.run_module('repro_torch.launch.dryrun', "
            "run_name='__main__'); "
            "bad = [m for m in sys.modules if m == 'jax' or m == 'repro' "
            "or m.startswith(('jax.', 'repro.'))]; "
            "assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=os.path.join(os.path.dirname(HERE),
                                                   "src"))
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   capture_output=True, timeout=120)
    with open(tmp_path / "qwen2-0.5b_decode_32k_16x16.json") as f:
        res = json.load(f)
    cfg = configs.get_config("qwen2-0.5b")
    assert res["chips"] == 256 and res["kind"] == "decode"
    assert res["model_flops"] == 2 * cfg.active_param_count() * 128
    assert set(res["memory"]) == {"argument_bytes", "output_bytes",
                                  "temp_bytes", "peak_per_device"}
    for k in ("flops_per_device", "hbm_bytes_per_device",
              "coll_bytes_per_device", "useful_flops_ratio"):
        assert math.isfinite(res[k]) and res[k] > 0
    assert res["roofline"]["bottleneck"] in ("compute", "memory",
                                             "collective")
