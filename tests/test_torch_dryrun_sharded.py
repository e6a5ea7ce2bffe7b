"""The sharded dry run (``launch.dryrun``'s sharded pass, ``layers.constrain``
on DTensors, ``sharding.to_named`` and ``fake_device_mesh``):

  * the dry run's three steps (loss and gradients with AdamW, prefill,
    one decode step) of six reduced family configs, one layer period each,
    run as DTensors on a (2, 2) mesh of four gloo processes on the CPU and
    equal the plain steps within 1e-5 (loss, gradients, AdamW moments,
    logits and caches, by ``full_tensor()``);
  * on a (4, 1) FSDP-only fake mesh, one reduced dense train step's
    collective bytes equal a count derived by hand from the weights;
  * the probes' extrapolation to 4 periods equals the direct 4-period run:
    collectives and ``cost`` exactly, ``temp_bytes`` within 1 %;
  * ``dryrun.StepCost``'s counting rules on hand-sized ops, with exact
    bytes, and each composite's transcendentals equal to its
    decomposition's; the sharded pass's ``cost["flops"]`` equal to
    ``roofline.count_flops`` of the same step on a (1, 1) mesh, and a
    quarter of it per device on a (4, 1) mesh;
  * ``--hlo-dump`` writes the 1-period probe's op trace, whose bytes
    column sums to that probe's ``bytes_accessed``;
  * ``--fast`` records no ``cost``, with its reason;
  * ``fake_device_mesh`` leaves no process group behind, after an error
    too, and refuses to open over another group;
  * the sharded pass imports no JAX (a fresh process).
"""
import contextlib
import dataclasses
import io
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
dist = pytest.importorskip("torch.distributed")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ShapeCfg  # noqa: E402
from repro_torch.distributed import sharding as SH  # noqa: E402
from repro_torch.launch import dryrun, roofline  # noqa: E402
from repro_torch.launch.hlo_analysis import COLLECTIVE_KINDS  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.models.module import tree_paths  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
RANKS = ROOT / "tests" / "_torch_dtensor_ranks.py"
# two meshes of four ranks at once, the archs split so the two take about
# as long
GROUPS = (["smollm-360m", "grok-1-314b", "mamba2-130m", "recurrentgemma-9b"],
          ["whisper-small", "internvl2-76b"])
ARCHS = [a for g in GROUPS for a in g]
TOL = 1e-5
NO_JAX = """
import sys
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeCfg
from repro_torch.launch import dryrun
rec = dryrun.sharded_fit(get_config("smollm-360m").reduced(),
                         ShapeCfg("t", 16, 4, "prefill"),
                         {"data": 2, "model": 2})
assert rec["temp_bytes"] > 0
print(sum(1 for m in sys.modules if m == "jax" or m.startswith("jax.")))
"""


def _env():
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + [p for p in env.get("PYTHONPATH", "").split(
            os.pathsep) if p])
    return env


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    """Every group's four ranks and the no-JAX process, started together
    and left running while the tests on the fake mesh run here."""
    tmp = tmp_path_factory.mktemp("ranks")
    procs, outs = [], []
    for g, archs in enumerate(GROUPS):
        port, out = _free_port(), tmp / f"group{g}.json"
        outs.append(out)
        for rank in range(4):
            procs.append(subprocess.Popen(
                [sys.executable, str(RANKS), str(rank), "4", str(port),
                 str(out)] + archs, env=_env(), cwd=ROOT,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    no_jax = subprocess.Popen([sys.executable, "-c", NO_JAX], env=_env(),
                              cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
    yield procs, outs, no_jax
    for p in procs + [no_jax]:
        if p.poll() is None:
            p.kill()
            p.communicate()


@pytest.fixture(scope="module")
def ranks(launched):
    """``(per-arch results, the no-JAX process's (rc, stdout, stderr))``."""
    procs, outs, no_jax = launched
    logs = [p.communicate(timeout=600)[0] for p in procs]
    nj_out, nj_err = no_jax.communicate(timeout=600)
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    results = {}
    for out in outs:
        results.update(json.loads(out.read_text()))
    return results, (no_jax.returncode, nj_out, nj_err)


def test_to_placements_follow_the_spec(launched):
    from torch.distributed.tensor import Replicate, Shard

    names = ("pod", "data", "model")
    assert SH.to_placements((("pod", "data"), None, "model"), names) == (
        Shard(0), Shard(0), Shard(2))
    assert SH.to_placements(None, names) == (Replicate(),) * 3
    assert SH.to_placements(("data", None), names) == (
        Replicate(), Shard(0), Replicate())
    with pytest.raises(ValueError, match="named twice"):
        SH.to_placements(("data", "data"), names)
    # a shard over one rank is the whole tensor: replicated
    assert SH.to_placements(("data", "model"), ("data", "model"), (4, 1)) \
        == (Shard(0), Replicate())


def test_fsdp_collective_bytes_equal_a_hand_count():
    """(4, 1): batch over ``data``; every weight with a d_model dim is
    sharded over it (FSDP), the norm scales are replicated, nothing is
    split over ``model`` (size 1: a collective over one rank moves
    nothing, and is not counted). One train step of reduced smollm-360m
    (float32, two layers, tied embeddings, no remat, clipping off) then
    issues:

      * all-gather: each layer's FSDP weights once (``fsdp_gather`` before
        the period) and the embedding table twice (the lookup and the tied
        unembedding), each result the whole weight;
      * reduce-scatter: the gradient of each of those gathers back to its
        shards, a quarter of the weight each;
      * all-reduce: the replicated norm scales' gradients, whole;
      * all-to-all: none.
    """
    cfg = get_config("smollm-360m").reduced()
    mesh = make_host_mesh(4, 1)
    rec = dryrun.sharded_fit(cfg, ShapeCfg("t", 16, 8, "train"), mesh)
    ctx = dryrun.with_mesh_context(cfg, mesh)
    pspec = api.param_spec(ctx, dryrun.vocab_pad_for(ctx, mesh))
    specs = SH.tree_paths_like(SH.params_pspecs_cfg(pspec, mesh, ctx))
    w = rep = 0
    for path, leaf in tree_paths(pspec).items():
        nbytes = leaf.numel() * leaf.element_size()
        if path == "embedding/embed":
            table = nbytes
        elif "data" in specs[path]:
            w += nbytes
        elif all(e is None for e in specs[path]):
            rep += nbytes
    assert cfg.tie_embeddings and not cfg.remat and w and rep
    want = {"all-gather": w + 2 * table,
            "reduce-scatter": (w + 2 * table) // 4,
            "all-reduce": rep,
            "all-to-all": 0, "collective-permute": 0}
    got = rec["collectives"]
    assert got["per_kind"] == want
    assert got["total_bytes"] == sum(want.values())
    assert set(got["per_kind"]) == set(COLLECTIVE_KINDS)


def test_probes_extrapolate_to_a_direct_run():
    """4 periods from the 1- and 2-period probes against the 4-period run
    itself, on a (2, 2) fake mesh: the collectives equal, ``temp_bytes``
    within 1 % (the peak grows by the same bytes per period only as far
    as it sits at the same point of the step), and ``cost`` equal through
    the 3-period probe (a train step's bytes grow as the square of the
    depth)."""
    cfg = dataclasses.replace(get_config("smollm-360m").reduced(),
                              n_layers=4)
    mesh = make_host_mesh(2, 2)
    shape = ShapeCfg("t", 32, 8, "train")
    probed = dryrun.sharded_probes(cfg, shape, mesh)
    direct = dryrun.sharded_fit(cfg, shape, mesh)
    assert probed["probes"] == [1, 2, 3]  # train: the quadratic's third
    assert probed["collectives"] == direct["collectives"]
    assert probed["cost"] == direct["cost"]
    assert all(isinstance(v, int) and v > 0
               for v in direct["cost"].values())
    assert probed["argument_local_bytes"] == direct["argument_local_bytes"]
    assert probed["temp_bytes"] == pytest.approx(direct["temp_bytes"],
                                                 rel=0.01)


def _ops_mm():
    a = torch.ones((4, 8), dtype=torch.bfloat16)
    b = torch.ones((8, 16), dtype=torch.bfloat16)
    return lambda: torch.mm(a, b), dict(
        bytes_accessed=(4 * 8 + 8 * 16 + 4 * 16) * 2, flops=2 * 4 * 8 * 16,
        transcendentals=0)


def _ops_views():
    x = torch.ones((4, 8))

    def run():
        x.view(32)
        x.t()
        torch.ops.aten._unsafe_view(x, [32])
        x.detach()
        torch.empty((64,))
        torch.empty_strided((4, 4), (4, 1))
        x.new_empty((16,))
    return run, dict(bytes_accessed=0, flops=0, transcendentals=0)


def _ops_expand():
    row, full = torch.ones((1, 8)), torch.ones((4, 8))
    # the expanded operand holds its 8 elements; the other 32, the result 32
    return lambda: torch.add(row.expand(4, 8), full), dict(
        bytes_accessed=(8 + 32 + 32) * 4, flops=0, transcendentals=0)


def _ops_add_():
    x, y = torch.ones((4, 8)), torch.ones((4, 8))
    # x read and written, y read
    return lambda: x.add_(y), dict(bytes_accessed=3 * 32 * 4, flops=0,
                                   transcendentals=0)


def _ops_fills():
    x = torch.ones((4, 8))

    def run():
        torch.zeros((4, 8))  # its result, 128 B
        x.zero_()  # written, not read: 128 B
        torch.full((2, 8), 3.0)  # 64 B
    return run, dict(bytes_accessed=128 + 128 + 64, flops=0,
                     transcendentals=0)


def _ops_softmax():
    x = torch.ones((4, 8))
    return lambda: torch.softmax(x, dim=-1), dict(
        bytes_accessed=2 * 32 * 4, flops=0, transcendentals=32)


def _ops_cache_write():
    cache = torch.zeros((2, 64, 4, 16))  # (B, S, H, Dh), 32 KiB
    rows, slot = torch.arange(2), torch.tensor([5, 9])
    tok = torch.ones((2, 4, 16))
    # one token per row: the indices (2 × 2 int64), the token read, the
    # token's place written; not the cache's 32 KiB twice
    return lambda: cache.index_put_((rows, slot), tok), dict(
        bytes_accessed=2 * 2 * 8 + 2 * 512, flops=0, transcendentals=0)


def _ops_gathers():
    cache = torch.zeros((2, 64, 4, 16))
    rows, slot = torch.arange(2), torch.tensor([5, 9])
    table, ids = torch.ones((100, 8)), torch.zeros((3, 5), dtype=torch.long)

    def run():
        cache[rows, slot]  # the (2, 4, 16) taken, read and written
        torch.nn.functional.embedding(ids, table)  # (3, 5, 8)
        torch.index_select(table, 0, ids[0])  # (5, 8)
    return run, dict(bytes_accessed=(32 + 2 * 512) + (120 + 2 * 480)
                     + (40 + 2 * 160), flops=0, transcendentals=0)


def _ops_scatters():
    acc, idx, src = torch.zeros((8, 4)), torch.tensor([1, 3, 1]), \
        torch.ones((3, 4))

    def run():
        acc.index_add_(0, idx, src)  # idx, src, the 3 rows read and written
        acc.index_add(0, idx, src)  # the same after a copy of acc (2 × 128)
    one = 24 + 48 + 2 * 48
    return run, dict(bytes_accessed=one + (2 * 128 + one), flops=0,
                     transcendentals=0)


@pytest.mark.parametrize("case", ["mm", "views", "expand", "add_", "fills",
                                  "softmax", "cache_write", "gathers",
                                  "scatters"])
def test_step_cost_counting_rules(case):
    """Exact bytes, FLOPs and transcendentals of hand-sized ops: a bf16
    (M, K) @ (K, N) moves (MK + KN + MN)·2 B; views, ``_unsafe_view``,
    ``detach`` and allocations move none; an ``expand``ed operand counts
    the elements it holds; an in-place ``add_`` its read and its write; a
    fill its result; a softmax one transcendental per element; a one-token
    ``index_put_`` into a (B, S, H, Dh) cache its indices and the token
    twice; a gather (``index``, ``embedding``, ``index_select``) its
    indices and its result twice; an ``index_add_`` its indices, its source
    and the rows it adds to twice, and an out-of-place one also the copy of
    its first operand."""
    run, want = globals()[f"_ops_{case}"]()
    trace = []
    with dryrun.StepCost(trace) as counter:
        run()
    assert counter.cost() == want
    assert sum(row[3] for row in trace) == want["bytes_accessed"]
    assert counter.record()["total_bytes"] == 0


def _whole_or_decomposed_cases():
    """``(aten op, args, kwargs, transcendentals)`` at (4, 8) operands for
    each op of ``dryrun._TRANSCENDENTALS`` that ``torch._decomp``
    decomposes: per element, and a log per row (4) where the op takes
    one."""
    aten = torch.ops.aten
    gen = torch.Generator().manual_seed(0)
    x, y, g = (torch.randn((4, 8), generator=gen) for _ in range(3))
    p = torch.rand((4, 8), generator=gen) + 0.1
    rows = [-1]
    return {
        "softmax": (aten._softmax.default, (x, -1, False), {}, 32),
        "log_softmax": (aten._log_softmax.default, (x, -1, False), {}, 36),
        "log_softmax_backward": (
            aten._log_softmax_backward_data.default,
            (g, torch.log_softmax(x, -1), -1, torch.float32), {}, 32),
        "logsumexp": (aten.logsumexp.default, (x, rows), {}, 36),
        "logaddexp": (aten.logaddexp.default, (x, y), {}, 64),
        "softplus": (aten.softplus.default, (x, 1.0, 20.0), {}, 64),
        "softplus_backward": (aten.softplus_backward.default,
                              (g, x, 1.0, 20.0), {}, 32),
        "gelu": (aten.gelu.default, (x,), {}, 32),
        "gelu_tanh": (aten.gelu.default, (x,), {"approximate": "tanh"}, 32),
        "gelu_backward": (aten.gelu_backward.default, (g, x), {}, 64),
        "gelu_backward_tanh": (aten.gelu_backward.default, (g, x),
                               {"approximate": "tanh"}, 32),
        "silu": (aten.silu.default, (x,), {}, 32),
        "silu_backward": (aten.silu_backward.default, (g, x), {}, 32),
        "sigmoid": (aten.sigmoid.default, (x,), {}, 32),
        "rsqrt": (aten.rsqrt.default, (p,), {}, 32),
    }


@pytest.mark.parametrize("case", list(_whole_or_decomposed_cases()))
def test_transcendentals_count_the_same_whole_or_decomposed(case):
    """A composite op counts the transcendentals its decomposition
    (``torch._decomp``'s, what a torch version or DTensor may dispatch in
    its place) computes: whole or as its parts, one count, so each computed
    transcendental counts once whatever the dispatch path."""
    from torch._decomp import decomposition_table

    op, args, kwargs, want = _whole_or_decomposed_cases()[case]
    counts = []
    for fn in (op, decomposition_table[op]):
        with dryrun.StepCost() as counter:
            fn(*args, **kwargs)
        counts.append(counter.cost()["transcendentals"])
    assert counts == [want, want], (case, counts)


KINDS = {"train": ShapeCfg("t", 16, 8, "train"),
         "prefill": ShapeCfg("p", 16, 4, "prefill"),
         "decode": ShapeCfg("d", 16, 4, "decode")}


@pytest.mark.parametrize("kind", list(KINDS))
def test_sharded_flops_equal_count_flops(kind):
    """Reduced smollm-360m: on a (1, 1) mesh the sharded pass's ``flops``
    equal ``roofline.count_flops`` of the same step; on a (4, 1) mesh
    (data parallel) each device's are a quarter of the whole batch's."""
    cfg, shape = get_config("smollm-360m").reduced(), KINDS[kind]
    for (d, m) in ((1, 1), (4, 1)):
        mesh = make_host_mesh(d, m)
        ctx = dryrun.with_mesh_context(cfg, mesh)
        want = roofline.count_flops(ctx, shape, dryrun.vocab_pad_for(ctx,
                                                                     mesh))
        got = dryrun.sharded_fit(cfg, shape, mesh)["cost"]
        assert got["flops"] * d == want > 0, (d, m)
        assert got["bytes_accessed"] > 0 and got["transcendentals"] > 0


def test_hlo_dump_writes_the_op_trace(tmp_path, monkeypatch):
    """``--hlo-dump`` on a 4-layer reduced config over the single-pod mesh:
    ``<arch>__<shape>__<mesh>.ops.txt`` beside the record, a header naming
    the cell and the probe depth, one line per op, its bytes column
    summing to the 1-period probe's ``bytes_accessed``; a collective line
    carries its kind and group size."""
    cfg = dataclasses.replace(get_config("smollm-360m").reduced(),
                              n_layers=4)
    shape = ShapeCfg("t", seq_len=32, global_batch=32, kind="train")
    monkeypatch.setattr(dryrun, "get_config", lambda arch: cfg)
    monkeypatch.setattr(dryrun, "SHAPES", {"t": shape})
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = dryrun.main(["--arch", "smollm-360m", "--shape", "t",
                          "--single-pod", "--hlo-dump", "--verbose",
                          "--out", str(tmp_path)])
    assert rc == 0, out.getvalue()
    assert "'bytes accessed'" in out.getvalue()
    rec = json.loads((tmp_path / "smollm-360m__t__pod_16x16.json")
                     .read_text())
    lines = (tmp_path / "smollm-360m__t__pod_16x16.ops.txt").read_text() \
        .splitlines()
    header = dict(ln[2:].split(": ", 1) for ln in lines
                  if ln.startswith("# ") and ": " in ln)
    assert header["arch"] == "smollm-360m" and header["shape"] == "t"
    assert header["mesh"] == "pod_16x16" and header["probe depth"] == "1"
    assert header["torch"] == torch.__version__
    rows = [ln.split("\t") for ln in lines if not ln.startswith("#")]
    assert all(len(r) == len(dryrun.TRACE_COLUMNS) for r in rows)
    col = dryrun.TRACE_COLUMNS.index
    probe = dryrun.sharded_fit(dataclasses.replace(cfg, n_layers=1), shape,
                               make_host_mesh(16, 16))["cost"]
    assert sum(int(r[col("bytes")]) for r in rows) == \
        probe["bytes_accessed"] == int(header["bytes_accessed"])
    assert sum(int(r[col("flops")]) for r in rows) == probe["flops"]
    assert sum(int(r[col("transcendentals")]) for r in rows) == \
        probe["transcendentals"]
    kinds = {r[col("collective")] for r in rows} - {"-"}
    assert kinds and all(k.split("/")[0] in COLLECTIVE_KINDS
                         and int(k.split("/")[1]) > 1 for k in kinds)
    assert rec["cost"]["bytes_accessed"] > probe["bytes_accessed"]
    assert rec["sharded"]["probes"] == [1, 2, 3]


def test_fast_pass_records_no_cost(tmp_path):
    """``--fast`` records ``cost: null`` with its reason, as it does
    ``temp_bytes``; ``--hlo-dump`` (the sharded pass's trace) refuses it."""
    with contextlib.redirect_stdout(io.StringIO()):
        rc = dryrun.main(["--arch", "smollm-360m", "--shape", "decode_32k",
                          "--single-pod", "--fast", "--out", str(tmp_path)])
    assert rc == 0
    rec = json.loads((tmp_path / "smollm-360m__decode_32k__pod_16x16.json")
                     .read_text())
    assert rec["status"] == "ok" and rec["cost"] is None
    assert rec["cost_reason"] == rec["memory"]["temp_reason"] == \
        dryrun.FAST_REASON
    with pytest.raises(SystemExit), \
            contextlib.redirect_stderr(io.StringIO()):
        dryrun.main(["--arch", "smollm-360m", "--fast", "--hlo-dump"])
    assert not list(tmp_path.glob("*.ops.txt"))


def test_fake_device_mesh_leaves_no_group_behind():
    assert not dist.is_initialized()
    with SH.fake_device_mesh({"data": 16, "model": 16}) as dm:
        assert dist.is_initialized() and dist.get_world_size() == 256
        assert tuple(dm.mesh_dim_names) == ("data", "model")
        assert SH.axis_sizes(dm) == {"data": 16, "model": 16}
        with pytest.raises(RuntimeError, match="already initialized"):
            with SH.fake_device_mesh({"data": 2}):
                pass
        assert dist.is_initialized()
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="boom"):
        with SH.fake_device_mesh({"pod": 2, "data": 16, "model": 16}):
            raise ValueError("boom")
    assert not dist.is_initialized()


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ARCHS)
def test_dtensor_steps_equal_the_plain_steps(ranks, arch, kind):
    rec = ranks[0][arch][kind]
    for name, got in rec.items():
        if name == "params_finite":
            assert got, (arch, kind)
            continue
        diff, scale = got
        assert scale > 0 and diff <= TOL, (arch, kind, name, diff, scale)


def test_the_sharded_pass_imports_no_jax(ranks):
    rc, out, err = ranks[1]
    assert rc == 0, err[-3000:]
    assert out.split()[-1] == "0"
