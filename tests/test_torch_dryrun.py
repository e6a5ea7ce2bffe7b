"""The port's dry-run and roofline tooling against ``repro``'s.

  * ``roofline.model_flops`` equals ``repro``'s exactly for every (arch ×
    shape), at full width (both are arithmetic over the param specs);
  * on a (1, 1) host mesh at reduced configs, the dry run's per-device
    argument and output bytes equal ``repro``'s
    ``build_lowering(...).compile().memory_analysis()`` for train, prefill
    and decode;
  * on the same cells the sharded pass's ``bytes_accessed`` is at least
    the argument + output bytes, and its transcendentals, and a prefill's
    or decode's bytes, lie within bands of XLA's cost analysis of
    ``repro``'s unrolled step;
  * ``hlo_analysis`` (a copy) equals ``repro``'s on the same HLO strings:
    a compiled scan, and hand-written HLO with a while loop of known trip
    count and collectives;
  * both CLIs write their records where ``--out`` says.
"""
import contextlib
import dataclasses
import importlib
import io
import json
import os

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import SHAPES as JSHAPES  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.launch import hlo_analysis as JHLO  # noqa: E402
from repro.launch.mesh import make_host_mesh as jax_host_mesh  # noqa: E402
from repro_torch.configs import SHAPES, get_config  # noqa: E402
from repro_torch.configs.base import ShapeCfg  # noqa: E402
from repro_torch.launch import dryrun, hlo_analysis, roofline  # noqa: E402
from repro_torch.launch.mesh import HW, make_host_mesh  # noqa: E402


def repro_launch(name):
    """``repro.launch.<name>``, imported with ``XLA_FLAGS`` kept as it was:
    ``repro``'s dry-run and roofline modules set a 512-host-device flag on
    import, which would reach every later jax start in this process."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        return importlib.import_module(f"repro.launch.{name}")
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved


@pytest.mark.parametrize("arch", dryrun.ARCHS)
def test_model_flops_equal_repros(arch):
    jroof = repro_launch("roofline")
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    for name, shape in SHAPES.items():
        got = roofline.model_flops(cfg, shape)
        assert got == jroof.model_flops(jcfg, JSHAPES[name]), (arch, name)
        assert all(isinstance(x, float) for x in got)


KINDS = {"train": ShapeCfg("tiny_train", seq_len=16, global_batch=4,
                           kind="train"),
         "prefill": ShapeCfg("tiny_prefill", seq_len=16, global_batch=2,
                             kind="prefill"),
         "decode": ShapeCfg("tiny_decode", seq_len=16, global_batch=2,
                            kind="decode")}


@pytest.mark.parametrize("arch", ["smollm-360m", "grok-1-314b",
                                  "mamba2-130m", "recurrentgemma-9b",
                                  "whisper-small", "internvl2-76b"])
def test_memory_fit_equals_xla_memory_analysis_on_a_host_mesh(arch):
    build_lowering = repro_launch("dryrun").build_lowering
    jmesh = jax_host_mesh(1, 1)
    cfg, jcfg = get_config(arch).reduced(), jax_get_config(arch).reduced()
    for kind, shape in KINDS.items():
        mem = build_lowering(jcfg, shape, jmesh).compile().memory_analysis()
        got = dryrun.memory_fit(cfg, shape, make_host_mesh(1, 1))
        assert got["argument_bytes"] == mem.argument_size_in_bytes, kind
        assert got["output_bytes"] == mem.output_size_in_bytes, kind
        assert got["temp_bytes"] is None and got["temp_reason"]
        assert got["fits_h100_80gb"]


#: the ranges the port's count keeps to, as a multiple of XLA's count of
#: ``repro``'s unrolled step (its roofline's probes: no ``while`` body
#: counted once), by kind: measured on the cells below at 0.47-0.94
#: (decode bytes: XLA slices each layer's cache out of the stacked one
#: and concatenates the written ones back, copies that the port, writing
#: the token in place, does not make), 0.82-1.26 (prefill bytes),
#: 0.90-1.00 (forward
#: transcendentals: exact but for the RG-LRU gate's and SSD's forms) and
#: 1.10-1.27 (train transcendentals: ``silu_backward`` recomputes the
#: logistic that XLA keeps from the forward)
XLA_BANDS = {"bytes_accessed": {"prefill": (0.75, 1.35),
                                "decode": (0.45, 0.97)},
             "transcendentals": {"train": (1.0, 1.35),
                                 "prefill": (0.85, 1.0),
                                 "decode": (0.85, 1.0)}}
COST_KINDS = dict(KINDS, decode_512=ShapeCfg("decode_512", seq_len=512,
                                             global_batch=2, kind="decode"))


@pytest.mark.parametrize("arch", ["smollm-360m", "grok-1-314b",
                                  "mamba2-130m", "recurrentgemma-9b",
                                  "whisper-small", "internvl2-76b"])
def test_bytes_accessed_cover_the_arguments_and_outputs(arch):
    """On a (1, 1) host mesh at reduced configs, the sharded pass's
    per-device ``bytes_accessed`` is at least the step's argument + output
    bytes, for train, prefill and decode (a 16- and a 512-token cache).
    Against XLA's cost analysis of ``repro``'s same step, unrolled as
    ``repro``'s roofline probes compile it: the transcendentals, and the
    bytes of a prefill or decode, within ``XLA_BANDS``; every ratio is
    printed. Train bytes are not held: XLA fuses the backward's
    elementwise chains, which the port runs op by op."""
    from repro.launch.mesh import cost_analysis_dict
    build_lowering = repro_launch("dryrun").build_lowering
    probe_cfg = repro_launch("roofline")._probe_cfg
    jmesh, mesh = jax_host_mesh(1, 1), make_host_mesh(1, 1)
    cfg, jcfg = get_config(arch).reduced(), jax_get_config(arch).reduced()
    for name, shape in COST_KINDS.items():
        fit = dryrun.memory_fit(cfg, shape, mesh)
        cost = dryrun.sharded_fit(cfg, shape, mesh)["cost"]
        xla = cost_analysis_dict(build_lowering(
            probe_cfg(jcfg, jcfg.n_layers, shape), shape, jmesh).compile())
        ratio = {"bytes_accessed": cost["bytes_accessed"]
                 / xla["bytes accessed"],
                 "transcendentals": cost["transcendentals"]
                 / xla["transcendentals"],
                 "flops": cost["flops"] / xla["flops"]}
        floor = fit["argument_bytes"] + fit["output_bytes"]
        print(f"{arch} {name}: {cost}; over XLA's: " + ", ".join(
            f"{k} {v:.3f}" for k, v in ratio.items())
            + f"; argument + output {floor}")
        assert isinstance(cost["bytes_accessed"], int), name
        assert cost["bytes_accessed"] >= floor > 0, name
        assert cost["flops"] > 0 and cost["transcendentals"] > 0, name
        for key, bands in XLA_BANDS.items():
            if shape.kind in bands:
                lo, hi = bands[shape.kind]
                assert lo <= ratio[key] <= hi, (name, key, ratio[key])


def _scan_hlo():
    def f(x, ws):
        def body(c, w):
            return jnp.tanh(c @ w), None
        y, _ = jax.lax.scan(body, x, ws)
        return y.sum()

    with jax_host_mesh(1, 1):
        return jax.jit(f).lower(
            jax.ShapeDtypeStruct((4, 8), jnp.float32),
            jax.ShapeDtypeStruct((5, 8, 8), jnp.float32)).compile().as_text()


HAND_HLO = """HloModule loop_with_collectives

%body.1 (p: (s32[], f32[16,32])) -> (s32[], f32[16,32]) {
  %p = (s32[], f32[16,32]) parameter(0)
  %i = s32[] get-tuple-element(%p), index=0
  %x = f32[16,32] get-tuple-element(%p), index=1
  %ag = f32[16,32] all-gather(f32[16,32] %x), dimensions={0}
  %ar = bf16[8,4] all-reduce(bf16[8,4] %y), to_apply=%sum
  %one = s32[] constant(1)
  %n = s32[] add(%i, %one)
  ROOT %t = (s32[], f32[16,32]) tuple(%n, %ag)
}

%cond.1 (p: (s32[], f32[16,32])) -> pred[] {
  %p = (s32[], f32[16,32]) parameter(0)
  %i = s32[] get-tuple-element(%p), index=0
  %lim = s32[] constant(12)
  ROOT %lt = pred[] compare(%i, %lim), direction=LT
}

%inner.2 (q: f32[4]) -> f32[4] {
  %q = f32[4] parameter(0)
  ROOT %cp = f32[4] collective-permute(f32[4] %q), source_target_pairs={{0,1}}
}

ENTRY %main.3 (a: f32[16,32]) -> f32[16,32] {
  %a = f32[16,32] parameter(0)
  %z = s32[] constant(0)
  %init = (s32[], f32[16,32]) tuple(%z, %a)
  %w = (s32[], f32[16,32]) while(%init), condition=%cond.1, body=%body.1, backend_config={"known_trip_count":{"n":"7"}}
  %c = f32[4] call(f32[4] %b), to_apply=%inner.2, calls=%inner.2
  %rs = f32[2,32] reduce-scatter(f32[16,32] %a), dimensions={0}
  ROOT %out = f32[16,32] get-tuple-element(%w), index=1
}
"""


@pytest.mark.parametrize("which", ["scan", "hand", "hand-no-trip"])
def test_hlo_analysis_equals_repros(which):
    text = {"scan": _scan_hlo, "hand": lambda: HAND_HLO,
            "hand-no-trip": lambda: HAND_HLO.replace(
                ', backend_config={"known_trip_count":{"n":"7"}}', "")}[which]()
    got = hlo_analysis.analyze_collectives(text)
    assert got == JHLO.analyze_collectives(text)
    for op in ("while", "all-gather", "tanh", "dot"):
        assert hlo_analysis.count_ops(text, op) == JHLO.count_ops(text, op)
    if which != "scan":
        trip = 7 if which == "hand" else 12  # the condition's constant
        assert got["per_kind"]["all-gather"] == trip * 16 * 32 * 4
        assert got["per_kind"]["all-reduce"] == trip * 8 * 4 * 2
        assert got["per_kind"]["reduce-scatter"] == 2 * 32 * 4
        assert got["per_kind"]["collective-permute"] == 16
    for t in ("f32[4,8]", "bf16[10]", "(f32[2,2], s32[3])", "pred[]"):
        assert hlo_analysis._shape_bytes(t) == JHLO._shape_bytes(t)


def test_dryrun_cli_writes_its_records(tmp_path):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = dryrun.main(["--arch", "smollm-360m", "--shape", "decode_32k",
                          "--fast", "--out", str(tmp_path)])
    assert rc == 0
    assert "dry-run summary: 2 ok, 0 failed, 0 skipped of 2 cells" \
        in out.getvalue()
    for mesh in ("pod_16x16", "multipod_2x16x16"):
        rec = json.loads((tmp_path / f"smollm-360m__decode_32k__{mesh}.json")
                         .read_text())
        assert rec["status"] == "ok" and rec["mesh"] == mesh
        m = rec["memory"]
        assert m["per_device_lower_bound"] == (m["argument_bytes"]
                                               + m["output_bytes"])
        assert m["temp_bytes"] is None
    with contextlib.redirect_stdout(io.StringIO()):
        dryrun.main(["--arch", "gemma-2b", "--shape", "long_500k",
                     "--single-pod", "--out", str(tmp_path)])
    rec = json.loads((tmp_path / "gemma-2b__long_500k__pod_16x16.json")
                     .read_text())
    assert rec["status"] == "skipped" and "full-attention" in rec["reason"]


def test_dryrun_cli_default_is_the_sharded_pass(tmp_path):
    """Without ``--fast`` each record carries the sharded pass: a numeric
    ``temp_bytes``, the total that ``fits_h100_80gb`` is judged on, and
    the collective bytes under every ``COLLECTIVE_KINDS`` name."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = dryrun.main(["--arch", "smollm-360m", "--shape", "decode_32k",
                          "--out", str(tmp_path)])
    assert rc == 0
    assert "dry-run summary: 2 ok, 0 failed, 0 skipped of 2 cells" \
        in out.getvalue()
    for mesh in ("pod_16x16", "multipod_2x16x16"):
        rec = json.loads((tmp_path / f"smollm-360m__decode_32k__{mesh}.json")
                         .read_text())
        assert rec["status"] == "ok" and rec["mesh"] == mesh
        m = rec["memory"]
        assert isinstance(m["temp_bytes"], int) and m["temp_bytes"] > 0
        assert m["per_device_lower_bound"] == (m["argument_bytes"]
                                               + m["output_bytes"])
        assert m["per_device_total"] == (m["argument_bytes"]
                                         + m["output_bytes"]
                                         + m["temp_bytes"])
        assert m["fits_h100_80gb"] == (m["per_device_total"]
                                       <= HW["hbm_bytes"])
        assert "temp_reason" not in m
        coll = rec["collectives"]
        assert set(coll["per_kind"]) == set(hlo_analysis.COLLECTIVE_KINDS)
        assert all(isinstance(v, int) and v >= 0
                   for v in coll["per_kind"].values())
        assert coll["total_bytes"] == sum(coll["per_kind"].values()) > 0


def test_roofline_cli_writes_its_records(tmp_path):
    with contextlib.redirect_stdout(io.StringIO()):
        rc = roofline.main(["--arch", "mamba2-130m", "--shape", "train_4k",
                            "--out", str(tmp_path)])
    assert rc == 0
    rec = json.loads((tmp_path / "mamba2-130m__train_4k.json").read_text())
    assert rec["status"] == "ok" and rec["terms_s"]["collective_s"] > 0
    assert rec["terms_s"]["collective_s"] == pytest.approx(
        sum(rec["full_graph_collectives"].values()) / HW["net_bw"])
    mf, _ = roofline.model_flops(get_config("mamba2-130m"),
                                 SHAPES["train_4k"])
    assert rec["model_flops_total"] == mf
    assert rec["terms_s"]["compute_s"] == pytest.approx(
        rec["per_device"]["flops"] / HW["peak_flops_bf16"])
    assert "mamba2-130m | train_4k" in (tmp_path / "roofline_table.md") \
        .read_text()


def test_flop_count_per_period_extrapolates_exactly():
    """The probes' extrapolation equals a direct count of the whole depth
    (a small config, so the direct count is cheap)."""
    cfg = dataclasses.replace(get_config("smollm-360m").reduced(),
                              n_layers=5)
    shape = ShapeCfg("t", seq_len=32, global_batch=2, kind="train")
    c1 = roofline.count_flops(roofline._probe_cfg(cfg, 1, shape), shape)
    c2 = roofline.count_flops(roofline._probe_cfg(cfg, 2, shape), shape)
    full = roofline.count_flops(roofline._probe_cfg(cfg, 5, shape), shape)
    assert c1 - (c2 - c1) + 5 * (c2 - c1) == full > 0


def test_roofline_without_probes_equals_the_probes(monkeypatch):
    """``analyze_cell(use_probes=False)`` (the full-depth FLOP count and
    sharded pass) gives the probed path's FLOPs, collective bytes and
    bytes accessed (the memory term), on a 4-layer reduced config over
    the single-pod mesh."""
    cfg = dataclasses.replace(get_config("smollm-360m").reduced(),
                              n_layers=4)
    shape = ShapeCfg("t", seq_len=32, global_batch=32, kind="train")
    monkeypatch.setattr(roofline, "get_config", lambda arch: cfg)
    monkeypatch.setattr(roofline, "SHAPES", {"t": shape})
    probed = roofline.analyze_cell("smollm-360m", "t")
    full = roofline.analyze_cell("smollm-360m", "t", use_probes=False)
    assert probed["status"] == full["status"] == "ok"
    assert probed["probes"] == [1, 2, 3] and full["probes"] is None
    assert full["per_device"]["flops"] == probed["per_device"]["flops"] > 0
    assert full["full_graph_collectives"] == probed["full_graph_collectives"]
    assert sum(full["full_graph_collectives"].values()) > 0
    assert full["terms_s"]["collective_s"] == \
        probed["terms_s"]["collective_s"] > 0
    assert full["per_device"]["bytes"] == probed["per_device"]["bytes"] > \
        probed["per_device"]["bytes_lower_bound"]
    assert full["terms_s"]["memory_s"] == probed["terms_s"]["memory_s"] == \
        probed["per_device"]["bytes"] / HW["hbm_bw"]
    assert full["per_device"]["sharded_flops"] == \
        probed["per_device"]["sharded_flops"] > 0
