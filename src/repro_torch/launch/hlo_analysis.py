"""Parse compiled HLO text: collective bytes with loop trip-count attribution.

A copy of ``repro.launch.hlo_analysis`` (it imports only ``re`` and
``typing``), held to it on the same HLO strings by
``tests/test_torch_dryrun.py``. PyTorch emits no HLO, so no HLO of the
port reaches the parser: the port's dry run counts its collective bytes
op by op in the sharded pass (``launch.dryrun.StepCost``), filed under
this module's ``COLLECTIVE_KINDS``, and ``launch.roofline`` reads them
from there. :func:`analyze_collectives` and :func:`count_ops` read the
HLO text of an XLA compile wherever one is at hand, to set XLA's plan
beside the port's.

`compiled.cost_analysis()` counts a `while` body once regardless of trip
count, and collective bytes are not reported at all. This module segments
the HLO module text into computations, builds the call graph
(while/call/fusion/conditional edges), extracts loop trip counts (from
``backend_config={"known_trip_count":{"n":...}}`` or the condition region's
compare constant), and accumulates per-collective operand bytes weighted by
the product of enclosing trip counts.
"""
from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

_DTYPE_BYTES = {
    "f64": 8, "f32": 4, "f16": 2, "bf16": 2, "f8e4m3fn": 1, "f8e5m2": 1,
    "s64": 8, "u64": 8, "s32": 4, "u32": 4, "s16": 2, "u16": 2,
    "s8": 1, "u8": 1, "pred": 1, "c64": 8, "c128": 16,
}

COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter",
                    "all-to-all", "collective-permute")

_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")
_DEF_RE = re.compile(r"^\s*(?:ROOT\s+)?%([\w.\-]+)\s*=\s*(.*)$")
_CALLS_RE = re.compile(r"(?:calls|body|condition|branch_computations)=\{?%?([\w.\-,% ]+)\}?")
_TRIP_RE = re.compile(r'"known_trip_count":\{"n":"?(\d+)"?\}')
_CONST_RE = re.compile(r"s32\[\]\s+constant\((\d+)\)")


def _shape_bytes(type_str: str) -> int:
    """Total bytes of a (possibly tuple) HLO type string."""
    total = 0
    for m in _SHAPE_RE.finditer(type_str):
        dt, dims = m.group(1), m.group(2)
        if dt not in _DTYPE_BYTES:
            continue
        n = 1
        if dims:
            for d in dims.split(","):
                n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


def _split_computations(hlo: str) -> Dict[str, List[str]]:
    comps: Dict[str, List[str]] = {}
    cur: Optional[str] = None
    lines: List[str] = []
    for line in hlo.splitlines():
        header = re.match(r"^(?:ENTRY\s+)?%?([\w.\-]+)\s*\((.*)\)\s*->.*\{\s*$", line)
        if header and not line.lstrip().startswith("%param"):
            cur = header.group(1)
            lines = []
            comps[cur] = lines
            continue
        if line.startswith("}"):
            cur = None
            continue
        if cur is not None:
            lines.append(line)
    return comps


def _cond_trip_count(cond_lines: List[str]) -> Optional[int]:
    consts = [int(m.group(1)) for l in cond_lines for m in _CONST_RE.finditer(l)]
    return max(consts) if consts else None


def analyze_collectives(hlo: str) -> Dict[str, object]:
    """Returns per-kind collective bytes (trip-count weighted) + loop info."""
    comps = _split_computations(hlo)

    # per-computation local collective bytes + call edges
    local: Dict[str, Dict[str, int]] = {}
    edges: Dict[str, List[Tuple[str, int]]] = {}
    for name, lines in comps.items():
        bytes_by_kind: Dict[str, int] = {}
        calls: List[Tuple[str, int]] = []
        for line in lines:
            m = _DEF_RE.match(line)
            if not m:
                continue
            rhs = m.group(2)
            shape_str = rhs.split(" ", 1)[0] if "(" in rhs else rhs
            # find the op kind: token right before the first '('
            kind_m = re.search(r"([\w\-]+)\(", rhs)
            kind = kind_m.group(1) if kind_m else ""
            for ck in COLLECTIVE_KINDS:
                if kind == ck or kind.startswith(ck + "-"):
                    # operand bytes ~= output bytes for AG/AR/CP; use output
                    bytes_by_kind[ck] = bytes_by_kind.get(ck, 0) + _shape_bytes(shape_str)
                    break
            if kind == "while":
                body_m = re.search(r"body=%?([\w.\-]+)", rhs)
                cond_m = re.search(r"condition=%?([\w.\-]+)", rhs)
                trip = None
                tm = _TRIP_RE.search(rhs)
                if tm:
                    trip = int(tm.group(1))
                if trip is None and cond_m and cond_m.group(1) in comps:
                    trip = _cond_trip_count(comps[cond_m.group(1)])
                if trip is None:
                    trip = 1
                if body_m:
                    calls.append((body_m.group(1), trip))
                if cond_m:
                    calls.append((cond_m.group(1), trip))
            elif kind in ("fusion", "call", "conditional", "custom-call"):
                cm = re.search(r"calls=%?([\w.\-]+)", rhs)
                if cm:
                    calls.append((cm.group(1), 1))
                bm = re.search(r"branch_computations=\{([^}]*)\}", rhs)
                if bm:
                    for b in bm.group(1).split(","):
                        calls.append((b.strip().lstrip("%"), 1))
        local[name] = bytes_by_kind
        edges[name] = calls

    # entry = computation not called by anyone
    called = {c for cl in edges.values() for c, _ in cl}
    entries = [n for n in comps if n not in called]

    totals: Dict[str, int] = {k: 0 for k in COLLECTIVE_KINDS}
    loops: List[Dict[str, object]] = []

    def visit(name: str, mult: int, seen: Tuple[str, ...]):
        if name not in comps or name in seen:
            return
        for k, b in local.get(name, {}).items():
            totals[k] += b * mult
        for callee, m in edges.get(name, []):
            if m > 1:
                loops.append({"body": callee, "trip_count": m, "mult": mult})
            visit(callee, mult * m, seen + (name,))

    for e in entries:
        visit(e, 1, ())

    totals_all = sum(totals.values())
    return {"per_kind": totals, "total_bytes": totals_all, "loops": loops,
            "n_computations": len(comps)}


def count_ops(hlo: str, op: str) -> int:
    return len(re.findall(rf"\b{re.escape(op)}\(", hlo))
