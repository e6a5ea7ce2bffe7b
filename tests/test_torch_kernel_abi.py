"""The port's kernel interfaces, checked on the CPU.

Each CUDA kernel takes one argument struct through ``ctypes``; a wrapper
whose ``_Args`` drifts from the struct in the ``.cu`` source would pass
garbage that only a card shows. These tests parse each struct out of its
source and hold the wrapper's fields to it, name, order and C type, and
check the argument builders that run before a launch: an omitted operand
makes no tensor, a window's host arrays are staged in one buffer, and a
size an ``int`` field cannot hold is refused.
Imports torch, numpy and ``repro_torch`` only.
"""
import ctypes
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.olaf_queue import TorchQueueState, queue_init  # noqa: E402
from repro_torch.kernels import (decode_attention, flash_attention,  # noqa: E402
                                 olaf_combine, olaf_enqueue, olaf_robust,
                                 olaf_step)
from repro_torch.kernels._build import CSRC  # noqa: E402

_C_TYPES = {"int": ctypes.c_int, "float": ctypes.c_float,
            "long long": ctypes.c_longlong}


def parse_struct(source: Path, name: str):
    """``[(field, ctypes type)]`` of ``struct name`` in a CUDA source:
    every pointer is a ``c_void_p``, ``int``/``float``/``long long`` their
    ctypes types."""
    text = re.sub(r"//[^\n]*", "", source.read_text())
    body = re.search(r"struct\s+%s\s*\{(.*?)\};" % name, text, re.S).group(1)
    fields = []
    for decl in filter(None, (d.strip() for d in body.split(";"))):
        first, *more = decl.replace("*", " * ").split(",")
        *words, name = first.split()
        pointer = "*" in words
        base = " ".join(w for w in words if w not in ("const", "*"))
        for n in [name, *(m.strip() for m in more)]:
            fields.append((n, ctypes.c_void_p if pointer else _C_TYPES[base]))
    return fields


@pytest.mark.parametrize("module,source,struct", [
    (olaf_step, "olaf_step.cu", "OlafStepArgs"),
    (olaf_combine, "olaf_combine.cu", "OlafCombineArgs"),
    (olaf_robust, "olaf_robust.cu", "OlafRobustArgs"),
    (flash_attention, "flash_attention.cu", "FlashArgs"),
    (decode_attention, "decode_attention.cu", "DecodeArgs"),
    (flash_attention, "flash_attention.cu", "FlashBwdArgs"),
])
def test_args_mirror_the_cuda_struct(module, source, struct):
    want = parse_struct(CSRC / source, struct)
    args = module._BwdArgs if struct == "FlashBwdArgs" else module._Args
    assert [(n, t) for n, t in args._fields_] == want


def test_struct_parser_reads_pointers_and_lists(tmp_path):
    """The parser itself, on a struct of every declaration form."""
    src = tmp_path / "probe.cu"
    src.write_text("struct P {\n  int a, b;  // two\n  float x;\n"
                   "  long long s;\n  const float* p;\n  bool *q;\n};\n")
    assert parse_struct(src, "P") == [
        ("a", ctypes.c_int), ("b", ctypes.c_int), ("x", ctypes.c_float),
        ("s", ctypes.c_longlong), ("p", ctypes.c_void_p),
        ("q", ctypes.c_void_p)]


def _burst(rng, S, U, D):
    shape = (S, U) if S else (U,)
    return (torch.from_numpy(rng.integers(0, 6, shape).astype(np.int32)),
            torch.from_numpy(rng.integers(0, 4, shape).astype(np.int32)),
            torch.from_numpy(rng.random(shape).astype(np.float32)),
            torch.from_numpy(rng.normal(size=shape).astype(np.float32)),
            torch.from_numpy(rng.normal(size=shape + (D,)).astype(np.float32)))


@pytest.mark.parametrize("capacity", [None, 5, np.int32(3), "tensor"])
def test_cycle_operands_make_no_tensor_for_an_omitted_operand(capacity):
    """``send``, ``screen`` and ``capacity`` left out (the trainer's
    drain) reach the kernel as null pointers, and an int capacity as the
    scalar ``cap``: no fill runs on the card for them."""
    rng = np.random.default_rng(0)
    S, Q, U, D = 2, 6, 5, 7
    st = TorchQueueState.stack([queue_init(Q, D, device="cpu")] * S)
    cap = (torch.tensor([4, 6], dtype=torch.int32) if capacity == "tensor"
           else capacity)
    st2, burst, sz = olaf_step.cycle_operands(
        "olaf_step", st, *_burst(rng, S, U, D), 3, None, cap, None)
    assert burst["u_send"] is None and burst["u_screen"] is None
    assert sz == dict(S=S, Q=Q, U=U, D=D, K=3,
                      cap=Q if capacity in (None, "tensor") else int(capacity))
    if capacity == "tensor":
        assert burst["capacity"].tolist() == [4, 6]
    else:
        assert burst["capacity"] is None
    # burst operands of the kernel's dtypes are passed as they are
    assert st2.payload.data_ptr() == st.payload.data_ptr()
    send = torch.ones((S, U), dtype=torch.bool)
    _, burst, _ = olaf_step.cycle_operands("olaf_step", st, *_burst(
        rng, S, U, D), 9, send, None, send)
    assert burst["u_send"].data_ptr() == send.data_ptr()
    assert burst["u_screen"] is not None


def test_cycle_operands_of_one_queue_are_views():
    """One queue (no S axis): the kernel sees views with S = 1, so its
    in-place update reaches the caller's tensors."""
    rng = np.random.default_rng(1)
    st = queue_init(4, 9, device="cpu")
    st2, burst, sz = olaf_step.cycle_operands(
        "olaf_enqueue", st, *_burst(rng, 0, 3, 9), 0, None, None, None)
    assert sz["S"] == 1 and sz["K"] == 0 and sz["cap"] == 4
    assert st2.payload.shape == (1, 4, 9)
    for n, v in st.fields().items():
        assert getattr(st2, n).data_ptr() == v.data_ptr(), n
    assert burst["u_payload"].shape == (1, 3, 9)


def test_stage_window_packs_host_arrays_into_one_buffer():
    """Host (numpy) window arrays share ONE staging buffer (one copy to a
    card); each view holds its array exactly, the 4-byte ones aligned."""
    rng = np.random.default_rng(2)
    S, Q, U, K = 3, 4, 8, 2
    host = dict(clusters=rng.integers(-1, Q, (S, U)).astype(np.int32),
                gate=rng.integers(0, 3, (S, U)).astype(np.int64),
                reset=rng.random((S, Q)) < 0.5,
                drain_sw=np.array([2, 0], np.int64),
                drain_slot=np.array([1, 3], np.int64),
                drain_hop=np.array([-1, -2], np.int32))
    w = olaf_combine.stage_window(torch.device("cpu"), **host)
    storages = {v.untyped_storage().data_ptr() for v in w.values()}
    assert len(storages) == 1
    for name, a in host.items():
        t = w[name]
        assert t.dtype == (torch.bool if a.dtype == bool else torch.int32)
        assert t.is_contiguous() and t.data_ptr() % 4 == 0
        np.testing.assert_array_equal(t.numpy(), a, err_msg=name)


def test_stage_window_keeps_device_tensors():
    """Operands already on the device are used as they are (no copy);
    only the host ones are staged; a tensor elsewhere raises."""
    clusters = torch.zeros((2, 4), dtype=torch.int32)
    w = olaf_combine.stage_window(torch.device("cpu"), clusters=clusters,
                                  gate=np.ones((2, 4), np.int32), reset=None)
    assert w["clusters"].data_ptr() == clusters.data_ptr()
    assert w["reset"] is None and w["drain_sw"] is None
    assert w["gate"].tolist() == [[1] * 4] * 2
    with pytest.raises(ValueError, match="more than one device"):
        olaf_combine.stage_window(torch.device("cpu"),
                                  clusters=clusters.to("meta"))


def _meta(shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _cycle_meta(S, Q, U, D):
    """A queue and a burst of these sizes on the meta device: shapes only,
    no memory."""
    one = queue_init(1, 1, device="meta").fields()
    st = TorchQueueState(**{n: _meta((S, Q, D) if n == "payload" else (
        (S, Q) if v.dim() == 1 else (S,)), v.dtype) for n, v in one.items()})
    burst = (_meta((S, U), torch.int32), _meta((S, U), torch.int32),
             _meta((S, U)), _meta((S, U)), _meta((S, U, D)))
    return st, burst


BIG = 2**31  # one past what an int field of a kernel's argument struct holds


@pytest.mark.parametrize("dim", ["S", "Q", "U", "D"])
def test_cycle_kernels_refuse_a_size_over_int32(dim):
    """``olaf_step`` and ``olaf_enqueue`` raise before ``ctypes.c_int``
    would wrap a size over 2**31 - 1 (on shapes alone: meta tensors);
    2**31 - 1 itself passes the check (and fails next, off a card)."""
    sizes = dict(S=1, Q=4, U=2, D=8)
    for n, match in ((BIG, r"over the kernel's limit of 2\*\*31 - 1"),
                     (BIG - 1, "needs CUDA tensors")):
        st, burst = _cycle_meta(**{**sizes, dim: n})
        with pytest.raises(ValueError, match=match):
            olaf_step.olaf_step_cuda(st, *burst, 2)
        with pytest.raises(ValueError, match=match):
            olaf_enqueue.olaf_enqueue_cuda(st, *burst)


@pytest.mark.parametrize("dim", ["S", "Q", "U", "D", "K", "robust.D"])
def test_combine_kernel_refuses_a_size_over_int32(dim):
    """The window combine at each size, and the PS step's robust combine
    (``robust.D``: its row width; K is at most 32 there)."""
    sizes = dict(S=1, Q=4, U=2, D=8, K=1)
    for n, match in ((BIG, r"over the kernel's limit of 2\*\*31 - 1"),
                     (BIG - 1, "needs CUDA tensors")):
        if dim == "robust.D":
            with pytest.raises(ValueError, match=match):
                olaf_robust.olaf_robust_combine_cuda(
                    _meta((4, n)), _meta((4,)), _meta((), torch.int32),
                    _meta((), torch.int32), threshold=0.25)
            continue
        S, Q, U, D, K = ({**sizes, dim: n}[k] for k in "SQUDK")
        with pytest.raises(ValueError, match=match):
            olaf_combine.olaf_combine_cuda(
                _meta((S, Q, D)), _meta((S, Q), torch.int32),
                _meta((S, U, D)), _meta((S, U), torch.int32),
                _meta((S, U), torch.int32),
                drain_sw=_meta((K,), torch.int32),
                drain_slot=_meta((K,), torch.int32))


@pytest.mark.parametrize("K,match", [(32, "needs CUDA tensors"),
                                     (33, "over the kernel's 32")])
def test_robust_combine_refuses_more_rows_than_its_sort(K, match):
    """The robust combine sorts each column's rows in registers, at most
    ``MAX_ROWS`` (32) of them: 33 rows raise before any launch, 32 pass
    the check (and fail next, off a card)."""
    assert olaf_robust.MAX_ROWS == 32
    with pytest.raises(ValueError, match=match):
        olaf_robust.olaf_robust_combine_cuda(
            _meta((K, 8)), _meta((K,)), _meta((), torch.int32),
            _meta((), torch.int32), threshold=0.25)
