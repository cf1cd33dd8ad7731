"""The ctypes bindings of the port's CUDA libraries against their C entry
points, on the CPU: each `ops/cuda/<module>._lib()` is run on a stand-in for
the built library that records what it binds, and every function of each
source's `extern "C"` block must be bound with one ctypes type a parameter,
in order, and its return type. ctypes passes surplus arguments of a cdecl
function by its own default conversions, so a list one entry short still
calls: a 64-bit pointer or `long long` at the end of it then goes out as a
4-byte int, and the callee reads the other half of its slot from whatever
lay there (a stream handle's upper bits, say)."""

import ctypes
import re
from pathlib import Path

import pytest

from seqrec_tpu_torch.ops import _build
from seqrec_tpu_torch.ops.cuda import attention, gather, gru, head, lstm

CSRC = Path(__file__).resolve().parents[1] / "seqrec_tpu_torch" / "csrc"
# csrc/<source>.cu and the module that binds it.
SOURCES = {"attention": attention, "gather": gather, "gru": gru, "lstm": lstm,
           "softmax_head": head}
C_TYPES = {"int": ctypes.c_int, "long long": ctypes.c_longlong, "float": ctypes.c_float,
           "void*": ctypes.c_void_p, "const void*": ctypes.c_void_p,
           "const char*": ctypes.c_char_p}


def _entry_points(source: str) -> dict:
    """{name: (return type, [parameter types])} of csrc/<source>.cu's
    extern "C" block."""
    text = (CSRC / f"{source}.cu").read_text()
    block = text[text.index('extern "C" {'):text.index('}  // extern "C"')]
    found = {}
    for ret, name, params in re.findall(r"^([A-Za-z][\w ]*?\**)\s*(seqrec_\w+)\(([^)]*)\)\s*\{",
                                        block, re.M):
        kinds = [re.sub(r"\s*\b\w+$", "", " ".join(p.split())) for p in params.split(",")]
        found[name] = (ret.strip(), kinds)
    return found


class _Function:
    def __init__(self):
        self.argtypes = None
        self.restype = ctypes.c_int  # ctypes' default


class _Library:
    """Records the functions a binding looks up and what it sets on them."""

    def __init__(self):
        self.functions = {}

    def __getattr__(self, name):
        return self.functions.setdefault(name, _Function())


def _bound(source: str, monkeypatch) -> dict:
    stand_in = _Library()
    monkeypatch.setattr(_build, "load", lambda name: stand_in if name == source else None)
    SOURCES[source]._lib()
    return stand_in.functions


CASES = [(source, name) for source in SOURCES for name in _entry_points(source)]


def test_every_source_exports_what_the_cases_cover():
    assert len(CASES) == 38
    assert {"seqrec_gru_xproj", "seqrec_lstm_xproj", "seqrec_step_gemm_f32"} <= {
        name for _, name in CASES}


@pytest.mark.parametrize("source,name", CASES, ids=[name for _, name in CASES])
def test_binding_matches_the_c_signature(source, name, monkeypatch):
    ret, kinds = _entry_points(source)[name]
    fn = _bound(source, monkeypatch).get(name)
    assert fn is not None, f"{name} is exported by csrc/{source}.cu but never bound"
    want = [C_TYPES[k] for k in kinds]
    assert fn.argtypes == want, (f"{name}: bound {len(fn.argtypes or [])} arguments, the C "
                                 f"entry point takes {len(want)}: {kinds}")
    assert fn.restype == C_TYPES[ret]


def test_both_projection_entry_points_share_one_binding(monkeypatch):
    """The GRU's and the LSTM's bf16 projections take the same plan: one
    list binds both (gru.XPROJ_ARGTYPES)."""
    assert _bound("gru", monkeypatch)["seqrec_gru_xproj"].argtypes == gru.XPROJ_ARGTYPES
    assert _bound("lstm", monkeypatch)["seqrec_lstm_xproj"].argtypes == gru.XPROJ_ARGTYPES
    assert gru.XPROJ_ARGTYPES.count(ctypes.c_int) == 3 + len(gru.xproj_plan_args(64, 64, 64)) - 1
