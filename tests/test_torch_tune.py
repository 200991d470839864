"""The tuning studies' builds (``ops/gru_fwd_tune.py``,
``ops/readout_topk_tune.py``, ``ops/dec_scan_tune.py``), on the CPU.

Each study builds its kernel's source with text edits
(``_build.build_variants``, on ``_build.source``: the source with its
csrc/ headers inlined), which only the card's machine compiles. Here
every edit of every build is applied to the current source, so an edit of a
kernel that moves a study's text fails on the CPU and not on the card;
``apply_edits`` raises by name where a text is missing, and ``loaded_as``
puts a build under the kernel's wrappers only within its block."""

import pytest

from vag_nmt_tpu_torch.ops import (_build, dec_scan_tune, gru_fwd_tune,
                                   readout_topk_tune)

STUDIES = [("gru_fwd", gru_fwd_tune.PROBES),
           ("readout_topk", readout_topk_tune.PROBES),
           *((name, dec_scan_tune.PROBES) for name in dec_scan_tune.KERNELS)]
CASES = [(name, label, edits) for name, probes in STUDIES
         for label, edits in probes]


@pytest.mark.parametrize("name,label,edits", CASES,
                         ids=[f"{n}:{lb}" for n, lb, _ in CASES])
def test_probe_edits_apply_to_the_source(name, label, edits):
    src = _build.source(name)
    out = _build.apply_edits(src, label, edits)
    assert (out == src) == (not edits)
    for old, new in edits:
        assert new in out


@pytest.mark.parametrize("name,probes", STUDIES, ids=[n for n, _ in STUDIES])
def test_probe_labels_are_distinct_and_first_is_the_kernel(name, probes):
    labels = [label for label, _ in probes]
    assert len(set(labels)) == len(labels)
    assert probes[0] == ("kernel", [])


def test_apply_edits_names_a_missing_text():
    with pytest.raises(ValueError, match="'probe x'"):
        _build.apply_edits("abc", "probe x", [("b", "B"), ("zz", "y")])
    assert _build.apply_edits("abcb", "p", [("b", "B"), ("aB", "a")]) == "acB"


def test_loaded_as_restores_the_kernel_library():
    name = "readout_topk"
    before = _build._LOADED.get(name)
    stand_in = object()
    with _build.loaded_as(name, stand_in) as lib:
        assert lib is stand_in and _build._LOADED[name] is stand_in
    assert _build._LOADED.get(name) is before
    with pytest.raises(RuntimeError):
        with _build.loaded_as(name, stand_in):
            raise RuntimeError("a failed timing")
    assert _build._LOADED.get(name) is before


@pytest.mark.parametrize("name", ["readout_topk", "dec_step"])
def test_source_inlines_the_csrc_headers(name):
    """The text the studies edit holds the shared headers' helpers (the
    TF32 split the readout probes edit lives in tf32_mma.cuh) and no
    include of a csrc/ header."""
    src = _build.source(name)
    assert '#include "tf32_mma.cuh"' in (_build.CSRC / f"{name}.cu").read_text()
    assert '#include "' not in src and "#pragma once" not in src
    assert "__device__ __forceinline__ uint32_t tf32_rna(float x)" in src
    assert "__device__ __forceinline__ float tanh_fast(float x)" in src  # common.cuh
