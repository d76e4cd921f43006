"""``tools/sweep_fp32_tiles.py`` and ``tools/sweep_int8_tc.py`` against the kernel sources as they are.

Each tile variant of the sweep names lines of ``alg_tpu_torch/csrc`` to
replace. A line that a later change rewrote would make the variant fail on
the card, or, if it still occurred elsewhere, edit the wrong line. So every
line a variant replaces occurs exactly once in its source, its replacement
differs from it, and the copy the tool makes holds the replacement and only
the two fp32 compile units. The tool itself runs only on a card; these
checks run on the CPU."""

import importlib.util
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
CSRC = REPO / "alg_tpu_torch" / "csrc"


def _sweep():
    spec = importlib.util.spec_from_file_location("sweep_fp32_tiles", REPO / "tools" / "sweep_fp32_tiles.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


SWEEP = _sweep()


@pytest.mark.parametrize("name", list(SWEEP.VARIANTS))
def test_every_replaced_line_occurs_once_in_its_source(name):
    for source, old, new in SWEEP.VARIANTS[name]:
        text = (CSRC / source).read_text()
        assert text.count(old) == 1, f"{name}: {source} holds {text.count(old)} copies of {old!r}"
        assert new != old and new not in text, f"{name}: {new!r} changes nothing in {source}"


@pytest.mark.parametrize("name", ["base", "fwd_small_tm1", "dq_d64_tm4_bk64", "dq_d128_bk48"])
def test_the_copy_holds_the_variant_and_the_fp32_units_alone(name, tmp_path):
    root = Path(SWEEP.make_copy(name, str(tmp_path)))
    csrc = root / "alg_tpu_torch" / "csrc"
    assert sorted(p.name for p in csrc.glob("*.cu")) == sorted((SWEEP.FWD, SWEEP.BWD))
    assert not (root / "alg_tpu_torch" / "_build").exists()
    changed = {source for source, _, _ in SWEEP.VARIANTS[name]}
    for source, old, new in SWEEP.VARIANTS[name]:
        text = (csrc / source).read_text()
        assert new in text and old not in text
    for path in csrc.iterdir():
        if path.name not in changed:
            assert path.read_text() == (CSRC / path.name).read_text(), path.name


def _int8_sweep():
    spec = importlib.util.spec_from_file_location("sweep_int8_tc", REPO / "tools" / "sweep_int8_tc.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


INT8_SWEEP = _int8_sweep()


@pytest.mark.parametrize("name", list(INT8_SWEEP.VARIANTS))
def test_every_int8_variant_line_occurs_once_in_the_source(name):
    """``tools/sweep_int8_tc.py``: the same checks for its variants of ``csrc/flash_attention_int8_tc.cu``."""
    text = (CSRC / INT8_SWEEP.SRC).read_text()
    for old, new in INT8_SWEEP.VARIANTS[name]:
        assert text.count(old) == 1, f"{name}: {INT8_SWEEP.SRC} holds {text.count(old)} copies of {old!r}"
        assert new != old and (not new or new not in text), f"{name}: {new!r} changes nothing"


@pytest.mark.parametrize("name", ["base", "nomax", "rows1"])
def test_the_int8_copy_holds_the_variant_and_the_int8_unit_alone(name, tmp_path):
    root = Path(INT8_SWEEP.make_copy(name, str(tmp_path)))
    csrc = root / "alg_tpu_torch" / "csrc"
    assert [p.name for p in csrc.glob("*.cu")] == [INT8_SWEEP.SRC]
    text = (csrc / INT8_SWEEP.SRC).read_text()
    for old, new in INT8_SWEEP.VARIANTS[name]:
        assert new in text and old not in text
    if not INT8_SWEEP.VARIANTS[name]:
        assert text == (CSRC / INT8_SWEEP.SRC).read_text()
