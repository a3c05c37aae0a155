"""A traced run of a test-sized SAM cell (`tests/data`: the architecture
file `arch/sam_vit_h.py` at a width of 64) through `run_cell` on the CPU:
its numbers and the two SAM metric readers run and the cell comes out
correct. `tests/test_torch_sam.py` holds the configuration's FLOPs, stated
config, faults and readers."""

import os

import pytest

from bench_port import spec
from bench_port.run import run_cell
from rt3d_torch.models import sam as P

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


@pytest.fixture
def tiny_sam(monkeypatch):
    sizes = spec.load_json(os.path.join(DATA, "configs", "small_sam.json"))["sam"]
    monkeypatch.setitem(P.SAM_SIZES, "test", P.SamSizes(
        **{**sizes, "global_attn_indexes": tuple(sizes["global_attn_indexes"])}))


def test_a_tiny_sam_cell_runs_traced_and_correct(tiny_sam):
    bench = {"end_to_end": [], "per_layer": [
        {"name": n, "unit": "x"} for n in ("sam_ms", "sam_encoder_roofline_pct", "detect_ms")]}
    result, numbers = run_cell("small_sam.objects2", 2**31 + 7, 4.0, True, device="cpu",
                               here=DATA, bench=bench)
    assert result["correct"] is True, result["checks"]
    assert result["metrics"]["sam_ms"]["value"] > 0
    assert "sam_encoder_roofline_pct" not in result["metrics"]  # no device span on the CPU
    assert numbers["sam_logit_rel_med"] < 1e-5 and numbers["sam_logit_off_share"] == 0.0
    assert result["checks"]["sam_logit_rel_med"]["limit"] == 1e-4

