"""The port's roofline (``repro_torch/analysis/roofline.py``) against the
reference's: ``model_flops_for`` and ``lm_active_params`` equal for every
arch x shape of both registries; the report's three terms against the
H100's published peaks (compute summed over the dtypes' own peaks),
``dominant`` and the JSON round trip through ``load_reports``."""
import json

import pytest

from repro.analysis import roofline as j_roofline
from repro.models.api import get_arch as j_get_arch, list_archs as j_list_archs
from repro_torch.analysis import roofline
from repro_torch.models.api import get_arch, list_archs
from repro_torch.models.transformer import LMConfig


def test_registries_hold_the_same_cells():
    assert list_archs() == j_list_archs()
    for name in list_archs():
        assert list(get_arch(name).shapes) == list(j_get_arch(name).shapes), name


@pytest.mark.parametrize("name", sorted(j_list_archs()))
def test_model_flops_equal_the_reference_for_every_shape(name):
    arch, j_arch = get_arch(name), j_get_arch(name)
    for shape in arch.shapes:
        assert roofline.model_flops_for(arch, shape) == \
            j_roofline.model_flops_for(j_arch, shape), (name, shape)
    if isinstance(getattr(arch, "cfg", None), LMConfig):
        assert roofline.lm_active_params(arch.cfg) == j_roofline.lm_active_params(j_arch.cfg)
    smoke = get_arch(name, smoke=True)
    for shape in smoke.shapes:
        assert roofline.model_flops_for(smoke, shape) == \
            j_roofline.model_flops_for(j_get_arch(name, smoke=True), shape), (name, shape)


def _report(**over):
    kw = dict(arch="qwen2-1.5b", shape="train_4k", mesh="single_pod_16x16", chips=1,
              flops_per_chip=989e12 + 67e12, bytes_per_chip=3.35e12,
              collective_bytes_per_chip=3 * 450e9, collectives={"all-gather": 2},
              model_flops=528e12, memory_per_chip=1e9, compile_seconds=0.5,
              flops_by_dtype={"bfloat16": 989e12, "float32": 67e12})
    kw.update(over)
    return roofline.RooflineReport(**kw)


def test_report_terms_against_the_h100_peaks():
    assert roofline.PEAK_FLOPS["bfloat16"] == roofline.PEAK_FLOPS["float16"] == 989e12
    assert roofline.PEAK_FLOPS["float32"] == 67e12
    assert (roofline.HBM_BW, roofline.LINK_BW) == (3.35e12, 450e9)
    r = _report()
    assert r.compute_term == pytest.approx(2.0)      # 1 s of bf16 + 1 s of fp32
    assert r.memory_term == pytest.approx(1.0)
    assert r.collective_term == pytest.approx(3.0)
    assert r.dominant == "collective"
    assert r.step_time_bound == pytest.approx(3.0)
    assert r.roofline_fraction == pytest.approx(2.0 / 3.0)
    assert r.useful_flops_fraction == pytest.approx(528e12 / (989e12 + 67e12))
    assert _report(collective_bytes_per_chip=0.0).dominant == "compute"
    assert _report(bytes_per_chip=3.35e13, collective_bytes_per_chip=0.0).dominant == "memory"
    # a dtype without a listed peak runs at the fp32 rate
    assert _report(flops_by_dtype={"float64": 67e12}).compute_term == pytest.approx(1.0)


def test_report_json_round_trip_and_table(tmp_path):
    reports = [_report(), _report(arch="mind", shape="train_batch",
                                  flops_by_dtype={"float32": 67e9}, bytes_per_chip=1e9)]
    paths = []
    for i, r in enumerate(reports):
        p = tmp_path / f"r{i}.json"
        p.write_text(json.dumps({"status": "ok", "lower_seconds": 0.1, **r.to_json()}))
        paths.append(p)
    back = roofline.load_reports(paths)
    assert back == reports
    d = reports[0].to_json()
    assert set(j_roofline.RooflineReport.__dataclass_fields__) | {"flops_by_dtype"} \
        <= set(d)
    assert d["dominant"] == "collective" and d["compute_term"] == pytest.approx(2.0)
    table = roofline.render_markdown_table(back)
    assert table.count("\n") == 3 and "| mind | train_batch |" in table
