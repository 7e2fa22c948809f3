"""The harness finds a configuration, a traffic mix, a per-layer metric, a
driver, a vision tower and a cell's limits by name: a later change adds
files and entries and edits none. A configuration's program keys, its
serving precision among them, are run as the file states them."""

import copy
import json
import shutil

import pytest

from mmrp_bench import harness, trace, work
from mmrp_bench.tests import micro


def test_new_files_are_found_without_editing_any(tmp_path):
    base = tmp_path / "mmrp_bench"
    shutil.copytree(harness.HERE, base, ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in base.rglob("*") if p.is_file()}
    cfg = json.loads((base / "configs" / "flagship.json").read_text())
    (base / "configs" / "wide.json").write_text(json.dumps(dict(cfg, name="wide")))
    traffic = json.loads((base / "traffic" / "stream-openi.json").read_text())
    (base / "traffic" / "stream-short.json").write_text(json.dumps(dict(traffic, ring=4)))
    (base / "metrics" / "batches.count.py").write_text(
        "def read(data):\n    return float(data['window']['batches'])\n")
    (base / "drivers" / "echo.py").write_text("def run(ctx):\n    return {'seed': ctx.seed}\n")
    (base / "limits" / "wide.stream-short.json").write_text(json.dumps({"emb_cos_gap": 1.0}))
    (base / "vision" / "toy.py").write_text(
        "KEYS = ('img_size',)\n"
        "def out(v):\n    return 1, 8\n"
        "def flops(v):\n    return 7 * v['img_size']\n")
    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "wide", "source": "x", "file": "mmrp_bench/configs/wide.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "wide.stream-short", "config": "wide",
                               "traffic": "stream-short", "chips": 1, "why": "x"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    b = harness.benchmark(tmp_path)
    cell = harness.workload(b, "wide.stream-short")
    assert harness.config_file(b, cell["config"], tmp_path)["name"] == "wide"
    assert harness.traffic_file(cell["traffic"], base)["ring"] == 4
    assert harness.limits_file(cell["name"], base) == {"emb_cos_gap": 1.0}
    assert harness.metric_reader("batches.count", base)({"window": {"batches": 7}}) == 7.0
    assert harness.driver("echo", base).run(harness.Ctx("c", {}, {}, {}, 5, 1.0, False)) == {
        "seed": 5}
    toy = harness.vision_kind("toy", base)
    assert toy.flops({"img_size": 3}) == 21 and toy.out({}) == (1, 8)
    # the files that were there are as they were
    assert all(p.read_bytes() == data for p, data in before.items())


def test_a_new_vision_kind_file_sets_the_work(tmp_path, monkeypatch):
    (tmp_path / "vision").mkdir()
    (tmp_path / "vision" / "toy.py").write_text(
        "KEYS = ()\ndef out(v):\n    return 4, 16\ndef flops(v):\n    return 1000\n"
        "def param_bytes(v, dtype_bytes=2):\n    return 10 * dtype_bytes\n")
    real = harness.vision_kind
    monkeypatch.setattr(harness, "vision_kind",
                        lambda kind, base=harness.HERE: real(kind, tmp_path if kind == "toy"
                                                             else base))
    cfg = copy.deepcopy(micro.MICRO)
    cfg["vision"] = {"kind": "toy"}
    assert work.vision_flops(cfg) == 1000 and work.vision_out(cfg) == (4, 16)
    assert work.layer_param_bytes(cfg, "vision") == 20


def test_the_program_block_sets_the_serving_precision():
    cfg = copy.deepcopy(micro.MICRO)
    cfg["program"]["config"].update(serve_quant="int8_static")
    cfg["control"] = {"program": {"serve_quant": "none"}}
    mc = harness.program_config(cfg)
    assert mc.quant == "int8" and mc.swin.quant == "int8_static"
    assert mc.text.quant == "int8_kernel"
    # the control runs what the file's control block says, and nothing else
    ctl = harness.program_config(cfg, variant="control")
    assert ctl.quant == "none" and ctl.swin.quant != "int8_static"
    assert harness.program_keys(micro.MICRO) == micro.MICRO["program"]["config"]


def test_a_calibration_path_is_taken_from_the_checkout():
    cfg = copy.deepcopy(micro.MICRO)
    cfg["program"]["config"].update(serve_quant="int8_static",
                                    swin_act_amax_path="mmrp_bench/calib/x.json")
    keys = harness.program_keys(cfg)
    assert keys["swin_act_amax_path"] == str(harness.ROOT / "mmrp_bench/calib/x.json")


@pytest.mark.parametrize("key", ["joint_dim", "quant", "text.quant", "swin.quant"])
def test_an_override_may_not_change_what_the_file_sets(key):
    with pytest.raises(ValueError, match="configuration file sets"):
        harness.program_config(micro.MICRO, {key: "int8" if "quant" in key else 64})


def test_the_launch_counters_are_found_by_walking_the_package(tmp_path, monkeypatch):
    pkg = tmp_path / "toyops"
    pkg.mkdir()
    (pkg / "__init__.py").write_text("")
    (pkg / "a.py").write_text("def k(x):\n    k.launches += 1\nk.launches = 0\n"
                              "k.launches_int8 = 2\nk.other = 5\n"
                              "from toyops.b import j\n")
    (pkg / "b.py").write_text("def j():\n    pass\nj.launches = 1\n")
    (pkg / "gone.py").write_text("import a_module_that_is_not_there\n")
    monkeypatch.syspath_prepend(str(tmp_path))
    found = trace.counter_sources("toyops")
    assert sorted(found) == ["a.k.launches", "a.k.launches_int8", "b.j.launches"]
    assert trace.counts(found) == (0, 2, 1)
    assert set(trace.counter_sources()) >= {"fused_attention.fused_attention.launches",
                                            "wattn_core.core_forward.launches"}


def test_port_kernels_are_classed_by_their_namespace():
    assert work.is_port_kernel("void mmrp::(anonymous namespace)::qkv_kernel<false>(x)")
    assert work.is_port_kernel("void mmrp::(anonymous namespace)::a_kernel_added_later(y)")
    assert not work.is_port_kernel("nvjet_tst_192x192_64x4_2x1_v_bz_coopB_bias_TNN")
    assert not work.is_port_kernel("void at::native::elementwise_kernel<128, 2>(int)")
