"""The control: the nearest precision below the configuration's bfloat16.
For the stream, the program's own int8 serving path; for the train step,
the reference with every GEMM in int8 in the program's place. On the CPU at
micro sizes the control reads far above the sound program; on the card, at
the cell's own size, the control comes out not correct against the cell's
limits and the program correct (``-m cuda``)."""

import pytest

from mmrp_bench import harness
from mmrp_bench.run import is_correct
from mmrp_bench.tests import micro


def readings(checks):
    return {n: v for n, v, _ in checks}


def test_stream_control_reads_far_above_the_program():
    sound = readings(harness.driver("stream").run(
        micro.ctx(micro.MICRO, micro.stream_traffic(), "flagship.stream-openi", seed=31))["checks"])
    low = readings(harness.driver("stream").run(
        micro.ctx(micro.MICRO, micro.stream_traffic(), "flagship.stream-openi", seed=31,
                  variant="control"))["checks"])
    for name in ("emb_cos_gap", "logit_cos_gap"):
        assert low[name] > 1e-6 and low[name] > 100 * sound[name], name


def test_train_control_reads_far_above_the_program():
    drv = harness.driver("train")
    sound = readings(drv.run(micro.ctx(micro.MICRO, micro.train_traffic(),
                                       "flagship.train-openi", seed=32, seconds=0.2))["checks"])
    low = readings(drv.readings(micro.ctx(micro.MICRO, micro.train_traffic(),
                                          "flagship.train-openi", seed=32), "control"))
    assert low["loss_gap"] > 1e-4 and low["loss_gap"] > 100 * sound["loss_gap"]
    assert low["grad_coord_gap"] > 1e-3 and low["grad_coord_gap"] > 100 * sound["grad_coord_gap"]


def cell_ctx(name, seed, **kw):
    bench = harness.benchmark()
    cell = harness.workload(bench, name)
    return harness.Ctx(cell=name, config=harness.config_file(bench, cell["config"]),
                       traffic=harness.traffic_file(cell["traffic"]),
                       limits=harness.limits_file(name), seed=seed, seconds=2.0, trace=False,
                       device="cuda", **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["flagship.stream-openi", "medclip.stream-openi"])
def test_stream_control_fails_the_limits_on_the_card(card, name):
    drv = harness.driver("stream")
    assert is_correct(drv.run(cell_ctx(name, 3_500_000_001))["checks"])
    assert not is_correct(drv.run(cell_ctx(name, 3_500_000_001, variant="control"))["checks"])


@pytest.mark.cuda
def test_train_control_fails_the_limits_on_the_card(card):
    checks = harness.driver("train").readings(cell_ctx("flagship.train-openi", 3_500_000_002),
                                              "control")
    assert not is_correct([c for c in checks if c[2] is not None])
