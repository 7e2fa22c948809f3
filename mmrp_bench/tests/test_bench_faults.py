"""A run with the timed path broken underneath comes out not correct: the
harness's run without its look for a chip, at micro sizes on the CPU, once
for each fault a cell can have (one chip: no exchange between chips)."""

import pytest
import torch

from mmrp_bench import harness
from mmrp_bench.run import is_correct
from mmrp_bench.tests import micro


def stream_run():
    return harness.driver("stream").run(
        micro.ctx(micro.MICRO, micro.stream_traffic(), "flagship.stream-openi", seed=21))


def train_run():
    return harness.driver("train").run(
        micro.ctx(micro.MICRO, micro.train_traffic(), "flagship.train-openi", seed=22,
                  seconds=0.2))


def test_sound_runs_are_correct():
    assert is_correct(stream_run()["checks"])
    assert is_correct(train_run()["checks"])


def _forward_fault(kind):
    from mmrp_tpu_torch.api import serving_forward

    def faulty(model):
        fwd = serving_forward(model)

        def call(image, ids, mask):
            if kind == "half":  # half of the batch left out, its rows' answers copied
                h = ids.shape[0] // 2
                out = fwd(image[:h], ids[:h], mask[:h])
                return {k: torch.cat([v, v[: ids.shape[0] - h]]) for k, v in out.items()}
            out = dict(fwd(image, ids, mask))
            emb = out["joint_emb"].clone()
            emb[0] = emb[0] + 0.05 * emb[0].abs().mean()  # an answer altered where made
            out["joint_emb"] = emb
            return out

        return call

    return faulty


@pytest.mark.parametrize("kind", ["embedding", "half"])
def test_stream_forward_faults_are_not_correct(monkeypatch, kind):
    from mmrp_tpu_torch.serve import stream

    monkeypatch.setattr(stream, "serving_forward", _forward_fault(kind))
    assert not is_correct(stream_run()["checks"])


def test_stream_altered_retrieval_answer_is_not_correct(monkeypatch):
    from mmrp_tpu_torch.serve.stream import StreamingPipeline

    finish = StreamingPipeline._finish

    def altered(self, batch, host, done):
        res = finish(self, batch, host, done)
        top = res["retrieval"][0]
        res["retrieval"][0] = [(str((int(top[-1][0]) + 1) % len(self.engine.ids)), top[-1][1])
                               ] + top[1:]
        return res

    monkeypatch.setattr(StreamingPipeline, "_finish", altered)
    out = stream_run()
    assert dict((n, v) for n, v, _ in out["checks"])["topk_misses"] > 0
    assert not is_correct(out["checks"])


def test_train_step_that_leaves_its_state_unchanged_is_not_correct(monkeypatch):
    from mmrp_tpu_torch.train import state

    def unchanged(self, st, grads, norm=None):
        return float(state.global_norm([g.float() for g in grads.values()]))

    monkeypatch.setattr(state.AdamW, "apply", unchanged)
    out = train_run()
    readings = dict((n, v) for n, v, _ in out["checks"])
    assert readings["change_norm_gap"] >= 0.99 and readings["last_change_gap"] >= 0.99
    assert readings["grad_coord_gap"] >= 0.99  # no second moment: no gradient
    assert not is_correct(out["checks"])


def test_train_step_on_half_the_batch_is_not_correct(monkeypatch):
    from mmrp_tpu_torch.train import joint

    make = joint.make_train_step

    def half(model, cfg, pos_weight=None):
        step = make(model, cfg, pos_weight)
        return lambda st, batch: step(st, {k: v[: v.shape[0] // 2] for k, v in batch.items()})

    monkeypatch.setattr(joint, "make_train_step", half)
    assert not is_correct(train_run()["checks"])


def test_train_step_that_changes_after_the_warm_up_is_not_correct(monkeypatch):
    """A step that is sound through set-up and goes wrong in the window (as
    one captured or cached on first use could) fails the last step's check."""
    from mmrp_tpu_torch.train import joint

    make = joint.make_train_step
    traffic = micro.train_traffic()
    sound_calls = traffic["reference_steps"] + traffic["warmup_steps"]

    def late_fault(model, cfg, pos_weight=None):
        step = make(model, cfg, pos_weight)
        calls = [0]

        def call(st, batch):
            calls[0] += 1
            if calls[0] > sound_calls:
                batch = {k: v[: v.shape[0] // 2] for k, v in batch.items()}
            return step(st, batch)

        return call

    monkeypatch.setattr(joint, "make_train_step", late_fault)
    out = harness.driver("train").run(
        micro.ctx(micro.MICRO, traffic, "flagship.train-openi", seed=23, seconds=0.2))
    readings = dict((n, v) for n, v, _ in out["checks"])
    assert readings["loss_gap"] < 1e-5 and readings["change_norm_gap"] < 1e-2
    assert not is_correct(out["checks"])
