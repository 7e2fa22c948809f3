"""Drives ``train.joint.make_train_step(model, cfg, pos_weight)``'s
``step(state, batch)`` on batches already on the device.

Set-up builds one model and one train state from the seed (the benchmark's
weights and KG projection), makes a ring of distinct batches on the device,
and runs the first steps on ring batches 0, 1, 2, ... through the same
``step`` the window calls: those steps warm every shape, and what they
leave (each step's loss, the optimizer's second moment after step 1, the
masters after the reference's steps) is what the first check compares. The
window then continues round the ring for ``--seconds``; every step ends in
the host reading its metrics, so a step completes when ``step`` returns.
Before each of the window's last steps (those that may be its last, by the
mean step time so far) the state's masters and moments are copied aside,
so that the window's last step, a timed one, is checked too.

The check, once the window has closed and the program is freed, against
the plain float32 reference (``reference/train.py``):

- the start: the reference takes the same first steps from the same
  weights on the same batches. Compared: each step's loss (relative gap),
  each parameter's change over those steps (:func:`change_gap`), and the
  first gradient as the optimizer got it, coordinate by coordinate, from
  its second moment after step 1: |g| = sqrt(nu / (1 - b2)) times the
  clip's factor, the step's global norm (:func:`coord_gap`).
- the window's last step: the reference takes that step from the
  program's own masters and moments as they were before it (the harness
  counts the step, and the batch is the ring's), on the same batch.
  Compared: the step's loss and each parameter's change over the step.

Read and not compared: the norms of those first gradients, parameter by
parameter (:func:`compare`). Parameters whose reference gradient is under a
thousandth of the median's move by round-off alone under Adam and are left
out of a change and of the first gradient.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from mmrp_bench import gen, harness, work
from mmrp_bench.reference import quant as Q
from mmrp_bench.reference.train import AdamW, gradients
from mmrp_bench.trace import counter_sources, counts, growth, kinds_line, reduce_profile


def make_ring(ctx, device=None):
    """Device batches of the ring and the valid lengths of each."""
    tr, cfg = ctx.traffic, ctx.config
    dev = device or ctx.device
    B, R = tr["batch"], tr["ring"]
    text = dict(tr["text"], vocab_size=cfg["text"]["vocab_size"])
    ids, mask, L = gen.texts(B * R, text, ctx.seed, dev)
    images = gen.model_images(B * R, tr["image"], ctx.seed, dev)
    labels = gen.labels(B * R, cfg["num_classes"], tr["labels_p"], ctx.seed, dev)
    kg = gen.kg_targets(B * R, tr["kg_dim"], ctx.seed, dev)
    ring = [{"image": images[i * B:(i + 1) * B], "input_ids": ids[i * B:(i + 1) * B].long(),
             "attention_mask": mask[i * B:(i + 1) * B].long(),
             "labels": labels[i * B:(i + 1) * B], "kg_target": kg[i * B:(i + 1) * B],
             "kg_target_valid": torch.ones(B, device=dev)} for i in range(R)]
    pw = gen.pos_weight(labels.cpu().numpy(), tr["train_config"]["pos_weight_clamp_max"])
    return ring, [L[i * B:(i + 1) * B] for i in range(R)], pw


def optimizer_spec(tr) -> dict:
    c = tr["train_config"]
    return {"lr": c["lr"], "total_steps": tr["total_steps"], "warmup_frac": 0.1,
            "weight_decay": 0.01, "clip_norm": 1.0, "mu_bf16": c["adam_mu_bf16"]}


def _snapshot(state, keys):
    """Buffers for the masters and moments, allocated once at set-up."""
    return {part: [torch.empty_like(getattr(state, part)[k]) for k in keys]
            for part in ("params", "mu", "nu")}


def _copy_state(snap, state, keys) -> None:
    for part in ("params", "mu", "nu"):
        torch._foreach_copy_(snap[part], [getattr(state, part)[k] for k in keys])


def run(ctx) -> dict:
    from mmrp_tpu_torch.config import Config
    from mmrp_tpu_torch.train.joint import init_train_state, make_train_step

    tr, cfg = ctx.traffic, ctx.config
    B, n_ref = tr["batch"], tr["reference_steps"]
    cuda = torch.device(ctx.device).type == "cuda"
    ctx.phase("imports")
    model, w = harness.build_model(ctx, tr.get("model_overrides"))
    sch = harness.schema(model)
    ctx.phase("model and weights")
    tcfg = Config(**tr["train_config"])
    D = cfg["fusion"]["joint_dim"]
    state = init_train_state(model, tcfg, seed=tcfg.seed, total_steps=tr["total_steps"],
                             kg_dim=tr["kg_dim"])
    kg0 = gen.kg_proj(D, tr["kg_dim"], ctx.seed, ctx.device)
    state.params["kg_proj"].copy_(kg0)
    ring, ring_len, pw = make_ring(ctx)
    step = make_train_step(model, tcfg, pw)
    R = len(ring)
    names = list(state.params)
    ctx.phase("state and ring")

    # the first steps, through the window's own call
    losses, g1 = [], None
    t_steps = []
    for s in range(n_ref):
        t1 = time.perf_counter()
        _, m = step(state, ring[s % R])
        t_steps.append(time.perf_counter() - t1)
        losses.append(m["loss/total"])
        if s == 0:
            # nu = (1 - b2) g^2 after one step, and nu >= 0: its 1-norm is
            # (1 - b2) times the squared norm of the clipped gradient; the
            # clip's factor is the step's global norm (the step's metric)
            nu = [state.nu[k] for k in names]
            clip = max(m["grad_norm"], 1.0)
            g1 = (torch.stack(torch._foreach_norm(nu, 1)).double() / (1 - 0.999)).sqrt()
            g1 = g1.cpu().numpy() * clip
            # and coordinate by coordinate: |g| = sqrt(nu / (1 - b2)) times the factor
            g1_abs = torch._foreach_mul(nu, clip ** 2 / (1 - 0.999))
            torch._foreach_sqrt_(g1_abs)
    p0 = [w[k].float() if k in w else kg0 for k in names]
    d3 = torch.stack(torch._foreach_norm(torch._foreach_sub([state.params[k] for k in names],
                                                            p0)))
    d3 = d3.double().cpu().numpy()
    del p0, w, kg0
    ctx.phase("first steps")
    i = n_ref
    for _ in range(tr["warmup_steps"]):
        t1 = time.perf_counter()
        step(state, ring[i % R])
        t_steps.append(time.perf_counter() - t1)
        i += 1
    snap = _snapshot(state, names)
    _copy_state(snap, state, names)  # its first copy, before the window
    if cuda:
        torch.cuda.synchronize()

    counters = counter_sources() if (ctx.trace and cuda) else None
    # whole steps: the window closes with the first step that ends at or
    # after --seconds, and the rate is all its steps over all its time
    t0 = time.perf_counter()
    setup_s = t0 - ctx.t_start
    ctx.phase("window opens")
    first, elapsed, snap_at, m = i, 0.0, None, None
    mean = float(np.mean(t_steps[1:] or t_steps))
    while elapsed < ctx.seconds:
        if elapsed + SNAP_AHEAD * mean >= ctx.seconds:
            _copy_state(snap, state, names)
            snap_at = i
        _, m = step(state, ring[i % R])
        now = time.perf_counter() - t0
        i += 1
        mean = now / (i - first)
        elapsed = now
    n_in = i - first
    useful = sum(work.batch_flops(cfg, ring_len[j % R]) for j in range(first, i))
    out = {"setup_s": setup_s, "attempted": n_in,
           "end_to_end": {"train_pairs_per_s": n_in * B / elapsed}}
    data = {"window": {"seconds": elapsed, "steps": n_in, "pairs": n_in * B,
                       "useful_flops": 3 * useful}}
    if snap_at != i - 1:  # a step far over the mean closed the window: check one more
        ctx.log(f"the window's last step {i - 1} was not copied aside; checking step {i}")
        _copy_state(snap, state, names)
        snap_at = i
        _, m = step(state, ring[i % R])
        i += 1
    last = {"step": snap_at, "loss": m["loss/total"],
            "d": torch.stack(torch._foreach_norm(torch._foreach_sub(
                [state.params[k] for k in names], snap["params"]))).double().cpu().numpy()}
    if counters is not None:
        data["trace"] = profile_steps(ctx, step, state, ring, i, counters)
    if cuda:
        torch.cuda.synchronize()
        out["memory_peak_bytes"] = torch.cuda.max_memory_allocated()
    del step, state, model, ring, m
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    prog = {"losses": losses, "g1": g1, "g1_abs": dict(zip(names, g1_abs)), "d3": d3,
            "names": names}
    ref = reference_steps(ctx, sch, n_ref)
    checks, grad_gap = compare(prog, ref, ctx.limits)
    ref_last = reference_step(ctx, sch, dict(zip(names, snap["params"])),
                              dict(zip(names, snap["mu"])), dict(zip(names, snap["nu"])),
                              last["step"])
    del snap
    checks += compare_last(last, ref_last, names, ctx.limits)
    out["checks"] = checks
    ctx.log(f"reading grad_norm_median_gap {grad_gap!r} (not compared); last step "
            f"{last['step']} of {first}..{i - 1}")
    out["failed"] = 0
    out["layer_data"] = data
    return out


# the window's steps copied aside: those that begin within this many mean
# step times of the window's close
SNAP_AHEAD = 2.5


def profile_steps(ctx, step, state, ring, i, counters) -> dict:
    """``trace_steps`` steps under the profiler, device activity only: the
    step issues about ten thousand launches, and recording each on the host
    would slow the host, which paces this step, and read as idle device
    time. One step traced alone first gives the kernels a step launches; the
    traced steps have to hold that many each, with the same counter growth.
    The traced window runs from the first device operation to the end of
    the last."""
    from torch.profiler import ProfilerActivity, profile

    n = ctx.traffic["trace_steps"]
    R = len(ring)
    c0 = counts(counters)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step(state, ring[i % R])
        torch.cuda.synchronize()
    one = reduce_profile(prof, (), None)
    per_step = growth(c0, counts(counters))
    c1 = counts(counters)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for j in range(n):
            step(state, ring[(i + 1 + j) % R])
        torch.cuda.synchronize()
    red = reduce_profile(prof, (), None,
                         expect=(n * one["port_events"], n * one["device_events"]))
    if growth(c1, counts(counters)) != tuple(n * g for g in per_step):
        red["complete"] = False
        red["incomplete_why"].append("the traced steps made other wrapper calls")
    red["steps"] = n
    ctx.log(f"trace: complete {red['complete']} {red['incomplete_why']}, port kernels "
            f"{red['port_events']}, device operations {red['device_events']} "
            f"(one step: {one['port_events']}, {one['device_events']}); by kind: {kinds_line(red)}")
    return red


def _tf32_off(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


def _ref_batch(ctx, j: int, half: bool = False):
    ring, _, pw = make_ring(ctx)
    batch = ring[j % len(ring)]
    if half:
        batch = {k: v[: v.shape[0] // 2] for k, v in batch.items()}
    return batch, torch.from_numpy(pw).to(ctx.device)


def _ref_grad(ctx, sch, params, j: int, quant=None, half: bool = False):
    tr = ctx.traffic
    batch, pw = _ref_batch(ctx, j, half)
    return gradients(ctx.config, params, batch, tr["train_config"], pw,
                     rows=tr["check"]["rows_per_block"], quant=quant,
                     served={name: dtype for name, _, dtype in sch})


def reference_steps(ctx, sch, n_ref: int, quant=None, half: bool = False,
                    keep: bool = False) -> dict:
    """The reference's first ``n_ref`` steps from the benchmark's weights:
    each loss, each parameter's gradient at step 1 and its norm, each
    parameter's change. ``quant``: GEMMs in that precision (the control);
    ``half``: each batch's first half only (a planted fault); ``keep``: also
    the parameters and the optimizer after the steps."""
    tr, cfg = ctx.traffic, ctx.config
    dev = ctx.device
    _tf32_off(dev)
    params = {k: v.float() for k, v in gen.weights(sch, ctx.seed, dev).items()}
    params["kg_proj"] = gen.kg_proj(cfg["fusion"]["joint_dim"], tr["kg_dim"], ctx.seed, dev)
    p0 = {k: v.clone() for k, v in params.items()}
    opt = AdamW(optimizer_spec(tr), params)
    losses, g1 = [], None
    for s in range(n_ref):
        loss, _, grads = _ref_grad(ctx, sch, params, s, quant, half)
        opt.step(params, grads)
        losses.append(loss)
        if s == 0:
            g1 = {k: float(torch.linalg.vector_norm(v.double())) for k, v in grads.items()}
            g1_full = grads
        del grads
    d3 = {k: float(torch.linalg.vector_norm((params[k] - p0[k]).double())) for k in params}
    out = {"losses": losses, "g1": g1, "g1_full": g1_full, "d3": d3}
    if keep:
        out["params"], out["opt"] = params, opt
    return out


def reference_step(ctx, sch, params, mu, nu, count: int, quant=None,
                   half: bool = False) -> dict:
    """One reference step from a state (``params``, ``mu``, ``nu`` after
    ``count`` updates) on ring batch ``count``: its loss, each parameter's
    gradient norm and change. The state's tensors are not written."""
    _tf32_off(ctx.device)
    params = {k: v.float().clone() for k, v in params.items()}
    opt = AdamW(optimizer_spec(ctx.traffic), params)
    opt.mu = {k: v.clone() for k, v in mu.items()}
    opt.nu = {k: v.float().clone() for k, v in nu.items()}
    opt.count = count
    before = {k: v.clone() for k, v in params.items()}
    loss, _, grads = _ref_grad(ctx, sch, params, count, quant, half)
    g = {k: float(torch.linalg.vector_norm(v.double())) for k, v in grads.items()}
    opt.step(params, grads)
    del grads
    d = {k: float(torch.linalg.vector_norm((params[k] - before[k]).double())) for k in params}
    return {"loss": loss, "g": g, "d": d}


def change_gap(prog_d, ref_d, ref_g) -> float:
    """The worst parameter's gap of its change, against the larger of the
    reference's change and the median parameter's, over the parameters
    whose reference gradient is at least a thousandth of the median's."""
    moved = ref_g >= 1e-3 * np.median(ref_g)
    gap = np.abs(prog_d - ref_d) / np.maximum(ref_d, np.median(ref_d))
    return float(np.max(gap[moved]))


def coord_gap(prog_abs, ref_g, names, rg) -> float:
    """The median parameter's gap of the first gradient's magnitudes taken
    coordinate by coordinate, || |g| - |g_ref| || / ||g_ref||, over the
    parameters :func:`change_gap` keeps."""
    moved = rg >= 1e-3 * np.median(rg)
    gaps = [float(torch.linalg.vector_norm(prog_abs[k].double() - ref_g[k].double().abs()))
            / rg[i] for i, k in enumerate(names) if moved[i]]
    return float(np.median(gaps))


def compare(prog: dict, ref: dict, lim: dict) -> tuple:
    """(the start's compared numbers, the gradient's reading). Compared: the
    largest relative gap of a step's loss, :func:`change_gap` over the first
    steps, and :func:`coord_gap` of the first gradient.

    The step-1 gradient norms, parameter by parameter, are read and not
    compared: neither the worst parameter's gap (a few small parameters,
    such as the scalar residual gates, swing it from seed to seed) nor the
    median parameter's (a norm averages the coordinates' rounding away)
    reads three times apart between the program and the int8 control, so
    the first gradient is compared coordinate by coordinate; the norms'
    median reading is logged, for the record."""
    names = prog["names"]
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"]))
    rg = np.array([ref["g1"][k] for k in names])
    rd = np.array([ref["d3"][k] for k in names])
    grad_gap = float(np.median(np.abs(prog["g1"] - rg) / np.maximum(rg, np.median(rg))))
    return [("loss_gap", loss_gap, lim["loss_gap"]),
            ("change_norm_gap", change_gap(prog["d3"], rd, rg), lim["change_norm_gap"]),
            ("grad_coord_gap", coord_gap(prog["g1_abs"], ref["g1_full"], names, rg),
             lim["grad_coord_gap"])], grad_gap


def compare_last(last: dict, ref: dict, names, lim: dict) -> list:
    """The window's last step: the relative gap of its loss, and
    :func:`change_gap` over the step."""
    rg = np.array([ref["g"][k] for k in names])
    rd = np.array([ref["d"][k] for k in names])
    return [("last_loss_gap", abs(last["loss"] - ref["loss"]) / abs(ref["loss"]),
             lim["last_loss_gap"]),
            ("last_change_gap", change_gap(np.asarray(last["d"]), rd, rg),
             lim["last_change_gap"])]


def readings(ctx, mode: str) -> list:
    """The compared numbers of the reference put in the program's place:
    ``control`` (int8 GEMMs) or ``half`` (half of each batch left out, the
    mean taken over the rest), against the float32 reference: over the
    first steps from the seed, and over the step after them from the
    float32 reference's state."""
    from mmrp_tpu_torch.models.multimodal import MultiModalRetrievalModel

    n_ref = ctx.traffic["reference_steps"]
    mc = harness.program_config(ctx.config, ctx.traffic.get("model_overrides"))
    sch = harness.schema(MultiModalRetrievalModel(
        mc, dtype=harness.dtype_of(ctx.config["serve_dtype"]), device="cpu"))
    quant = Q.int8 if mode == "control" else None
    ref = reference_steps(ctx, sch, n_ref, keep=True)
    alt = reference_steps(ctx, sch, n_ref, quant=quant, half=mode == "half")
    names = [n for n, _, _ in sch] + ["kg_proj"]
    prog = {"losses": alt["losses"], "names": names,
            "g1": np.array([alt["g1"][k] for k in names]),
            "g1_abs": {k: v.abs() for k, v in alt["g1_full"].items()},
            "d3": np.array([alt["d3"][k] for k in names])}
    checks, grad_gap = compare(prog, ref, ctx.limits)
    opt = ref["opt"]
    base = reference_step(ctx, sch, ref["params"], opt.mu, opt.nu, n_ref)
    other = reference_step(ctx, sch, ref["params"], opt.mu, opt.nu, n_ref, quant=quant,
                           half=mode == "half")
    checks += compare_last({"loss": other["loss"], "d": [other["d"][k] for k in names]},
                           base, names, ctx.limits)
    return checks + [("grad_norm_median_gap", grad_gap, None)]
