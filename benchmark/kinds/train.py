"""Training steps back to back, as ``cli/train.py --streaming off`` runs
them on a dataset held on the card.

Parameters: ``batch`` pairs a step, ``lr_size`` (LR side; HR is twice
it), ``pool`` batches made from the seed at set-up and cycled, each of
independent slices, as the trainer's shuffled loader gives them, ``crop``
and ``noise_std`` of the extraction's k-space degradation that makes each
LR from its HR, ``warmup`` steps after the three that are checked.

Set-up builds one training step and its state and drives it through its
first steps on distinct batches; the same object then runs the window.
The reference follows the first three from the same weights and batches.
One step of the window, at a time drawn from the seed in its second half,
is checked too: its params and Adam's state are copied before and after
it, and the reference takes the same step from the copy before.
``train_slices_per_s`` is the HR slices of every step enqueued in the
window over the time until the device finished them (one synchronise,
at the end).
"""

from __future__ import annotations

import time
from types import SimpleNamespace

import torch

from benchmark import measure, reference, systems, traffic

CHECKED_STEPS = 3


# the window's checked step starts at this share of it, drawn from the seed
CHECK_FROM = (0.5, 0.9)


def _batches(env):
    t = env.traffic
    n, s = t["batch"], t["lr_size"]
    out = []
    for b in range(t["pool"]):
        hr = traffic.phantoms(env.seed, 100 + b, n, 2 * s, 2 * s, env.device)
        lr = traffic.degrade(hr, env.seed, 100 + b, t["crop"], t["noise_std"])
        # the PNG codes the trainer reads
        hr, lr = (torch.round(x * 255.0) / 255.0 for x in (hr, lr))
        out.append({"hr": hr[..., None].contiguous(),
                    "lr": lr[..., None].contiguous(),
                    "weight": torch.ones(n, device=env.device)})
    return out


def setup(env):
    st = SimpleNamespace(env=env, attempted=0, failed=0, notes=[])
    clock = env.clock()
    st.pool = _batches(env)
    st.params = env.make_params()
    clock("inputs and weights")
    st.step = systems.make_trainer(env.system, env.cfg, env.ref, st.params,
                                   env.device)
    clock("program built")
    losses = []
    for i in range(CHECKED_STEPS):
        losses.append(st.step(st.pool[i]))
        if i == 0:
            st.first_grad = {k: v.clone()
                             for k, v in st.step.first_grad().items()}
    st.params3 = st.step.params()
    st.losses = [float(x) for x in losses]
    for i in range(env.traffic["warmup"]):
        st.step(st.pool[(CHECKED_STEPS + i) % len(st.pool)])
    st.next = CHECKED_STEPS + env.traffic["warmup"]
    env.sync()
    clock("steps")
    return st


def window(st, t0: float, seconds: float, tracer) -> None:
    t_end = t0 + seconds
    t_check = t0 + seconds * traffic.rng(st.env.seed, 11).uniform(
        *CHECK_FROM)
    st.work = []              # (call's start, its end, slices)
    st.checked = None
    n = 0
    losses = []
    while True:
        now = time.perf_counter()
        if now >= t_end:
            break
        tracer.tick(now)
        now = time.perf_counter()
        i = (st.next + n) % len(st.pool)
        batch = st.pool[i]
        before = None
        # the checked step, or the last that surely ends in the window
        if st.checked is None and (
                now >= t_check or now + 2 * (now - t0) / max(n, 1) >= t_end):
            before = st.step.snapshot()
        with tracer.span("train_step"):
            a = time.perf_counter()
            losses.append(st.step(batch))
            b = time.perf_counter()
        if before is not None:
            st.checked = (i, before, st.step.snapshot(), losses[-1])
        st.work.append((a, b, st.env.traffic["batch"]))
        n += 1
    tracer.stop()
    st.env.sync()
    st.t0, st.t_end = t0, time.perf_counter()
    st.window_s = st.t_end - t0
    st.steps = n
    st.attempted = n
    st.failed = int((~torch.isfinite(torch.stack(losses))).sum())
    st.wrong = st.failed > 0
    host = [e - s for s, e, _ in st.work]
    fifths = [host[i * n // 5:(i + 1) * n // 5] for i in range(5)] \
        if n >= 5 else [host]
    st.notes.append(f"train: {n} steps; host ms a step, median of each "
                    f"fifth of the window: "
                    f"{[1e3 * sorted(f)[len(f) // 2] for f in fifths]}")


def e2e(st) -> dict:
    return {"train_slices_per_s": measure.rate(
        st.steps * st.env.traffic["batch"], st.window_s)}


def reading(st) -> dict:
    t = st.env.traffic
    return {"t0": st.t0, "t_end": st.t_end, "work": st.work,
            "batch": t["batch"],
            "flops_per_slice": st.env.ref.flops_per_slice(
                st.env.cfg, t["lr_size"], t["lr_size"]),
            "b1_site_hw": (t["lr_size"], t["lr_size"])}


def release(st) -> None:
    st.step = None


def _gaps(prefix: str, got_g, want_g, got_d, want_d, p0) -> dict:
    """The gradient's and the change's numbers by worst leaf: the gaps of
    norms and the norms of the differences, over the leaves that move."""
    moving = reference.moving_leaves(want_g)
    d_got = {k: got_d[k] - p0[k] for k in moving}
    d_want = {k: want_d[k] - p0[k] for k in moving}
    out = {}
    for name, f, got, want in (
            ("grad_gap", reference.leaf_gaps, got_g, want_g),
            ("grad_diff", reference.leaf_diffs, got_g, want_g),
            ("change_gap", reference.leaf_gaps, d_got, d_want),
            ("change_diff", reference.leaf_diffs, d_got, d_want)):
        leaves = f(got, want, moving)
        v, leaf = reference.worst(leaves)
        out[prefix + name] = v
        out[f"{prefix}{name}.leaf"] = leaf
        out[f"{prefix}{name}.median"] = reference.median(leaves)
    out[prefix + "leaves"] = f"{len(moving)} of {len(want_g)}"
    return out


def check(st) -> dict:
    """Every number of the first three steps and of the window's checked
    step; those that the configuration's ``limits`` name are compared."""
    env = st.env
    lim = env.cfg["limits"]["train"]
    batches = [(b["lr"], b["hr"]) for b in st.pool[:CHECKED_STEPS]]
    args = (systems.LEARNING_RATE, systems.WEIGHT_DECAY, systems.SSIM_WEIGHT)
    with reference.fp32():
        losses, g1, p3 = reference.train_steps(env.ref.forward, st.params,
                                               batches, *args)
    nums = {"loss_gap": max(abs(a - b) / abs(b)
                            for a, b in zip(st.losses, losses))}
    nums.update(_gaps("", st.first_grad, g1, st.params3, p3, st.params))
    if st.checked is not None:
        i, before, after, loss = st.checked
        b1 = reference.ADAM_BETAS[0]
        got_g = {k: (after["exp_avg"][k] - b1 * before["exp_avg"][k])
                 / (1.0 - b1) for k in before["exp_avg"]}
        b = st.pool[i]
        with reference.fp32():
            (ref_loss,), g, p1 = reference.train_steps(
                env.ref.forward, before["params"], [(b["lr"], b["hr"])],
                *args, state=before)
        nums["step_loss_gap"] = abs(float(loss) - ref_loss) / abs(ref_loss)
        nums.update(_gaps("step_", got_g, g, after["params"], p1,
                          before["params"]))
        nums["step_at"] = int(before["step"])
    st.numbers = nums
    st.notes.append(f"train numbers: {nums}; reference losses {losses}")
    inf = float("inf")
    return {k: (nums.get(k, inf), v) for k, v in lim.items()}
