"""The port's spans (``utils/spans.py``) on the CPU: nothing while no
profiler runs; under ``torch.profiler`` nested and threaded spans kept on
the profiler's clock; the store bounded; one span of each of the engine's
dispatch steps a batch and of each of the train step's phases; and the
spans named in ``--profile_dir``'s Chrome trace. On the card (marked
``cuda``): a page-locked volume's lock spans, and the forward and the
train phases timed by their events."""

import json
import threading
import time
from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from mri_superresolution_torch import native
from mri_superresolution_torch.cli import train as cli
from mri_superresolution_torch.config import LossConfig, ModelConfig
from mri_superresolution_torch.infer import InferenceEngine
from mri_superresolution_torch.losses import CombinedLoss
from mri_superresolution_torch.models import build_model
from mri_superresolution_torch.train import trainer
from mri_superresolution_torch.utils import spans
from mri_superresolution_torch.utils.phantom import phantom_batch

torch.set_num_threads(2)

DISPATCH = ("engine.upload", "engine.normalize", "engine.forward",
            "engine.pack", "engine.fetch")
PHASES = ("train.forward", "train.loss", "train.backward", "train.update")


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def _kept(lo):
    return spans.records(lo, time.time_ns())


def _inside(inner, outer) -> bool:
    return outer.start_ns <= inner.start_ns and inner.end_ns <= outer.end_ns


def test_off_is_the_shared_no_op(monkeypatch):
    def no_event(*a, **k):
        raise AssertionError("an event was made with the profiler off")
    monkeypatch.setattr(torch.cuda, "Event", no_event)
    lo = time.time_ns()
    assert not spans.profiling()
    for dev in (None, torch.device("cpu"), torch.device("cuda")):
        s = spans.span("engine.forward", dev)
        assert s is spans.OFF
        with s:
            pass
    assert _kept(lo) == []


def test_nested_and_threaded_spans_are_kept():
    lo = time.time_ns()

    def other():
        with spans.span("engine.collect"):
            pass

    with _cpu_profile():
        with spans.span("engine.dispatch"):
            with spans.span("engine.upload"):
                torch.ones(8) + 1
        t = threading.Thread(target=other)
        t.start()
        t.join(timeout=30)
    assert not t.is_alive()
    got = {r.name: r for r in _kept(lo)}
    assert set(got) == {"engine.dispatch", "engine.upload", "engine.collect"}
    assert _inside(got["engine.upload"], got["engine.dispatch"])
    assert got["engine.upload"].thread == got["engine.dispatch"].thread \
        == threading.get_ident()
    assert got["engine.collect"].thread == t.ident
    assert all(r.events is None for r in got.values())


def test_records_lie_inside_their_profiler_events():
    """Each kept interval lies within the ``user_annotation`` event of the
    same span, less than a millisecond inside each end: the record and the
    trace share one clock."""
    with _cpu_profile():                 # the first range of a process is
        with record_function("warm"):    # slow to enter
            pass
    lo = time.time_ns()
    with _cpu_profile() as p:
        for i in range(3):
            with spans.span(f"train.step{i}"):
                with spans.span(f"train.forward{i}"):
                    torch.ones(64, 64) @ torch.ones(64, 64)
    kept = {r.name: r for r in _kept(lo)}
    events = {e.name(): e for e in p.profiler.kineto_results.events()
              if e.name() in kept}
    assert set(events) == set(kept) and len(kept) == 6
    for name, r in kept.items():
        ev = events[name]
        assert ev.is_user_annotation()
        start, end = ev.start_ns(), ev.start_ns() + ev.duration_ns()
        assert 0 <= r.start_ns - start < 1_000_000, name
        assert 0 <= end - r.end_ns < 1_000_000, name


def test_the_store_is_bounded_and_reports_what_it_dropped():
    rec = spans.Recorder(maxlen=4)
    for i in range(6):
        rec.keep(spans.Record(f"s{i}", 10 * i, 10 * i + 5, 1, None))
    assert [r.name for r in rec.records(0, 100)] == ["s2", "s3", "s4", "s5"]
    assert [r.name for r in rec.records(20, 35)] == ["s2", "s3"]
    # s0 and s1 were dropped: s1 ended at 15
    assert rec.overflowed(15) and rec.overflowed(0)
    assert not rec.overflowed(16)
    assert not spans.Recorder(maxlen=4).overflowed(0)


class _FakeEvent:
    made = []

    def __init__(self, enable_timing=False):
        assert enable_timing
        self.stream = None
        _FakeEvent.made.append(self)

    def record(self, stream):
        self.stream = stream

    def elapsed_time(self, end):
        if end.stream is None:
            raise RuntimeError("event not recorded")
        return 2.5


def test_a_device_span_times_its_devices_current_stream(monkeypatch):
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device: ("stream of", device))
    _FakeEvent.made.clear()
    lo = time.time_ns()
    dev = torch.device("cuda", 1)
    with _cpu_profile():
        with spans.span("train.backward", dev):
            pass
        with spans.span("train.step"):
            pass
    got = {r.name: r for r in _kept(lo)}
    start, end = got["train.backward"].events
    assert [start, end] == _FakeEvent.made
    assert start.stream == end.stream == ("stream of", dev)
    assert spans.device_ms(got["train.backward"]) == 2.5
    assert got["train.step"].events is None
    assert spans.device_ms(got["train.step"]) is None
    end.stream = None
    assert spans.device_ms(got["train.backward"]) is None


def test_the_engine_keeps_one_dispatch_span_of_each_a_batch():
    model = build_model(ModelConfig(base_filters=16),
                        generator=torch.Generator().manual_seed(0))
    eng = InferenceEngine(ModelConfig(base_filters=16), model.state_dict(),
                          bf16=False, out_dtype=np.int16, device="cpu",
                          normalize_inputs=True, transpose_io=True)
    rng = np.random.default_rng(0)
    vol = (rng.random((5, 16, 24)) * 900).astype(np.int16)
    lo = time.time_ns()
    with _cpu_profile():
        with eng.page_locked(vol):
            outs = list(eng.upscale_batches(
                (vol[s:s + 2] for s in range(0, 5, 2)), depth=2))
        eng.upscale_batch(vol[:1])
    assert [o.shape[0] for o in outs] == [2, 2, 1]
    kept = _kept(lo)
    counts = Counter(r.name for r in kept)
    # 4 batches; no page-lock on the CPU
    assert counts == Counter({n: 4 for n in
                              ("engine.dispatch", "engine.collect")
                              + DISPATCH})
    dispatches = [r for r in kept if r.name == "engine.dispatch"]
    for r in kept:
        if r.name in DISPATCH:
            assert sum(_inside(r, d) for d in dispatches) == 1, r.name
        if r.name == "engine.collect":
            assert not any(_inside(r, d) for d in dispatches)


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_the_train_step_keeps_its_phases(grad_accum):
    model = build_model(ModelConfig(base_filters=16),
                        generator=torch.Generator().manual_seed(0))
    st = trainer.TrainState(model, trainer.make_optimizer(
        model.parameters(), 1e-4, 1e-5), 0,
        {k: p.detach().clone() for k, p in model.named_parameters()})
    step = trainer.build_train_step(CombinedLoss(LossConfig()), None,
                                    grad_accum, 0.9)
    rng = np.random.default_rng(2)
    batch = {"lr": torch.from_numpy(phantom_batch(rng, 4, 16)[..., None]),
             "hr": torch.from_numpy(phantom_batch(rng, 4, 32)[..., None]),
             "weight": torch.ones(4)}
    lo = time.time_ns()
    with _cpu_profile():
        for _ in range(2):
            step(st, batch, 1e-4)
    kept = _kept(lo)
    counts = Counter(r.name for r in kept)
    assert counts["train.step"] == 2
    for name in PHASES[:3]:
        assert counts[name] == 2 * grad_accum, name
    assert counts["train.update"] == 2
    steps = [r for r in kept if r.name == "train.step"]
    for r in kept:
        if r.name in PHASES:
            assert sum(_inside(r, s) for s in steps) == 1, r.name


@pytest.fixture(scope="module")
def pngs(tmp_path_factory):
    """8 phantom pairs (LR 16², HR 32²) of 2 subjects."""
    d = tmp_path_factory.mktemp("pngs")
    hr = phantom_batch(np.random.default_rng(1), 8, 32)
    lr = phantom_batch(np.random.default_rng(1), 8, 16)
    for sub in ("hr", "lr"):
        (d / sub).mkdir()
    for i in range(8):
        name = f"sub-{i // 4:02d}_T1w_s{i:03d}.png"
        native.imwrite_gray(str(d / "hr" / name),
                            np.round(hr[i] * 255).astype(np.uint8))
        native.imwrite_gray(str(d / "lr" / name),
                            np.round(lr[i] * 255).astype(np.uint8))
    return d


def test_profile_dir_trace_names_the_train_spans(pngs, tmp_path, capsys):
    prof = tmp_path / "prof"
    ck = tmp_path / "ck"
    cli.main(["--full_res_dir", str(pngs / "hr"), "--low_res_dir",
              str(pngs / "lr"), "--base_filters", "16", "--batch_size", "4",
              "--epochs", "1", "--seed", "3", "--cpu", "--checkpoint_dir",
              str(ck), "--log_dir", str(ck / "logs"),
              "--profile_dir", str(prof)])
    capsys.readouterr()
    with open(prof / "trace_epoch0.json") as f:
        events = json.load(f)["traceEvents"]
    names = Counter(e.get("name", "") for e in events
                    if e.get("cat") == "user_annotation")
    assert names["train.step"] >= 1, sorted(names)
    for name in PHASES:
        assert names[name] == names["train.step"], (name, names)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
def test_on_the_card_a_volume_keeps_its_lock_spans_and_events(card):
    """A page-locked volume on the card: one ``engine.page_lock`` and one
    ``engine.unlock`` around its batches, and each forward timed on the
    compute stream."""
    model = build_model(ModelConfig(base_filters=16),
                        generator=torch.Generator().manual_seed(0))
    eng = InferenceEngine(ModelConfig(base_filters=16), model.state_dict(),
                          bf16=True, out_dtype=np.int16, device=card,
                          normalize_inputs=True, transpose_io=True)
    vol = (np.random.default_rng(0).random((5, 32, 40)) * 900).astype(
        np.int16)
    eng.upscale_batch(vol[:2])
    lo = time.time_ns()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        with eng.page_locked(vol):
            outs = list(eng.upscale_batches(
                (vol[s:s + 2] for s in range(0, 5, 2)), depth=2))
    torch.cuda.synchronize()
    assert [o.shape for o in outs] == [(2, 64, 80), (2, 64, 80), (1, 64, 80)]
    kept = _kept(lo)
    counts = Counter(r.name for r in kept)
    assert counts == Counter({"engine.page_lock": 1, "engine.unlock": 1,
                              **{n: 3 for n in ("engine.dispatch",
                                                "engine.collect")
                                 + DISPATCH}})
    by = {r.name: r for r in kept}
    assert by["engine.page_lock"].end_ns <= min(
        r.start_ns for r in kept if r.name == "engine.dispatch")
    assert by["engine.unlock"].start_ns >= max(
        r.end_ns for r in kept if r.name == "engine.collect")
    for r in kept:
        ms = spans.device_ms(r)
        if r.name == "engine.forward":
            assert ms is not None and ms > 0
        else:
            assert ms is None


@pytest.mark.cuda
def test_on_the_card_the_train_phases_are_timed(card):
    model = build_model(ModelConfig(base_filters=16), dtype=torch.bfloat16,
                        generator=torch.Generator().manual_seed(0)).to(card)
    st = trainer.TrainState(model, trainer.make_optimizer(
        model.parameters(), 1e-4, 1e-5))
    step = trainer.build_train_step(CombinedLoss(LossConfig()))
    rng = np.random.default_rng(2)
    batch = {"lr": torch.from_numpy(phantom_batch(rng, 4, 32)[..., None]),
             "hr": torch.from_numpy(phantom_batch(rng, 4, 64)[..., None]),
             "weight": torch.ones(4)}
    batch = {k: v.to(card) for k, v in batch.items()}
    step(st, batch, 1e-4)
    lo = time.time_ns()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        for _ in range(2):
            step(st, batch, 1e-4)
    torch.cuda.synchronize()
    kept = _kept(lo)
    assert Counter(r.name for r in kept) == Counter(
        {n: 2 for n in ("train.step",) + PHASES})
    for r in kept:
        ms = spans.device_ms(r)
        if r.name == "train.step":
            assert ms is None
        else:
            assert ms is not None and ms > 0, r.name
