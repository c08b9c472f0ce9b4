"""The port's spans (``utils/profiling.py``) on the CPU: the no-op they
are with no profiler running; the sliding window's, the NIfTI ingest's
and the train step's spans under ``torch.profiler``, one request id per
case or step, carried across the pipeline's stages and its IO worker;
``trace(logdir)`` writing them beside the Chrome trace; and
``perfbench/spans.py``, which the benchmark's per-layer metrics read them
through, on made-up records."""

import importlib.util
import json
import os
import sys
import threading
from collections import Counter, defaultdict
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from fetal_mri_segmentation_tpu_torch.config import Config  # noqa: E402
from fetal_mri_segmentation_tpu_torch.inference.predict import (  # noqa: E402
    build_serving_predictor, make_device_preprocessor,
    predict_cases_pipelined)
from fetal_mri_segmentation_tpu_torch.models import build_model  # noqa: E402
from fetal_mri_segmentation_tpu_torch.training.state import (  # noqa: E402
    create_train_state)
from fetal_mri_segmentation_tpu_torch.training.train_step import (  # noqa: E402
    make_train_step)
from fetal_mri_segmentation_tpu_torch.utils import profiling  # noqa: E402
from fetal_mri_segmentation_tpu_torch.utils.nifti import save_nifti  # noqa: E402

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
WINDOW = ["window.case", "window.stage", "window.gather", "window.model",
          "window.overlap_add", "window.finish", "window.fetch"]
INGEST = ["ingest.case", "ingest.read", "ingest.write"]
TRAIN = ["train.step", "train.augment", "train.forward", "train.backward",
         "train.update"]


def _profiled(fn):
    """``fn()`` under a CPU ``torch.profiler`` session, from an empty
    recorder; returns (fn's result, the span records, the profiler's
    event names)."""
    profiling.reset_spans()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    events = list(prof.profiler.kineto_results.events())
    return out, profiling.span_records(), events


def _by_request(records):
    groups = defaultdict(list)
    for r in records:
        groups[r["request"]].append(r)
    return groups


@pytest.fixture(scope="module")
def unet():
    cfg = Config(image_shape=(20, 20, 20), patch_shape=(16, 16, 16),
                 depth=2, n_base_filters=4, compute_dtype="float32",
                 fold_level0="off")
    torch.manual_seed(0)
    return cfg, build_model(cfg, "cpu")


def test_off_is_one_shared_noop_and_records_nothing(monkeypatch):
    entered = []
    monkeypatch.setattr(profiling, "_RecordFunctionFast",
                        lambda name: entered.append(name))

    class NoClock:
        def time_ns(self):
            raise AssertionError("the clock was read with no profiler")

    monkeypatch.setattr(profiling, "time", NoClock())
    profiling.reset_spans()
    a, b = profiling.span("window.case"), profiling.span("train.step", 7)
    assert a is b
    with a as s:
        assert s.request is None
        with profiling.span("window.model"):
            pass
    obj = np.zeros(3)
    assert profiling.tag(obj) is obj
    assert profiling.request_of(obj) is None
    assert profiling.span_records() == []
    assert entered == []


@pytest.mark.parametrize("batch", [4, 27])
def test_one_case_through_the_window_is_one_request(unet, batch):
    cfg, model = unet
    predictor = build_serving_predictor(model, cfg, overlap=4,
                                        patch_batch_size=batch)
    vol = np.random.default_rng(0).normal(
        size=(1,) + cfg.image_shape).astype(np.float32)

    def case():
        return predictor.unpack_labels(predictor.predict_labels_async(vol))

    labels, records, events = _profiled(case)
    np.testing.assert_array_equal(labels, predictor.predict_labels(vol))
    n = predictor.n_batches
    assert n == -(-8 // batch)
    counts = Counter(r["name"] for r in records)
    assert counts == {"window.case": 1, "window.stage": 1,
                      "window.finish": 1, "window.fetch": 1,
                      "window.gather": n, "window.model": n,
                      "window.overlap_add": n}
    assert len({r["request"] for r in records}) == 1
    assert set(records[0]) == {"name", "request", "span", "parent",
                               "start_ns", "end_ns", "host_ms"}
    # no device on the CPU: nothing to give the spans
    assert profiling.span_device_ms(events) == {}
    assert all(r["end_ns"] >= r["start_ns"] and r["host_ms"] >= 0
               for r in records)
    case_rec = next(r for r in records if r["name"] == "window.case")
    inner = [r for r in records if r["name"] not in ("window.case",
                                                     "window.fetch")]
    assert all(r["parent"] == case_rec["span"] for r in inner)
    # the range sits in the profiler's trace, on the span's clock
    ev = [e for e in events if e.name() == "fetal.window.case"]
    assert len(ev) == 1
    assert abs(ev[0].start_ns() - case_rec["start_ns"]) < 50e6


def test_spans_nest_into_a_request_and_take_one_each(unet):
    cfg, model = unet
    predictor = build_serving_predictor(model, cfg, overlap=4)
    vol = np.zeros((1,) + cfg.image_shape, np.float32)

    def two():
        with profiling.span("outer") as outer:
            predictor.predict_labels(vol)
        predictor.predict_labels(vol)
        predictor(vol)  # no fetch span: the probabilities come back whole
        return outer.request

    outer, records, _ = _profiled(two)
    groups = _by_request(records)
    assert len(groups) == 3
    assert {r["name"] for r in groups[outer]} == {"outer", *WINDOW}
    names = [sorted({r["name"] for r in g}) for g in groups.values()]
    assert names[1] == sorted(WINDOW)
    assert names[2] == sorted(set(WINDOW) - {"window.fetch"})


def _write_cases(directory, n):
    paths = []
    for i in range(n):
        rng = np.random.default_rng(i)
        vol = np.zeros((26, 28, 24), np.float32)
        vol[4:22, 5:23, 3:21] = 1.0 + rng.normal(0, 0.3, (18, 18, 18))
        case = directory / f"case_{i}"
        case.mkdir(parents=True)
        save_nifti(vol, str(case / "volume.nii.gz"),
                   affine=np.diag([1.0, 1.0, 2.0, 1.0]))
        paths.append(str(case))
    return paths


@pytest.mark.parametrize("device_pre", [False, True])
def test_pipelined_cases_keep_one_request_each(unet, tmp_path, device_pre):
    cfg, model = unet
    paths = _write_cases(tmp_path / "in", 2)
    predictor = build_serving_predictor(model, cfg, overlap=4)
    pre = make_device_preprocessor(model, cfg) if device_pre else None
    n, records, _ = _profiled(lambda: predict_cases_pipelined(
        [(p, str(tmp_path / "out" / Path(p).name)) for p in paths],
        predictor, cfg, save_inputs=False, device_pre=pre, verbose=False))
    assert n == 2
    groups = _by_request(records)
    assert len(groups) == 2
    for request, group in groups.items():
        counts = Counter(r["name"] for r in group)
        resample = set() if device_pre else {"ingest.resample"}
        assert set(counts) == set(INGEST) | resample | set(WINDOW)
        assert counts["ingest.case"] == counts["ingest.read"] == 1
        assert counts["window.case"] == counts["window.fetch"] == 1
        # the prediction's write, on the IO worker: no span open there
        (write,) = [r for r in group if r["name"] == "ingest.write"]
        assert write["parent"] is None
        case_rec = next(r for r in group if r["name"] == "ingest.case")
        assert write["start_ns"] >= case_rec["end_ns"]
    first, second = sorted(groups)
    # case 1's ingest ran before case 0's fetch: both ids interleave
    fetch0 = next(r for r in groups[first] if r["name"] == "window.fetch")
    read1 = next(r for r in groups[second] if r["name"] == "ingest.read")
    assert read1["end_ns"] <= fetch0["start_ns"]


@pytest.mark.parametrize("augment", [False, True])
def test_one_train_step_is_one_request(augment):
    cfg = Config(depth=2, n_base_filters=4, patch_shape=(8, 8, 8),
                 batch_size=2, compute_dtype="float32", fold_level0="off",
                 augment=augment, flip=augment, permute=augment)
    torch.manual_seed(0)
    model = build_model(cfg, "cpu")
    state = create_train_state(model, cfg)
    step = make_train_step(model, cfg,
                           generator=torch.Generator().manual_seed(0))
    x = torch.randn((2, 1, 8, 8, 8))
    y = (x > 0.5).float()
    metrics, records, events = _profiled(lambda: step(state, x, y))
    assert torch.isfinite(metrics["loss"])
    assert sorted(r["name"] for r in records) == sorted(TRAIN)
    assert len({r["request"] for r in records}) == 1
    top = next(r for r in records if r["name"] == "train.step")
    assert all(r["parent"] == top["span"] for r in records if r is not top)
    phases = sorted((r for r in records if r is not top),
                    key=lambda r: r["start_ns"])
    assert [r["name"] for r in phases] == TRAIN[1:]
    assert {"fetal." + n for n in TRAIN} <= {e.name() for e in events}


def test_norm_backward_spans_join_the_train_step(monkeypatch):
    """With the norms on the training Function (routed there on the CPU),
    each norm's backward is one ``norm.backward`` span under the step's
    request, and the step stays one request."""
    from fetal_mri_segmentation_tpu_torch.models import layers

    monkeypatch.setattr(layers, "_kernel_device", lambda x: True)
    cfg = Config(model_name="isensee", depth=3, n_base_filters=8,
                 n_segmentation_levels=2, patch_shape=(16, 16, 16),
                 batch_size=2, compute_dtype="float32", fold_level0="off",
                 augment=False)
    torch.manual_seed(0)
    model = build_model(cfg, "cpu")
    norms = sum(isinstance(m, layers.InstanceNorm) for m in model.modules())
    state = create_train_state(model, cfg)
    step = make_train_step(model, cfg,
                           generator=torch.Generator().manual_seed(0))
    x = torch.randn((2, 1, 16, 16, 16))
    y = (x > 0.5).float()
    metrics, records, events = _profiled(lambda: step(state, x, y))
    assert torch.isfinite(metrics["loss"])
    counts = Counter(r["name"] for r in records)
    assert counts == {**dict.fromkeys(TRAIN, 1), "norm.backward": norms}
    assert norms == 15
    assert len({r["request"] for r in records}) == 1
    assert "fetal.norm.backward" in {e.name() for e in events}


def test_tagged_ctx_joins_a_span_on_another_thread():
    """What the fused norm's Function does for autograd's CUDA backward
    thread: its ctx, tagged in the forward on the step's thread, gives a
    span opened on another thread the step's request; tagged outside every
    span, none."""
    profiling.reset_spans()

    class Ctx:  # stands in for an autograd Function's ctx
        pass

    loose, ctx = Ctx(), Ctx()
    seen = []

    def later(obj):
        with profiling.span("norm.backward",
                            request=profiling.request_of(obj)):
            pass

    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        profiling.tag(loose)
        with profiling.span("train.step") as top:
            profiling.tag(ctx)
        worker = threading.Thread(target=later, args=(ctx,))
        worker.start()
        worker.join()
        seen = [profiling.request_of(ctx), profiling.request_of(loose)]
    records = {r["name"]: r for r in profiling.span_records()}
    assert seen == [top.request, None]
    assert records["norm.backward"]["request"] == top.request
    assert records["norm.backward"]["parent"] is None


def test_trace_writes_the_spans_beside_the_chrome_trace(tmp_path):
    profiling.reset_spans()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with profiling.span("before"):
            pass
    with profiling.trace(str(tmp_path)) as path:
        with profiling.span("train.step"):
            with profiling.span("train.update"):
                torch.ones(4).sum()
    assert path.endswith(".pt.trace.json") and os.path.exists(path)
    with open(path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"fetal.train.step", "fetal.train.update"} <= names
    with open(path.replace(".pt.trace.json", ".spans.json")) as f:
        spans = json.load(f)
    assert [s["name"] for s in spans] == ["train.update", "train.step"]
    assert spans[0]["parent"] == spans[1]["span"]


def test_threads_record_every_span_under_their_own_ids():
    """More recording threads than cores, switching often, while the
    records are read: no span lost, no id given twice, each thread's
    nested spans under its own outer span's id."""
    threads, per = 16, 50
    errors = []

    def work():
        try:
            for _ in range(per):
                with profiling.span("outer"):
                    with profiling.span("inner"):
                        pass
        except Exception as e:  # surfaced by the assertion below
            errors.append(e)

    profiling.reset_spans()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            pool = [threading.Thread(target=work) for _ in range(threads)]
            for t in pool:
                t.start()
            while any(t.is_alive() for t in pool):
                profiling.span_records()
            for t in pool:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in pool)
    finally:
        sys.setswitchinterval(interval)
    assert errors == []
    records = profiling.span_records()
    assert len(records) == 2 * threads * per
    outer = [r for r in records if r["name"] == "outer"]
    assert len({r["request"] for r in outer}) == threads * per
    by_serial = {r["span"]: r for r in outer}
    for r in records:
        if r["name"] == "inner":
            assert by_serial[r["parent"]]["request"] == r["request"]


class _Event:
    """A stand-in for one of the profiler's events (times in ms)."""

    def __init__(self, name, start, dur, *, device=False, thread=1,
                 corr=0, link=0, note=False):
        self._name, self._start, self._dur = name, start, dur
        self._device, self._thread = device, thread
        self._corr, self._link, self._note = corr, link, note

    def name(self):
        return self._name

    def start_ns(self):
        return int(self._start * 1e6)

    def duration_ns(self):
        return int(self._dur * 1e6)

    def device_type(self):
        return (torch.autograd.DeviceType.CUDA if self._device
                else torch.autograd.DeviceType.CPU)

    def is_user_annotation(self):
        return self._note

    def correlation_id(self):
        return self._corr

    def linked_correlation_id(self):
        return self._link

    def start_thread_id(self):
        return self._thread


def test_span_device_ms_gives_each_span_what_launched_inside_it():
    launch = lambda corr, at, thread=1: _Event(  # noqa: E731
        "cudaLaunchKernel", at, 0.01, thread=thread, corr=corr)
    kernel = lambda link, dur: _Event(  # noqa: E731
        "kernel", 500, dur, device=True, link=link)
    events = [
        _Event("fetal.window.case", 0, 100),
        _Event("fetal.window.model", 10, 40),
        _Event("fetal.ingest.write", 25, 10, thread=3),
        # a range's mark on the device's timeline is no device work
        _Event("fetal.window.case", 400, 50, device=True, note=True),
        _Event("annotation", 400, 50, device=True, note=True),
        launch(1, 20), kernel(1, 5.0),  # inside model and case
        launch(2, 60), kernel(2, 2.0),  # inside the case alone
        # autograd's thread opens no span: what is open anywhere
        launch(3, 30, thread=2), kernel(3, 3.0),
        # the main thread opens spans, none open at 200: outside
        launch(4, 200), kernel(4, 1.0),
        kernel(99, 0.5),  # no launch in the session: outside
        # the IO worker's own launch, inside its write only
        launch(5, 30, thread=3), kernel(5, 0.25),
    ]
    got = profiling.span_device_ms(events)
    assert got == pytest.approx({"window.case": 10.0, "window.model": 8.0,
                                 "ingest.write": 3.25, None: 1.5})


def test_span_device_ms_counts_the_backward_thread_in_every_span():
    """Autograd's backward thread opens its own ``norm.backward`` spans:
    what it launches counts for those and for the step's spans open on
    the thread that called backward."""
    launch = lambda corr, at: _Event(  # noqa: E731
        "cudaLaunchKernel", at, 0.01, thread=2, corr=corr)
    kernel = lambda link, dur: _Event(  # noqa: E731
        "kernel", 500, dur, device=True, link=link)
    events = [
        _Event("fetal.train.step", 0, 100),
        _Event("fetal.train.backward", 50, 50),
        _Event("autograd::engine::evaluate_function: _InstanceNormActBackward",
               60, 10, thread=2),
        _Event("fetal.norm.backward", 61, 4, thread=2),
        launch(1, 62), kernel(1, 4.0),  # the norm's backward
        launch(2, 68), kernel(2, 1.0),  # another node's
        launch(3, 120), kernel(3, 0.5),  # after the step
    ]
    got = profiling.span_device_ms(events)
    assert got == pytest.approx({"train.step": 5.0, "train.backward": 5.0,
                                 "norm.backward": 4.0, None: 0.5})


# ---------------------------------------------------- perfbench/spans.py


def _spans_module():
    path = ROOT / "perfbench" / "spans.py"
    spec = importlib.util.spec_from_file_location("pb_spans_test", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _made_up(n_requests, names=("a", "b"), skip=()):
    """Each request r holds one span per name, host ms r + 10 * j for the
    j-th name; ``skip``: (request, name) left out."""
    out = []
    for r in range(n_requests):
        for j, name in enumerate(names):
            if (r, name) not in skip:
                out.append({"name": name, "request": r,
                            "host_ms": r + 10.0 * j})
    return out


def test_spans_reader_keeps_the_device_stretch():
    spans = _spans_module()
    items = 3
    records = _made_up(spans.WARMUP + 2 * items)
    assert spans.per_request(items, ["a"], records) == [2, 3, 4]
    assert spans.per_request(items, ["a", "b"], records) == [
        2 + 12, 3 + 13, 4 + 14]
    assert spans.median({"items": items}, ["b"], records) == 13
    # two spans of one name in a request are summed
    extra = records + [{"name": "a", "request": 3, "host_ms": 100.0}]
    assert spans.per_request(items, ["a"], extra) == [2, 103, 4]


@pytest.mark.parametrize("case", ["too_few", "too_many", "span_missing",
                                  "program_without_spans", "no_records"])
def test_spans_reader_refuses_what_it_cannot_read(case, monkeypatch):
    spans = _spans_module()
    items = 3
    n = spans.WARMUP + 2 * items
    records = {
        "too_few": _made_up(n - 1), "too_many": _made_up(n + 1),
        "span_missing": _made_up(n, skip={(3, "b")}),
        # a program that keeps no spans: the reader finds none to read
        "program_without_spans": None,
        "no_records": [],
    }[case]
    monkeypatch.setattr(spans, "program_records", lambda: None)
    assert spans.per_request(items, ["a", "b"], records) is None
    assert spans.median({"items": items}, ["a", "b"], records) is None
    # a span missing from a dropped request does not matter
    if case == "span_missing":
        ok = _made_up(n, skip={(0, "b"), (n - 1, "b")})
        assert spans.per_request(items, ["a", "b"], ok) is not None


def test_spans_reader_reads_the_program_records():
    spans = _spans_module()
    profiling.reset_spans()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        for _ in range(spans.WARMUP + 2):
            with profiling.span("train.step"):
                pass
    assert spans.per_request(1, ["train.step"]) is not None
    assert spans.per_request(1, ["train.update"]) is None
