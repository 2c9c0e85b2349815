"""The port's spans (``embeddingnet_tpu_torch/utils/trace.py``) and the
sites that open them, on the CPU: off, a span records and allocates
nothing; on, spans nest by thread and ``totals()`` sums ``spans()``; under
a CPU ``torch.profiler`` the training path's ranges appear by name and a
span placed by ``clock_offset_ns()`` lies on its range; a two-epoch
``Trainer`` run (ResNet-18 at 32 px, P-K 3 x 3 from ``tiny_dataset``) opens
``data.wait``, ``data.get``, ``step``, ``optimizer`` and ``bn`` as often as
it should; a ViT ArcFace step opens ``attn``, ``ln``, ``mlp`` and
``arcface`` as often as it should, with and without remat, and off counts
``vit.LAUNCHES`` alike. The card's cases (marked ``cuda``, skipped without
a card; run them with ``python -m pytest tests/test_torch_port_trace.py
-q -m cuda --noconftest``): a kernel lands inside its span on a card-only
profile's clock, and a host sleep inside a span between two kernels counts
as idle inside it."""

import threading
import time
import tracemalloc

import pytest

torch = pytest.importorskip("torch")

from embeddingnet_tpu_torch.config import params_from_dict  # noqa: E402
from embeddingnet_tpu_torch.data import ENDataLoader  # noqa: E402
from embeddingnet_tpu_torch.ops.fused_conv import (BNScaleBias,  # noqa: E402
                                                    cast)
from embeddingnet_tpu_torch.train.loop import Trainer  # noqa: E402
from embeddingnet_tpu_torch.utils import trace  # noqa: E402


@pytest.fixture(autouse=True)
def _spans_off_after():
    """Each test starts and ends with spans off and none recorded, on one
    torch thread (the suite runs its files in parallel processes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    trace.disable()
    trace.reset()
    yield
    trace.disable()
    trace.reset()
    torch.set_num_threads(n)


def _trainer(dataset, work_dir, n_batches=2, augmentations=None, **perf):
    cfg = {
        "MODEL": {"backbone_name": "resnet18", "input_shape": [32, 32, 3],
                  "encodings_len": 32, "backbone_weights": None,
                  "mode": "triplet", "embeddings_normalization": True},
        "DATALOADER": {"dataset_path": dataset, "val_ratio": 0.2},
        "GENERATOR": {"negatives_selection_mode": "batch_all",
                      "k_classes": 3, "k_samples": 3, "batch_size": 6,
                      "n_batches": n_batches, "n_batches_val": 1,
                      "augmentations": augmentations},
        "TRAIN": {"n_epochs": 1, "eval_recall_every": 0,
                  "plot_history": False},
        "GENERAL": {"work_dir": str(work_dir), "project_name": "run",
                    "seed": 3},
        "PERFORMANCE": {"compute_dtype": "float32", **perf},
    }
    params = params_from_dict(cfg)
    loader = ENDataLoader(**{k: params.dataloader[k]
                             for k in params.dataloader.keys()})
    return Trainer(params, loader, device="cpu", log_fn=lambda *a: None)


def test_off_a_span_records_and_allocates_nothing():
    shared = trace.span("a")
    assert trace.span("b") is shared

    def grown(make):
        """Peak bytes allocated over 1,000 ``with make():`` blocks."""
        before = tracemalloc.get_traced_memory()[0]
        tracemalloc.reset_peak()
        for _ in range(1000):
            with make():
                pass
        return tracemalloc.get_traced_memory()[1] - before

    def off():
        return trace.span("x")

    def baseline():
        return shared

    tracemalloc.start()
    try:
        grown(off), grown(baseline)
        assert grown(off) == grown(baseline)
    finally:
        tracemalloc.stop()
    assert trace.spans() == [] and trace.totals() == {}


def test_on_spans_nest_by_thread_and_totals_sum_them():
    trace.enable()
    with trace.span("outer"):
        with trace.span("inner"):
            time.sleep(0.001)
        with trace.span("inner"):
            pass
        other = threading.Thread(target=lambda: trace.span("side")
                                 .__enter__().__exit__(None, None, None))
        other.start()
        other.join()
    trace.disable()
    with trace.span("after"):
        pass
    got = {(s.name, s.parent) for s in trace.spans()}
    assert got == {("outer", None), ("inner", "outer"), ("side", None)}
    me = threading.get_ident()
    threads = {s.name: s.thread for s in trace.spans()}
    assert threads["outer"] == threads["inner"] == me != threads["side"]
    for s in trace.spans():
        assert s.end_ns >= s.start_ns
    totals = trace.totals()
    assert {k: v[0] for k, v in totals.items()} == {"outer": 1, "inner": 2,
                                                    "side": 1}
    for name, (count, seconds) in totals.items():
        assert seconds == pytest.approx(sum(
            (s.end_ns - s.start_ns) * 1e-9 for s in trace.spans()
            if s.name == name))
    assert totals["inner"][1] >= 0.001
    outer = next(s for s in trace.spans() if s.name == "outer")
    assert outer.end_ns - outer.start_ns >= 1e9 * totals["inner"][1]
    trace.reset()
    assert trace.spans() == []


def test_a_span_placed_by_the_offset_lies_on_its_profiler_range():
    from torch.profiler import ProfilerActivity, profile
    trace.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            with trace.span("probe"):
                time.sleep(0.002)
    ranges = sorted((e.start_ns(), e.end_ns())
                    for e in prof.profiler.kineto_results.events()
                    if e.name() == "probe")
    placed = sorted(trace.place(trace.spans(), "probe"))
    assert len(ranges) == len(placed) == 3
    for (rs, re_), (ps, pe) in zip(ranges, placed):
        # the range opens before the span's stamp and closes after it
        assert rs - 100_000 <= ps <= rs + 200_000
        assert re_ - 200_000 <= pe <= re_ + 100_000


def test_idle_inside_intervals_by_hand():
    busy = [[0, 10], [20, 30], [40, 50]]
    assert trace.idle_ns(busy, [(5, 25)]) == 10
    assert trace.idle_ns(busy, [(5, 25), (8, 12)]) == 10     # one union
    assert trace.idle_ns(busy, [(0, 60)]) == 30
    assert trace.idle_ns(busy, [(0, 60)], window=(15, 45)) == 15
    assert trace.idle_ns(busy, [(12, 18)]) == 6
    assert trace.idle_ns(busy, [(21, 29)]) == 0
    assert trace.idle_ns([], [(3, 7)]) == 4


def test_a_cast_opens_a_range_only_when_it_converts():
    trace.enable()
    x, w = torch.ones(2), torch.ones(2)
    assert cast(torch.float32, x, w, None) == (x, w, None)
    assert trace.spans() == []
    got = cast(torch.bfloat16, x, w, None)
    assert [t.dtype for t in got[:2]] == [torch.bfloat16] * 2
    assert got[2] is None
    assert [s.name for s in trace.spans()] == ["cast"]


def test_the_training_ranges_appear_by_name_under_the_profiler(
        tiny_dataset, tmp_path):
    trainer = _trainer(tiny_dataset, tmp_path, n_batches=1,
                       augmentations="default", compute_dtype="bfloat16")
    # the profiler of EMBEDDINGNET_PROFILE's first-epoch trace
    with trainer._profiler() as prof:
        trainer._run_train_epoch()
    names = {e.name for e in prof.events()}
    for name in ("augment", "mining", "bn", "cast", "optimizer", "step",
                 "data.wait", "data.get"):
        assert name in names, name
    # spans off: the profiler's ranges alone, nothing recorded
    assert trace.spans() == []


def test_a_two_epoch_fit_opens_each_span_as_often_as_it_should(
        tiny_dataset, tmp_path):
    trace.enable()
    trainer = _trainer(tiny_dataset, tmp_path)
    assert [s.name for s in trace.spans()] == ["init"]
    n_bn = sum(isinstance(m, BNScaleBias) for m in trainer.module.modules())
    assert n_bn == 20       # ResNet-18: stem, 16 in blocks, 3 downsamples
    for epoch in range(2):
        trace.reset()
        trainer._current_epoch = epoch
        trainer._run_train_epoch()
        records = trace.spans()
        totals = trace.totals()
        count = {k: v[0] for k, v in totals.items()}
        assert count["step"] == count["optimizer"] == 2
        assert count["data.wait"] == 3          # the last one ends the epoch
        assert count["bn"] == 2 * n_bn
        assert "cast" not in count and "data.pin" not in count
        parents = {(s.name, s.parent) for s in records}
        assert ("optimizer", "step") in parents
        assert ("data.get", "data.wait") in parents
        assert not any(s.name == "bn" and s.parent == "bn" for s in records)
        wait = totals["data.wait"][1]
        assert totals["data.get"][1] <= wait
        assert wait <= trainer._data_wait_s
        assert wait == pytest.approx(trainer._data_wait_s, rel=0.02)


@pytest.mark.parametrize("on", [True, False], ids=["on", "off"])
def test_the_vit_and_arcface_spans(on, monkeypatch):
    """A ViT ArcFace step opens ``attn`` and ``mlp`` once a block, ``ln``
    twice a block and once after, ``arcface`` once; under remat the
    blocks' spans open again in the recompute. ``attn`` holds no ``cast``
    (the projections stay outside it). Off, nothing is recorded and
    ``vit.LAUNCHES`` counts all the same."""
    from embeddingnet_tpu_torch.models import vit
    from embeddingnet_tpu_torch.models.registry import ArcFaceModule
    from embeddingnet_tpu_torch.ops.augment import get_aug
    from embeddingnet_tpu_torch.train import optim
    from embeddingnet_tpu_torch.train.state import TrainState
    from embeddingnet_tpu_torch.train.steps import make_arcface_train_step
    from torch.profiler import ProfilerActivity, profile
    monkeypatch.setitem(vit._VARIANTS, "vit-b16",
                        dict(patch=16, dim=32, depth=2, heads=2))
    module = ArcFaceModule("vit-b16", 16, n_classes=4,
                           input_shape=(32, 32, 3), dtype=torch.bfloat16)
    spec = optim.get_optimizer("adam", 1e-3)
    state = TrainState.create(module, spec,
                              generator=torch.Generator().manual_seed(3))
    images = torch.zeros((4, 32, 32, 3), dtype=torch.uint8)
    labels = torch.arange(4)
    want = {"attn": 2, "mlp": 2, "ln": 5, "arcface": 1}
    for remat in (False, True):
        step = make_arcface_train_step(
            module, spec, n_classes=4, remat=remat,
            augment_fn=get_aug("deepfake", (32, 32, 3)),
            compute_dtype=torch.bfloat16)
        trace.reset()
        if on:
            trace.enable()
        before = dict(vit.LAUNCHES)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            step(state, images, labels)
        trace.disable()
        again = {"attn": 2, "mlp": 2, "ln": 4, "arcface": 0} if remat else {}
        count = {k: want[k] + again.get(k, 0) for k in want}
        assert {k: vit.LAUNCHES[k] - before[k] for k in before} == {
            "attention": count["attn"], "layernorm": count["ln"]}
        ranges = [e.name for e in prof.events() if e.name in want]
        assert {k: ranges.count(k) for k in want} == count
        if not on:
            assert trace.spans() == []
            continue
        totals = {k: v[0] for k, v in trace.totals().items()}
        assert {k: totals[k] for k in want} == count
        parents = {(s.name, s.parent) for s in trace.spans()}
        assert ("cast", "mlp") in parents
        assert not any(p == "attn" for _, p in parents)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _sleep_cycles(card, ms):
    """``torch.cuda._sleep`` cycles for about ``ms`` on this card."""
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(1000)
    start.record()
    torch.cuda._sleep(1_000_000)
    end.record()
    torch.cuda.synchronize()
    return int(1_000_000 * ms / start.elapsed_time(end))


@pytest.mark.cuda
def test_a_kernel_lands_inside_its_span_on_a_card_only_profile(card):
    """The profiler loses kernel records now and then, so the read is one
    that ``benchmark/trace.py``'s ``settled`` takes."""
    from torch.profiler import ProfilerActivity, profile
    from benchmark.trace import READS, settled
    cycles = _sleep_cycles(card, 1.0)
    counts = []
    while len(counts) < READS and not (counts and settled(counts)):
        trace.reset()
        trace.enable()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                torch.cuda.synchronize()
                with trace.span("sleep"):
                    torch.cuda._sleep(cycles)
                    torch.cuda.synchronize()
        busy = trace.device_busy_ns(prof)
        counts.append(len(busy))
    placed = sorted(trace.place(trace.spans(), "sleep"))
    assert len(busy) == len(placed) == 3, (busy, placed)
    for (ks, ke), (ss, se) in zip(busy, placed):
        assert ke - ks > 500_000
        assert ss <= ks < ss + 500_000, (ks - ss)
        assert ke <= se, (se - ke)


@pytest.mark.cuda
def test_a_host_sleep_in_a_span_is_idle_inside_it(card):
    from torch.profiler import ProfilerActivity, profile
    cycles = _sleep_cycles(card, 0.2)
    trace.enable()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(cycles)
        torch.cuda.synchronize()
        with trace.span("probe"):
            time.sleep(0.01)
        torch.cuda._sleep(cycles)
        torch.cuda.synchronize()
    probe = trace.place(trace.spans(), "probe")
    idle = trace.idle_ns(trace.device_busy_ns(prof), probe)
    length = probe[0][1] - probe[0][0]
    assert 9_500_000 <= idle <= length
