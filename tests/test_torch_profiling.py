"""The port's timing utilities on the CPU: ``time_fn`` (host clock for
CPU results; CUDA events only when a result lies on the card) and the
layer ranges of the training step (host ranges under the CPU profiler;
marks that read the host clock and charge the same way as the card's
kernel)."""

import os
import time

import pytest
import torch

from neuralvolumetricreconstructionformedicalimages_torch.config import with_defaults
from neuralvolumetricreconstructionformedicalimages_torch.data import dataset as tds
from neuralvolumetricreconstructionformedicalimages_torch.ops import _build
from neuralvolumetricreconstructionformedicalimages_torch.train import trainer as T
from neuralvolumetricreconstructionformedicalimages_torch.train.optim import make_optimizer
from neuralvolumetricreconstructionformedicalimages_torch.utils import profiling

SMOKE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     "data", "smoke.pickle")
# The main path's leaf host ranges in a step, repeats collapsed: the CPU
# marks what the card marks, the span gather reading the positions through
# the permutation and the feature unpack after it.
MAIN_PATH = ["batch", "sample", "encode.index", "encode.sort", "encode.gather",
             "encode.permute", "mlp", "render", "loss", "optim"]
# The device ranges the main path's step marks, each once.
MAIN_HITS = {r: 1 for r in profiling.RANGES
             if r not in ("encode", "backward.encode.sort", "step.io")}
# The device ranges the XOR path's step marks, each once, in step order.
XOR_HITS = {r: 1 for r in ("batch", "sample", "encode.index", "encode.gather", "mlp",
                           "render", "loss", "backward.render", "backward.mlp",
                           "backward.encode.sort", "backward.encode.bucket", "optim")}


def test_time_fn_on_cpu():
    calls = []

    def fn(x, scale=1.0):
        calls.append(1)
        time.sleep(0.002)
        return x * scale

    r = profiling.time_fn(fn, torch.ones(4), warmup=3, iters=5, scale=2.0)
    assert len(calls) == 1 + 2 + 5      # first call, warm-up, timed calls
    assert set(r) == {"compile_s", "mean_s", "median_s", "min_s", "std_s", "iters"}
    assert r["iters"] == 5
    assert 0.002 <= r["min_s"] <= r["median_s"] <= 1.0
    assert r["min_s"] <= r["mean_s"] and r["std_s"] >= 0.0 and r["compile_s"] > 0


def test_time_fn_detects_the_card_from_results():
    assert not profiling._on_cuda((torch.ones(2), {"a": [torch.zeros(1)]}, 3))
    assert not profiling._on_cuda(None)


@pytest.mark.cuda
def test_time_fn_uses_cuda_events_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x = torch.ones((1024, 1024), device="cuda")
    r = profiling.time_fn(torch.mm, x, x, warmup=2, iters=5)
    assert 0 < r["min_s"] <= r["median_s"] < 1.0


@pytest.mark.cuda
def test_device_times_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x = torch.ones((1024, 1024), device="cuda")
    r = profiling.device_times(lambda: torch.mm(x, x), iters=5, calls=20)
    assert r["parts"] and 0 < r["profiler_ms"] < 100.0
    assert r["profiler_ms"] == pytest.approx(sum(r["parts"].values()))
    assert 0 < r["back_to_back_ms"] < 100.0


# ---- layer ranges ----

def _parts(n_fine=0, encoder=None):
    """A tiny main-path field on the smoke scan, on the CPU, its encoder
    updated by ``encoder``: (arrays, the eager step, the epoch function)."""
    cfg = with_defaults({
        "exp": {"expname": "r", "expdir": ".", "datadir": SMOKE},
        "network": {"net_type": "mlp", "num_layers": 4, "hidden_dim": 16,
                    "skips": [2], "out_dim": 1, "last_activation": "sigmoid",
                    "bound": 0.3},
        "encoder": {"encoding": "hashgrid", "input_dim": 3, "num_levels": 3,
                    "level_dim": 2, "base_resolution": 8, "log2_hashmap_size": 14,
                    "forward": "sorted", "table_dtype": "bfloat16", "pack_sort": True,
                    **(encoder or {})},
        "render": {"n_samples": 32, "n_fine": n_fine, "perturb": True,
                   "raw_noise_std": 0.0, "netchunk": 4096},
        "train": {"epoch": 1, "n_batch": 1, "n_rays": 64, "lrate": 1e-2,
                  "lrate_gamma": 0.1, "lrate_step": 10, "resume": False},
        "log": {"i_eval": 0, "i_save": 0}})
    ds = tds.make_dataset(tds.load_pickle(SMOKE), "train", 64)
    g = torch.Generator().manual_seed(0)
    field = T.build_model(cfg, g)
    field_fine = T.build_model(cfg, g) if n_fine else None
    params = list(field.parameters()) + (list(field_fine.parameters()) if n_fine else [])
    opt = make_optimizer(cfg, params)
    kw = dict(n_rays=64, n_batch=1, use_mask=False, generator=g, field_fine=field_fine)
    return (ds.arrays(), T.make_train_step(cfg, field, opt, **kw),
            T.make_epoch_fn(cfg, field, opt, 10, **kw))


def _cpu_profile(run):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        run()
    return list(prof.events())


def _ancestors(ev):
    p = ev.cpu_parent
    while p is not None:
        yield p
        p = p.cpu_parent


def test_ranges_off_open_nothing_and_launch_no_mark(monkeypatch):
    """With no profiler and no marking block, a range is the shared null
    context, and a whole step launches no mark and registers no hook."""
    arrays, step, _ = _parts()
    charged = []
    monkeypatch.setattr(profiling, "charge", lambda *a: charged.append(a))
    monkeypatch.setattr(torch.Tensor, "register_hook",
                        lambda *a: charged.append("hook"))
    assert not profiling.ranges_on()
    assert profiling.layer_range("batch") is profiling._NULL
    assert profiling.layer_range("step") is profiling._NULL
    n0 = _build.LAUNCHES["range_mark"]
    step(arrays, torch.tensor([0]))
    assert charged == [] and _build.LAUNCHES["range_mark"] == n0


def test_host_ranges_cover_the_eager_step():
    """Under the CPU profiler, every top-level aten op of the forward and
    of the optimiser lies inside a leaf ``nvr.`` range, every op of the
    backward inside ``nvr.backward``, and the leaf ranges come in the main
    path's order."""
    arrays, step, _ = _parts()
    step(arrays, torch.tensor([0]))               # Adam's state, outside the trace
    views = torch.tensor([1])
    events = _cpu_profile(lambda: step(arrays, views))
    leaves = {profiling.PREFIX + r for r in profiling.RANGES}
    outside = []
    for ev in events:
        if not ev.name.startswith("aten::"):
            continue
        up = list(_ancestors(ev))
        if any(a.name.startswith("aten::") for a in up):
            continue                               # not top-level
        names = {a.name for a in up}
        if not (names & leaves or "nvr.backward" in names):
            outside.append(ev.name)
    assert outside == []
    seq = [ev.name[len(profiling.PREFIX):] for ev in
           sorted(events, key=lambda e: e.time_range.start)
           if ev.name in leaves or ev.name == "nvr.backward"]
    collapsed = [r for i, r in enumerate(seq) if i == 0 or seq[i - 1] != r]
    assert collapsed == MAIN_PATH[:-1] + ["backward", "optim"]


def test_host_clock_marks_charge_every_range():
    """Three eager steps, each in a marking block on the CPU: every range
    of the main path is hit as often as it runs a step, ``step.io`` once
    between two steps, and the intervals add up to the time from the first
    mark to the last end mark: none falls outside a range."""
    arrays, step, _ = _parts()
    step(arrays, torch.tensor([0]))
    profiling.reset_ranges("cpu")
    h = profiling.range_buffer("cpu").numpy()
    first = None
    for i in range(3):
        with profiling.marking("cpu"):
            step(arrays, torch.tensor([i]))
        first = h[0] if first is None else first
        n = int(sum(MAIN_HITS.values()))
        assert profiling.range_totals("cpu")["steps"] == i + 1
        # the step's own ranges add up to its first mark to its end mark
        assert h[n] > h[0]
    t = profiling.range_totals("cpu")
    assert t["hits"] == {**{r: 3 * MAIN_HITS.get(r, 0) for r in profiling.RANGES},
                         "step.io": 2}
    total_ns = round(sum(t["device_ms"].values()) * 1e6)
    last_end = h[profiling._TOTALS + 2 * len(profiling.RANGES)]
    assert total_ns == last_end - first
    assert all(v > 0 for r, v in t["device_ms"].items() if t["hits"][r])


def test_xor_path_marks_its_encoder_apart_from_the_mlp():
    """The XOR path's step (``hash_encode_fast``): its forward marks
    ``encode.index`` and ``encode.gather``, its backward
    ``backward.encode.sort`` and ``backward.encode.bucket``, each once a
    step, and never ``encode``; the encoder's backward begins after the
    MLP's, so ``backward.mlp`` holds the MLP's backward alone."""
    arrays, step, _ = _parts(encoder={"hash_variant": "xor", "table_dtype": "float32",
                                      "pack_sort": False})
    step(arrays, torch.tensor([0]))
    profiling.reset_ranges("cpu")
    for i in range(2):
        with profiling.marking("cpu"):
            step(arrays, torch.tensor([i]))
    t = profiling.range_totals("cpu")
    assert t["hits"] == {**{r: 2 * XOR_HITS.get(r, 0) for r in profiling.RANGES},
                         "step.io": 1}
    h = profiling.range_buffer("cpu").numpy()
    ids = [profiling.RANGES[int(r)] for r in
           h[profiling.MAX_MARKS:profiling.MAX_MARKS + sum(XOR_HITS.values())]]
    assert ids == list(XOR_HITS)


def test_fine_pass_marks_both_fields():
    """With the fine pass each field runs its own encoder and MLP ranges:
    ``mlp`` and ``encode.gather`` are hit twice, every forward range at
    least once, and the step's intervals still add up to its span."""
    arrays, step, _ = _parts(n_fine=2)
    step(arrays, torch.tensor([0]))
    profiling.reset_ranges("cpu")
    with profiling.marking("cpu"):
        step(arrays, torch.tensor([1]))
    t = profiling.range_totals("cpu")
    h = profiling.range_buffer("cpu").numpy()
    assert t["steps"] == 1 and t["hits"]["mlp"] == 2 and t["hits"]["encode.gather"] == 2
    assert all(t["hits"][r] for r in MAIN_PATH)
    n = sum(t["hits"].values())
    assert round(sum(t["device_ms"].values()) * 1e6) == h[n] - h[0]


def test_marks_dedupe_and_charge_by_the_clock(monkeypatch):
    """Marks at given clock readings: a range entered again while it runs
    adds no mark; each interval goes to the range its first mark started;
    the gap between two steps to ``step.io``; a reset zeroes the sums."""
    clock = iter([100, 130, 170, 200, 260])
    monkeypatch.setattr(profiling.time, "perf_counter_ns", lambda: next(clock))
    profiling.reset_ranges("cpu")
    with profiling.marking("cpu"):
        with profiling.layer_range("batch"):
            with profiling.layer_range("step"):    # a host-only name: no mark
                pass
        with profiling.layer_range("batch"):       # already running: no mark
            pass
        profiling.range_mark("sample")
    with profiling.marking("cpu"):
        with profiling.layer_range("optim"):
            pass
    t = profiling.range_totals("cpu")
    assert t["steps"] == 2
    assert {r: v for r, v in t["hits"].items() if v} == {
        "batch": 1, "sample": 1, "optim": 1, "step.io": 1}
    assert t["device_ms"]["batch"] == pytest.approx(30e-6)
    assert t["device_ms"]["sample"] == pytest.approx(40e-6)
    assert t["device_ms"]["step.io"] == pytest.approx(30e-6)
    assert t["device_ms"]["optim"] == pytest.approx(60e-6)
    profiling.reset_ranges("cpu")
    assert profiling.range_totals("cpu")["steps"] == 0
    with pytest.raises(RuntimeError, match="do not nest"):
        with profiling.marking("cpu"), profiling.marking("cpu"):
            pass


def test_range_totals_is_shaped():
    for dev in ("cpu", None):
        t = profiling.range_totals(dev)
        assert set(t) == {"steps", "device_ms", "hits"}
        assert isinstance(t["steps"], int) and t["steps"] >= 0
        assert list(t["device_ms"]) == list(profiling.RANGES) == list(t["hits"])
        assert all(isinstance(v, float) and v >= 0 for v in t["device_ms"].values())
        assert all(isinstance(v, int) and v >= 0 for v in t["hits"].values())
    assert profiling.RANGES[-1] == "step.io" and len(set(profiling.RANGES)) == 18


def test_ranges_on_in_a_ranges_block_or_under_a_profiler():
    assert not profiling.ranges_on()
    with profiling.ranges():
        with profiling.ranges():
            assert profiling.ranges_on()
        assert profiling.ranges_on()
    assert not profiling.ranges_on()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        assert profiling.ranges_on()
        assert profiling.layer_range("batch") is not profiling._NULL
    assert not profiling.ranges_on()


def test_epoch_host_ranges():
    """The epoch function's host work under ``nvr.epoch``: the staging once,
    and each step's range with its rate and loss copy inside."""
    arrays, _, epoch_fn = _parts()
    order = torch.arange(3)[:, None]
    events = _cpu_profile(lambda: epoch_fn(arrays, order, 0))
    count = {}
    for ev in events:
        count[ev.name] = count.get(ev.name, 0) + 1
    assert {k: v for k, v in count.items() if k.startswith("nvr.")
            and k[4:] not in profiling.RANGES} == {
        "nvr.epoch": 1, "nvr.epoch.stage": 1, "nvr.step": 3, "nvr.step.set_lr": 3,
        "nvr.step.loss": 3, "nvr.backward": 3}
    (epoch,) = [e for e in events if e.name == "nvr.epoch"]
    for ev in events:
        if ev.name.startswith("nvr.step"):
            assert epoch.time_range.start <= ev.time_range.start
            assert ev.time_range.end <= epoch.time_range.end


def test_union_of_device_spans():
    assert profiling.union_ms([]) == 0.0
    assert profiling.union_ms([(0, 1000), (500, 1500), (2000, 2500), (2100, 2200)]) \
        == pytest.approx(2.0)
