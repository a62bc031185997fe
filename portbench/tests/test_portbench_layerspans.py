"""The layer readings of ``portbench/layerspans.py`` on synthetic profiler
events, and on a real CPU profile of a small k-mer action."""
import numpy as np
import pytest

from portbench import devtrace, harness, layerspans

W, A = devtrace.WINDOW, devtrace.ACTION


def host(s, e, name):
    return (s, e, name, True, False)


def kernel(s, e, name):
    return (s, e, name, False, False)


def mark(s, e, name, flagged=True):
    """A GPU user annotation; ``flagged`` is the profiler's own flag."""
    return (s, e, name, False, flagged)


#: Two actions in a 100 s window (seconds, for round numbers).  Action 1:
#: dispatch 2-30 holds map 3-10, keyed.combine 10-11, exchange 11-20 and
#: keyed.merge 20-29; kernels 5-12 (map's), 12-25 (the exchange's),
#: 26-28 (the merge's), 31-40 after the dispatch; the gather 46-49 copies
#: 46-48.  Action 2 (50-100) launches one kernel, 60-70, outside any span.
PLAIN = [
    host(0, 100, W), host(0, 50, A), host(50, 100, A),
    host(2.4, 2.6, "cudaLaunchKernel"),
    kernel(5, 12, "void at::native::elementwise_kernel<128, 4>(int)"),
    kernel(12, 25, "void at::native::_scatter_gather_elementwise_kernel"
                   "<128, 4>(int)"),
    kernel(26, 28, "void (anonymous namespace)::segsum_fold<int, 1>()"),
    kernel(31, 40, "void at::native::CatArrayBatchedCopy<int>()"),
    kernel(46, 48, "Memcpy DtoH (Device -> Pageable)"),
    kernel(60, 70, "void at::native::index_elementwise_kernel()"),
    mark(0, 100, W), mark(0, 50, A, flagged=False),
]
SPANS = [
    host(1, 45, "mare.action"), host(2, 30, "mare.dispatch"),
    host(3, 10, "mare.map"), host(10, 11, "mare.keyed.combine"),
    host(11, 20, "mare.exchange"), host(20, 29, "mare.keyed.merge"),
    host(46, 49, "mare.gather"),
    mark(5, 40, "mare.action"), mark(5, 28, "mare.dispatch"),
    mark(5, 12, "mare.map"), mark(12, 25, "mare.exchange"),
    # an annotation the profiler did not flag is still no device work
    mark(26, 28, "mare.keyed.merge", flagged=False),
    mark(46, 48, "mare.gather"),
]


def test_layer_device_time_is_the_union_under_each_span():
    trace, spans = layerspans.parse(PLAIN + SPANS, actions=2)
    got = layerspans.readings(trace, spans)
    assert got["map_device_ms"] == pytest.approx(1e3 * 7 / 2)
    assert got["exchange_device_ms"] == pytest.approx(1e3 * 13 / 2)
    assert got["keyed_fold_device_ms"] == pytest.approx(1e3 * 2 / 2)
    assert got["tree_reduce_device_ms"] is None      # no such span
    assert got["gather_ms"] == pytest.approx(1e3 * 3 / 2)
    # the layers' device time never exceeds the busy time
    layers = sum(got[k] for k in layerspans.DEVICE_LAYERS if got[k])
    assert layers <= 1e3 * trace.busy_s / trace.actions


def test_nested_spans_of_one_layer_count_once():
    extra = [mark(5, 12, "mare.keyed.combine"),
             mark(6, 11, "mare.keyed.combine")]
    trace, spans = layerspans.parse(PLAIN + SPANS + extra, actions=1)
    assert layerspans.layer_device_s(
        trace, spans, ("keyed.combine", "keyed.merge")) == pytest.approx(9)


def test_dispatch_idle_is_the_gaps_inside_the_dispatch():
    trace, spans = layerspans.parse(PLAIN + SPANS, actions=2)
    # gaps 0-5 (middle 2.5), 25-26, 28-31 lie inside dispatch 2-30;
    # 40-46, 48-60 and 70-100 do not
    assert layerspans.readings(trace, spans)["dispatch_idle_ms"] \
        == pytest.approx(1e3 * (5 + 1 + 3) / 2)


def test_program_annotations_are_never_device_work():
    trace, _ = layerspans.parse(PLAIN + SPANS, actions=2)
    assert not any(n.startswith(layerspans.PREFIX) or n in (W, A)
                   for _, _, n in trace.device)
    assert trace.busy_s == pytest.approx(7 + 13 + 2 + 9 + 2 + 10)


def test_program_spans_change_nothing_but_the_gap_labels():
    with_spans, spans = layerspans.parse(PLAIN + SPANS, actions=2)
    plain, none = layerspans.parse(PLAIN, actions=2)
    assert none.host == [] and none.device == []
    assert len(spans.host) == 7 and len(spans.device) == 6
    assert (with_spans.actions, with_spans.window_s, with_spans.busy_s,
            with_spans.device) == (plain.actions, plain.window_s,
                                   plain.busy_s, plain.device)
    assert [g[:2] for g in with_spans.gaps] == [g[:2] for g in plain.gaps]
    labels = {g[:2]: g[2] for g in with_spans.gaps}
    before = {g[:2]: g[2] for g in plain.gaps}
    assert labels[(0, 5)] == "cudaLaunchKernel" == before[(0, 5)]
    assert labels[(25, 26)] == "mare.keyed.merge"
    assert before[(25, 26)] == "host python"
    assert labels[(70, 100)] == before[(70, 100)] == "host python"
    assert with_spans.breakdown() != plain.breakdown()


def test_readings_are_none_without_spans():
    trace, spans = layerspans.parse(PLAIN, actions=2)
    assert layerspans.readings(trace, spans) == {
        name: None for name in ("map_device_ms", "exchange_device_ms",
                                "keyed_fold_device_ms",
                                "tree_reduce_device_ms", "gather_ms",
                                "dispatch_idle_ms")}


def test_no_window_refused():
    with pytest.raises(RuntimeError):
        layerspans.parse([host(0, 1, "mare.map")], actions=1)


def test_overlap_of_interval_lists():
    assert layerspans.overlap([(0, 2), (3, 6)], [(1, 4), (5, 9)]) == 3
    assert layerspans.overlap([], [(0, 1)]) == 0


def test_a_cpu_profile_of_the_port_with_its_sink():
    """A real ``torch.profiler`` session on the CPU around two small
    k-mer actions under the port's profiler sink: the host ranges of
    every layer of the action arrive, the gather is read, and the device
    readings are None (no device on the CPU)."""
    harness.program_path()
    import torch  # noqa: F401
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch import obs
    from repro_torch.core import MaRe

    rng = np.random.default_rng(3)
    data = rng.choice(np.frombuffer(b"ACGT", np.uint8),
                      size=(256, 32)).astype(np.uint8)
    lens = np.full(256, 32, np.int32)
    ds = MaRe({"data": data, "len": lens}, num_shards=4,
              device="cpu").dataset

    def action():
        return (MaRe(ds).map(image="kmer-stats", command="kmer-stats 4")
                .reduce_by_key(lambda r: r[0], value_by=lambda r: (r[1],),
                               op="sum").collect())

    action()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with obs.tracing(profiler=True):
            with record_function(W):
                for _ in range(2):
                    with record_function(A):
                        action()
    trace, spans = layerspans.parse(layerspans.events_of(prof), actions=2)
    names = [n for _, _, n in spans.host]
    for name in ("action", "dispatch", "map", "keyed.combine", "exchange",
                 "keyed.merge", "gather"):
        assert names.count(name) == 2, (name, names)
    got = layerspans.readings(trace, spans)
    assert got["gather_ms"] > 0
    assert got["map_device_ms"] is None and trace.busy_s == 0
    assert got["dispatch_idle_ms"] is None or got["dispatch_idle_ms"] >= 0
