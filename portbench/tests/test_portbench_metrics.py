"""The frozen metric arithmetic on synthetic records: percentiles,
interval unions and gaps, the readers, the breakdown, lost records and
the profile's raw records."""
import pytest

from portbench.lib import stats, trace
from portbench.lib.manifest import reader
from portbench.lib.trace import Record, RunView


def test_percentile_is_nearest_rank_over_all_values():
    values = [float(v) for v in range(1, 101)]
    assert stats.percentile(values, 95) == 95.0
    assert stats.percentile(values[::-1], 95) == 95.0
    assert stats.percentile([3.0], 95) == 3.0
    assert stats.percentile([1.0, 2.0], 95) == 2.0
    with pytest.raises(ValueError):
        stats.percentile([], 95)


def test_quarter_means_in_window_order():
    assert stats.quarter_means([1.0, 2.0, 3.0, 4.0, 5.0, 6.0, 7.0, 8.0]) \
        == [1.5, 3.5, 5.5, 7.5]
    assert stats.quarter_means([2.0, 4.0]) == [2.0, 4.0]


def test_union_clip_and_gaps():
    spans = [(0, 10), (5, 20), (30, 40), (40, 45), (50, 50)]
    assert stats.merge(spans) == [(0, 20), (30, 45)]
    assert stats.covered(spans) == 35
    assert stats.clip(spans, 8, 35) == [(8, 10), (8, 20), (30, 35)]
    assert stats.gaps(spans, -5, 60) == [(-5, 0), (20, 30), (45, 60)]
    assert stats.gaps([], 0, 7) == [(0, 7)]


def _view(**kw):
    base = dict(requests=2, latencies_s=[0.02, 0.04], tuples=2000,
                window_s=0.5, setup_s=12.5, peak_bytes=3 * 2**30,
                launches={"radix_rank": 4, "segment_reduce": 2,
                          "tricluster_density": 2},
                sizes=(10, 20, 5), n_tuples=1000)
    base.update(kw)
    return RunView(**base)


def _traced_view():
    device = [
        Record("void radix_rank_onesweep<true>(int const*)", 100, 200),
        Record("void radix_rank_onesweep<true>(int const*)", 150, 260),
        Record("sr_onesweep<false>", 300, 350),
        Record("void at::native::tensor_kernel_scan_innermost_dim", 350, 400),
        Record("Memcpy HtoD (Pageable -> Device)", 0, 40),
        Record("Memcpy DtoH (Device -> Pageable)", 500, 560),
        Record("elementwise_kernel", 900, 1000),
        Record("before the window", -50, -10),
    ]
    spans = [Record("window", 0, 1000), Record("request", 0, 600),
             Record("mine", 0, 450), Record("readback", 450, 600),
             Record("request", 600, 1000), Record("mine", 600, 1000)]
    return _view(device=device, spans=spans, window_ns=(0, 1000),
                 event_ms={"dense": 30.0, "exact_density": 20.0})


def test_end_to_end_readers():
    v = _view()
    assert reader("mine_tuples_per_s")(v) == 4000.0
    assert reader("exact_tuples_per_s")(v) == 4000.0
    assert reader("mine_p95_ms")(v) == pytest.approx(40.0)
    assert reader("peak_device_gib")(v) == 3.0
    assert reader("setup_s")(v) == 12.5


def test_per_layer_readers_on_synthetic_records():
    v = _traced_view()
    assert reader("device_ms.sort")(v) == pytest.approx(160 / 1e6 / 2)
    assert reader("device_ms.scan")(v) == pytest.approx(100 / 1e6 / 2)
    assert reader("copy_ms.mine")(v) == pytest.approx(100 / 1e6 / 2)
    assert reader("launches.mine")(v) == 4.0
    twins = {"copy_ms.exact": "copy_ms.mine", "launches.exact":
             "launches.mine", "device_ms.sort.exact": "device_ms.sort",
             "device_ms.scan.exact": "device_ms.scan"}
    for exact, mine in twins.items():
        assert reader(exact)(v) == reader(mine)(v), exact
    assert reader("device_ms.dense")(v) == 15.0
    assert reader("device_ms.density")(v) == 10.0
    busy = 40 + 160 + 100 + 60 + 100
    assert reader("device_idle_share")(v) == pytest.approx(1 - busy / 1000)
    assert reader("device_idle_share.exact")(v) == \
        reader("device_idle_share")(v)


def test_readers_find_nothing_where_nothing_ran():
    v = _view(device=[], spans=[], window_ns=(0, 100), launches={})
    for name in ("device_ms.sort", "device_ms.scan", "copy_ms.mine",
                 "launches.mine", "device_ms.dense", "device_ms.density",
                 "copy_ms.exact", "launches.exact", "device_ms.sort.exact",
                 "device_ms.scan.exact"):
        assert reader(name)(v) is None, name


def test_breakdown_names_idle_time_by_innermost_span():
    v = _traced_view()
    out = trace.breakdown(v)
    ops = dict((k, s) for k, s in out["device_ops"])
    assert ops["elementwise_kernel"] == pytest.approx(100e-9)
    assert "before the window" not in ops
    idle = dict((k, s) for k, s in out["idle_gaps"])
    # gaps 40-100 and 260-300 lie in the first mine; 400-500's middle
    # in its readback; 560-900's middle in the second request's mine
    assert idle["mine"] == pytest.approx((60 + 40 + 340) / 1e9)
    assert idle["readback"] == pytest.approx(100 / 1e9)
    assert len(out["device_ops"]) <= 10 and len(out["idle_gaps"]) <= 10


def test_lost_records_compare_traced_kernels_with_launches():
    v = _traced_view()
    lost = trace.lost_records(v)
    assert lost["radix_rank"] == (2, 4)
    assert lost["segment_reduce"] == (1, 2)
    assert lost["tricluster_density"] == (0, 2)


class _Event:
    def __init__(self, name, device, start, dur):
        self._n, self._d, self._s, self._t = name, device, start, dur

    def name(self):
        return self._n

    def device_type(self):
        return self._d

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._t


def test_read_profile_keeps_device_work_and_host_spans_only():
    import types
    import torch
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    events = [_Event("portbench.mine", cpu, 10, 50),
              _Event("portbench.mine", cuda, 12, 60),    # its GPU copy
              _Event("aten::sort", cpu, 11, 5),
              _Event("sr_onesweep<true>", cuda, 20, 7)]
    results = types.SimpleNamespace(events=lambda: events)
    prof = types.SimpleNamespace(
        profiler=types.SimpleNamespace(kineto_results=results))
    device, spans = trace.read_profile(prof)
    assert device == [Record("sr_onesweep<true>", 20, 27)]
    assert spans == [Record("mine", 10, 60)]


def test_read_profile_needs_the_kineto_results():
    import types
    prof = types.SimpleNamespace(profiler=types.SimpleNamespace())
    with pytest.raises(RuntimeError, match="kineto"):
        trace.read_profile(prof)
