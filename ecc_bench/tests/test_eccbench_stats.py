"""Exact percentiles, rates, the union of intervals and the reading of a
device trace, on hand-made inputs."""
from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from ecc_bench import devtrace, stats
from ecc_bench.devtrace import Op


def test_percentile_is_nearest_rank():
    xs = list(range(1, 101))            # 1..100
    assert stats.percentile(xs, 95) == 95
    assert stats.percentile(xs, 100) == 100
    assert stats.percentile([3.0, 1.0, 2.0], 50) == 2.0
    assert stats.percentile([7.0], 95) == 7.0
    # 20 samples: the 19th smallest is the 95th percentile
    assert stats.percentile([float(i) for i in range(20)], 95) == 18.0


@pytest.mark.parametrize("bad", [0, -1, 100.5])
def test_percentile_refuses_out_of_range(bad):
    with pytest.raises(ValueError):
        stats.percentile([1.0, 2.0], bad)


def test_median_and_rate():
    assert stats.median([4.0, 1.0, 3.0, 2.0]) == 2.5
    assert stats.median([5.0, 1.0, 3.0]) == 3.0
    assert stats.rate(300, 2.5) == 120.0
    with pytest.raises(ValueError):
        stats.rate(1, 0.0)


def test_union_covered_and_gaps():
    iv = [(5, 7), (0, 2), (1, 3), (3, 4), (10, 10), (9, 8)]
    assert stats.union(iv) == [(0, 4), (5, 7)]
    assert stats.covered(iv) == 6
    assert stats.gaps(iv, -1, 9) == [(-1, 0), (4, 5), (7, 9)]
    assert stats.gaps([], 0, 2) == [(0, 2)]
    assert stats.gaps([(0, 5)], 1, 3) == []


def _trace():
    marks = [Op(devtrace.MARKER, 0.0, 1.0), Op(devtrace.MARKER, 101.0, 102.0)]
    device = marks + [
        Op("nvjet_tst_gemm", 10.0, 40.0),
        Op("void flash_attention_bf16_kernel<128, 128>", 35.0, 50.0),
        Op("void quantize_int8_kernel<bf16>", 60.0, 62.0),
        Op("void dequantize_int8_kernel<bf16>", 70.0, 71.0),
        Op("Memcpy DtoH (Device -> Pageable)", 90.0, 95.0),
        Op("outside the window", 150.0, 160.0),
    ]
    host = [Op("aten::mm", 0.0, 60.0), Op("cudaLaunchKernel", 51.0, 58.0),
            Op("cudaMemcpyAsync", 72.0, 96.0)]
    return devtrace.window(device, host)


def test_window_between_the_markers():
    t = _trace()
    assert (t.start_us, t.end_us) == (1.0, 101.0)
    assert t.window_s == pytest.approx(100e-6)
    # 10-50, 60-62, 70-71, 90-95: 40 + 2 + 1 + 5 us busy
    assert t.busy_s() == pytest.approx(48e-6)
    assert len(t.kernels) == 4          # the copy and the markers are not
    assert t.seconds(r"flash_attention") == pytest.approx(15e-6)
    assert t.seconds(r"quantize_int[48]") == pytest.approx(3e-6)


def test_idle_gaps_named_by_the_innermost_host_call():
    gaps = dict(devtrace.idle_gaps(_trace()))
    # 1-10 and 62-70 (mid 5.5, 66): aten::mm spans 5.5, nothing spans 66;
    # 50-60 (mid 55): cudaLaunchKernel is inside aten::mm; 71-90 (mid
    # 80.5): cudaMemcpyAsync; 95-101 (mid 98): nothing
    assert gaps["host: aten::mm"] == pytest.approx(9e-6)
    assert gaps["host: cudaLaunchKernel"] == pytest.approx(10e-6)
    assert gaps["host: cudaMemcpyAsync"] == pytest.approx(19e-6)
    assert gaps["host: no operation"] == pytest.approx(14e-6)


def test_idle_gaps_named_by_the_innermost_stage_range():
    t = _trace()
    # the program's stages: cloud_fwd over 0-100, action_head 45-100
    t.host_ops += [Op("roboecc.cloud_fwd", 0.0, 100.0),
                   Op("roboecc.action_head", 45.0, 100.0)]
    gaps = dict(devtrace.idle_gaps(t))
    # 1-10 (mid 5.5): cloud_fwd, not the shorter aten::mm; 50-60, 62-70,
    # 71-90, 95-101 (mids 55, 66, 80.5, 98): action_head
    assert gaps == {"host: roboecc.cloud_fwd": pytest.approx(9e-6),
                    "host: roboecc.action_head": pytest.approx(43e-6)}


def _event(name, start, end, device, annotation=False):
    return SimpleNamespace(
        name=name, time_range=SimpleNamespace(start=start, end=end),
        device_type=DeviceType.CUDA if device else DeviceType.CPU,
        is_user_annotation=annotation)


def test_user_annotations_are_no_operations():
    """A ``record_function`` range and its device-side twin neither count
    as launches nor cover the device's idle time."""
    prof = SimpleNamespace(events=lambda: [
        _event(devtrace.MARKER, 0.0, 1.0, True),
        _event("nvjet_tst_gemm", 10.0, 40.0, True),
        _event("head", 5.0, 95.0, True, annotation=True),
        _event("head", 4.0, 96.0, False, annotation=True),
        _event("aten::mm", 2.0, 60.0, False),
        _event(devtrace.MARKER, 101.0, 102.0, True)])
    t = devtrace.from_profiler(prof)
    assert [o.name for o in t.kernels] == ["nvjet_tst_gemm"]
    assert t.busy_s() == pytest.approx(30e-6)
    assert [o.name for o in t.host_ops] == ["aten::mm"]


def test_window_needs_two_markers():
    with pytest.raises(RuntimeError):
        devtrace.window([Op(devtrace.MARKER, 0.0, 1.0)], [])


def test_top_ops_and_groups():
    t = _trace()
    top = devtrace.top_ops(t, n=2)
    assert top[0] == ["nvjet_tst_gemm", pytest.approx(30e-6)]
    groups = devtrace.by_group(t)
    assert groups["matrix products (library)"] == pytest.approx(30e-6)
    assert groups["hand-written: flash_attention_bf16"] == pytest.approx(15e-6)
