"""``bench/tools/range_check.py``'s summary of a synthetic chrome trace,
against counts and sums made by hand: the program's ranges by host and
device span, a forward range's leaf check, and the slice's idle time by the
innermost program range open on the host."""
import pytest

from bench.tools.range_check import summarise


def _x(cat, name, ts, dur, tid=1, corr=None):
    ev = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid}
    if corr is not None:
        ev["args"] = {"correlation": corr}
    return ev


def _doc(nested: bool):
    """A 0-100 us slice; host: ``serve.chunk_forward`` over [10, 40] (with
    ``plain_attention`` over [20, 30] inside when ``nested``) launching
    kernels 1 and 2 at 12 and 35, a launch of kernel 3 at 60 outside it;
    device: the range's span [15, 50], kernels [15, 25], [45, 50], [70, 80]
    (kernel 2 also has a copy at [52, 54], outside the span)."""
    evs = [_x("user_annotation", "bench:slice", 0, 100),
           _x("user_annotation", "serve.chunk_forward", 10, 30),
           _x("user_annotation", "bench:mixed tick", 5, 50),
           _x("cuda_runtime", "cudaLaunchKernel", 12, 1, corr=1),
           _x("cuda_runtime", "cudaLaunchKernel", 35, 1, corr=2),
           _x("cuda_runtime", "cudaLaunchKernel", 60, 1, corr=3),
           _x("gpu_user_annotation", "serve.chunk_forward", 15, 35, tid=7),
           _x("kernel", "k1", 15, 10, tid=7, corr=1),
           _x("kernel", "k2", 45, 5, tid=7, corr=2),
           _x("gpu_memcpy", "copy", 52, 2, tid=7, corr=2),
           _x("kernel", "k3", 70, 10, tid=7, corr=3)]
    if nested:
        evs.append(_x("user_annotation", "plain_attention", 20, 10))
    return {"traceEvents": evs}


def test_counts_leaves_and_idle_by_hand():
    s = summarise(_doc(nested=False))
    assert s["slice_ms"] == pytest.approx(0.1)
    assert s["host"] == {"count": {"serve.chunk_forward": 1},
                         "ms": {"serve.chunk_forward": pytest.approx(0.03)}}
    assert s["device"]["ms"] == {"serve.chunk_forward": pytest.approx(0.035)}
    assert s["leaves"] == {"serve.chunk_forward": {
        "host_spans": 1, "nested_program_ranges": [],
        "device_ops_in_projection": 2, "device_ops_outside": 1}}
    # busy [15, 25], [45, 50], [52, 54], [70, 80]; the range open [10, 40]:
    # idle 0-10, 40-45, 50-52, 54-70, 80-100 outside it (53 us), 10-15 and
    # 25-40 in it (20 us)
    assert s["idle_ms_by_range"] == {"(no program range)": pytest.approx(0.053),
                                     "serve.chunk_forward": pytest.approx(0.020)}


def test_a_range_inside_a_forward_range_is_found():
    s = summarise(_doc(nested=True))
    assert s["leaves"]["serve.chunk_forward"]["nested_program_ranges"] == ["plain_attention"]
    # the inner range [20, 30] is busy until 25: 25-30 is its idle
    assert s["idle_ms_by_range"]["plain_attention"] == pytest.approx(0.005)
