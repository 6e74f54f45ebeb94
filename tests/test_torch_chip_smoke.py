"""``chip_smoke.py``'s measurements when ``torch.profiler`` delivers no
device event: a CUDA trace now and then comes back empty on the card.
``device_ms`` takes the trace again and then times with CUDA events;
``traced`` runs its region again and then gives no trace, so what it
would have measured reads as not measured.  Each gap is listed in
``PROFILER_GAPS``.  The profiler and the CUDA events are stand-ins here,
so this runs on the CPU."""

import types

import pytest
import torch
import torch.profiler
from torch.autograd import DeviceType

import chip_smoke


class _Event:
    """A device event as ``chip_smoke.device_events`` reads it."""

    def __init__(self, start_us, end_us, name):
        self._span = (start_us, end_us)
        self._name = name

    def device_type(self):
        return DeviceType.CUDA

    def is_user_annotation(self):
        return False

    def start_ns(self):
        return self._span[0] * 1000

    def end_ns(self):
        return self._span[1] * 1000

    def name(self):
        return self._name


def _profiler(traces):
    """A ``profile`` stand-in whose n-th trace holds ``traces[n]``'s
    device events (the last one repeats)."""
    taken = []

    class Profile:
        def __init__(self, **kw):
            self.kw = kw
            events = traces[min(len(taken), len(traces) - 1)]
            taken.append(kw)
            self.profiler = types.SimpleNamespace(
                kineto_results=types.SimpleNamespace(events=lambda: events))
            self._events = events

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def key_averages(self):
            return [types.SimpleNamespace(
                self_device_time_total=e.end_ns() / 1e3 - e.start_ns() / 1e3)
                for e in self._events]

    return Profile, taken


class _CudaEvent:
    """CUDA events on a clock that moves 4 ms at each record."""
    clock = 0.0

    def __init__(self, enable_timing):
        assert enable_timing

    def record(self):
        _CudaEvent.clock += 4.0
        self.at = _CudaEvent.clock

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return end.at - self.at


@pytest.fixture
def gaps(monkeypatch):
    monkeypatch.setattr(chip_smoke, "PROFILER_GAPS", [])
    monkeypatch.setattr(chip_smoke, "PROFILER_RETRY_S", 0.0)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(torch.cuda, "Event", _CudaEvent)
    return chip_smoke.PROFILER_GAPS


def test_device_ms_reads_the_trace_and_takes_an_empty_one_again(
        gaps, monkeypatch):
    profile, taken = _profiler([[], [_Event(0, 50, "k")] * 20])
    monkeypatch.setattr(torch.profiler, "profile", profile)
    calls = []
    assert chip_smoke.device_ms(lambda: calls.append(1)) == 0.05
    assert len(taken) == 2 and len(calls) == 3 + 2 * 20
    assert [g["outcome"] for g in gaps] == ["trace taken again"]


def test_device_ms_falls_back_to_cuda_events_after_three_empty_traces(
        gaps, monkeypatch):
    profile, taken = _profiler([[]])
    monkeypatch.setattr(torch.profiler, "profile", profile)
    calls = []
    ms = chip_smoke.device_ms(lambda: calls.append(1), iters=4)
    # two records 4 ms apart over 4 calls
    assert ms == 1.0
    assert len(taken) == 3 and len(calls) == 3 + 3 * 4 + 4
    assert [g["outcome"] for g in gaps] == (
        ["trace taken again"] * 3 + ["timed with CUDA events: 1.0 ms"])
    assert all(g["what"].startswith("device_ms at test_") for g in gaps)


@pytest.mark.parametrize("empty_traces", [0, 2])
def test_traced_runs_again_until_the_trace_holds_device_time(
        gaps, monkeypatch, empty_traces):
    events = [_Event(0, 10, "k")]
    profile, taken = _profiler([[]] * empty_traces + [events])
    monkeypatch.setattr(torch.profiler, "profile", profile)
    runs = []
    out, prof = chip_smoke.traced(torch, lambda: runs.append(1) or len(runs),
                                  "region", record_shapes=True)
    assert out == empty_traces + 1 and len(runs) == empty_traces + 1
    assert chip_smoke.device_events(prof) == [(0.0, 10.0, "k")]
    assert taken[-1]["record_shapes"] and len(taken[-1]["activities"]) == 1
    assert gaps == [{"what": "region", "outcome": "trace taken again"}] \
        * empty_traces


def test_traced_gives_no_trace_after_three_empty_ones(gaps, monkeypatch):
    profile, taken = _profiler([[]])
    monkeypatch.setattr(torch.profiler, "profile", profile)
    runs = []
    out, prof = chip_smoke.traced(torch, lambda: runs.append(1) or len(runs),
                                  "region")
    assert (out, prof, len(runs), len(taken)) == (3, None, 3, 3)
    assert [g["outcome"] for g in gaps] == (
        ["trace taken again"] * 3 + ["not measured"])
