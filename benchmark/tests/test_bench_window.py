"""The window arithmetic of the end-to-end metrics: `step_ms` over the
whole window, `step_p90_ms` only from 100 steps on, `view_s` over whole
calls that fit."""

import pytest
import torch

from benchmark.core import window


class FakeClock:
    def __init__(self):
        self.now = 0.0

    def __call__(self):
        return self.now


@pytest.fixture
def clock(monkeypatch):
    c = FakeClock()
    monkeypatch.setattr(window.time, "perf_counter", c)
    return c


def test_step_window_runs_until_the_seconds_pass(clock):
    def step(i):
        clock.now += 0.25

    seconds, durations = window.step_window(step, 2.0, torch.device("cpu"))
    assert seconds == pytest.approx(2.0)
    assert durations == pytest.approx([250.0] * 8)
    assert window.step_ms(seconds, len(durations)) == pytest.approx(250.0)


def test_p90_needs_a_hundred_steps():
    assert window.p90([1.0] * 99) is None
    values = list(range(1, 101))
    assert window.p90(values) == 90
    assert window.p90(list(range(1, 201))) == 180


@pytest.mark.parametrize("call_s, seconds, calls", [
    (20.0, 45.0, 2),   # a third call would end at 60 s
    (20.0, 40.0, 2),   # the second ends exactly at the limit
    (20.0, 39.0, 1),   # the second would end past it
    (50.0, 45.0, 1),   # the first call always runs
])
def test_call_window_holds_whole_calls(clock, call_s, seconds, calls):
    def call(i):
        clock.now += call_s

    window_s, n = window.call_window(call, seconds, torch.device("cpu"))
    assert n == calls
    assert window_s == pytest.approx(calls * call_s)
