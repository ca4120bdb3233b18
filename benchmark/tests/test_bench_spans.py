"""The span readers over a hand-made trace and span list: each span's
device ms a step, the glue as the roots less their stages, the window's
idle charged to the root's child the host was in (the rest to glue, so
the six idle metrics sum to the window's idle), and nothing read where
the roots are not one a step or the event records do not pair."""

import pytest

from benchmark.core import spans as spans_mod
from benchmark.core.cell import CellRun
from benchmark.core.spans import RECORD_CALLS
from benchmark.core.trace import Trace
from benchmark.run import load_module, reader_path
from youreditableavatar_tpu_torch.utils import profiling
from youreditableavatar_tpu_torch.utils.profiling import Span

# Host clock = trace clock + OFFSET µs; TREE and BUSY in ms.
OFFSET = 1000.0
MS = 1000.0
# Two steps on the trace's clock: (name, parent, start, end, device ms).
TREE = [
    ("edit.step", -1, 0.0, 100.0, 100.0),
    ("edit.prepare", 0, 1.0, 10.0, 1.0),
    ("edit.render", 0, 10.5, 40.0, 30.0),
    ("edit.guidance", 0, 40.5, 60.0, 20.0),
    ("unet", 3, 45.0, 55.0, 10.0),
    ("edit.backward", 0, 60.5, 90.0, 30.0),
    ("edit.record", 0, 90.5, 99.0, 5.0),
    ("edit.step", -1, 120.0, 200.0, 80.0),
    ("edit.prepare", 7, 121.0, 130.0, 2.0),
    ("edit.render", 7, 130.5, 160.0, 25.0),
    ("edit.guidance", 7, 160.5, 170.0, 10.0),
    ("edit.backward", 7, 170.5, 190.0, 20.0),
    ("edit.record", 7, 190.5, 199.0, 3.0),
]
BUSY = [(5.0, 15.0), (20.0, 35.0), (50.0, 58.0), (62.0, 85.0),
        (125.0, 150.0), (172.0, 180.0)]
# Idle [0, 5], [15, 20], [35, 50], [58, 62], [85, 125], [150, 172],
# [180, 205] (the window ends with the synchronize): 116 ms.
WINDOW_IDLE_MS = 116.0


def _spans():
    out = []
    for name, parent, a, b, ms in TREE:
        root = len(out) if parent == -1 else out[parent].root
        out.append(Span(name, parent, root, 1, int((a * MS + OFFSET) * 1e3),
                        int((b * MS + OFFSET) * 1e3), ms))
    return out


def _trace(iters=2, drop=(), lag=0.0, late=()):
    """The window's trace: a record call at each span event (`drop`: the
    indices of those the trace does not list at top level; each call
    starts `lag` µs after its event's host time, those in `late` 3 ms
    after), the device's busy intervals and the closing synchronize."""
    calls = sorted([t * MS for _, _, a, b, _ in TREE for t in (a, b)])
    # The runtime's name for the call differs between CUDA versions.
    host = [(RECORD_CALLS[k % 2], t + lag + 3000.0 * (k in late),
             t + lag + 3000.0 * (k in late) + 1.0)
            for k, t in enumerate(calls) if k not in drop]
    host += [("aten::add", 2.0 * MS, 4.0 * MS),
             ("cudaDeviceSynchronize", 199.5 * MS, 205.0 * MS)]
    device = [("kernel", a * MS, b * MS) for a, b in BUSY]
    return Trace(iters=iters, wall_us=205.0 * MS, device=device,
                 kernels=device, host_ops=host)


def _run(trace):
    return CellRun(attempted=2, failed=0, metrics={}, checks=[],
                   memory_peak_bytes=0, trace=trace, layer={})


def _read(name, run):
    return load_module(reader_path(name), name.replace(".", "_")).read(run, {})


@pytest.fixture
def taken(monkeypatch):
    """The spans the readers take: the hand-made list, once."""
    box = [_spans()]
    monkeypatch.setattr(spans_mod, "_take", lambda: box.pop() if box else [])


def test_device_ms_a_step_and_the_glue(taken, capsys):
    run = _run(_trace())
    got = {k: _read(f"{k}_ms.step", run)
           for k in ("render", "losses", "guidance", "backward", "optimizer",
                     "glue", "unet", "vae")}
    assert got == pytest.approx({"render": 27.5, "losses": 0.0,
                                 "guidance": 15.0, "backward": 25.0,
                                 "optimizer": 0.0, "glue": 22.5,
                                 "unet": 5.0, "vae": 0.0})
    # The six stage metrics make up the root's device time.
    six = ("render", "losses", "guidance", "backward", "optimizer", "glue")
    assert sum(got[k] for k in six) == pytest.approx((100.0 + 80.0) / 2)
    err = capsys.readouterr().err
    assert "root 0 edit.step" in err and "root 7 edit.step" in err
    assert "26 of 26 span events line up" in err


def test_idle_is_charged_to_the_span_the_host_was_in(taken):
    run = _run(_trace())
    got = {k: _read(f"{k}_idle_ms.step", run)
           for k in ("render", "losses", "guidance", "backward", "optimizer",
                     "glue")}
    # In ms over both steps: render 5 + 5 + 10; guidance 9.5 + 2 + 9.5
    # (the unet nested in it counts as guidance); backward 1.5 + 5 + 1.5 +
    # 10; the rest — prepare, record, the roots' own time, the 20 ms
    # between the steps and the 5 after the last — glue.
    assert got == pytest.approx({"render": 10.0, "losses": 0.0,
                                 "guidance": 10.5, "backward": 9.0,
                                 "optimizer": 0.0, "glue": 28.5})
    assert sum(got.values()) == pytest.approx(WINDOW_IDLE_MS / 2)


def test_glue_takes_the_root_self_time_and_the_gaps_between_roots(taken):
    """Idle inside no child of a root lands in glue and nowhere else."""
    run = _run(_trace())
    charged = spans_mod.idle_by_span(run)
    assert charged[spans_mod.SELF] == pytest.approx(MS * (
        1.0 + 0.5 + 0.5 + 0.5 + 1.0 + 20.0 + 1.0 + 0.5 + 0.5 + 0.5 + 1.0
        + 5.0))
    assert sum(charged.values()) == pytest.approx(WINDOW_IDLE_MS * MS)


def test_nothing_is_read_unless_a_root_spans_each_step(taken, capsys):
    run = _run(_trace(iters=3))
    assert _read("render_ms.step", run) is None
    assert _read("render_idle_ms.step", run) is None
    assert "2 root spans in a window of 3 steps" in capsys.readouterr().err


def test_a_few_records_the_trace_does_not_list_change_nothing(taken,
                                                              capsys):
    """The profiler may nest an odd record call under another host op; the
    rest still line the spans up (2 of 26 gone, as 2 of 100 on the card)."""
    run = _run(_trace(drop=(5, 17)))
    assert _read("render_idle_ms.step", run) == pytest.approx(10.0)
    assert _read("glue_idle_ms.step", run) == pytest.approx(28.5)
    assert "24 of 26 span events line up with one of 24" in \
        capsys.readouterr().err


def test_the_clocks_are_lined_up_by_most_records_not_the_first(taken):
    """Every call 7 µs after its event's host time, the first and another
    3 ms late: the spans land on their host intervals 7 µs on."""
    run = _run(_trace(lag=7.0, late=(0, 20)))
    placed = spans_mod._placed(run, spans_mod.spans(run))
    assert placed[0] == pytest.approx([7.0, 100 * MS + 7.0])
    assert placed[7] == pytest.approx([120 * MS + 7.0, 200 * MS + 7.0])


def test_no_idle_is_charged_unless_most_events_line_up(taken, capsys):
    run = _run(_trace(drop=tuple(range(0, 26, 2))))
    assert _read("glue_idle_ms.step", run) is None
    assert _read("render_idle_ms.step", run) is None
    assert _read("render_ms.step", run) == pytest.approx(27.5)
    err = capsys.readouterr().err
    assert "13 of 26 span events line up" in err and "too few" in err


def test_a_program_without_spans_gives_nothing_and_raises_nothing(
        monkeypatch):
    """The parent commit's program has no `take_spans`."""
    monkeypatch.delattr(profiling, "take_spans")
    run = _run(_trace())
    for name in ("unet_ms.view", "controlnet_ms.view", "glue_idle_ms.step"):
        assert _read(name, run) is None


def test_spans_without_device_times_give_nothing(monkeypatch):
    """A CPU run records no CUDA events: no device ms to read."""
    import dataclasses

    cpu = [dataclasses.replace(s, device_ms=None) for s in _spans()]
    monkeypatch.setattr(spans_mod, "_take", lambda: cpu)
    assert _read("unet_ms.step", _run(_trace())) is None
