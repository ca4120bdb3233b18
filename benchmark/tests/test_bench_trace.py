"""The interval union, the kernels found by name in a trace, the idle
gaps named by the host, and the readers over a hand-made trace."""

import pytest

from benchmark.core.cell import CellRun
from benchmark.core.trace import Trace, longest_gaps, union_length
from benchmark.run import BENCH, load_module, reader_path


@pytest.mark.parametrize("intervals, length", [
    ([], 0.0),
    ([(0, 1)], 1.0),
    ([(0, 2), (1, 3)], 3.0),          # overlap counts once
    ([(0, 1), (0, 1)], 1.0),          # a repeat counts once
    ([(0, 1), (2, 3)], 2.0),
    ([(5, 9), (0, 10), (11, 12)], 11.0),
])
def test_union_length(intervals, length):
    assert union_length(intervals) == length


def test_longest_gaps_are_named_by_the_host_op():
    gaps = longest_gaps([(0, 10), (40, 50), (55, 60)],
                        [("step", 0, 100), ("backward", 8, 45)])
    assert gaps == [["step", 30e-6], ["step", 5e-6]]


def _trace():
    kernels = [
        ("scatter_kernel(int const*, float const*)", 0.0, 10.0),
        ("_Z14scatter_kernelPKiPKfS2_xiiP6float2", 20.0, 30.0),
        ("void at::native::index_scatter_kernel<float>()", 30.0, 31.0),
        ("void resolve_kernel(float const*)", 40.0, 44.0),
    ]
    device = kernels + [("Memset (Device)", 50.0, 52.0)]
    return Trace(iters=2, wall_us=100.0, device=device, kernels=kernels,
                 host_ops=[("step", 0.0, 100.0)])


def test_kernel_time_by_name_mangled_or_not():
    t = _trace()
    assert t.kernel_time_us("(^|[^A-Za-z_])scatter_kernel") == (2, 20.0)
    assert t.kernel_time_us("(^|[^A-Za-z_])resolve_kernel") == (1, 4.0)


def _reader(name):
    return load_module(reader_path(name), name.replace(".", "_"))


def _run(**layer):
    return CellRun(attempted=2, failed=0, metrics={}, checks=[],
                   memory_peak_bytes=0, trace=_trace(), layer=layer)


RESOLVE = {"match": "(^|[^A-Za-z_])resolve_kernel",
           "bytes": {"mesh_faces": 36, "mesh_pairs": 4, "mesh_tiles": 8,
                     "mesh_pixels": 16}}
# One resolve launch bound by 1 µs of bytes.
ONE_US = {"mesh_faces": 0, "mesh_pairs": 0, "mesh_tiles": 0,
          "mesh_pixels": 3.35e12 * 1e-6 / 16}


def test_readers_over_a_hand_made_trace():
    run = _run(unit_ms=0.05, least_ms=0.01, launch_quantities=ONE_US)
    kernels = {"mesh_resolve": RESOLVE}
    # busy 27 µs (the union: 10 + 11 + 4 + 2) over 2 steps of 50 µs each
    assert _reader("idle_share.step").read(run, kernels) == pytest.approx(0.73)
    assert _reader("launches.step").read(run, kernels) == 2.0
    assert _reader("mfu.step").read(run, kernels) == pytest.approx(20.0)
    # 1 µs of bound against 4 µs on the device
    assert _reader("kernel_roofline.step").read(run, kernels) == pytest.approx(25.0)


def test_a_metric_of_a_known_kind_needs_no_reader_of_its_own():
    assert reader_path("idle_share.some_new_cell") == BENCH / "metrics" / "idle_share.py"
    assert reader_path("mfu.train") == BENCH / "metrics" / "mfu.py"


def test_kernel_roofline_takes_every_kernel_file_that_launched(capsys):
    """A kernel file added later counts where its launches are in the trace
    and the cell gives its quantities; one whose quantities the cell does
    not give, and one listed for the cell that matched nothing, are named."""
    roofline = _reader("kernel_roofline.step")
    scatter = {"match": "(^|[^A-Za-z_])scatter_kernel",
               "bytes": {"hash_rows": 12, "hash_table_floats": 4}}
    absent = {"match": "no_such_kernel", "bytes": {"mesh_faces": 1}}
    run = _run(launch_quantities=dict(ONE_US, hash_rows=3.35e12 * 1e-6 / 12,
                                      hash_table_floats=0),
               expected_kernels=["mesh_resolve", "absent"])
    kernels = {"mesh_resolve": RESOLVE, "absent": absent}
    assert roofline.read(run, kernels) == pytest.approx(25.0)
    # Both scatter launches (20 µs), each bound by 1 µs: 3 of 24 µs.
    kernels["hash_scatter"] = scatter
    assert roofline.read(run, kernels) == pytest.approx(100.0 * 3 / 24)
    assert "absent is listed for the cell and matched no launch" in \
        capsys.readouterr().err
    del run.layer["launch_quantities"]["hash_table_floats"]
    assert roofline.read(run, kernels) == pytest.approx(25.0)
    assert "hash_scatter launched 2 times; the cell gives no " \
        "hash_table_floats" in capsys.readouterr().err


def test_readers_find_nothing_without_a_trace():
    run = CellRun(attempted=1, failed=0, metrics={}, checks=[],
                  memory_peak_bytes=0)
    for name in sorted(p.stem for p in (BENCH / "metrics").glob("*.py")):
        assert _reader(name).read(run, {}) is None
