"""bench/trace_report.py reads a jax.profiler trace with jax alone.

The reduction is checked on a small trace recorded on the CPU, where XLA's
ops land on the host plane; on the GPU the same code reads the
"/device:GPU:*" planes (chip_smoke.py phase 4)."""

import jax
import jax.numpy as jnp
import pytest


@pytest.fixture(scope="module")
def trace_report():
    import bench

    return bench.load_sub_bench("trace_report.py")


@pytest.fixture(scope="module")
def cpu_trace(tmp_path_factory):
    d = tmp_path_factory.mktemp("trace")
    f = jax.jit(lambda x: jnp.sort(x * 3 + 1))
    x = jnp.arange(4096, dtype=jnp.uint32)[::-1]
    f(x).block_until_ready()
    with jax.profiler.trace(str(d)):
        for _ in range(3):
            f(x).block_until_ready()
    return str(d)


def test_op_totals_on_cpu_trace(trace_report, cpu_trace):
    path = trace_report.newest_xplane(cpu_trace)
    assert path.endswith(".xplane.pb")
    totals = trace_report.op_totals(path, "/host:CPU")
    assert list(totals) == ["/host:CPU"]
    ops = {
        name
        for dur in totals["/host:CPU"].values()
        for name, ns in dur.items()
        if ns > 0
    }
    assert any("sort" in name for name in ops), sorted(ops)[:20]
    text = trace_report.report(totals, top=3)
    assert text.startswith("== /host:CPU")
    assert " ms  " in text


def test_main_fails_without_device_planes(trace_report, cpu_trace, capsys):
    # a CPU trace has no "/device:" plane: the report must say so, not
    # print an empty table
    assert trace_report.main([cpu_trace]) == 1
    assert "no events" in capsys.readouterr().err
    assert trace_report.main([cpu_trace, "/host:CPU"]) == 0
    assert "== /host:CPU" in capsys.readouterr().out


def test_missing_trace_raises(trace_report, tmp_path):
    with pytest.raises(FileNotFoundError):
        trace_report.newest_xplane(str(tmp_path))
