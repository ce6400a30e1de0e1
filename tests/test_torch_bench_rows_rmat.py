"""The committed benchmark rows on the port's RMAT workloads: each gated
modeled row of ``BENCH_sessions.json`` from fig11 and fig15–fig19, run with
its figure's settings on the port's engine (the graph built by the port on
the CPU), gives the JAX benchmark's modeled throughput to the last bit.
fig10's, fig14's and fig20's rows are held in ``test_torch_engine.py``, the
SNAP surrogates' and fig22's in ``test_torch_bench_rows_real.py``; fig21's
measured ratios and the ``_wall`` rows are host wall-time measurements and
carry no modeled throughput to hold."""
import pytest

pytest.importorskip("torch")

from _torch_bench_rows import one_torch_thread, gated_rows, run_row  # noqa: E402,F401

FIGURES = ("fig11/", "fig15/", "fig16/", "fig17/", "fig18/", "fig19/")
# the other test files' figures (see the module docstring)
ELSEWHERE = ("fig10/", "fig14/", "fig20/", "fig12/", "fig13/", "fig22/")
ROWS = gated_rows()


@pytest.mark.parametrize("row", sorted(n for n in ROWS if n.startswith(FIGURES)))
def test_gated_bench_row_reproduced(row):
    assert run_row(row).throughput_modeled() == ROWS[row]


def test_every_gated_row_has_a_test():
    assert len(ROWS) == 63
    assert all(n.startswith(FIGURES + ELSEWHERE) for n in ROWS)
    assert not any(n.startswith("fig21/") or "_wall/" in n for n in ROWS)
