"""The committed benchmark rows on the SNAP surrogates and under dynamic
ingest: each gated modeled row of ``BENCH_sessions.json`` from fig12, fig13
(``load_dataset(name, scale_div=512)``) and fig22 (an sf12 base graph, a
``GraphEpochLog`` publishing 6 batches), run with its figure's settings on
the port's engine, gives the JAX benchmark's modeled throughput to the last
bit."""
import pytest

pytest.importorskip("torch")

from _torch_bench_rows import one_torch_thread, gated_rows, run_row  # noqa: E402,F401

FIGURES = ("fig12/", "fig13/", "fig22/")
ROWS = gated_rows()


@pytest.mark.parametrize("row", sorted(n for n in ROWS if n.startswith(FIGURES)))
def test_gated_bench_row_reproduced(row):
    assert run_row(row).throughput_modeled() == ROWS[row]
