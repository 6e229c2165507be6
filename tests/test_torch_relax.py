"""The port's over-relaxation sweep (``raocp_tpu_torch.scripts.bench_relax``)
against the JAX package on the CPU, in float64: every setting on BASELINE
config 2 (relax 1.0, 1.5 and 1.8, adaptive, relax 1.8 with adaptive) takes
the count of JAX's ``_run_cp`` with the same options (``check_every=25,
unroll=25``, as the JAX script calls it) and the committed reference's."""

import contextlib
import io
import json

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from raocp_tpu_torch.scripts import bench_configs, bench_relax  # noqa: E402
from raocp_tpu_torch.scripts.bench_configs import CONFIGS  # noqa: E402
from test_torch_sweeps import _jax_loop  # noqa: E402


@pytest.fixture(scope="module")
def relax_rows():
    """``bench_relax``'s config-2 rows on the CPU in float64, as its
    command line prints them."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        bench_relax.main(["--configs", "2", "--repeats", "1", "--device",
                          "cpu"])
    return {row["setting"]: row
            for row in map(json.loads, out.getvalue().splitlines())}


@pytest.mark.parametrize("setting", list(bench_relax.SETTINGS))
def test_relax_config2_counts_match_jax(relax_rows, setting):
    """Every setting's count on config 2 in float64 equals that of the JAX
    package's ``_run_cp`` with the same options and the committed
    reference's, which the row carries beside it."""
    key = bench_relax.relax_solve(2, setting)
    want, _ = _jax_loop(2, key)
    got = relax_rows[setting]
    ref = bench_configs.reference_row(CONFIGS[2].name, key)
    assert got["solve"] == key and got["converged"]
    assert got["iterations"] == int(want[2]) == ref["iterations"] \
        == got["jax_iterations"]
    assert got["k1_launches"] == 0
    assert got["prox_f_calls"] == got["iterations"]


def test_relax_row_fields(relax_rows):
    """The JAX script's fields and the port's, on every row."""
    assert list(relax_rows) == list(bench_relax.SETTINGS)
    for row in relax_rows.values():
        for key in ("config", "setting", "iterations", "converged",
                    "time_to_tol_s", "iters_per_s", "dtype", "device",
                    "card", "k1_path", "k1_launches", "prox_f_calls",
                    "max_memory_allocated_mb", "jax_iterations"):
            assert key in row, key
        assert (row["dtype"], row["device"], row["card"]) == \
            ("torch.float64", "cpu", None)
        assert row["k1_path"] and row["max_memory_allocated_mb"] is None
