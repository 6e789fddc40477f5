"""The port's schedule-perturbation harness (``repro_torch.analysis.perturb``)
against the JAX package's: tie-break permutations of equal-time events in
the port's ``Sim``, and the migration regression rows bit-identical under
tie-break seeds and equal to the JAX package's rows."""
import pytest

from repro.analysis import perturb as jperturb
from repro.cluster.sim import _mix64 as jmix64
from repro_torch.analysis.perturb import (canon, chaos_run,
                                          perturb_chaos, perturb_regressions,
                                          regression_row, tiebreak)
from repro_torch.cluster.sim import Sim, _mix64


def _tie_order(tiebreak_seed, n=6):
    """Fire n processes at the same instant; return completion order."""
    sim = Sim(tiebreak_seed=tiebreak_seed)
    log = []

    def proc(tag):
        yield 1.0
        log.append(tag)

    for i in range(n):
        sim.process(proc(i), name=f"p{i}")
    sim.run()
    return log


def test_mix64_identical_to_reference():
    for seed in (0, 1, 7):
        outs = [_mix64(i, seed) for i in range(5000)]
        assert len(set(outs)) == 5000
        assert outs == [jmix64(i, seed) for i in range(5000)]


def test_tiebreak_permutes_equal_time_events_only():
    assert _tie_order(None) == list(range(6))
    orders = {tuple(_tie_order(s)) for s in range(8)}
    assert len(orders) > 1
    for order in orders:
        assert sorted(order) == list(range(6))
    assert _tie_order(3) == _tie_order(3)


def test_tiebreak_env_var_plumbs_into_nested_sims():
    with tiebreak(42):
        assert Sim().tiebreak_seed == 42
    assert Sim().tiebreak_seed is None


@pytest.mark.parametrize("strategy", ["ms2m_individual", "ms2m_precopy",
                                      "ms2m_statefulset"])
def test_regression_rows_bit_identical_and_equal_to_reference(strategy):
    """Each strategy's flat-topology row, unperturbed and under two
    tie-break seeds, bit-identical, and the JAX package's row."""
    base = canon(regression_row(strategy))
    for ts in (1, 3):
        assert canon(regression_row(strategy, tiebreak_seed=ts)) == base
    assert base == jperturb.canon(jperturb.regression_row(strategy))


def test_perturb_regressions_report():
    report = perturb_regressions((2,), strategies=("ms2m_individual",))
    assert report["ok"] and report["cells"][0]["divergent_seeds"] == []


def test_chaos_run_identical_to_reference():
    """The port's copy of the chaos benchmark's run: the same fleet row
    and invariant as the JAX package's ``benchmarks/chaos.py``; and the
    invariant holds under a tie-break seed."""
    from benchmarks.chaos import _run_one

    got = chaos_run("ms2m_precopy", 10_000, 1)
    assert got["invariant_ok"]
    want = _run_one("ms2m_precopy", 10_000, 1)
    assert canon(got["row"]) == canon(want["row"])
    assert got["schedule"] == want["schedule"]
    report = perturb_chaos((2,), chaos_seeds=(10_000,))
    assert report["ok"], report
