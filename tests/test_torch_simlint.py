"""The port's determinism lint (``repro_torch.analysis.lint``) against the
JAX package's: every fixture of ``tests/test_simlint.py`` gives the same
findings (rule, line, column, message) in both, the port's tree lints
clean under the port's lint, and each lint agrees on the other's tree."""
import os
import textwrap

import pytest

from repro.analysis import lint as jlint
from repro_torch.analysis import lint as tlint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (name, source, rules the lint must report): the fixtures of
# tests/test_simlint.py, one per rule case
FIXTURES = [
    ("sim001_flags_broad_except_in_generator", """
        def proc(ctx):
            try:
                yield 1.0
            except Exception:
                pass
    """, ["SIM001"]),
    ("sim001_bare_except_also_flagged", """
        def proc(ctx):
            try:
                yield 1.0
            except:
                pass
    """, ["SIM001"]),
    ("sim001_passes_with_prior_interrupt_handler", """
        def proc(ctx):
            try:
                yield 1.0
            except Interrupt:
                raise
            except Exception:
                pass
    """, []),
    ("sim001_passes_when_handler_just_reraises", """
        def proc(ctx):
            try:
                yield 1.0
            except Exception:
                raise
    """, []),
    ("sim001_ignores_non_generators", """
        def helper():
            try:
                return 1
            except Exception:
                return None
    """, []),
    ("sim002_flags_wall_clock_and_global_rng", """
        import random
        import time

        def sample():
            t = time.time()
            r = random.random()
            n = np.random.randint(10)
            return t, r, n
    """, ["SIM002", "SIM002", "SIM002"]),
    ("sim002_seeded_randomness_is_legal", """
        def sample(seed, key):
            rng = np.random.default_rng(seed)
            ks = jax.random.split(key, 3)
            t0 = time.perf_counter()  # measures real compute, not schedule
            return rng.integers(0, 10), ks, t0
    """, []),
    ("sim002_suppression_pragma", """
        def compile_timer():
            t0 = time.time()  # simlint: disable=SIM002
            # the pragma also works on the line above:
            # simlint: disable=SIM002
            t1 = time.time()
            return t1 - t0
    """, []),
    ("suppression_does_not_leak_to_other_rules", """
        def sample():
            return time.time()  # simlint: disable=SIM001
    """, ["SIM002"]),
    ("sim003_flags_set_iteration", """
        def schedule(jobs):
            for j in set(jobs):
                launch(j)
    """, ["SIM003"]),
    ("sim003_flags_anyof_over_live_dict_view", """
        def drive(sim, active):
            yield sim.any_of(*active.keys())
    """, ["SIM003"]),
    ("sim003_flags_mutation_during_iteration", """
        def drain(active):
            for cond in active:
                active.pop(cond)
    """, ["SIM003"]),
    ("sim003_sorted_and_snapshotted_are_legal", """
        def drive(sim, active):
            armed = list(active.keys())
            yield sim.any_of(*armed)
            for cond in sorted(active):
                done(cond)
    """, []),
    ("sim004_flags_busy_poll", """
        def drain(queue):
            while queue.depth() > 0:
                yield 0.05
    """, ["SIM004"]),
    ("sim004_large_delays_and_conditions_are_legal", """
        def heartbeat(sim, interval, wake):
            while True:
                yield 5.0
            while True:
                yield interval
            while True:
                yield wake
    """, []),
    ("sim005_flags_undetached_loop_registration", """
        def driver(conds, wake):
            while True:
                for c in conds:
                    c.on_trigger(print)
                yield wake
    """, ["SIM005"]),
    ("sim005_paired_detach_is_legal", """
        def driver(conds, wake):
            while True:
                for c in conds:
                    c.on_trigger(print)
                yield wake
                for c in conds:
                    c.detach(print)
    """, []),
]


def _findings(lint, src):
    return [(f.line, f.col, f.rule, f.message)
            for f in lint.lint_source(textwrap.dedent(src))]


@pytest.mark.parametrize("name,src,rules", FIXTURES,
                         ids=[f[0] for f in FIXTURES])
def test_fixture_findings_identical_to_reference(name, src, rules):
    got = _findings(tlint, src)
    assert [f[2] for f in got] == rules
    assert got == _findings(jlint, src)


def test_every_rule_has_a_fixture():
    assert tlint.RULES == jlint.RULES
    assert sorted({r for _, _, rules in FIXTURES for r in rules}) == sorted(
        tlint.RULES)


def test_finding_format_is_clickable():
    f = tlint.Finding("src/x.py", 12, 4, "SIM002", "msg")
    assert f.format() == "src/x.py:12:4: SIM002 msg"
    assert f.as_dict() == jlint.Finding("src/x.py", 12, 4, "SIM002",
                                        "msg").as_dict()


@pytest.mark.parametrize("tree", ["repro_torch", "repro"])
def test_trees_lint_clean_under_both_lints(tree):
    """The port's tree must lint clean (suppressions count as clean), and
    both lints read both trees alike."""
    path = os.path.join(REPO, "src", tree)
    findings = tlint.lint_paths([path])
    assert findings == [], "\n".join(f.format() for f in findings)
    assert jlint.lint_paths([path]) == []
