# Machine-checked guarantees for the event kernel: the determinism lint
# (repro_torch.analysis.lint / tools/simlint.py), the runtime leak/race
# sanitizer (Sim(sanitize=True)), and the virtual-time schedule
# perturbation harness (Sim(tiebreak_seed=N) / tools/sim_perturb.py).
# See docs/determinism.md for the contract these enforce.
from repro_torch.analysis.sanitizer import (  # noqa: F401
    SanitizerViolation,
    SimSanitizer,
    capture_site,
    format_site,
)
