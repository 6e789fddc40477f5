"""The benchmark's harness: run one cell of ``BENCHMARK.json`` on the card.

Everything that belongs to one configuration, traffic mix or per-layer
metric lives in a file of its own (``bench/configs``, ``bench/traffic``,
``bench/metrics``), found by the name ``BENCHMARK.json`` gives it.  The
modules here are the general code: the generator that reads a traffic
file, the weights drawn from the seed, the wall-clock migration phases,
the trace reduction and the comparison with the plain reference.
"""
