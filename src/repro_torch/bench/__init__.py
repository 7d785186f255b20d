"""Memory/perf regression harness of the port (``python -m
repro_torch.bench``), the counterpart of ``repro/bench/``.

``memory`` (activation-memory accounting), ``timing`` (kernel/backend wall
time + traced traffic), ``serving`` (the paged engine's gated numbers),
``record`` (the ``BENCH_*.json`` schema and the ``--check`` regression
gate) and ``paper_tables`` (Figures 3-6 analogues).  The suites run on the
card unless the caller names the CPU; records go to ``build/bench_torch/``
by default.  See README, "The port's bench harness".
"""

from repro_torch.bench.record import (DEFAULT_TOLERANCE_PCT, SCHEMA_VERSION,
                                      check_records, compare_records, entry,
                                      load_record, make_record, write_record)

__all__ = [
    "DEFAULT_TOLERANCE_PCT", "SCHEMA_VERSION", "check_records",
    "compare_records", "entry", "load_record", "make_record", "write_record",
]
