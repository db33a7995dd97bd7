"""Resilience pieces the port's autotuner and tolerance gate need, copied
from the JAX package's ``resilience/`` (the port imports nothing of it):
``journal`` (fsync'd jsonl journal, atomic writes), ``chaos`` (seeded fault
injection from ``CHAOS_SPEC``), ``policy`` (``Deadline``, and the bench's
``RetryPolicy``, ``FaultLog`` and ``retry_call``) and ``sentinel``
(``oracle_spot_check``, the gate's preflight)."""
