"""Resilience, copied from the JAX package's ``resilience/`` (the port imports
nothing of it): ``journal`` (fsync'd jsonl journal, atomic writes), ``chaos``
(seeded fault injection from ``CHAOS_SPEC``), ``policy`` (``Deadline``, the
bench's and ``run --max-retries``'s ``RetryPolicy``, ``FaultLog`` and
``retry_call``, ``run --fallback-chain``'s ``Degrader`` and
``tier_fallback_chain``), ``sentinel`` (the SDC sentinel, the stage digests,
``oracle_spot_check``, the gate's preflight) and ``supervisor`` (the elastic
supervisor: ``run --supervise``, the supervised server, ``supervise_step``)."""
