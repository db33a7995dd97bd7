"""Continuous-batching inference service on one GPU, and its fleet.

The JAX package's ``serving/``: an admission queue with per-request
deadlines and class-aware SLO shedding (``queue``, ``slo``), bucketed batch
assembly over a fixed set of padded shapes (``batcher``), a dispatch loop
over ``configs.build_forward`` that replays one CUDA graph per bucket and
journals every batch (``server``; a sharded config at ``n_shards`` slots on
the server's card), a load generator with Poisson and traffic-shaped
arrivals, latency percentiles and the saturation sweep (``loadgen``,
``traffic``), the HTTP front end over the admission queue with its
threaded client fleet (``frontend``), the closed-loop controller over one
server (``controller``), and the fleet: N backend processes, each a server
and front end (``fleet``), behind a crc32 router with a hysteretic health
machine (``router``) and the control plane that arbitrates degradation
across backends (``fleet_controller``).

Layering rule: ``queue``, ``batcher``, ``loadgen``, ``traffic``, ``slo``,
``controller``, ``router`` and ``fleet_controller`` import the standard
library and numpy only, never torch; only ``server`` touches torch, when it
builds its forward and graphs (the controller reaches it through the
server's actuators and the tolerance gate), ``frontend`` rides on
``server``, and ``fleet`` spawns each backend as a fresh interpreter.
"""
