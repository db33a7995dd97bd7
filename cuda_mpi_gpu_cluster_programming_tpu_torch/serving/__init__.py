"""Continuous-batching inference service on one GPU.

The JAX package's ``serving/``, first step: an admission queue with
per-request deadlines and class-aware SLO shedding (``queue``, ``slo``),
bucketed batch assembly over a fixed set of padded shapes (``batcher``),
a dispatch loop over ``configs.build_forward`` that replays one CUDA graph
per bucket and journals every batch (``server``), a load generator with
Poisson and traffic-shaped arrivals, latency percentiles and the
saturation sweep (``loadgen``, ``traffic``), the HTTP front end over
the admission queue with its threaded client fleet (``frontend``), and the
second step's closed-loop controller over one server (``controller``).

Layering rule: ``queue``, ``batcher``, ``loadgen``, ``traffic``, ``slo``
and ``controller`` import the standard library and numpy only, never
torch; only ``server`` touches torch, when it builds its forward and
graphs (the controller reaches it through the server's actuators and the
tolerance gate), and ``frontend`` rides on ``server``. The router, the
fleet and the fleet controller wait for ROADMAP Queue 1 item 1's third
step.
"""
