"""Continuous-batching inference service on one GPU.

The JAX package's ``serving/``, first step: an admission queue with
per-request deadlines and class-aware SLO shedding (``queue``, ``slo``),
bucketed batch assembly over a fixed set of padded shapes (``batcher``),
a dispatch loop over ``configs.build_forward`` that replays one CUDA graph
per bucket and journals every batch (``server``), a load generator with
Poisson and traffic-shaped arrivals, latency percentiles and the
saturation sweep (``loadgen``, ``traffic``), and the HTTP front end over
the admission queue with its threaded client fleet (``frontend``).

Layering rule: ``queue``, ``batcher``, ``loadgen``, ``traffic`` and ``slo``
import the standard library and numpy only, never torch; only ``server``
touches torch, when it builds its forward and graphs, and ``frontend``
rides on ``server``. The router, the fleet and the serving controllers
wait for ROADMAP Queue 1 item 1's second step.
"""
