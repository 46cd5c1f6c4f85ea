"""The paper's evaluation on the port.

One module per module of the repository's ``benchmarks/`` folder but its
timing harness (``kernel_bench``, ``run``): the figure and table modules
(``fig13_latency_by_layer``, ``fig14_breakdown``, ``fig15_total_latency``,
``fig16_throughput_batch``, ``tab3_energy``, ``tab4_cache_scaling``), the
LM cost model (``lm_neural_cache``), the schedule-priced breakdown with
its gates (``sched_breakdown``) and the fleet's traffic replay
(``traffic_replay``).  Each module's ``run()`` returns the reference's CSV
rows (``name,us_per_call,derived``).  The figure and table rows are
modeled Xeon-cache times from the simulator, never device times; the two
measured inputs of ``sched_breakdown`` and the real fleet of
``traffic_replay`` run on ``device`` (default ``cuda``).
"""
