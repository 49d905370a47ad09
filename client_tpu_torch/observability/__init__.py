"""Observability: the clients' side (``client_stats``; the trace context
and ``Server-Timing`` parsing of ``tracing``) and the server's planes:
``metrics`` (the registry behind ``/metrics``), ``tracing`` (the span
store behind ``/v2/trace/requests``), ``events`` (the journal behind
``/v2/events``), ``profiler`` and ``roofline`` (``/v2/profile``),
``memory`` (the HBM census behind ``/v2/memory``), ``costs``
(``/v2/costs``), ``slo`` (``/v2/slo``), ``timeseries`` (the flight
recorder behind ``/v2/timeseries``) and ``blackbox`` (incident bundles
behind ``/v2/debug/{bundles,capture}``); the router's ``fleet`` (the
merges of the fleet plane and its drift math) and ``scrape`` (exposition
parsing and histogram quantiles).
Nothing is imported here: the clients import ``tracing`` and
``client_stats`` without a framework."""
