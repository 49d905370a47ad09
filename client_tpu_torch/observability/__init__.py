"""Observability: the clients' side (``client_stats``; the trace context
and ``Server-Timing`` parsing of ``tracing``) and the server's planes:
``metrics`` (the registry behind ``/metrics``), ``tracing`` (the span
store behind ``/v2/trace/requests``), ``events`` (the journal behind
``/v2/events``), ``profiler`` and ``roofline`` (``/v2/profile``). The
HBM census, SLO, costs, timeseries and blackbox planes are not ported
yet. Nothing is imported here: the clients import ``tracing`` and
``client_stats`` without a framework."""
