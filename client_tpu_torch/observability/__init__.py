"""Observability: the clients' side so far (``client_stats``, and the
trace context and ``Server-Timing`` parsing of ``tracing``). The engine's
metrics, span store and planes are not ported yet."""
