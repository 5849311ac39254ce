"""Observability of the port's serving tier: tracing (`trace`), Prometheus
text exposition (`prom`) and device memory (`memory`). Host-side only:
nothing here launches device work or waits on a stream."""
