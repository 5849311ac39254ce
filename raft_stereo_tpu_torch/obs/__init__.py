"""Observability of the port's serving tier and trainer: tracing
(`trace`), Prometheus text exposition (`prom`, and the trainer's `/metrics`
sidecar) and device memory (`memory`). Host-side only: nothing here
launches device work or waits on a stream."""
