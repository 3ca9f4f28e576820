"""The observe plane's base: metrics, tracing, the flight recorder, trace
export, device truth and the profiler window.

The port of ``veles_tpu/observe/`` part (a) (ROADMAP A7), with
``xla_stats`` and ``profile``:

- :mod:`~veles_tpu_torch.observe.metrics`: the process-global
  :class:`MetricsRegistry` with Prometheus and OpenMetrics exposition,
  mounted as ``/metrics`` on every HTTP surface by
  ``core/httpd.serve_metrics``; weak bridges re-publish
  ``ServingHealth``, ``ContinuousDecoder`` and the loaders at scrape time;
- :mod:`~veles_tpu_torch.observe.tracing`: trace_id/span_id spans through
  the EventRecorder, propagated by the ``X-Veles-Trace`` header;
- :mod:`~veles_tpu_torch.observe.trace_export`: the Chrome trace
  exporter and ``python -m veles_tpu_torch observe``;
- :mod:`~veles_tpu_torch.observe.flight`: the always-on bounded flight
  recorder and its black-box dumps;
- :mod:`~veles_tpu_torch.observe.xla_stats`: device truth on CUDA (kernel
  builds, program calls, device memory, online MFU; no XLA);
- :mod:`~veles_tpu_torch.observe.profile`: the ``torch.profiler``
  window with span-named ranges.

The request ledger, SLO engine, serve scope, memory scope and metric
history wait for ROADMAP A7 (b); the governor, rollout, replay, capacity
and regress for (c); plotting and web status for (d); the fleet scope
for A9.

Everything is off by default with a structural no-op fast path (the
disabled tracer hands out one shared null span, the disabled registry
returns before its lock), except the flight recorder, which is on and
records with a bounded lock-free append at the millisecond-scale
dispatch sites.
"""

from veles_tpu_torch.observe.flight import (  # noqa: F401
    FlightRecorder, get_flight_recorder)
from veles_tpu_torch.observe.metrics import (  # noqa: F401
    DEFAULT_BUCKETS, MetricsRegistry, bridge, get_metrics_registry,
    publish_decoder, publish_kv_pool, publish_loader,
    publish_serving_health)
from veles_tpu_torch.observe.tracing import (  # noqa: F401
    NULL_SPAN, TRACE_HEADER, Tracer, current_context,
    format_trace_header, get_tracer, parse_trace_field,
    parse_trace_header)
from veles_tpu_torch.observe.xla_stats import (  # noqa: F401
    CompileTracker, ensure_registered, get_compile_tracker,
    instrument)
