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

and the serving hooks (ROADMAP A7 (b)):

- :mod:`~veles_tpu_torch.observe.reqledger`: one row per serving request
  with its stage waterfall and attribution (``/debug/requests``,
  ``observe slo``);
- :mod:`~veles_tpu_torch.observe.slo`: objectives over multi-window
  burn rates, fed once per resolved row;
- :mod:`~veles_tpu_torch.observe.servescope`: the serving wall and
  token-waste decomposition and the per-slot timeline (``/debug/serve``,
  ``observe serve-trace``);
- :mod:`~veles_tpu_torch.observe.memscope`: per-owner device-memory
  attribution, lifecycle-edge leak verdicts, the pool's headroom
  (``/debug/memory``);
- :mod:`~veles_tpu_torch.observe.history`: the metric history, anomaly
  rules and incident bundles (``/debug/history``, ``observe incident``).

and what acts on those hooks (ROADMAP A7 (c)):

- :mod:`~veles_tpu_torch.observe.governor`: the serving governor, the
  tier ladder, the admission limit, the Retry-After price and the
  proactive breaker guard, ticked by the serving driver;
- :mod:`~veles_tpu_torch.observe.replay`: anonymised traffic traces from
  the request ledger and their open-loop, seeded replay (``observe
  record``, ``observe replay``);
- :mod:`~veles_tpu_torch.observe.capacity`: the capacity search over a
  replayed trace, its report naming the first-breaching series and the
  dominant waste cause (``observe capacity``);
- :mod:`~veles_tpu_torch.observe.regress`: bench artifacts with atomic
  writes and sidecars, and the direction-aware regression gate
  (``observe regress``).

The blue-green rollout is ``veles_tpu_torch/rollout.py``. The
dashboards (ROADMAP A7 (d)) are ``veles_tpu_torch/plotting/`` (the
GraphicsServer and the stock plotters) and ``veles_tpu_torch/web_status.py``
(the WebStatusServer with its ``/metrics`` mount, and the launcher's
StatusNotifier); ``xla_stats`` publishes the active mesh's gauges and the
data-parallel reduce plane (``parallel/mesh.py``, ``mapreduce.py``). The
fleet scope is ``observe/fleetscope.py``: span rings, clock estimates,
step windows, straggler verdicts, goodput, ``observe fleet-trace``.

Everything is off by default with a structural no-op fast path (the
disabled tracer hands out one shared null span, the disabled registry
returns before its lock), except the flight recorder, the request ledger
and the serve scope, which are on and record with bounded lock-free
appends at the millisecond-scale dispatch sites; the history samples
while a serving front runs.
"""

from veles_tpu_torch.observe.flight import (  # noqa: F401
    FlightRecorder, get_flight_recorder)
from veles_tpu_torch.observe.metrics import (  # noqa: F401
    DEFAULT_BUCKETS, MetricsRegistry, bridge, get_metrics_registry,
    publish_decoder, publish_fleet, publish_kv_pool, publish_loader,
    publish_serving_health)
from veles_tpu_torch.observe.tracing import (  # noqa: F401
    NULL_SPAN, TRACE_HEADER, Tracer, current_context,
    format_trace_header, get_tracer, parse_trace_field,
    parse_trace_header)
from veles_tpu_torch.observe.xla_stats import (  # noqa: F401
    CompileTracker, ensure_registered, get_compile_tracker,
    instrument)
from veles_tpu_torch.observe.history import (  # noqa: F401
    AnomalyRule, HistoryConfig, IncidentRecorder, MetricHistory,
    default_rules, ensure_metric_history, get_metric_history,
    parse_history_spec, set_metric_history, start_history_sampler,
    stop_history_sampler)
from veles_tpu_torch.observe.memscope import (  # noqa: F401
    MemScope, get_memscope, pytree_nbytes, set_memscope)
from veles_tpu_torch.observe.reqledger import (  # noqa: F401
    RequestLedger, autopsy, format_waterfall, get_request_ledger,
    publish_request_ledger, widest_gap)
from veles_tpu_torch.observe.servescope import (  # noqa: F401
    ServeScope, ensure_serve_registered, get_serve_scope,
    publish_serve_scope)
from veles_tpu_torch.observe.slo import (  # noqa: F401
    SLOEngine, get_slo_engine, observe_request, parse_objectives,
    row_latencies, set_slo_engine)
from veles_tpu_torch.observe.governor import (  # noqa: F401
    GovernorConfig, ServingGovernor, format_governor_transitions,
    parse_governor_spec, publish_governor)
from veles_tpu_torch.observe.capacity import (  # noqa: F401
    CapacityFinder, render_capacity_report, write_capacity_report)
from veles_tpu_torch.observe.replay import (  # noqa: F401
    hash_tenant, load_trace, plan_fingerprint, record_trace, replay,
    warp_plan, write_trace)
from veles_tpu_torch.observe.regress import (  # noqa: F401
    BenchArtifact, compare, load_bench, regressions)
